"""Number of CUDA graph captures in the run's process: the program's
``cvf.graph.capture`` spans, profiled ones included. One is set-up's
capture; more is a capture again inside the timed path."""

from portbench.metrics import _spans


def value(spans):
    return float(len(_spans.named(spans, "cvf.graph.capture",
                                  profiled=True)))


def read(ctx):
    return _spans.apply(value)

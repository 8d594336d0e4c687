"""Seconds of capturing epochs as CUDA graphs: the sum of the program's
``cvf.graph.capture`` spans (each an eager epoch and its capture), part of
set-up."""

from portbench.metrics import _spans


def value(spans):
    return _spans.total_s(spans, "cvf.graph.capture")


def read(ctx):
    return _spans.apply(value)

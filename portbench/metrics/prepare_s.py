"""Seconds of preparing the training data: the sum of the program's
``cvf.task.prepare`` spans (the batches gathered on the device and, on the
Gram path, the Gram precompute), part of set-up."""

from portbench.metrics import _spans


def value(spans):
    return _spans.total_s(spans, "cvf.task.prepare")


def read(ctx):
    return _spans.apply(value)

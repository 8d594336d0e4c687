"""Seconds of the tasks' construction: the sum of the program's
``cvf.task.init`` spans (a task's whole constructor, its subclass's
included), part of set-up."""

from portbench.metrics import _spans


def value(spans):
    return _spans.total_s(spans, "cvf.task.init")


def read(ctx):
    return _spans.apply(value)

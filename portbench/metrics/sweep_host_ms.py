"""Median over sweep calls, in ms, of the sweep's host phases: stacking the
replicas (``cvf.sweep.load``) and building the R results
(``cvf.sweep.unpack``), summed per call (``cvf.sweep.call``). Calls that
capture a graph are left out, as are profiled ones."""

from collections import defaultdict

import numpy as np

from portbench.metrics import _spans


def value(spans):
    capturing = {s.call for s in spans if s.name == "cvf.graph.capture"}
    host = defaultdict(float)
    for name in ("cvf.sweep.load", "cvf.sweep.unpack"):
        for s in _spans.named(spans, name):
            if s.call not in capturing:
                host[s.call] += _spans.seconds(s) * 1e3
    return float(np.median(list(host.values()))) if host else None


def read(ctx):
    return _spans.apply(value)

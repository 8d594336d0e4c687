"""Median, in us, of the host time from an epoch's fetch to the launch of
the next epoch of the same call: from the end of a ``cvf.epoch.fetch``
span to the start of the next ``cvf.epoch.issue`` of its call, where that
one replays a graph. The card has nothing queued there."""

from collections import defaultdict

import numpy as np

from portbench.metrics import _spans


def value(spans):
    by_call = defaultdict(list)
    for name in ("cvf.epoch.fetch", "cvf.epoch.issue"):
        for s in _spans.named(spans, name):
            by_call[s.call].append(s)
    gaps = []
    for seq in by_call.values():
        seq.sort(key=lambda s: s.start_ns)
        for a, b in zip(seq, seq[1:]):
            if (a.name == "cvf.epoch.fetch" and b.name == "cvf.epoch.issue"
                    and b.attrs.get("replay")):
                gaps.append((b.start_ns - a.end_ns) * 1e-3)
    return float(np.median(gaps)) if gaps else None


def read(ctx):
    return _spans.apply(value)

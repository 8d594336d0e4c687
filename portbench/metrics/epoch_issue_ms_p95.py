"""95th percentile, in ms, of the host time to issue one replayed epoch:
the program's ``cvf.epoch.issue`` spans with ``replay=True`` (the CUDA
graph's launch)."""

import numpy as np

from portbench.metrics import _spans


def value(spans):
    ms = [_spans.seconds(s) * 1e3
          for s in _spans.named(spans, "cvf.epoch.issue")
          if s.attrs.get("replay")]
    return float(np.percentile(ms, 95.0)) if ms else None


def read(ctx):
    return _spans.apply(value)

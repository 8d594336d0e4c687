"""95th percentile of the wall time of every epoch in the window, each
epoch timed by the program's own host clock up to its one fetch
(``TrainingTask.epoch_times`` with ``progress_interval=1``)."""

import numpy as np


def read(ctx):
    epochs = [t for c in ctx.calls for t in c.get("epoch_s", ())]
    if not epochs:
        return None
    return float(np.percentile(np.asarray(epochs), 95.0)) * 1e3

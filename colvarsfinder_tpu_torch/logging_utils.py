r"""Observability of the port: TensorBoard scalars and loss dataframes
(from ``colvarsfinder_tpu/logging_utils.py``). Neither tensorboardX nor
pandas is needed to train: the writer is a no-op unless tensorboardX is
importable and asked for, and pandas is imported only to build a
dataframe."""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["MetricsWriter", "losses_to_dataframe"]


class MetricsWriter:
    """Thin wrapper over tensorboardX's SummaryWriter, gated on
    availability."""

    def __init__(self, log_dir: str, enabled: bool = True):
        self._writer = None
        if enabled:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                return
            self._writer = SummaryWriter(log_dir)

    def add_scalar(self, tag: str, value, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), step)

    def add_scalars_split(
        self, names: Sequence[str], train_vals, test_vals, epoch: int
    ) -> None:
        """Write '<name>/train' and '<name>/test' for each metric."""
        if self._writer is None:
            return
        for i, name in enumerate(names):
            self.add_scalar(f"{name}/train", train_vals[i], epoch)
            self.add_scalar(f"{name}/test", test_vals[i], epoch)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()


def losses_to_dataframe(per_epoch_means: Sequence[np.ndarray],
                        columns: Sequence[str]):
    """Stack per-epoch mean metric vectors into a pandas DataFrame."""
    import pandas as pd

    if len(per_epoch_means) == 0:
        return pd.DataFrame(columns=list(columns))
    return pd.DataFrame(np.stack(per_epoch_means), columns=list(columns))

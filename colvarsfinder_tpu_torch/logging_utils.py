r"""Observability of the port: TensorBoard scalars, loss dataframes and
profiler traces (from ``colvarsfinder_tpu/logging_utils.py``). Neither
tensorboardX nor pandas is needed to train: the writer is a no-op unless
tensorboardX is importable and asked for, and pandas is imported only to
build a dataframe."""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["MetricsWriter", "losses_to_dataframe", "profile_trace"]


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


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str], device: torch.device):
    """Optionally wrap a block in a ``torch.profiler`` trace of the host and,
    on the card, the device, written to ``log_dir`` as a TensorBoard trace
    (``<host>_<pid>.<ns>.pt.trace.json``); the counterpart of the JAX
    package's ``jax.profiler`` trace."""
    if log_dir is None:
        yield
        return
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield


def losses_to_dataframe(per_epoch_means: Sequence[np.ndarray],
                        columns: Sequence[str]):
    """Stack per-epoch mean metric vectors into a pandas DataFrame."""
    import pandas as pd

    if len(per_epoch_means) == 0:
        return pd.DataFrame(columns=list(columns))
    return pd.DataFrame(np.stack(per_epoch_means), columns=list(columns))

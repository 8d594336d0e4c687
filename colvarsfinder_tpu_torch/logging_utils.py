r"""Observability of the port: the span recorder, TensorBoard scalars,
loss dataframes and profiler traces (from
``colvarsfinder_tpu/logging_utils.py``). Neither tensorboardX nor pandas is
needed to train: the writer is a no-op unless tensorboardX is importable
and asked for, and pandas is imported only to build a dataframe.

The recorder keeps, in memory, a span for each phase of the program that a
caller may want to time (a task's construction, a ``train()`` call, each
epoch's launch and fetch, a capture, a sweep's host phases) and a few
counters (the hand-written kernels' launches). Spans are at phase and
epoch granularity, never per step and never inside a captured CUDA graph.
Each span holds its name, its start and end on ``time.perf_counter_ns()``,
its own id, its parent's id, the id of the call that caused it (its
outermost open span: a ``train()``, a sweep, a construction) and a few
small attributes. While a ``torch.profiler`` session records, each span
also opens a ``record_function`` of its name, so that the span sits in the
profiler's trace as a ``user_annotation`` on the device's timeline, and is
flagged ``profiled``. Nothing is written to disk. :func:`set_tracing` turns
the recorder off and on; off, :func:`span` returns one shared context that
records nothing, and ``TrainingTask.epoch_times`` and
``parallel.ensemble.last_run_seconds``, which the recorder times, read
nan."""

from __future__ import annotations

import contextlib
import itertools
import math
import threading
from collections import deque
from time import perf_counter_ns
from typing import Optional, Sequence

import numpy as np
import torch
import torch.autograd.profiler as _profiler

__all__ = [
    "MetricsWriter",
    "Recorder",
    "Span",
    "count",
    "counters",
    "losses_to_dataframe",
    "profile_trace",
    "reset_trace",
    "set_tracing",
    "span",
    "spans",
]

#: spans the recorder keeps; beyond it the oldest are dropped, and counted
#: by the counter ``cvf.trace.dropped``
SPAN_CAPACITY = 65536


class Span:
    """One timed phase: a context manager that, on exit, is the record of
    the phase (``name``, ``start_ns``, ``end_ns``, ``id``, ``parent``,
    ``call``, ``profiled``, ``attrs``)."""

    __slots__ = ("name", "attrs", "id", "parent", "call", "profiled",
                 "start_ns", "end_ns", "_rec", "_fn")

    def __init__(self, rec: "Recorder", name: str, attrs: dict):
        self._rec, self.name, self.attrs = rec, name, attrs
        self.start_ns = self.end_ns = None

    def __enter__(self) -> "Span":
        rec = self._rec
        stack = rec._open()
        self.id = next(rec._ids)
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.parent, self.call = None, self.id
        stack.append(self)
        # a module global torch keeps for exactly this cheap check
        self.profiled = _profiler._is_profiler_enabled
        self._fn = None
        if self.profiled:
            self._fn = _profiler.record_function(self.name)
            self._fn.__enter__()
        self.start_ns = perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = perf_counter_ns()
        if self._fn is not None:
            self._fn.__exit__(*exc)
            self._fn = None
        self._rec._open().pop()
        self._rec._keep(self)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class _NoSpan:
    """What :func:`span` returns while tracing is off: records nothing."""

    seconds = math.nan

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


class Recorder:
    """Spans in a ring of ``capacity`` and counters by name, both in
    memory. The module's :func:`span`, :func:`count`, :func:`spans`,
    :func:`counters`, :func:`reset_trace` and :func:`set_tracing` are those
    of one recorder of the process."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self.enabled = True
        self._ring: deque = deque(maxlen=int(capacity))
        self._counters: dict = {}
        self._ids = itertools.count(1)
        self._local = threading.local()

    def span(self, name: str, **attrs):
        """A context manager that records the phase it wraps as a span
        named ``name`` with the attributes ``attrs``."""
        if not self.enabled:
            return _NO_SPAN
        return Span(self, name, attrs)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name``. A size of a symbolic trace
        (``torch.export``'s ``torch.SymInt``) counts nothing: the trace
        evaluates nothing."""
        if self.enabled and not isinstance(n, torch.SymInt):
            self._counters[name] = self._counters.get(name, 0) + n

    def spans(self) -> list:
        """The recorded spans, in the order they ended."""
        return list(self._ring)

    def counters(self) -> dict:
        """Every counter by name."""
        return dict(self._counters)

    def reset(self) -> None:
        """Forget every recorded span and counter."""
        self._ring.clear()
        self._counters.clear()

    def set_enabled(self, on: bool) -> bool:
        """Turn recording on or off; returns the previous setting."""
        prev, self.enabled = self.enabled, bool(on)
        return prev

    def _open(self) -> list:
        """This thread's open spans, innermost last."""
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _keep(self, s: Span) -> None:
        if len(self._ring) == self._ring.maxlen:
            self.count("cvf.trace.dropped")
        self._ring.append(s)


_RECORDER = Recorder()
span = _RECORDER.span
count = _RECORDER.count
spans = _RECORDER.spans
counters = _RECORDER.counters
reset_trace = _RECORDER.reset
set_tracing = _RECORDER.set_enabled


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
    package's ``jax.profiler`` trace. The recorder's spans opened inside it
    appear in the trace as ``user_annotation`` events."""
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

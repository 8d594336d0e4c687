"""The port's CUDA graphs: capture, replay, the counts carried into
replays, staleness, and the one switch that runs them eagerly.

An owner (a task's epoch or streamed steps, a sweep's epoch, a sampler
call's blocks) keeps its captured programs in one :class:`Graphs`, by kind.
A replay runs no Python, so what the program's Python counts in the
recorder (the kernel launches of :mod:`.ops._cuda`, the alignment's, the
features' and the stacked heads' counters) is taken out of the capture,
held with its graph and added again by every replay.
"""

from __future__ import annotations

import contextlib
import gc
from typing import NamedTuple

import torch

from .logging_utils import count, counters, span
from .ops._cuda import COUNTER, KERNELS

__all__ = ["Captured", "Graphs", "capture", "eager", "held_counts",
           "replay", "report_blocks"]

# the block limits of the open eager() switches, innermost last
_EAGER: list = []


@contextlib.contextmanager
def eager(blocks: int | None = None):
    """Inside, every :class:`Graphs` runs its bodies eagerly, on the card
    too: a captured run's eager twin, for a bit-for-bit comparison. With
    ``blocks=m`` a sampler's report loop also stops after m blocks."""
    _EAGER.append(blocks)
    try:
        yield
    finally:
        _EAGER.pop()


def report_blocks(n: int) -> int:
    """Report blocks a sampler call runs of ``n``: all, or at most the
    innermost :func:`eager` switch's ``blocks``."""
    limit = _EAGER[-1] if _EAGER else None
    return n if limit is None else min(n, int(limit))


@contextlib.contextmanager
def held_counts():
    """Around a CUDA graph capture: yields a dict that is filled, on exit,
    with the launches each kernel wrapper counted inside (the launches the
    graph holds), by wrapper name, and takes them back out of the
    counters, since a capture runs nothing. Every other counter of the
    recorder that moved inside is taken back out the same way and held
    under its full name."""
    before = counters()
    held: dict = {}
    try:
        yield held
    finally:
        after = counters()
        for name in KERNELS:
            n = after.get(COUNTER + name, 0) - before.get(COUNTER + name, 0)
            held[name] = n
            count(COUNTER + name, -n)
        for name, v in after.items():
            n = v - before.get(name, 0)
            if n and not name.startswith(COUNTER):
                held[name] = n
                count(name, -n)


def replay(graph, launches: dict) -> None:
    """Replay a captured graph and count what it holds (``launches``, from
    :func:`held_counts`)."""
    graph.replay()
    for name, n in launches.items():
        if n:
            count(COUNTER + name if name in KERNELS else name, n)


class Captured(NamedTuple):
    """One program captured as a CUDA graph, with the counts it carries
    into each replay (:func:`held_counts`), the owner's key at capture, and
    ``held``, which keeps alive every object whose ``id`` is in the key."""

    graph: object
    launches: dict
    key: tuple
    held: list


def _no_key():
    return None, []


def capture(body, device, key_fn=_no_key,
            what: str = "the training epoch") -> Captured:
    """Run ``body()`` once eagerly on a side stream (a real epoch, which
    also creates the optimizer's state, the cuBLAS handles and the kernel
    libraries), then capture it as a CUDA graph on that stream with its
    counts held; ``key_fn()`` gives the ``(key, held)`` of the result after
    the eager run. A capture that fails raises, naming ``what`` was
    captured: nothing falls back to eager on the card.

    Python's cyclic garbage collector is run before the capture and held
    off during it: a graph that died in a reference cycle would otherwise
    be destroyed whenever the collector runs, and destroying a graph
    invalidates a capture in progress.

    The eager run and the capture are one ``cvf.graph.capture`` span."""
    with span("cvf.graph.capture", what=what):
        current = torch.cuda.current_stream(device)
        stream = torch.cuda.Stream(device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            body()
        key, held = key_fn()
        graph = torch.cuda.CUDAGraph()
        gc.collect()
        gc.disable()
        try:
            with held_counts() as launches, \
                    torch.cuda.graph(graph, stream=stream):
                body()
        except RuntimeError as err:
            raise RuntimeError(
                f"capturing {what} as a CUDA graph failed (a host sync or a "
                f"call that capture forbids inside it?): {err}"
            ) from err
        finally:
            gc.enable()
        current.wait_stream(stream)
    return Captured(graph, launches, key, held)


class Graphs(dict):
    """An owner's captured programs by kind, ``{kind: Captured}``, valid
    while ``key_fn()`` gives the key they were captured with (without a
    ``key_fn``, until :meth:`drop`). A dropped graph frees its memory
    pool."""

    def __init__(self, device: torch.device, key_fn=_no_key):
        super().__init__()
        self.device, self.key_fn = device, key_fn

    def mode(self, kind) -> str:
        """What :meth:`run` does for ``kind``: ``'eager'`` for the kind
        ``None``, on the CPU or inside :func:`eager`, else ``'replay'`` of
        the held graph, else ``'capture'``."""
        if kind is None or self.device.type != "cuda" or _EAGER:
            return "eager"
        return "replay" if kind in self else "capture"

    def run(self, kind, body, what: str = "the training epoch") -> None:
        """Run ``body()`` eagerly, replay ``kind``'s graph, or capture
        ``body`` as it, as :meth:`mode` says."""
        mode = self.mode(kind)
        if mode == "eager":
            body()
        elif mode == "replay":
            replay(self[kind].graph, self[kind].launches)
        else:
            self[kind] = capture(body, self.device, self.key_fn, what)

    def drop(self) -> bool:
        """Forget every graph; whether any was held."""
        had = bool(self)
        self.clear()
        return had

    def check(self) -> bool:
        """Drop every graph if ``key_fn()`` gives another key than a
        graph's; whether they were dropped."""
        key = self.key_fn()[0] if self else None
        return any(g.key != key for g in self.values()) and self.drop()

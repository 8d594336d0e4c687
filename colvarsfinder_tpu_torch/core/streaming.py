r"""The host-to-device pipeline of the streaming layout
(:meth:`.task.TrainingTask._stream_epochs`; the JAX package's
``TrainingTask._stream_epochs``, ``colvarsfinder_tpu/core/task.py:566-851``).

A task describes one streamed batch by ``_stream_pack(rows)``: a tuple of
leaves, each ``None`` or a gather ``(source, indices)`` from a host array
(a ``np.memmap`` included); one gather object at two positions fills both
with one tensor. :class:`StreamIO` lays one kind of batch (train or test)
out in flat buffers, one per dtype on the wire (one per leaf without
packing), each leaf at a 512-byte aligned offset, as the caching allocator
aligns the resident batches:

* a ring of host buffers (pinned on the card) that the gather threads fill
  with ``np.take(..., out=)`` into their numpy views, casting per batch
  where the source's dtype is not the buffer's;
* on the card, a ring of device slots that a dedicated copy stream fills
  from the host buffers (``copy_(non_blocking=True)``), an event after each
  copy;
* the step's inputs, one buffer per group at a fixed address, which a
  captured step reads: the compute stream waits on a slot's event and copies
  the slot into them (a device-to-device copy) before the step.

Frame leaves (sources of two or more dims) travel in the wire dtype when
one is set and are upcast by the step; per-frame scalars (weights, region
masks) keep the default dtype. :class:`GatherPool` runs the gathers on
threads in strict round robin, so results come back in order; an exception
in any of them reaches the caller, and :meth:`GatherPool.close` ends every
thread. Only the calling thread makes CUDA calls: a gather thread touches
host memory alone, so a CUDA graph capture on the calling thread is not
disturbed by it.
"""

from __future__ import annotations

import queue
import threading
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["GatherPool", "StreamIO"]

#: offset alignment of each leaf in a group buffer, in bytes
ALIGN_BYTES = 512


class _Leaf(NamedTuple):
    positions: tuple  # the batch positions it fills
    group: int
    offset: int  # elements into its group's buffer
    shape: tuple
    wire: bool  # held in the wire dtype, upcast by the step


def _take(src: np.ndarray, idx: np.ndarray, out: torch.Tensor,
          out_np) -> None:
    """``out[...] = src[idx]`` along axis 0, straight into ``out`` where the
    dtypes agree and through one temporary where they do not."""
    if idx.size and (idx.min() < 0 or idx.max() >= src.shape[0]):
        raise IndexError(
            f"frame index out of range for {src.shape[0]} frames")
    if out_np is not None and out_np.dtype == src.dtype:
        np.take(src, idx, axis=0, out=out_np, mode="clip")
        return
    tmp = np.take(src, idx, axis=0, mode="clip")
    if out_np is not None:
        np.copyto(out_np, tmp, casting="unsafe")
    else:  # bfloat16 has no numpy view
        out.copy_(torch.from_numpy(tmp))


class StreamIO:
    """The buffers of one kind of streamed batch.

    Args:
        leaves: one batch's ``_stream_pack`` result; it fixes the layout,
            and every later batch of this kind must match it.
        device: where the step runs.
        dtype: the default dtype (the dtype of every leaf on the device).
        wire: None, ``torch.float16`` or ``torch.bfloat16``: the dtype of
            the frame leaves on the host and over the link.
        packed: one buffer per dtype (one copy per batch) instead of one per
            leaf.
        n_host: host buffers in the ring.
        n_slots: device slots in the ring (the card only).
        width: the width of a step's metric row (:attr:`row`).
        copy_stream: the CUDA stream of the host-to-device copies.
    """

    def __init__(self, leaves, *, device, dtype, wire, packed: bool,
                 n_host: int, n_slots: int, width: int, copy_stream=None):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.dtype = dtype
        self.n_positions = len(leaves)
        self.n_host, self.n_slots = n_host, n_slots
        self.copy_stream = copy_stream
        self.leaves: list = []
        sources: list = []
        group_dtypes: list = []
        sizes: list = []
        for pos, leaf in enumerate(leaves):
            if leaf is None:
                continue
            same = [i for i, s in enumerate(sources) if s is leaf]
            if same:
                old = self.leaves[same[0]]
                self.leaves[same[0]] = old._replace(
                    positions=old.positions + (pos,))
                continue
            src, idx = leaf
            shape = (len(idx),) + tuple(src.shape[1:])
            is_wire = wire is not None and src.ndim >= 2
            gdt = wire if is_wire else dtype
            if packed and gdt in group_dtypes:
                g = group_dtypes.index(gdt)
            else:
                g = len(group_dtypes)
                group_dtypes.append(gdt)
                sizes.append(0)
            esz = torch.empty((), dtype=gdt).element_size()
            offset = -(-sizes[g] * esz // ALIGN_BYTES) * ALIGN_BYTES // esz
            sizes[g] = offset + int(np.prod(shape, dtype=np.int64))
            sources.append(leaf)
            self.leaves.append(_Leaf((pos,), g, offset, shape, is_wire))
        groups = list(zip(group_dtypes, sizes))

        def alloc(**kw):
            return [torch.empty(n, dtype=gdt, **kw) for gdt, n in groups]

        # the ring of host buffers: pinned on the card, or an error
        self.host = [alloc(pin_memory=self.cuda) for _ in range(n_host)]
        if self.cuda and not all(b.is_pinned() for bufs in self.host
                                 for b in bufs):
            raise RuntimeError("streaming: the host buffers could not be "
                               "pinned")
        self.host_bytes = sum(b.numel() * b.element_size()
                              for bufs in self.host for b in bufs)
        self.batch_bytes = sum(b.numel() * b.element_size()
                               for b in self.host[0])
        # per host buffer, per leaf: (tensor view, numpy view or None)
        self._views = []
        for bufs in self.host:
            views = []
            for leaf in self.leaves:
                t = self._leaf_view(bufs, leaf)
                views.append((t, None if t.dtype == torch.bfloat16
                              else t.numpy()))
            self._views.append(views)
        self.inputs = alloc(device=self.device)
        self.row = torch.empty(width, dtype=dtype, device=self.device)
        if self.cuda:
            self.slots = [alloc(device=self.device) for _ in range(n_slots)]
            self._host_free = [torch.cuda.Event() for _ in range(n_host)]
            self._slot_full = [torch.cuda.Event() for _ in range(n_slots)]
            self._slot_free = [torch.cuda.Event() for _ in range(n_slots)]

    @staticmethod
    def _leaf_view(bufs, leaf: _Leaf) -> torch.Tensor:
        n = int(np.prod(leaf.shape, dtype=np.int64))
        return bufs[leaf.group][leaf.offset:leaf.offset + n].view(leaf.shape)

    # -- the gather threads' side: host memory only ----------------------
    def gather(self, c: int, leaves) -> None:
        """Gather use ``c``'s batch (``_stream_pack``'s leaves) into host
        buffer ``c % n_host``."""
        if len(leaves) != self.n_positions:
            raise ValueError(f"a streamed batch has {len(leaves)} leaves, "
                             f"the layout {self.n_positions}")
        for leaf, (out, out_np) in zip(self.leaves, self._views[c % self.n_host]):
            src, idx = leaves[leaf.positions[0]]
            idx = np.asarray(idx, dtype=np.int64)
            if idx.shape != leaf.shape[:1]:
                raise ValueError(f"a streamed batch of {idx.shape[0]} rows "
                                 f"where the layout has {leaf.shape[0]}")
            _take(src, idx, out, out_np)

    # -- the calling thread's side ------------------------------------------
    def wait_host(self, c: int) -> None:
        """Before use ``c`` is gathered: its host buffer's previous copy to
        the card has completed."""
        if self.cuda and c >= self.n_host:
            self._host_free[c % self.n_host].synchronize()

    def transfer(self, c: int, timing=None) -> None:
        """Copy use ``c``'s host buffer into device slot ``c % n_slots`` on
        the copy stream, once the step that last read that slot has taken
        it in; a no-op on the CPU. ``timing``: a list that gets the copy's
        ``(start, end, bytes)``."""
        if not self.cuda:
            return
        p, d = c % self.n_host, c % self.n_slots
        with torch.cuda.stream(self.copy_stream):
            if c >= self.n_slots:
                self.copy_stream.wait_event(self._slot_free[d])
            if timing is not None:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            for dst, src in zip(self.slots[d], self.host[p]):
                dst.copy_(src, non_blocking=True)
            if timing is not None:
                end.record()
                timing.append((start, end, self.batch_bytes))
            self._host_free[p].record()
            self._slot_full[d].record()

    def consume(self, c: int, timing=None) -> None:
        """Fill the step's inputs with use ``c``'s batch on the current
        stream: on the card from its slot, after its copy (``timing``: a
        list that gets an event recorded once the copy has arrived), on the
        CPU from its host buffer."""
        if not self.cuda:
            for dst, src in zip(self.inputs, self.host[c % self.n_host]):
                dst.copy_(src)
            return
        d = c % self.n_slots
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(self._slot_full[d])
        if timing is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            timing.append(start)
        for dst, src in zip(self.inputs, self.slots[d]):
            dst.copy_(src, non_blocking=True)
        self._slot_free[d].record(stream)

    def batch(self) -> tuple:
        """The step's batch: views of the inputs, the wire dtype's leaves
        upcast to the default dtype."""
        out = [None] * self.n_positions
        for leaf in self.leaves:
            t = self._leaf_view(self.inputs, leaf)
            if leaf.wire:
                t = t.to(self.dtype)
            for pos in leaf.positions:
                out[pos] = t
        return tuple(out)


class GatherPool:
    """``n`` threads running ``work(s)`` for sequence numbers ``s``, which
    go to thread ``s % n`` (strict round robin): :meth:`wait` takes their
    completions in order with no reorder buffer. An exception in ``work``
    ends its thread and is raised by :meth:`wait` at its sequence number;
    :meth:`close` ends every thread (the JAX pipeline delivered a failure
    to one queue and left the other threads blocked,
    ``colvarsfinder_tpu/core/task.py:774``)."""

    def __init__(self, n: int, work):
        self._work = work
        self._todo = [queue.SimpleQueue() for _ in range(n)]
        self._done = [queue.SimpleQueue() for _ in range(n)]
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._run, args=(i,), daemon=True,
                             name=f"cvf-stream-gather-{i}")
            for i in range(n)
        ]
        for t in self._threads:
            t.start()

    def _run(self, i: int) -> None:
        todo, done = self._todo[i], self._done[i]
        while True:
            s = todo.get()
            if s is None:
                return
            if self._stop.is_set():
                continue
            try:
                self._work(s)
            except BaseException as err:  # raised again by wait()
                done.put(err)
                return
            done.put(s)

    def submit(self, s: int) -> None:
        self._todo[s % len(self._todo)].put(s)

    def wait(self, s: int) -> None:
        """Block until ``work(s)`` has completed; raise what it raised."""
        item = self._done[s % len(self._done)].get()
        if isinstance(item, BaseException):
            raise item

    def close(self) -> None:
        """Skip the work not yet started and end every thread."""
        self._stop.set()
        for q in self._todo:
            q.put(None)
        for t in self._threads:
            t.join()

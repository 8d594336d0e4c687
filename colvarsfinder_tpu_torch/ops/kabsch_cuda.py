r"""CUDA Kabsch kernels (counterpart of ``colvarsfinder_tpu/ops/kabsch_pallas.py``).

* :func:`kabsch_rotations_cuda` — kernel K1 (``csrc/kabsch.cu``,
  ``cvf_kabsch_qcp``), replacing ``_kabsch_kernel``
  (``kabsch_pallas.py:48``): covariances C [B,3,3] -> rotations R [B,3,3].
  Plain version: :func:`.alignment.kabsch_rotations_quat`. Backward: autograd
  of the SVD Kabsch, as the JAX ``custom_vjp`` does (``:122-126``).
* :func:`align_frames_fused_cuda` / :class:`FusedAlignmentLayer` — kernel K2
  (``cvf_fused_align``), replacing ``_make_fused_align_kernel``
  (``:140-206``): the whole alignment of x [B,N,3] in one pass. Plain
  version: ``align_frames(..., method='quaternion')``, whose autograd is
  also the backward (``:276-286``).

On the H100 both kernels move a few hundred bytes and do a few hundred
flops per frame; at the main path's B = 20,000 they are bound by launch
latency and one dependent QCP chain per frame, not by the card's memory
rate or FMA rate (see ``csrc/kabsch.cu``). Both stage a tile of
consecutive frames through shared memory with coalesced copies, one thread
per frame solves, and the whole block stores the tile in order; K2's frames
too large for a tile (thousands of atoms) take its direct variant, one
thread per frame from device memory. :func:`align_launch_shape` picks K2's
variant.

* :func:`kabsch_rotations_exact` — kernel K6 (``csrc/kabsch_exact.cu``,
  ``cvf_kabsch_exact``), port-only: the rotation solve of
  ``AlignmentLayer(method='quaternion')`` on a float32 CUDA tensor, C
  [B,3,3] -> R [B,3,3] in one launch, equal to every bit to
  :func:`.alignment.kabsch_rotations_quat` run by PyTorch's kernels (built
  without FMA contraction, the chain's operations in its order). Backward:
  that plain chain's vjp, recorded where asked, so the gradients through
  the layer, and second derivatives by what comes after it, are the plain
  chain's to the bit; a second derivative by the frames themselves sums
  its two branches in another order (equal within rounding). It composes
  with the ``torch.func`` transforms (a vmap rule folds the mapped
  dimension into one launch). On the TPU XLA fuses the chain, so there is
  no kernel to replace.

As the JAX kernels do, K1 and K2 take inputs of any floating dtype,
compute in float32 and return the input's dtype; their backward
differentiates the plain formulation at the input in the input's own dtype.
K6 takes float32 alone.

Each launch is a ``torch.library`` operator, ``cvf_torch::kabsch_qcp``,
``cvf_torch::fused_align`` and ``cvf_torch::kabsch_qcp_exact``, so that
``torch.export`` carries the kernels into the CV programs (:mod:`..export`):
the operator dispatches by the tensor's device, to the kernel on a CUDA
tensor (which launches or raises) and to the plain version on a CPU
tensor, and has a fake implementation that gives the output's shape and
dtype to a trace. Importing this module registers all three.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..logging_utils import count
from . import _cuda, alignment
from .alignment import (
    align_frames,
    kabsch_rotations_quat,
    kabsch_rotations_svd,
    newton_diff_mode,
)
from .fused_eigen import SMEM_LIMIT

__all__ = [
    "ALIGN_TILE",
    "KABSCH_TILE",
    "KABSCH_TILES",
    "AlignShape",
    "FusedAlignmentLayer",
    "align_frames_fused_cuda",
    "align_launch_shape",
    "align_resident_blocks",
    "align_smem_bytes",
    "kabsch_exact_launch",
    "kabsch_qcp_launch",
    "kabsch_resident_blocks",
    "fused_align_launch",
    "kabsch_rotations_cuda",
    "kabsch_rotations_exact",
]

#: frames (one thread each) per block of K1, and the tiles it was swept
#: over: at the main path's shapes all four took the same time on an H100
#: to within 0.09 us, and no tile was fastest in every run
#: (scripts/k4_ablation.py k1); 32 spreads the 20,000 frames over every SM
#: (625 blocks), as K2's tile does
KABSCH_TILE = 32
KABSCH_TILES = (32, 64, 128, 256)
#: frames per block of K2's staged variant: at the main path's shapes 32
#: frames (625 blocks, at most 5 on an SM) took 7.12 us on an H100 against
#: 7.48 us for 64 (313 blocks, 3 on the busiest SM), 7.71 us for 16 and
#: 9.07 us for 128 (scripts/k4_ablation.py k2)
ALIGN_TILE = 32
#: threads of a staged block (csrc/kabsch.cu kStagedThreads) and of a
#: direct block (kThreads)
STAGED_THREADS = 128
DIRECT_THREADS = 256
# floats per frame of the rotation slots (R and centroid; kRStride)
_R_STRIDE = 13
#: Newton steps of the plain chain before its extra differentiable ones
#: (``kabsch_rotations_quat``'s ``iters``; ``csrc/qcp.cuh`` kNewtonIters)
NEWTON_ITERS = 16


class AlignShape(NamedTuple):
    """Launch shape of K2: ``tile`` frames per block of ``threads`` with
    ``smem_bytes`` of dynamic shared memory (the staged variant), or
    ``tile`` 0: the direct variant, one thread per frame."""

    tile: int
    threads: int
    smem_bytes: int

    def blocks(self, B: int) -> int:
        per = self.tile or self.threads
        return -(-B // per)


def align_smem_bytes(N: int, m: int, tile: int) -> int:
    """Shared memory of a staged K2 block: the tile at an odd stride per
    frame, rotation slots, the reference and the indices."""
    return 4 * (tile * ((3 * N) | 1) + tile * _R_STRIDE + 4 * m)


def align_launch_shape(N: int, m: int) -> AlignShape:
    """K2's launch shape for frames of N atoms with m align atoms: the
    staged variant at :data:`ALIGN_TILE` frames where its block fits in
    shared memory (up to ~580 atoms), else the direct variant."""
    smem = align_smem_bytes(N, m, ALIGN_TILE)
    if smem <= SMEM_LIMIT:
        return AlignShape(ALIGN_TILE, STAGED_THREADS, smem)
    return AlignShape(0, DIRECT_THREADS, 0)


def align_resident_blocks(shape: AlignShape) -> int:
    """Staged K2 blocks resident on one SM of the current card at
    ``shape`` (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    import ctypes

    out = ctypes.c_int(0)
    err = _cuda.library("kabsch").cvf_fused_align_occupancy(
        shape.smem_bytes, ctypes.byref(out))
    _cuda.check(err, "cvf_fused_align_occupancy")
    return out.value


def _require(t: torch.Tensor, name: str, shape_ok: bool, dtype=torch.float32):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not shape_ok:
        raise ValueError(f"{name} has unsupported shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def kabsch_resident_blocks(tile: int = KABSCH_TILE) -> int:
    """K1 blocks of ``tile`` frames resident on one SM of the current card
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    import ctypes

    out = ctypes.c_int(0)
    err = _cuda.library("kabsch").cvf_kabsch_qcp_occupancy(
        tile, ctypes.byref(out))
    _cuda.check(err, "cvf_kabsch_qcp_occupancy")
    return out.value


def kabsch_qcp_launch(C: torch.Tensor, tile: int = KABSCH_TILE) -> torch.Tensor:
    """Launch K1 on C [B, 3, 3] float32 (CUDA, contiguous), one block of
    ``tile`` threads per ``tile`` frames."""
    _require(C, "C", C.dim() == 3 and C.shape[1:] == (3, 3))
    R = torch.empty_like(C)
    lib = _cuda.library("kabsch")
    err = lib.cvf_kabsch_qcp(
        C.data_ptr(), R.data_ptr(), C.shape[0], tile, _cuda.stream_handle()
    )
    _cuda.check(err, "cvf_kabsch_qcp")
    count(_cuda.COUNTER + "kabsch_qcp")
    return R


def kabsch_exact_launch(C: torch.Tensor, newton_steps: int) -> torch.Tensor:
    """Launch K6 on C [B, 3, 3] float32 (CUDA, contiguous): ``newton_steps``
    Newton steps a frame, one thread a frame, blocks of 32 frames. No
    frames, no launch."""
    _require(C, "C", C.dim() == 3 and C.shape[1:] == (3, 3))
    R = torch.empty_like(C)
    if C.shape[0] == 0:
        return R
    err = _cuda.library("kabsch_exact").cvf_kabsch_exact(
        C.data_ptr(), R.data_ptr(), C.shape[0], newton_steps,
        _cuda.stream_handle())
    _cuda.check(err, "cvf_kabsch_exact")
    count(_cuda.COUNTER + "kabsch_exact")
    return R


def fused_align_launch(x: torch.Tensor, ref: torch.Tensor,
                       idx: torch.Tensor,
                       shape: AlignShape | None = None) -> torch.Tensor:
    """Launch K2 on x [B, N, 3], reference [m, 3] and int32 indices [m]
    (all CUDA, contiguous, on one device), at ``shape`` (default:
    :func:`align_launch_shape`)."""
    _require(x, "x", x.dim() == 3 and x.shape[2] == 3)
    m = ref.shape[0]
    _require(ref, "ref", ref.dim() == 2 and ref.shape[1] == 3 and m > 0)
    _require(idx, "idx", idx.shape == (m,), dtype=torch.int32)
    if not (x.device == ref.device == idx.device):
        raise ValueError("x, ref and idx must be on one device")
    if shape is None:
        shape = align_launch_shape(x.shape[1], m)
    out = torch.empty_like(x)
    lib = _cuda.library("kabsch")
    err = lib.cvf_fused_align(
        x.data_ptr(), ref.data_ptr(), idx.data_ptr(), out.data_ptr(),
        x.shape[0], x.shape[1], m, shape.tile, shape.smem_bytes,
        _cuda.stream_handle(),
    )
    _cuda.check(err, "cvf_fused_align")
    count(_cuda.COUNTER + "fused_align")
    return out


@torch.library.custom_op("cvf_torch::kabsch_qcp", mutates_args=(),
                         device_types="cuda")
def _kabsch_qcp_op(C: torch.Tensor) -> torch.Tensor:
    """K1 on float32 C [B, 3, 3]: the kernel on the card."""
    return kabsch_qcp_launch(C)


@_kabsch_qcp_op.register_kernel("cpu")
def _(C):
    return kabsch_rotations_quat(C)


@_kabsch_qcp_op.register_fake
def _(C):
    return C.new_empty(C.shape)


@torch.library.custom_op("cvf_torch::kabsch_qcp_exact", mutates_args=(),
                         device_types="cuda")
def _kabsch_exact_op(C: torch.Tensor, diff_steps: int) -> torch.Tensor:
    """K6 on float32 C [B, 3, 3], the Newton steps of
    :func:`.alignment.newton_diff_mode` ``(diff_steps)``: the kernel on the
    card."""
    return kabsch_exact_launch(C, NEWTON_ITERS + max(diff_steps, 0))


@_kabsch_exact_op.register_kernel("cpu")
def _(C, diff_steps):
    with newton_diff_mode(diff_steps):
        return kabsch_rotations_quat(C)


@_kabsch_exact_op.register_fake
def _(C, diff_steps):
    return C.new_empty(C.shape)


@_kabsch_exact_op.register_vmap
def _(info, in_dims, C, diff_steps):
    # the frames are independent: the mapped dimension joins the batch
    if in_dims[0] is None:
        return _kabsch_exact_op(C, diff_steps), None
    C = C.movedim(in_dims[0], 0)
    R = _kabsch_exact_op(C.reshape(-1, 3, 3).contiguous(), diff_steps)
    return R.reshape(C.shape), 0


@torch.library.custom_op("cvf_torch::fused_align", mutates_args=(),
                         device_types="cuda")
def _fused_align_op(x: torch.Tensor, ref: torch.Tensor,
                    idx: torch.Tensor) -> torch.Tensor:
    """K2 on float32 x [B, N, 3], ref [m, 3] and int32 idx [m]: the kernel
    on the card."""
    return fused_align_launch(x, ref, idx)


@_fused_align_op.register_kernel("cpu")
def _(x, ref, idx):
    return align_frames(x, ref, idx.long(), method="quaternion")


@_fused_align_op.register_fake
def _(x, ref, idx):
    return x.new_empty(x.shape)


def _plain_vjp(plain, x, g):
    """The vjp of the plain formulation ``plain`` at the saved input ``x``
    along ``g``, as the JAX ``custom_vjp`` backward is ``jax.vjp`` of it.
    Inside an autograd ``backward`` grad mode is on exactly when the caller
    asked for ``create_graph=True``; then the vjp is recorded against ``x``
    and ``g``, so that it can be differentiated once more (the generator
    loss differentiates input gradients by the parameters). Otherwise it
    is computed on a detached copy and records nothing."""
    if torch.is_grad_enabled() and x.requires_grad:
        return torch.autograd.grad(plain(x), x, g, create_graph=True)[0]
    with torch.enable_grad():
        xd = x.detach().requires_grad_()
        return torch.autograd.grad(plain(xd), xd, g)[0]


class _KabschQCP(torch.autograd.Function):
    """K1 on C in float32, R in C's dtype; the backward differentiates the
    SVD Kabsch at C in C's own dtype (``kabsch_pallas.py:118-126``), twice
    where asked (:func:`_plain_vjp`)."""

    @staticmethod
    def forward(ctx, C):
        ctx.save_for_backward(C)
        R = torch.ops.cvf_torch.kabsch_qcp(C.to(torch.float32).contiguous())
        return R.to(C.dtype)

    @staticmethod
    def backward(ctx, g):
        (C,) = ctx.saved_tensors
        return _plain_vjp(kabsch_rotations_svd, C, g)


def _rotations_dot(C, g):
    """<kabsch_rotations_quat(C), g>: its gradient by C is the chain's vjp
    along g, and ``torch.func.grad`` takes it with g an argument, so that a
    g carried by an outer transform stays at its own level."""
    return (kabsch_rotations_quat(C) * g).sum()


class _KabschExact(torch.autograd.Function):
    """K6 on float32 C; the backward and the forward-mode derivative are
    the plain chain's at C under the Newton mode of the forward, by
    ``torch.func.grad`` and ``torch.func.jvp``, recorded where grad mode is
    on, so they compose with the ``torch.func`` transforms (``vmap`` folds
    the mapped dimension into the operator's batch) and with an ordinary
    double backward alike."""

    generate_vmap_rule = True

    @staticmethod
    def forward(C, diff_steps):
        return torch.ops.cvf_torch.kabsch_qcp_exact(C.contiguous(),
                                                    diff_steps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        C, ctx.diff_steps = inputs
        ctx.save_for_backward(C)
        ctx.save_for_forward(C)

    @staticmethod
    def backward(ctx, g):
        (C,) = ctx.saved_tensors
        with newton_diff_mode(ctx.diff_steps):
            return torch.func.grad(_rotations_dot)(C, g), None

    @staticmethod
    def jvp(ctx, dC, _):
        (C,) = ctx.saved_tensors
        with newton_diff_mode(ctx.diff_steps):
            return torch.func.jvp(kabsch_rotations_quat, (C,), (dC,))[1]


def kabsch_rotations_exact(C: torch.Tensor) -> torch.Tensor:
    """Optimal rotations from float32 covariances C [B, 3, 3] through
    kernel K6 on the card (its CPU kernel is the plain chain itself): equal
    to every bit to :func:`.alignment.kabsch_rotations_quat` under the
    current :func:`.alignment.newton_diff_mode`, forward and backward.
    Another dtype raises."""
    if C.dtype != torch.float32:
        raise TypeError(f"K6 takes float32 covariances, got {C.dtype}")
    return _KabschExact.apply(C, alignment.DEFAULT_NEWTON_DIFF_STEPS)


def kabsch_rotations_cuda(C: torch.Tensor) -> torch.Tensor:
    """Optimal rotations from covariances C [B, 3, 3] of any floating dtype
    through kernel K1 (its plain version on a CPU tensor), computed in
    float32 and returned in C's dtype; interchangeable with
    :func:`.alignment.kabsch_rotations_svd`."""
    return _KabschQCP.apply(C)


class _FusedAlign(torch.autograd.Function):
    """K2 on x and the reference in float32, the result in x's dtype; the
    backward differentiates ``align_frames`` at x with the reference in x's
    dtype (``kabsch_pallas.py:272-286``), twice where asked
    (:func:`_plain_vjp`)."""

    @staticmethod
    def forward(ctx, x, ref, idx32, idx64):
        ctx.save_for_backward(x, ref, idx64)
        out = torch.ops.cvf_torch.fused_align(
            x.to(torch.float32).contiguous(),
            ref.to(torch.float32).contiguous(), idx32)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, ref, idx64 = ctx.saved_tensors
        ref = ref.to(x.dtype)
        gx = _plain_vjp(
            lambda xd: align_frames(xd, ref, idx64, method="quaternion"), x, g)
        return gx, None, None, None


def align_frames_fused_cuda(x: torch.Tensor, ref_centered: torch.Tensor,
                            align_idx) -> torch.Tensor:
    """Fused rigid alignment of x [B, N, 3] of any floating dtype: equal to
    ``align_frames(x, ref_centered, align_idx, method='quaternion')`` in
    float32, run as one kernel on a CUDA tensor, returned in x's dtype;
    differentiable w.r.t. ``x``."""
    idx = np.asarray(torch.as_tensor(align_idx).cpu(), dtype=np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= x.shape[1]):
        raise IndexError(f"align indices out of range for {x.shape[1]} atoms")
    idx64 = torch.as_tensor(idx, device=x.device)
    ref = torch.as_tensor(ref_centered, device=x.device,
                          dtype=torch.float32)
    return _FusedAlign.apply(x, ref, idx64.to(torch.int32), idx64)


class FusedAlignmentLayer(nn.Module):
    """Drop-in alternative to :class:`.alignment.AlignmentLayer` (no align
    weights) that runs the whole alignment as kernel K2 on the card
    (``colvarsfinder_tpu/ops/kabsch_pallas.py:292``). Frames of any floating
    dtype are aligned in float32 and returned in their dtype; a layer moved
    to float64 (``.double()``) aligns with its reference cast back to
    float32, as the JAX layer does.

    Args:
        align_positions: reference coordinates of the align atoms [m, 3]
            (centered internally), or an AtomGroup.
        align_indices: indices of the align atoms within the input atoms.
    """

    def __init__(self, align_positions, align_indices=None):
        super().__init__()
        pos = np.asarray(
            getattr(align_positions, "positions", align_positions),
            dtype=np.float64,
        )
        pos = pos - pos.mean(axis=0, keepdims=True)
        if align_indices is None:
            raise ValueError("align_indices is required")
        idx = np.asarray(align_indices, dtype=np.int64).reshape(-1)
        if idx.shape[0] != pos.shape[0] or idx.size == 0 or idx.min() < 0:
            raise ValueError(
                f"{pos.shape[0]} reference atoms need as many non-negative "
                f"align indices, got {idx.tolist()}"
            )
        self._max_idx = int(idx.max())
        self.register_buffer(
            "ref_centered", torch.as_tensor(pos.astype(np.float32))
        )
        self.register_buffer("align_idx", torch.as_tensor(idx))
        self.register_buffer(
            "_align_idx32", torch.as_tensor(idx.astype(np.int32)),
            persistent=False,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        squeeze = x.dim() == 2
        if squeeze:
            x = x[None]
        if self._max_idx >= x.shape[1]:
            raise IndexError(
                f"align index {self._max_idx} out of range for "
                f"{x.shape[1]} atoms"
            )
        out = _FusedAlign.apply(x, self.ref_centered, self._align_idx32,
                                self.align_idx)
        return out[0] if squeeze else out

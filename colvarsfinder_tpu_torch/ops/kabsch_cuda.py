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

As the JAX kernels do, both take inputs of any floating dtype, compute in
float32 and return the input's dtype; their backward differentiates the
plain formulation at the input in the input's own dtype. Each wrapper
dispatches by the tensor's device: on the CPU it runs the plain version; on
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from . import _cuda
from .alignment import align_frames, kabsch_rotations_quat, kabsch_rotations_svd
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
    "kabsch_qcp_launch",
    "kabsch_resident_blocks",
    "fused_align_launch",
    "kabsch_rotations_cuda",
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
    _cuda.LAUNCHES["kabsch_qcp"] += 1
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
    _cuda.LAUNCHES["fused_align"] += 1
    return out


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
        C32 = C.to(torch.float32)
        if C.device.type == "cpu":
            R = kabsch_rotations_quat(C32)
        else:
            R = kabsch_qcp_launch(C32.contiguous())
        return R.to(C.dtype)

    @staticmethod
    def backward(ctx, g):
        (C,) = ctx.saved_tensors
        return _plain_vjp(kabsch_rotations_svd, C, g)


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
        x32, ref32 = x.to(torch.float32), ref.to(torch.float32)
        if x.device.type == "cpu":
            out = align_frames(x32, ref32, idx64, method="quaternion")
        else:
            out = fused_align_launch(x32.contiguous(), ref32.contiguous(),
                                     idx32)
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

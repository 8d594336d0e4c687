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
flops per frame, one thread per frame with everything in registers; at the
main path's B = 20,000 they are bound by launch latency, not by the
card's memory rate or FMA rate (see ``csrc/kabsch.cu``).

Each wrapper dispatches by the tensor's device: on the CPU it runs the
plain version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import _cuda
from .alignment import align_frames, kabsch_rotations_quat, kabsch_rotations_svd

__all__ = [
    "FusedAlignmentLayer",
    "align_frames_fused_cuda",
    "kabsch_qcp_launch",
    "fused_align_launch",
    "kabsch_rotations_cuda",
]


def _require(t: torch.Tensor, name: str, shape_ok: bool, dtype=torch.float32):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not shape_ok:
        raise ValueError(f"{name} has unsupported shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def kabsch_qcp_launch(C: torch.Tensor) -> torch.Tensor:
    """Launch K1 on C [B, 3, 3] float32 (CUDA, contiguous)."""
    _require(C, "C", C.dim() == 3 and C.shape[1:] == (3, 3))
    R = torch.empty_like(C)
    lib = _cuda.library("kabsch")
    err = lib.cvf_kabsch_qcp(
        C.data_ptr(), R.data_ptr(), C.shape[0], _cuda.stream_handle()
    )
    _cuda.check(err, "cvf_kabsch_qcp")
    _cuda.LAUNCHES["kabsch_qcp"] += 1
    return R


def fused_align_launch(x: torch.Tensor, ref: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
    """Launch K2 on x [B, N, 3], reference [m, 3] and int32 indices [m]
    (all CUDA, contiguous, on one device)."""
    _require(x, "x", x.dim() == 3 and x.shape[2] == 3)
    m = ref.shape[0]
    _require(ref, "ref", ref.dim() == 2 and ref.shape[1] == 3 and m > 0)
    _require(idx, "idx", idx.shape == (m,), dtype=torch.int32)
    if not (x.device == ref.device == idx.device):
        raise ValueError("x, ref and idx must be on one device")
    out = torch.empty_like(x)
    lib = _cuda.library("kabsch")
    err = lib.cvf_fused_align(
        x.data_ptr(), ref.data_ptr(), idx.data_ptr(), out.data_ptr(),
        x.shape[0], x.shape[1], m, _cuda.stream_handle(),
    )
    _cuda.check(err, "cvf_fused_align")
    _cuda.LAUNCHES["fused_align"] += 1
    return out


class _KabschQCP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, C):
        ctx.save_for_backward(C)
        return kabsch_qcp_launch(C)

    @staticmethod
    def backward(ctx, g):
        (C,) = ctx.saved_tensors
        with torch.enable_grad():
            Cd = C.detach().requires_grad_()
            (gC,) = torch.autograd.grad(kabsch_rotations_svd(Cd), Cd, g)
        return gC


def kabsch_rotations_cuda(C: torch.Tensor) -> torch.Tensor:
    """Optimal rotations from covariances C [B, 3, 3] through kernel K1;
    interchangeable with :func:`.alignment.kabsch_rotations_svd`."""
    if C.device.type == "cpu":
        return kabsch_rotations_quat(C)
    return _KabschQCP.apply(C.contiguous())


class _FusedAlign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ref, idx32, idx64):
        ctx.save_for_backward(x, ref, idx64)
        return fused_align_launch(x, ref, idx32)

    @staticmethod
    def backward(ctx, g):
        x, ref, idx64 = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_()
            out = align_frames(xd, ref, idx64, method="quaternion")
            (gx,) = torch.autograd.grad(out, xd, g)
        return gx, None, None, None


def _fused_align(x, ref, idx64, idx32):
    """K2 on a CUDA tensor, its plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return align_frames(x, ref, idx64, method="quaternion")
    return _FusedAlign.apply(x.contiguous(), ref, idx32, idx64)


def align_frames_fused_cuda(x: torch.Tensor, ref_centered: torch.Tensor,
                            align_idx) -> torch.Tensor:
    """Fused rigid alignment of x [B, N, 3]: equal to
    ``align_frames(x, ref_centered, align_idx, method='quaternion')`` and run
    as one kernel on a CUDA tensor; differentiable w.r.t. ``x``."""
    idx = np.asarray(torch.as_tensor(align_idx).cpu(), dtype=np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= x.shape[1]):
        raise IndexError(f"align indices out of range for {x.shape[1]} atoms")
    idx64 = torch.as_tensor(idx, device=x.device)
    ref = torch.as_tensor(ref_centered, device=x.device,
                          dtype=torch.float32).contiguous()
    return _fused_align(x, ref, idx64, idx64.to(torch.int32))


class FusedAlignmentLayer(nn.Module):
    """Drop-in alternative to :class:`.alignment.AlignmentLayer` (no align
    weights) that runs the whole alignment as kernel K2 on the card
    (``colvarsfinder_tpu/ops/kabsch_pallas.py:292``).

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
        out = _fused_align(x, self.ref_centered, self.align_idx,
                           self._align_idx32)
        return out[0] if squeeze else out

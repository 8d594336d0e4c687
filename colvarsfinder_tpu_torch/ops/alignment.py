r"""Batched rigid-body alignment (Kabsch), port of
``colvarsfinder_tpu/ops/alignment.py``.

Every frame is rotated onto a reference structure using a subset of
"align" atoms. Three interchangeable rotation solvers sit behind
:func:`align_frames`, all differentiable:

* ``method='quaternion'`` (default): the QCP scheme in plain PyTorch —
  Newton on the quartic characteristic polynomial of Horn's 4x4 key matrix
  plus an adjugate-row eigenvector;
* ``method='svd'``: batched 3x3 SVD, the numerical oracle;
* ``method='cuda'`` (``'pallas'``, the JAX package's name, is accepted for
  it): the same QCP math as a CUDA kernel (:mod:`.kabsch_cuda`).

The row-vector convention ``y = x @ R`` is used throughout.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..config import default_dtype

__all__ = [
    "AlignmentLayer",
    "align_frames",
    "kabsch_rotations_quat",
    "kabsch_rotations_svd",
    "quaternion_from_covariance",
    "quaternion_to_rotation_entries",
]


def _cross_covariances(frames_c: torch.Tensor, ref_c: torch.Tensor):
    """C_b = A_b^T B for centered align atoms A_b [B, m, 3] and centered
    reference B [m, 3] -> [B, 3, 3]."""
    return torch.einsum("bmi,mj->bij", frames_c, ref_c)


def kabsch_rotations_svd(C: torch.Tensor) -> torch.Tensor:
    """Optimal rotations from covariances C [B, 3, 3]: R = U D V^T with
    D = diag(1, 1, det(U V^T))."""
    U, _, Vh = torch.linalg.svd(C)
    det = torch.linalg.det(U @ Vh)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    return torch.einsum("bij,bj,bjk->bik", U, D, Vh)


def _det3(a, b, c, d, e, f, g, h, i):
    """Determinant of [[a,b,c],[d,e,f],[g,h,i]], elementwise."""
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def quaternion_from_covariance(c9, newton_iters: int = 16,
                               diff_steps: int = 0):
    """Optimal-rotation quaternion from the 9 entries of a covariance
    pre-normalized by its Frobenius norm
    (``colvarsfinder_tpu/ops/alignment.py:102-238``).

    ``diff_steps == 0``: the Newton loop is differentiated step by step.
    ``diff_steps > 0``: convergence runs on detached coefficients and this
    many differentiable steps follow (implicit differentiation; the forward
    value is unchanged).

    Returns the unit quaternion ``(w, x, y, z)`` (sign arbitrary).
    """
    sxx, sxy, sxz, syx, syy, syz, szx, szy, szz = c9

    k00 = sxx + syy + szz
    k01 = syz - szy
    k02 = szx - sxz
    k03 = sxy - syx
    k11 = sxx - syy - szz
    k12 = sxy + syx
    k13 = szx + sxz
    k22 = syy - sxx - szz
    k23 = syz + szy
    k33 = szz - sxx - syy

    fro2 = (
        sxx * sxx + sxy * sxy + sxz * sxz
        + syx * syx + syy * syy + syz * syz
        + szx * szx + szy * szy + szz * szz
    )
    c2 = -2.0 * fro2
    c1 = -8.0 * _det3(sxx, sxy, sxz, syx, syy, syz, szx, szy, szz)
    c0 = (
        k00 * _det3(k11, k12, k13, k12, k22, k23, k13, k23, k33)
        - k01 * _det3(k01, k12, k13, k02, k22, k23, k03, k23, k33)
        + k02 * _det3(k01, k11, k13, k02, k12, k23, k03, k13, k33)
        - k03 * _det3(k01, k11, k12, k02, k12, k22, k03, k13, k23)
    )

    def newton_step(lam, c2, c1, c0):
        p = ((lam * lam + c2) * lam + c1) * lam + c0
        dp = (4.0 * lam * lam + 2.0 * c2) * lam + c1
        return lam - p / torch.where(dp.abs() > 1e-12, dp,
                                     torch.full_like(dp, 1e-12))

    if diff_steps <= 0:
        lam = 2.0 * torch.sqrt(fro2)
        for _ in range(newton_iters):
            lam = newton_step(lam, c2, c1, c0)
    else:
        c2s, c1s, c0s = c2.detach(), c1.detach(), c0.detach()
        lam = 2.0 * torch.sqrt(fro2.detach())
        for _ in range(newton_iters):
            lam = newton_step(lam, c2s, c1s, c0s)
        for _ in range(diff_steps):
            lam = newton_step(lam, c2, c1, c0)

    m00 = k00 - lam
    m11 = k11 - lam
    m22 = k22 - lam
    m33 = k33 - lam

    rows = [
        (
            _det3(m11, k12, k13, k12, m22, k23, k13, k23, m33),
            -_det3(k01, k12, k13, k02, m22, k23, k03, k23, m33),
            _det3(k01, m11, k13, k02, k12, k23, k03, k13, m33),
            -_det3(k01, m11, k12, k02, k12, m22, k03, k13, k23),
        ),
        (
            -_det3(k01, k02, k03, k12, m22, k23, k13, k23, m33),
            _det3(m00, k02, k03, k02, m22, k23, k03, k23, m33),
            -_det3(m00, k01, k03, k02, k12, k23, k03, k13, m33),
            _det3(m00, k01, k02, k02, k12, m22, k03, k13, k23),
        ),
        (
            _det3(k01, k02, k03, m11, k12, k13, k13, k23, m33),
            -_det3(m00, k02, k03, k01, k12, k13, k03, k23, m33),
            _det3(m00, k01, k03, k01, m11, k13, k03, k13, m33),
            -_det3(m00, k01, k02, k01, m11, k12, k03, k13, k23),
        ),
        (
            -_det3(k01, k02, k03, m11, k12, k13, k12, m22, k23),
            _det3(m00, k02, k03, k01, k12, k13, k02, m22, k23),
            -_det3(m00, k01, k03, k01, m11, k13, k02, k12, k23),
            _det3(m00, k01, k02, k01, m11, k12, k02, k12, m22),
        ),
    ]

    # largest-norm cofactor row; strictly greater norm wins
    norms = [sum(e * e for e in r) for r in rows]
    best = rows[0]
    best_n = norms[0]
    for r, n in zip(rows[1:], norms[1:]):
        take = n > best_n
        best = tuple(torch.where(take, ri, bi) for ri, bi in zip(r, best))
        best_n = torch.maximum(n, best_n)

    inv = torch.rsqrt(best_n + 1e-30)
    return tuple(e * inv for e in best)


def quaternion_to_rotation_entries(w, x, y, z):
    """Unit quaternion -> the 9 rotation entries (row-major), y = x @ R."""
    return (
        1 - 2 * (y * y + z * z), 2 * (x * y + w * z), 2 * (x * z - w * y),
        2 * (x * y - w * z), 1 - 2 * (x * x + z * z), 2 * (y * z + w * x),
        2 * (x * z + w * y), 2 * (y * z - w * x), 1 - 2 * (x * x + y * y),
    )


def kabsch_rotations_quat(C: torch.Tensor, iters: int = 16) -> torch.Tensor:
    """Optimal rotations via QCP — the plain version of the K1 kernel
    (:func:`.kabsch_cuda.kabsch_rotations_cuda`). A frame with
    ||C||_F <= 1e-12 (all align atoms coincident) gets the identity."""
    norm = torch.sqrt((C * C).sum(dim=(-2, -1), keepdim=True))
    ok = norm > 1e-12
    Cn = C / torch.where(ok, norm, torch.ones_like(norm))
    c9 = tuple(Cn[:, i, j] for i in range(3) for j in range(3))
    q = quaternion_from_covariance(c9, newton_iters=iters)
    R = torch.stack(quaternion_to_rotation_entries(*q), dim=-1)
    R = R.reshape(-1, 3, 3)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    return torch.where(ok, R, eye)


def align_frames(
    x: torch.Tensor,
    ref_centered: torch.Tensor,
    align_idx: torch.Tensor,
    align_weights: Optional[torch.Tensor] = None,
    method: str = "quaternion",
) -> torch.Tensor:
    """Rigidly align each frame onto the reference.

    Args:
        x: frames [B, N, 3]
        ref_centered: reference align-atom coordinates [m, 3], centered
        align_idx: indices of the m align atoms within the N atoms
        align_weights: optional per-align-atom weights (e.g. masses)
        method: 'quaternion' (default), 'svd', or 'cuda' ('pallas')

    Returns:
        [B, N, 3]: x centered on its align-atom centroid and rotated by the
        optimal Kabsch rotation.
    """
    sel = x.index_select(1, align_idx)  # [B, m, 3]
    if align_weights is not None:
        # weighted Kabsch: both structures centered on the weighted centroid
        w = align_weights / align_weights.sum()
        com = torch.einsum("m,bmi->bi", w, sel)
        ref_centered = ref_centered - torch.einsum("m,mi->i", w, ref_centered)
    else:
        com = sel.mean(dim=1)
    x_c = x - com[:, None, :]
    sel_c = sel - com[:, None, :]
    if align_weights is not None:
        sel_c = sel_c * align_weights[None, :, None]
    C = _cross_covariances(sel_c, ref_centered)
    if method == "svd":
        R = kabsch_rotations_svd(C)
    elif method == "quaternion":
        R = kabsch_rotations_quat(C)
    elif method in ("cuda", "pallas"):
        from .kabsch_cuda import kabsch_rotations_cuda

        R = kabsch_rotations_cuda(C)
    else:
        raise ValueError(f"unknown alignment method '{method}'")
    return torch.einsum("bni,bij->bnj", x_c, R)


class AlignmentLayer(nn.Module):
    """Rigid alignment preprocessing layer (molann ``AlignmentLayer``
    equivalent; ``colvarsfinder_tpu/ops/alignment.py:317``).

    Args:
        align_positions: reference coordinates of the align atoms [m, 3]
            (centered internally), or an MDAnalysis AtomGroup.
        align_indices: indices of the align atoms within the input atoms.
        input_ag: optional AtomGroup of the input atoms (derives
            ``align_indices`` from an AtomGroup ``align_positions``).
        method: 'quaternion' (default), 'svd', or 'cuda' ('pallas').
        align_weights: optional per-align-atom weights, or 'masses' with an
            AtomGroup.
    """

    def __init__(
        self,
        align_positions=None,
        align_indices: Optional[Sequence[int]] = None,
        input_ag=None,
        method: str = "quaternion",
        align_weights=None,
    ):
        super().__init__()
        if method not in ("quaternion", "svd", "cuda", "pallas"):
            raise ValueError(f"unknown alignment method '{method}'")
        ag = align_positions
        np_dtype = np.float64 if default_dtype() == torch.float64 else np.float32
        if hasattr(ag, "positions"):  # MDAnalysis AtomGroup
            pos = np.asarray(ag.positions, dtype=np_dtype)
            if align_indices is None:
                if input_ag is None:
                    raise ValueError(
                        "pass align_indices or input_ag to locate align "
                        "atoms within the input atom list"
                    )
                input_ix = list(np.asarray(input_ag.ix))
                align_indices = [input_ix.index(i) for i in np.asarray(ag.ix)]
        else:
            pos = np.asarray(align_positions, dtype=np_dtype)
            if align_indices is None:
                raise ValueError("align_indices is required")
        pos = pos - pos.mean(axis=0, keepdims=True)
        self.register_buffer("ref_centered", torch.as_tensor(pos))
        self.register_buffer(
            "align_idx",
            torch.as_tensor(np.asarray(align_indices, dtype=np.int64)),
        )
        if isinstance(align_weights, str):
            if align_weights != "masses":
                raise ValueError(
                    f"unknown align_weights spec '{align_weights}' "
                    "(supported: 'masses' with an AtomGroup)"
                )
            if not hasattr(ag, "masses"):
                raise ValueError(
                    "align_weights='masses' requires align_positions to be "
                    "an AtomGroup with masses"
                )
            align_weights = ag.masses
        if align_weights is not None:
            aw = torch.as_tensor(np.asarray(align_weights, dtype=np_dtype))
            if aw.shape != (pos.shape[0],):
                raise ValueError(
                    "align_weights must have one entry per align atom "
                    f"({pos.shape[0]}), got {tuple(aw.shape)}"
                )
            self.register_buffer("align_weights", aw)
        else:
            self.align_weights = None
        self.method = method

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        squeeze = x.dim() == 2
        if squeeze:
            x = x[None]
        out = align_frames(
            x, self.ref_centered, self.align_idx,
            align_weights=self.align_weights, method=self.method,
        )
        return out[0] if squeeze else out

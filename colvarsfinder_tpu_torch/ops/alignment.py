r"""Batched rigid-body alignment (Kabsch), port of
``colvarsfinder_tpu/ops/alignment.py``.

Every frame is rotated onto a reference structure using a subset of
"align" atoms. Three interchangeable rotation solvers sit behind
:func:`align_frames`, all differentiable:

* ``method='quaternion'`` (default): the QCP scheme in plain PyTorch —
  Newton on the quartic characteristic polynomial of Horn's 4x4 key matrix
  plus an adjugate-row eigenvector;
* ``method='svd'``: batched 3x3 SVD (one-sided Jacobi), the numerical
  oracle;
* ``method='cuda'`` (``'pallas'``, the JAX package's name, is accepted for
  it): the same QCP math as a CUDA kernel (:mod:`.kabsch_cuda`).

:class:`AlignmentLayer` with ``method='quaternion'`` solves the rotations of
float32 CUDA frames in one launch of kernel K6 (:mod:`.kabsch_cuda`), which
equals the plain chain to every bit, its backward being the plain chain's
vjp; the CPU, other dtypes and :func:`align_frames` itself run the plain
chain.

The row-vector convention ``y = x @ R`` is used throughout.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch._subclasses.fake_tensor import is_fake

from ..config import default_dtype
from ..logging_utils import count

__all__ = [
    "AlignmentLayer",
    "align_frames",
    "kabsch_rotations_quat",
    "kabsch_rotations_svd",
    "newton_diff_mode",
    "quaternion_from_covariance",
    "quaternion_to_rotation_entries",
]


def _cross_covariances(frames_c: torch.Tensor, ref_c: torch.Tensor):
    """C_b = A_b^T B for centered align atoms A_b [B, m, 3] and centered
    reference B [m, 3] -> [B, 3, 3]."""
    return torch.einsum("bmi,mj->bij", frames_c, ref_c)


#: one-sided Jacobi sweeps of :func:`kabsch_rotations_svd`: random,
#: reflected, rank-2 and near-degenerate covariances converge in 4 sweeps
#: in float64 (the columns orthogonal to 2e-16); two more for margin
JACOBI_SWEEPS = 6


def _positive_or_one(v):
    """``v`` where it is positive, else 1: keeps ``sqrt`` and division off
    zero, so that a branch ``torch.where`` drops has finite gradients."""
    return torch.where(v > 0, v, torch.ones_like(v))


def kabsch_rotations_svd(C: torch.Tensor) -> torch.Tensor:
    """Optimal rotations from covariances C [B, 3, 3] by the SVD
    C = U S V^T: R = U D V^T with D = diag(1, 1, det(U V^T)), the JAX
    package's ``kabsch_rotations_svd``.

    The SVD is one-sided Jacobi in plain tensor ops, a fixed
    :data:`JACOBI_SWEEPS` sweeps of plane rotations that orthogonalise
    the columns of W = C V: nothing checks on the host, so a CUDA graph
    captures it (``torch.linalg.svd`` on CUDA does not), and the CPU runs
    the same arithmetic as the card. With u_i = w_i / |w_i| and a, b the
    two columns of largest norm, the sign rule makes
    R = u_a v_a^T + u_b v_b^T + (u_a x u_b)(v_a x v_b)^T. Twice
    differentiable; a zero C gives the identity, as the SVD's U = V = I
    does."""
    w = [C[..., :, j] for j in range(3)]
    eye = torch.eye(3, dtype=C.dtype, device=C.device).expand(C.shape)
    v = [eye[..., :, j] for j in range(3)]
    for _ in range(JACOBI_SWEEPS):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            a = (w[p] * w[p]).sum(-1)
            g = (w[p] * w[q]).sum(-1)
            d = (w[q] * w[q]).sum(-1) - a
            # tan of the smaller angle that makes w_p and w_q orthogonal
            r2 = d * d + 4.0 * g * g
            r = torch.where(r2 > 0, torch.sqrt(_positive_or_one(r2)),
                            torch.zeros_like(r2))
            sign = torch.where(d >= 0, torch.ones_like(d), -torch.ones_like(d))
            t = 2.0 * g * sign / _positive_or_one(d.abs() + r)
            c = torch.rsqrt(1.0 + t * t)[..., None]
            s = t[..., None] * c
            w[p], w[q] = c * w[p] - s * w[q], s * w[p] + c * w[q]
            v[p], v[q] = c * v[p] - s * v[q], s * v[p] + c * v[q]
    n = [(wi * wi).sum(-1, keepdim=True) for wi in w]
    # a zero column takes v_i, so that a zero C gives V V^T = I
    u = [torch.where(ni > 0, wi * torch.rsqrt(_positive_or_one(ni)), vi)
         for wi, ni, vi in zip(w, n, v)]
    drop0 = (n[0] <= n[1]) & (n[0] <= n[2])
    drop01 = drop0 | (n[1] <= n[2])

    def largest_two(cols):
        return (torch.where(drop0, cols[1], cols[0]),
                torch.where(drop01, cols[2], cols[1]))

    (ua, ub), (va, vb) = largest_two(u), largest_two(v)
    uc, vc = torch.linalg.cross(ua, ub), torch.linalg.cross(va, vb)
    return (ua[..., :, None] * va[..., None, :]
            + ub[..., :, None] * vb[..., None, :]
            + uc[..., :, None] * vc[..., None, :])


def _det3(a, b, c, d, e, f, g, h, i):
    """Determinant of [[a,b,c],[d,e,f],[g,h,i]], elementwise."""
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


#: default differentiation mode of the QCP Newton solve
#: (``colvarsfinder_tpu/ops/alignment.py:72-82``): 0 differentiates every
#: Newton step; n > 0 runs the convergence on detached coefficients and
#: appends n differentiable steps (implicit differentiation, exact first
#: and, with two steps, second derivatives at the root)
DEFAULT_NEWTON_DIFF_STEPS: int = 0


@contextmanager
def newton_diff_mode(diff_steps: int):
    """Override of :data:`DEFAULT_NEWTON_DIFF_STEPS` inside the block, the
    previous mode restored on the way out, an exception included
    (``colvarsfinder_tpu/ops/alignment.py:85-99``).

    The JAX package reads the mode when it traces a program. Eager PyTorch
    has no trace: the mode is read each time :func:`quaternion_from_covariance`
    runs, so it holds for every alignment (and every K2 backward, which is
    the plain alignment's) computed inside the block. A CUDA graph keeps
    the mode it was captured under; the graph keys of captured epochs and
    sweeps hold the mode (:func:`..config.numerics_key`), so a change of
    mode captures anew instead of replaying a stale graph."""
    global DEFAULT_NEWTON_DIFF_STEPS
    prev = DEFAULT_NEWTON_DIFF_STEPS
    DEFAULT_NEWTON_DIFF_STEPS = diff_steps
    try:
        yield
    finally:
        DEFAULT_NEWTON_DIFF_STEPS = prev


def quaternion_from_covariance(c9, newton_iters: int = 16,
                               diff_steps: int | None = None):
    """Optimal-rotation quaternion from the 9 entries of a covariance
    pre-normalized by its Frobenius norm
    (``colvarsfinder_tpu/ops/alignment.py:102-238``).

    ``diff_steps`` is None: :data:`DEFAULT_NEWTON_DIFF_STEPS` as it stands
    at the call (:func:`newton_diff_mode`). ``0``: the Newton loop is
    differentiated step by step. ``> 0``: convergence runs on detached
    coefficients and this many differentiable steps follow (implicit
    differentiation; the forward value is unchanged).

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

    if diff_steps is None:
        diff_steps = DEFAULT_NEWTON_DIFF_STEPS
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
    # ||C||_F^2 summed left to right over the row-major entries, an order
    # that K6 repeats on the card (a reduction kernel's order is its own)
    sq = (C * C).reshape(-1, 9).unbind(-1)
    fro2 = sq[0]
    for v in sq[1:]:
        fro2 = fro2 + v
    norm = torch.sqrt(fro2)[:, None, None]
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
    if method == "svd":
        solve = kabsch_rotations_svd
    elif method == "quaternion":
        solve = kabsch_rotations_quat
    elif method in ("cuda", "pallas"):
        from .kabsch_cuda import kabsch_rotations_cuda as solve
    else:
        raise ValueError(f"unknown alignment method '{method}'")
    return _align(x, ref_centered, align_idx, align_weights, solve)


def _layer_quaternion_rotations(C: torch.Tensor) -> torch.Tensor:
    """The rotation solve of ``AlignmentLayer(method='quaternion')``: kernel
    K6 for float32 covariances on the card, under ``torch.func`` transforms
    too, and in a trace of float32 ones (``torch.export``: the program's
    operator then dispatches by the device it runs on); the plain chain for
    every other dtype and on the CPU. Both give the same bits; the
    recorder's counters ``cvf.align.quat_kernel`` and
    ``cvf.align.quat_plain`` count the frames each way solved (under
    ``torch.func.vmap``, those of one mapped slice a call)."""
    if C.dtype == torch.float32 and (C.is_cuda or is_fake(C)):
        from .kabsch_cuda import kabsch_rotations_exact

        count("cvf.align.quat_kernel", C.shape[0])
        return kabsch_rotations_exact(C)
    count("cvf.align.quat_plain", C.shape[0])
    return kabsch_rotations_quat(C)


def _align(x, ref_centered, align_idx, align_weights, solve):
    """:func:`align_frames` with the rotation solve ``solve``: covariances
    C [B, 3, 3] -> rotations [B, 3, 3]."""
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
    return torch.einsum("bni,bij->bnj", x_c, solve(C))


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

    With ``method='quaternion'``, float32 frames on the card have their
    rotations solved by kernel K6, one launch a call, under ``torch.func``
    transforms too (:func:`.kabsch_cuda.kabsch_rotations_exact`): the plain
    QCP chain's operations in its order, so the layer's values, its input
    gradients and second derivatives by the parameters after it (the
    generator loss's) are the plain chain's to the bit; the centroid and
    the two products stay PyTorch's. Other dtypes on the card (float64) and
    the CPU run the plain chain.
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
        if self.method == "quaternion":
            out = _align(x, self.ref_centered, self.align_idx,
                         self.align_weights, _layer_quaternion_rotations)
        else:
            out = align_frames(
                x, self.ref_centered, self.align_idx,
                align_weights=self.align_weights, method=self.method,
            )
        return out[0] if squeeze else out

    def show_info(self):
        """Print the align atoms, the method and the centred reference, in
        the JAX package's words (``colvarsfinder_tpu/ops/alignment.py:
        409-415``)."""
        weighted = "" if self.align_weights is None else ", weighted"
        print(
            f"AlignmentLayer: {self.ref_centered.shape[0]} align atoms, "
            f"method={self.method}{weighted}\nreference (centered):\n"
            f"{self.ref_centered.detach().cpu().numpy()}"
        )

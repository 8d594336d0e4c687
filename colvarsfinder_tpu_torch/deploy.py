r"""Dependency-free CV deployment: numpy spec export + evaluator.

Copied from the JAX package's ``colvarsfinder_tpu/deploy.py``: the numpy
half (``UnsupportedLayerError`` to ``load_numpy_cv``, ``:58-705``) is taken
over as it stands, so the two packages write and read one artifact format
(``FORMAT`` is unchanged) and each evaluates the other's artifacts.
:func:`build_spec` walks this package's own classes instead of the JAX
ones, with the node kinds and parameter keys of ``deploy.py:713-830``.

Two halves:

* **Spec building** (:func:`save_numpy_cv`) walks a
  :class:`~colvarsfinder_tpu_torch.export.ColvarModel` (or a supported pp
  layer / model) and writes ``cv_numpy_spec.json`` (a small computation
  graph of named node kinds) plus ``cv_numpy.npz`` (the array parameters),
  and from them the native program ``cv_native.bin``
  (:mod:`.deploy_native`).
* **Evaluation** (:func:`load_numpy_cv`, :func:`eval_spec`,
  :func:`eval_spec_grad`) interprets the spec with nothing but numpy, values
  and the input Jacobian, for MD-engine plugins and analysis scripts that
  have neither torch nor this package.

Supported graph node kinds:

=============  ==========================================================
``identity``   pass-through (ops.Identity)
``alignment``  rigid Kabsch alignment onto a stored reference
               (ops.AlignmentLayer; numpy SVD with the det-sign fix)
``features``   position / bond / angle / angle_rad / dihedral /
               dihedral_rad / contact / coordination feature vector
               (ops.FeatureLayer)
``compose``    sequential composition of child nodes
``mlp``        feedforward net, activation between layers
``stacked_mlp`` k-head ensemble net, weights [k, d_out, d_in]
               (models.EigenFunctions)
=============  ==========================================================

``FusedAlignmentLayer`` (kernel K2) and ``Lambda`` have no spec and raise
:class:`UnsupportedLayerError`, as in the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable

import numpy as np

__all__ = [
    "FORMAT",
    "PARAMS_NAME",
    "SPEC_NAME",
    "UnsupportedLayerError",
    "build_spec",
    "eval_spec",
    "eval_spec_grad",
    "load_numpy_cv",
    "save_numpy_cv",
]


class UnsupportedLayerError(TypeError):
    """A CV component has no dependency-free numpy representation
    (e.g. ops.Lambda wrapping an arbitrary tensor function)."""

SPEC_NAME = "cv_numpy_spec.json"
PARAMS_NAME = "cv_numpy.npz"
FORMAT = "colvarsfinder-tpu-cv-numpy/1"


# ---------------------------------------------------------------------------
# numpy evaluation
# ---------------------------------------------------------------------------


def _np_elu(x):
    return np.where(x > 0, x, np.expm1(np.minimum(x, 0.0)))


def _np_gelu(x):
    # the tanh approximation: the 'gelu' of both packages' models
    c = np.sqrt(2.0 / np.pi).astype(x.dtype) if hasattr(x, "dtype") else np.sqrt(2.0 / np.pi)
    return 0.5 * x * (1.0 + np.tanh(c * (x + 0.044715 * x**3)))


_NP_ACTIVATIONS: dict[str, Callable[[np.ndarray], np.ndarray]] = {
    "tanh": np.tanh,
    "tanh_native": np.tanh,
    "relu": lambda x: np.maximum(x, 0.0),
    "elu": _np_elu,
    "gelu": _np_gelu,
    "sigmoid": lambda x: 1.0 / (1.0 + np.exp(-x)),
    "celu": lambda x: np.where(x > 0, x, np.expm1(np.minimum(x, 0.0))),
    "softplus": lambda x: np.logaddexp(x, 0.0),
    "identity": lambda x: x,
}


def _np_kabsch_align(
    x: np.ndarray, ref_c: np.ndarray, idx: np.ndarray, weights=None
) -> np.ndarray:
    """Align frames [B, N, 3] onto the centered reference [m, 3].

    Same math as ops.alignment.align_frames (quaternion and SVD solutions
    coincide), including its weighted (e.g. mass-weighted) variant; numpy
    SVD with the determinant-sign fix is the simplest dependency-free
    formulation.
    """
    sel = x[:, idx, :]
    if weights is not None:
        wn = weights / weights.sum()
        com = np.einsum("m,bmi->bi", wn, sel)
        ref_c = ref_c - np.einsum("m,mi->i", wn, ref_c)
    else:
        com = sel.mean(axis=1)
    x_c = x - com[:, None, :]
    sel_c = sel - com[:, None, :]
    if weights is not None:
        sel_c = sel_c * weights[None, :, None]
    C = np.einsum("bmi,mj->bij", sel_c, ref_c)
    U, _, Vt = np.linalg.svd(C)
    det = np.linalg.det(np.einsum("bij,bjk->bik", U, Vt))
    D = np.ones_like(U[:, :, 0])
    D[:, 2] = det
    R = np.einsum("bij,bj,bjk->bik", U, D, Vt)
    return np.einsum("bni,bij->bnj", x_c, R)


def _np_dihedral_cos_sin(ra, rb, rc, rd):
    b1 = rb - ra
    b2 = rc - rb
    b3 = rd - rc
    n1 = np.cross(b1, b2)
    n2 = np.cross(b2, b3)
    m1 = np.cross(n1, b2 / np.linalg.norm(b2, axis=-1, keepdims=True))
    c = (n1 * n2).sum(axis=-1)
    s = (m1 * n2).sum(axis=-1)
    norm = np.sqrt(c * c + s * s)
    return c / norm, s / norm


def _np_switch(r, sw):
    """RATIONAL switching value (mirror of ops.features.switching_rational,
    incl. the series evaluation at the removable x = 1 singularity)."""
    r0, d0, nn, mm = sw["r0"], sw["d0"], sw["nn"], sw["mm"]
    x = np.maximum((r - d0) / r0, 0.0)
    near1 = np.abs(x - 1.0) < 1e-8
    xs = np.where(near1, 0.5, x)
    s = (1.0 - xs**nn) / (1.0 - xs**mm)
    return np.where(near1, nn / mm + nn * (nn - mm) / (2.0 * mm) * (x - 1.0), s)


def _np_switch_dr(r, sw):
    """ds/dr of the RATIONAL switch (0 in the clamped region r <= d0)."""
    r0, d0, nn, mm = sw["r0"], sw["d0"], sw["nn"], sw["mm"]
    x = np.maximum((r - d0) / r0, 0.0)
    near1 = np.abs(x - 1.0) < 1e-8
    xs = np.where(near1, 0.5, x)
    den = 1.0 - xs**mm
    ds = (-nn * xs ** (nn - 1) * den + mm * xs ** (mm - 1) * (1.0 - xs**nn)) / (
        den * den
    )
    ds = np.where(near1, nn * (nn - mm) / (2.0 * mm), ds)
    return np.where(r - d0 <= 0.0, 0.0, ds) / r0


def _switch_pairs(idx):
    return np.asarray(idx, dtype=np.int64).reshape(-1, 2)


def _np_mic(d: np.ndarray, box) -> np.ndarray:
    """Minimum-image displacement (orthogonal box lengths [3])."""
    if box is None:
        return d
    b = np.asarray(box, dtype=d.dtype)
    return d - b * np.round(d / b)


def _np_eval_feature(ftype: str, idx, x: np.ndarray, sw=None,
                     box=None) -> np.ndarray:
    if ftype == "position":
        return x[:, np.asarray(idx), :].reshape(x.shape[0], -1)
    if ftype in ("contact", "coordination"):
        p = _switch_pairs(idx)
        d = _np_mic(x[:, p[:, 1], :] - x[:, p[:, 0], :], box)
        s = _np_switch(np.linalg.norm(d, axis=-1), sw)  # [B, P]
        return s.sum(axis=1, keepdims=True) if ftype == "coordination" else s
    a = x[:, idx[0], :]
    b = x[:, idx[1], :]
    if ftype == "bond":
        return np.linalg.norm(_np_mic(b - a, box), axis=-1)[:, None]
    c = x[:, idx[2], :]
    if ftype == "angle":
        u, v = a - b, c - b
        cos_t = (u * v).sum(-1) / (
            np.linalg.norm(u, axis=-1) * np.linalg.norm(v, axis=-1)
        )
        return cos_t[:, None]
    if ftype == "angle_rad":
        u, v = a - b, c - b
        cross = np.cross(u, v)
        return np.arctan2(
            np.linalg.norm(cross, axis=-1), (u * v).sum(-1)
        )[:, None]
    d = x[:, idx[3], :]
    cs, sn = _np_dihedral_cos_sin(a, b, c, d)
    if ftype == "dihedral":
        return np.stack([cs, sn], axis=-1)
    return np.arctan2(sn, cs)[:, None]


def _eval_node(node: dict, params: dict, x: np.ndarray) -> np.ndarray:
    kind = node["kind"]
    if kind == "identity":
        return x
    if kind == "compose":
        for stage in node["stages"]:
            x = _eval_node(stage, params, x)
        return x
    if kind == "alignment":
        return _np_kabsch_align(
            x,
            params[node["ref"]],
            np.asarray(node["align_idx"], dtype=np.int64),
            weights=params[node["weights"]] if "weights" in node else None,
        )
    if kind == "features":
        feats = [
            _np_eval_feature(
                f["type"], f["atom_indices"], x, f.get("params"),
                node.get("box"),
            )
            for f in node["features"]
        ]
        return np.concatenate(feats, axis=1)
    if kind == "mlp":
        act = _NP_ACTIVATIONS[node["activation"]]
        n = len(node["layers"])
        for i, (wk, bk) in enumerate(node["layers"]):
            x = x @ params[wk].T + params[bk]
            if i < n - 1:
                x = act(x)
        return x
    if kind == "stacked_mlp":
        act = _NP_ACTIVATIONS[node["activation"]]
        n = len(node["layers"])
        w0 = params[node["layers"][0][0]]
        h = np.broadcast_to(x[None], (w0.shape[0],) + x.shape)
        for i, (wk, bk) in enumerate(node["layers"]):
            # [k,b,i] x [k,o,i] -> [k,b,o]
            h = np.einsum("kbi,koi->kbo", h, params[wk]) + params[bk][:, None, :]
            if i < n - 1:
                h = act(h)
        h = np.transpose(h, (1, 0, 2))
        return h.reshape(h.shape[0], -1)
    raise ValueError(f"unknown spec node kind '{kind}'")


def eval_spec(spec: dict, params: dict, x: np.ndarray) -> np.ndarray:
    """Evaluate a CV spec on a (batched or single) state with pure numpy."""
    x = np.asarray(x, dtype=np.float32)
    state_ndim = int(spec.get("state_ndim", 1))
    squeeze = x.ndim == state_ndim
    if squeeze:
        x = x[None]
    out = _eval_node(spec["graph"], params, x)
    return out[0] if squeeze else out


# ---------------------------------------------------------------------------
# numpy gradients (hand-written reverse mode)
#
# The reference's deployment artifact is a TorchScript module whose consumers
# (MD engines biasing along the CV) get forces dCV/dx from torch autograd for
# free (reference: colvarsfinder/core.py:212-227). The numpy artifact must
# provide the same, so every spec node kind carries an analytic VJP here.
# Cotangents carry a leading axis of size K (one slot per CV component), so
# the full Jacobian [B, K, *state] is a single backward sweep.
# ---------------------------------------------------------------------------


def _softplus_sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _gelu_grad(x):
    c = np.sqrt(2.0 / np.pi)
    a = 0.044715
    u = c * (x + a * x**3)
    t = np.tanh(u)
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * c * (1.0 + 3.0 * a * x * x)


# derivative of each activation given its pre-activation input z
_NP_ACTIVATION_GRADS: dict[str, Callable[[np.ndarray], np.ndarray]] = {
    "tanh": lambda z: 1.0 - np.tanh(z) ** 2,
    "tanh_native": lambda z: 1.0 - np.tanh(z) ** 2,
    "relu": lambda z: (z > 0).astype(z.dtype),
    "elu": lambda z: np.where(z > 0, 1.0, np.exp(np.minimum(z, 0.0))),
    "celu": lambda z: np.where(z > 0, 1.0, np.exp(np.minimum(z, 0.0))),
    "gelu": _gelu_grad,
    "sigmoid": lambda z: _softplus_sigmoid(z) * (1.0 - _softplus_sigmoid(z)),
    "softplus": _softplus_sigmoid,
    "identity": lambda z: np.ones_like(z),
}


def _quat_rotations(C: np.ndarray):
    """Rotations + quaternion eigen-data from cross-covariances [B, 3, 3].

    Same QCP convention as ops.alignment.quaternion_from_covariance (Horn's
    4x4 key matrix; row-vector rotation y = x @ R), solved by ``eigh``
    instead of Newton since the host-side batch is small. Returns
    ``(R [B,3,3], q [B,4], evals [B,4], evecs [B,4,4], ok [B])`` — the
    eigen-data feeds the implicit-differentiation backward.
    """
    B = C.shape[0]
    norm = np.sqrt((C * C).sum(axis=(-2, -1)))
    ok = norm > 1e-12
    c = C[:, 0, 0], C[:, 0, 1], C[:, 0, 2]
    sxx, sxy, sxz = c
    syx, syy, syz = C[:, 1, 0], C[:, 1, 1], C[:, 1, 2]
    szx, szy, szz = C[:, 2, 0], C[:, 2, 1], C[:, 2, 2]
    K = np.empty((B, 4, 4), dtype=C.dtype)
    K[:, 0, 0] = sxx + syy + szz
    K[:, 0, 1] = K[:, 1, 0] = syz - szy
    K[:, 0, 2] = K[:, 2, 0] = szx - sxz
    K[:, 0, 3] = K[:, 3, 0] = sxy - syx
    K[:, 1, 1] = sxx - syy - szz
    K[:, 1, 2] = K[:, 2, 1] = sxy + syx
    K[:, 1, 3] = K[:, 3, 1] = szx + sxz
    K[:, 2, 2] = syy - sxx - szz
    K[:, 2, 3] = K[:, 3, 2] = syz + szy
    K[:, 3, 3] = szz - sxx - syy
    evals, evecs = np.linalg.eigh(K)  # ascending
    q = evecs[:, :, 3]  # top eigenvector = optimal quaternion
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.empty((B, 3, 3), dtype=C.dtype)
    R[:, 0, 0] = 1 - 2 * (y * y + z * z)
    R[:, 0, 1] = 2 * (x * y + w * z)
    R[:, 0, 2] = 2 * (x * z - w * y)
    R[:, 1, 0] = 2 * (x * y - w * z)
    R[:, 1, 1] = 1 - 2 * (x * x + z * z)
    R[:, 1, 2] = 2 * (y * z + w * x)
    R[:, 2, 0] = 2 * (x * z + w * y)
    R[:, 2, 1] = 2 * (y * z - w * x)
    R[:, 2, 2] = 1 - 2 * (x * x + y * y)
    R[~ok] = np.eye(3, dtype=C.dtype)
    return R, q, evals, evecs, ok


def _quat_rotation_vjp(g_R, q, evals, evecs, ok):
    """Cotangent on C from cotangent on R = R(q(C)) — [.., B, 3, 3].

    Chains (a) the quadratic map q -> R, (b) the top eigenpair of the 4x4
    key matrix via the implicit derivative dq = (lam I - K)^+ dK q (exact
    for the simple symmetric eigenproblem), and (c) the linear map C -> K.
    Degenerate frames (``~ok``: all-coincident atoms, R pinned to I in the
    forward) contribute zero gradient through R, matching the forward's
    constant fallback.
    """
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    zero = np.zeros_like(w)
    # d(R entries, row-major)/d(q components): [B, 9, 4]
    J = np.stack([
        np.stack([zero, zero, -4 * y, -4 * z], axis=-1),
        np.stack([2 * z, 2 * y, 2 * x, 2 * w], axis=-1),
        np.stack([-2 * y, 2 * z, -2 * w, 2 * x], axis=-1),
        np.stack([-2 * z, 2 * y, 2 * x, -2 * w], axis=-1),
        np.stack([zero, -4 * x, zero, -4 * z], axis=-1),
        np.stack([2 * x, 2 * w, 2 * z, 2 * y], axis=-1),
        np.stack([2 * y, 2 * z, 2 * w, 2 * x], axis=-1),
        np.stack([-2 * x, -2 * w, 2 * z, 2 * y], axis=-1),
        np.stack([zero, -4 * x, -4 * y, zero], axis=-1),
    ], axis=-2)
    g_flat = g_R.reshape(g_R.shape[:-2] + (9,))
    g_q = np.einsum("...be,bef->...bf", g_flat, J)
    # implicit top-eigenpair backward: t = sum_{i<top} v_i (v_i . g_q)/gap_i
    lam = evals[:, 3]
    vs = evecs[:, :, :3]  # [B, 4, 3] non-top eigenvectors
    gaps = lam[:, None] - evals[:, :3]  # > 0 for a simple top eigenvalue
    coef = np.einsum("bfi,...bf->...bi", vs, g_q) / np.maximum(gaps, 1e-12)
    t = np.einsum("bfi,...bi->...bf", vs, coef)
    t = np.where(ok[:, None], t, 0.0)
    gK = t[..., :, None] * q[..., None, :]  # [.., B, 4, 4] (K-bar = t q^T)
    # transpose of the linear map C -> K
    gC = np.empty(gK.shape[:-2] + (3, 3), dtype=gK.dtype)
    d00, d11, d22, d33 = (gK[..., i, i] for i in range(4))
    gC[..., 0, 0] = d00 + d11 - d22 - d33
    gC[..., 1, 1] = d00 - d11 + d22 - d33
    gC[..., 2, 2] = d00 - d11 - d22 + d33
    s01 = gK[..., 0, 1] + gK[..., 1, 0]
    s02 = gK[..., 0, 2] + gK[..., 2, 0]
    s03 = gK[..., 0, 3] + gK[..., 3, 0]
    s12 = gK[..., 1, 2] + gK[..., 2, 1]
    s13 = gK[..., 1, 3] + gK[..., 3, 1]
    s23 = gK[..., 2, 3] + gK[..., 3, 2]
    gC[..., 1, 2] = s01 + s23
    gC[..., 2, 1] = -s01 + s23
    gC[..., 2, 0] = s02 + s13
    gC[..., 0, 2] = -s02 + s13
    gC[..., 0, 1] = s03 + s12
    gC[..., 1, 0] = -s03 + s12
    return gC


def _vjp_alignment(node, params, x):
    """Forward + VJP of the alignment node. The rotation here comes from
    the quaternion eigenproblem (same optimum as the forward-only SVD path
    in :func:`_np_kabsch_align`, consistent with its own backward)."""
    idx = np.asarray(node["align_idx"], dtype=np.int64)
    ref_c = params[node["ref"]]
    weights = params[node["weights"]] if "weights" in node else None
    m = idx.shape[0]
    sel = x[:, idx, :]
    if weights is not None:
        wn = weights / weights.sum()
        ref_c = ref_c - np.einsum("m,mi->i", wn, ref_c)
    else:
        wn = np.full((m,), 1.0 / m, dtype=x.dtype)
    com = np.einsum("m,bmi->bi", wn, sel)
    x_c = x - com[:, None, :]
    sel_c0 = sel - com[:, None, :]
    sel_c = sel_c0 * weights[None, :, None] if weights is not None else sel_c0
    C = np.einsum("bmi,mj->bij", sel_c, ref_c)
    R, q, evals, evecs, ok = _quat_rotations(C)
    out = np.einsum("bni,bij->bnj", x_c, R)

    def vjp(g):  # g: [K, B, N, 3]
        g_xc = np.einsum("kbnj,bij->kbni", g, R)
        g_R = np.einsum("bni,kbnj->kbij", x_c, g)
        g_C = _quat_rotation_vjp(g_R, q, evals, evecs, ok)
        g_sel_c = np.einsum("kbij,mj->kbmi", g_C, ref_c)
        if weights is not None:
            g_sel_c = g_sel_c * weights[None, None, :, None]
        g_com = -g_xc.sum(axis=2) - g_sel_c.sum(axis=2)  # [K, B, 3]
        g_x = g_xc.copy()
        g_sel = g_sel_c + wn[None, None, :, None] * g_com[:, :, None, :]
        np.add.at(g_x, (slice(None), slice(None), idx), g_sel)
        return g_x

    return out, vjp


def _vjp_feature(ftype: str, idx, x: np.ndarray, sw=None, box=None):
    """(out, per-feature vjp into a [K, B, N, 3] accumulator). The
    minimum-image shift (``box``) is locally constant, so each VJP just
    uses the MIC'd displacement in place of the raw one."""
    if ftype in ("contact", "coordination"):
        p = _switch_pairs(idx)
        d = _np_mic(x[:, p[:, 1], :] - x[:, p[:, 0], :], box)  # [B, P, 3]
        r = np.linalg.norm(d, axis=-1)
        s = _np_switch(r, sw)
        du = _np_switch_dr(r, sw)[..., None] * (d / r[..., None])  # ds/dr_j
        out = s.sum(axis=1, keepdims=True) if ftype == "coordination" else s

        def vjp_switch(g, acc):
            # coordination: one output column fans out to every pair;
            # contact: P == 1 == output width — same broadcast either way
            gu = g[..., 0][..., None, None] * du[None]  # [K, B, P, 3]
            np.add.at(acc, (slice(None), slice(None), p[:, 1]), gu)
            np.add.at(acc, (slice(None), slice(None), p[:, 0]), -gu)

        return out, vjp_switch

    if ftype == "position":
        ai = np.asarray(idx, dtype=np.int64)
        out = x[:, ai, :].reshape(x.shape[0], -1)

        def vjp_pos(g, acc):
            np.add.at(
                acc, (slice(None), slice(None), ai),
                g.reshape(g.shape[:2] + (ai.shape[0], 3)),
            )

        return out, vjp_pos

    a = x[:, idx[0], :]
    b = x[:, idx[1], :]
    if ftype == "bond":
        d = _np_mic(b - a, box)
        r = np.linalg.norm(d, axis=-1)
        u = d / r[:, None]
        out = r[:, None]

        def vjp_bond(g, acc):
            gu = g[..., 0][..., None] * u  # [K, B, 3]
            np.add.at(acc, (slice(None), slice(None), idx[0]), -gu)
            np.add.at(acc, (slice(None), slice(None), idx[1]), gu)

        return out, vjp_bond

    c = x[:, idx[2], :]
    if ftype in ("angle", "angle_rad"):
        u, v = a - b, c - b
        nu = np.linalg.norm(u, axis=-1)
        nv = np.linalg.norm(v, axis=-1)
        dot = (u * v).sum(-1)
        cos_t = dot / (nu * nv)
        if ftype == "angle":
            out = cos_t[:, None]
            du = v / (nu * nv)[:, None] - cos_t[:, None] * u / (nu * nu)[:, None]
            dv = u / (nu * nv)[:, None] - cos_t[:, None] * v / (nv * nv)[:, None]
        else:
            w = np.cross(u, v)
            s = np.linalg.norm(w, axis=-1)
            out = np.arctan2(s, dot)[:, None]
            # dtheta = (c ds - s dc)/(s^2 + c^2); d|w|/du = v x w_hat
            wh = w / np.maximum(s, 1e-30)[:, None]
            n2 = s * s + dot * dot
            cs, ss = (dot / n2)[:, None], (s / n2)[:, None]
            du = cs * np.cross(v, wh) - ss * v
            dv = cs * np.cross(wh, u) - ss * u

        def vjp_angle(g, acc, du=du, dv=dv):
            ga = g[..., 0][..., None] * du
            gc = g[..., 0][..., None] * dv
            np.add.at(acc, (slice(None), slice(None), idx[0]), ga)
            np.add.at(acc, (slice(None), slice(None), idx[2]), gc)
            np.add.at(acc, (slice(None), slice(None), idx[1]), -(ga + gc))

        return out, vjp_angle

    # dihedral / dihedral_rad
    d = x[:, idx[3], :]
    b1, b2, b3 = b - a, c - b, d - c
    n1 = np.cross(b1, b2)
    n2 = np.cross(b2, b3)
    nb2 = np.linalg.norm(b2, axis=-1)
    b2h = b2 / nb2[:, None]
    m1 = np.cross(n1, b2h)
    ct = (n1 * n2).sum(axis=-1)
    st = (m1 * n2).sum(axis=-1)
    norm2 = ct * ct + st * st
    inv_norm = 1.0 / np.sqrt(norm2)
    cos_p, sin_p = ct * inv_norm, st * inv_norm
    out = (
        np.stack([cos_p, sin_p], axis=-1)
        if ftype == "dihedral"
        else np.arctan2(st, ct)[:, None]
    )
    # dphi = (ct d st - st d ct)/norm2; assemble d st, d ct per bond vector
    dct_db1 = np.cross(b2, n2)
    dct_db2 = np.cross(n2, b1) + np.cross(b3, n1)
    dct_db3 = np.cross(n1, b2)
    bxn = np.cross(b2h, n2)
    proj = np.cross(n2, n1)
    proj = (proj - b2h * (proj * b2h).sum(-1)[:, None]) / nb2[:, None]
    dst_db1 = np.cross(b2, bxn)
    dst_db2 = np.cross(bxn, b1) + proj + np.cross(b3, m1)
    dst_db3 = np.cross(m1, b2)

    def vjp_dihedral(g, acc):
        if ftype == "dihedral":
            # chain through (cos, sin) = (ct, st)/norm: d cos = -sin dphi...
            g_phi = -g[..., 0] * sin_p + g[..., 1] * cos_p
        else:
            g_phi = g[..., 0]
        a_st = (g_phi * ct / norm2)[..., None]
        a_ct = (-g_phi * st / norm2)[..., None]
        g_b1 = a_ct * dct_db1 + a_st * dst_db1
        g_b2 = a_ct * dct_db2 + a_st * dst_db2
        g_b3 = a_ct * dct_db3 + a_st * dst_db3
        np.add.at(acc, (slice(None), slice(None), idx[0]), -g_b1)
        np.add.at(acc, (slice(None), slice(None), idx[1]), g_b1 - g_b2)
        np.add.at(acc, (slice(None), slice(None), idx[2]), g_b2 - g_b3)
        np.add.at(acc, (slice(None), slice(None), idx[3]), g_b3)

    return out, vjp_dihedral


def _vjp_node(node: dict, params: dict, x: np.ndarray):
    """Forward + VJP for a spec node. The returned vjp maps a cotangent of
    shape [K, B, *out] to [K, B, *in] (K = CV-component axis)."""
    kind = node["kind"]
    if kind == "identity":
        return x, lambda g: g
    if kind == "compose":
        vjps = []
        for stage in node["stages"]:
            x, vjp = _vjp_node(stage, params, x)
            vjps.append(vjp)

        def vjp_compose(g):
            for v in reversed(vjps):
                g = v(g)
            return g

        return x, vjp_compose
    if kind == "alignment":
        return _vjp_alignment(node, params, x)
    if kind == "features":
        outs, fns, widths = [], [], []
        for f in node["features"]:
            o, fn = _vjp_feature(
                f["type"], f["atom_indices"], x, f.get("params"),
                node.get("box"),
            )
            outs.append(o)
            fns.append(fn)
            widths.append(o.shape[1])
        out = np.concatenate(outs, axis=1)
        x_shape = x.shape

        def vjp_features(g):
            acc = np.zeros(g.shape[:2] + x_shape[1:], dtype=g.dtype)
            off = 0
            for fn, wd in zip(fns, widths):
                fn(g[:, :, off:off + wd], acc)
                off += wd
            return acc

        return out, vjp_features
    if kind == "mlp":
        act = _NP_ACTIVATIONS[node["activation"]]
        act_g = _NP_ACTIVATION_GRADS[node["activation"]]
        n = len(node["layers"])
        zs = []
        for i, (wk, bk) in enumerate(node["layers"]):
            z = x @ params[wk].T + params[bk]
            zs.append(z)
            x = act(z) if i < n - 1 else z

        def vjp_mlp(g):
            for i in range(n - 1, -1, -1):
                if i < n - 1:
                    g = g * act_g(zs[i])[None]
                g = g @ params[node["layers"][i][0]]
            return g

        return x, vjp_mlp
    if kind == "stacked_mlp":
        act = _NP_ACTIVATIONS[node["activation"]]
        act_g = _NP_ACTIVATION_GRADS[node["activation"]]
        n = len(node["layers"])
        w0 = params[node["layers"][0][0]]
        h = np.broadcast_to(x[None], (w0.shape[0],) + x.shape)
        zs = []
        for i, (wk, bk) in enumerate(node["layers"]):
            z = np.einsum("kbi,koi->kbo", h, params[wk]) + params[bk][:, None, :]
            zs.append(z)
            h = act(z) if i < n - 1 else z
        k, B, o = h.shape
        out = np.transpose(h, (1, 0, 2)).reshape(B, k * o)

        def vjp_stacked(g):  # [K, B, k*o]
            gh = np.transpose(
                g.reshape(g.shape[0], B, k, o), (0, 2, 1, 3)
            )  # [K, k, B, o]
            for i in range(n - 1, -1, -1):
                if i < n - 1:
                    gh = gh * act_g(zs[i])[None]
                gh = np.einsum(
                    "Kkbo,koi->Kkbi", gh, params[node["layers"][i][0]]
                )
            return gh.sum(axis=1)

        return out, vjp_stacked
    raise ValueError(f"unknown spec node kind '{kind}'")


def eval_spec_grad(spec: dict, params: dict, x: np.ndarray):
    """Evaluate a CV spec AND its input Jacobian with pure numpy.

    Returns ``(values, jacobian)`` with shapes ``[B, K]`` and
    ``[B, K, *state]`` (leading ``B`` dropped for an unbatched state) —
    the per-component input gradients an MD engine needs to turn a bias
    potential along the CV into atomic forces. Computed in float64 for
    host-side robustness regardless of the stored parameter dtype.
    """
    x = np.asarray(x, dtype=np.float64)
    params = {
        k: v.astype(np.float64) if v.dtype.kind == "f" else v
        for k, v in params.items()
    }
    state_ndim = int(spec.get("state_ndim", 1))
    squeeze = x.ndim == state_ndim
    if squeeze:
        x = x[None]
    out, vjp = _vjp_node(spec["graph"], params, x)
    out_shape = out.shape[1:]
    if out.ndim > 2:  # e.g. a bare alignment graph: flatten the components
        out = out.reshape(out.shape[0], -1)
    B, K = out.shape
    cot = np.zeros((K, B, K), dtype=x.dtype)
    cot[np.arange(K), :, np.arange(K)] = 1.0
    jac = np.moveaxis(vjp(cot.reshape((K, B) + out_shape)), 0, 1)
    return (out[0], jac[0]) if squeeze else (out, jac)


def load_numpy_cv(
    out_dir: str, with_grad: bool = False
) -> Callable[[np.ndarray], np.ndarray]:
    """Load a saved numpy-CV artifact as a plain ``x -> cv(x)`` callable.

    Requires only numpy — usable from processes that have no torch (MD engine
    plugins, analysis scripts). With ``with_grad=True`` the callable
    returns ``(values, jacobian)`` (see :func:`eval_spec_grad`), covering
    the biased-sampling consumers that need forces along the CV.
    """
    with open(os.path.join(out_dir, SPEC_NAME)) as f:
        spec = json.load(f)
    if spec.get("format") != FORMAT:
        raise ValueError(f"not a {FORMAT} artifact: {spec.get('format')!r}")
    with np.load(os.path.join(out_dir, PARAMS_NAME)) as data:
        params = {k: data[k] for k in data.files}
    if with_grad:
        return lambda x: eval_spec_grad(spec, params, x)
    return lambda x: eval_spec(spec, params, x)


# ---------------------------------------------------------------------------
# Spec building (walks this package's modules)
# ---------------------------------------------------------------------------


def _np(t) -> np.ndarray:
    """A parameter or buffer as a host numpy array (a task trained on the
    card saves the same files)."""
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _store(params_out: dict, prefix: str, name: str, arr) -> str:
    key = f"{prefix}{name}"
    params_out[key] = _np(arr)
    return key


def _mlp_node(layers, activation: str, params_out: dict, prefix: str,
              kind: str) -> dict:
    keys = []
    for i, layer in enumerate(layers):
        keys.append([
            _store(params_out, prefix, f"w{i}", layer["weight"]),
            _store(params_out, prefix, f"b{i}", layer["bias"]),
        ])
    return {"kind": kind, "activation": activation, "layers": keys}


def build_spec(obj: Any, params_out: dict, prefix: str = "n0_") -> dict:
    """Build a spec node for a pp layer / model module (recursive).

    Raises :class:`UnsupportedLayerError` for modules with no
    dependency-free representation (``Lambda``, ``FusedAlignmentLayer``).
    """
    from .export import ColvarModel
    from .models import EigenFunctions, Sequential
    from .ops import AlignmentLayer, FeatureLayer, Identity, PreprocessingANN

    if obj is None or isinstance(obj, Identity):
        return {"kind": "identity"}
    if isinstance(obj, ColvarModel):
        return {
            "kind": "compose",
            "stages": [
                build_spec(obj.pp_layer, params_out, prefix + "pp_"),
                build_spec(obj.head, params_out, prefix + "head_"),
            ],
        }
    if isinstance(obj, PreprocessingANN):
        stages = []
        if obj.alignment_layer is not None:
            stages.append(
                build_spec(obj.alignment_layer, params_out, prefix + "al_")
            )
        if obj.feature_layer is not None:
            stages.append(
                build_spec(obj.feature_layer, params_out, prefix + "ft_")
            )
        return {"kind": "compose", "stages": stages}
    if isinstance(obj, AlignmentLayer):
        node = {
            "kind": "alignment",
            "ref": _store(params_out, prefix, "ref", obj.ref_centered),
            "align_idx": _np(obj.align_idx).tolist(),
        }
        if obj.align_weights is not None:
            node["weights"] = _store(
                params_out, prefix, "w", obj.align_weights
            )
        return node
    if isinstance(obj, FeatureLayer):
        feats = []
        for f in obj.feature_list:
            d = {
                "name": f.name,
                "type": f.feature_type,
                "atom_indices": list(f.atom_indices),
            }
            if f.params:
                d["params"] = f.switch_params
            feats.append(d)
        node = {"kind": "features", "features": feats}
        if obj.box is not None:
            node["box"] = list(obj.box)
        return node
    if isinstance(obj, Sequential):
        return _mlp_node(obj.params, obj.activation, params_out, prefix,
                         "mlp")
    if isinstance(obj, EigenFunctions):
        return _mlp_node(obj.params, obj.activation, params_out, prefix,
                         "stacked_mlp")
    raise UnsupportedLayerError(
        f"no dependency-free spec for {type(obj).__name__}; the CV's "
        "parameters are still in cv_params.npz"
    )


def _state_ndim(node: dict) -> int:
    """Input rank of one state implied by the graph head node."""
    kind = node["kind"]
    if kind in ("alignment", "features"):
        return 2  # [N, 3] coordinates
    if kind == "compose":
        for stage in node["stages"]:
            if stage["kind"] != "identity":
                return _state_ndim(stage)
    return 1  # feature/state vector


def save_numpy_cv(cv_model: Any, out_dir: str) -> None:
    """Write ``cv_numpy_spec.json`` + ``cv_numpy.npz`` for a CV model, and
    from them the native program ``cv_native.bin``.

    The pair is evaluable by :func:`load_numpy_cv` with numpy alone.
    """
    os.makedirs(out_dir, exist_ok=True)
    params: dict[str, np.ndarray] = {}
    graph = build_spec(cv_model, params)
    spec = {
        "format": FORMAT,
        "state_ndim": _state_ndim(graph),
        "graph": graph,
    }
    with open(os.path.join(out_dir, SPEC_NAME), "w") as f:
        json.dump(spec, f, indent=1)
    np.savez(os.path.join(out_dir, PARAMS_NAME), **params)
    # engine-side binary program for the C++ evaluator (native/cveval.cpp);
    # a pure-Python re-encoding of the same graph, no compiler involved
    try:
        from .deploy_native import write_native_cv

        write_native_cv(out_dir)
    except Exception as e:  # artifact saving must not fail on this extra
        import warnings

        warnings.warn(f"native CV program not written: {e}")

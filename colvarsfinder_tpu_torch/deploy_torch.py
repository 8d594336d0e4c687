r"""TorchScript CV deployment: ``scripted_cv_cpu.pt``, the reference's own
artifact format.

Copied from the JAX package's ``colvarsfinder_tpu/deploy_torch.py`` (numpy
and torch only). The reference's deployment interface is a TorchScript
module ``scripted_cv_cpu.pt`` consumed by libtorch-based MD tooling
(openmm-torch, PLUMED's pytorch module, analysis scripts). This module
interprets the dependency-free spec graph that :func:`.deploy.build_spec`
produces (one node kind per layer family) as a tree of plain
``torch.nn.Module`` objects, scripts it with ``torch.jit.script`` (the batch
dimension stays polymorphic) and saves ``scripted_cv_cpu.pt``. Input
gradients, the biasing forces an MD engine needs, come from torch autograd.

Because the artifact is built from the spec and not from the live modules,
a CV trained with this package scripts to the same module as one trained
with the JAX package from the same parameters, and it always runs on the
CPU whatever device the CV was trained on.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np

__all__ = [
    "build_torch_cv",
    "export_torchscript_cv",
    "torchscript_from_numpy_cv",
]

SCRIPTED_NAME = "scripted_cv_cpu.pt"


def _torch():
    import torch

    return torch


# ---------------------------------------------------------------------------
# spec-node -> torch.nn.Module constructors
# ---------------------------------------------------------------------------


def _act_module(name: str):
    """Activation module matching the framework's activation registry
    (models/module.py) and the numpy evaluator's formulas (deploy.py)."""
    torch = _torch()
    nn = torch.nn
    table = {
        "tanh": nn.Tanh,
        "tanh_native": nn.Tanh,
        "relu": nn.ReLU,
        "elu": nn.ELU,
        "celu": nn.CELU,
        "sigmoid": nn.Sigmoid,
        "softplus": nn.Softplus,
        "identity": nn.Identity,
    }
    if name == "gelu":
        # the tanh approximation: the 'gelu' of both packages' models
        return nn.GELU(approximate="tanh")
    try:
        return table[name]()
    except KeyError:
        raise ValueError(f"no torch activation for '{name}'") from None


def _make_alignment(node: dict, params: dict):
    """Rigid Kabsch alignment onto a stored reference — same math as
    deploy._np_kabsch_align (ops.alignment.align_frames), torch SVD with the
    determinant-sign fix (differentiable, like molann's AlignmentLayer)."""
    torch = _torch()

    ref = np.asarray(params[node["ref"]], dtype=np.float64)
    idx = np.asarray(node["align_idx"], dtype=np.int64)
    m = idx.shape[0]
    if "weights" in node:
        w = np.asarray(params[node["weights"]], dtype=np.float64)
        wn = w / w.sum()
        ref_used = ref - np.einsum("m,mi->i", wn, ref)
        mult = w
    else:
        wn = np.full((m,), 1.0 / m)
        ref_used = ref
        mult = np.ones((m,))

    class _Alignment(torch.nn.Module):
        def __init__(self):
            super().__init__()
            # stored float64 (the precomputed centering/weight vectors carry
            # real arithmetic); forward casts to the input dtype, so a
            # .double() run reproduces the numpy f64 grad path exactly
            self.register_buffer("align_idx", torch.from_numpy(idx))
            self.register_buffer("ref_c", torch.from_numpy(ref_used))
            self.register_buffer("wn", torch.from_numpy(wn))
            self.register_buffer("mult", torch.from_numpy(mult))

        def forward(self, x):
            # x: [B, N, 3] -> aligned [B, N, 3]
            sel = x[:, self.align_idx, :]
            wn = self.wn.to(x.dtype)
            com = (wn.unsqueeze(0).unsqueeze(-1) * sel).sum(dim=1)
            x_c = x - com.unsqueeze(1)
            sel_c = (sel - com.unsqueeze(1)) * self.mult.to(x.dtype).unsqueeze(
                0
            ).unsqueeze(-1)
            # C[b, i, j] = sum_m sel_c[b, m, i] * ref_c[m, j]
            C = torch.matmul(sel_c.transpose(1, 2), self.ref_c.to(x.dtype))
            U, S, Vh = torch.linalg.svd(C)
            det = torch.linalg.det(torch.matmul(U, Vh))
            ones = torch.ones_like(det)
            D = torch.stack([ones, ones, det], dim=-1)
            R = torch.matmul(U * D.unsqueeze(1), Vh)
            return torch.matmul(x_c, R)

    return _Alignment()


def _feature_module(ftype: str, idx, params=None, box=None):
    torch = _torch()
    idx = [int(i) for i in np.asarray(idx).reshape(-1)]
    # minimum-image box for pair-distance features (None -> disabled);
    # the image shift is locally constant so autograd forces are exact
    box_t = (
        torch.tensor([float(v) for v in box], dtype=torch.float32)
        if box is not None
        else torch.zeros(0)
    )

    if ftype in ("contact", "coordination"):
        sw = dict(params)
        r0 = float(sw["r0"])
        d0 = float(sw["d0"])
        nn = int(sw["nn"])
        mm = int(sw["mm"])
        coord = ftype == "coordination"

        class _Switch(torch.nn.Module):
            """RATIONAL switching feature (mirror of
            ops.features.switching_rational incl. the series at x = 1)."""

            def __init__(self):
                super().__init__()
                self.register_buffer(
                    "ia", torch.tensor(idx[0::2], dtype=torch.int64)
                )
                self.register_buffer(
                    "ib", torch.tensor(idx[1::2], dtype=torch.int64)
                )
                self.register_buffer("box", box_t.clone())
                self.r0: float = r0
                self.d0: float = d0
                self.np_: int = nn
                self.mp_: int = mm
                self.coord: bool = coord

            def forward(self, x):
                d = x[:, self.ib, :] - x[:, self.ia, :]
                if self.box.numel() > 0:
                    b = self.box.to(d.dtype)
                    d = d - b * torch.round(d / b)
                r = torch.sqrt((d * d).sum(dim=-1))  # [B, P]
                xx = torch.clamp((r - self.d0) / self.r0, min=0.0)
                near1 = (xx - 1.0).abs() < 1e-8
                xs = torch.where(near1, torch.full_like(xx, 0.5), xx)
                s = (1.0 - xs**self.np_) / (1.0 - xs**self.mp_)
                lim = float(self.np_) / self.mp_ + self.np_ * (
                    self.np_ - self.mp_
                ) / (2.0 * self.mp_) * (xx - 1.0)
                s = torch.where(near1, lim, s)
                if self.coord:
                    return s.sum(dim=1, keepdim=True)
                return s

        return _Switch()

    if ftype == "position":

        class _Position(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.register_buffer(
                    "idx", torch.tensor(idx, dtype=torch.int64)
                )

            def forward(self, x):
                return x[:, self.idx, :].flatten(1)

        return _Position()

    if ftype == "bond":

        class _Bond(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.i0: int = idx[0]
                self.i1: int = idx[1]
                self.register_buffer("box", box_t.clone())

            def forward(self, x):
                d = x[:, self.i1, :] - x[:, self.i0, :]
                if self.box.numel() > 0:
                    b = self.box.to(d.dtype)
                    d = d - b * torch.round(d / b)
                return torch.sqrt((d * d).sum(dim=-1, keepdim=True))

        return _Bond()

    if ftype in ("angle", "angle_rad"):
        rad = ftype == "angle_rad"

        class _Angle(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.i0: int = idx[0]
                self.i1: int = idx[1]
                self.i2: int = idx[2]
                self.rad: bool = rad

            def forward(self, x):
                u = x[:, self.i0, :] - x[:, self.i1, :]
                v = x[:, self.i2, :] - x[:, self.i1, :]
                dot = (u * v).sum(dim=-1)
                if self.rad:
                    w = torch.cross(u, v, dim=-1)
                    s = torch.sqrt((w * w).sum(dim=-1))
                    return torch.atan2(s, dot).unsqueeze(-1)
                nu = torch.sqrt((u * u).sum(dim=-1))
                nv = torch.sqrt((v * v).sum(dim=-1))
                return (dot / (nu * nv)).unsqueeze(-1)

        return _Angle()

    if ftype in ("dihedral", "dihedral_rad"):
        rad = ftype == "dihedral_rad"

        class _Dihedral(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.i0: int = idx[0]
                self.i1: int = idx[1]
                self.i2: int = idx[2]
                self.i3: int = idx[3]
                self.rad: bool = rad

            def forward(self, x):
                b1 = x[:, self.i1, :] - x[:, self.i0, :]
                b2 = x[:, self.i2, :] - x[:, self.i1, :]
                b3 = x[:, self.i3, :] - x[:, self.i2, :]
                n1 = torch.cross(b1, b2, dim=-1)
                n2 = torch.cross(b2, b3, dim=-1)
                nb2 = torch.sqrt((b2 * b2).sum(dim=-1, keepdim=True))
                m1 = torch.cross(n1, b2 / nb2, dim=-1)
                c = (n1 * n2).sum(dim=-1)
                s = (m1 * n2).sum(dim=-1)
                if self.rad:
                    return torch.atan2(s, c).unsqueeze(-1)
                norm = torch.sqrt(c * c + s * s)
                return torch.stack([c / norm, s / norm], dim=-1)

        return _Dihedral()

    raise ValueError(f"unknown feature type '{ftype}'")


def _make_features(node: dict):
    torch = _torch()
    mods = [
        _feature_module(
            f["type"], f["atom_indices"], f.get("params"), node.get("box")
        )
        for f in node["features"]
    ]

    class _Features(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.feats = torch.nn.ModuleList(mods)

        def forward(self, x):
            outs = []
            for m in self.feats:
                outs.append(m(x))
            return torch.cat(outs, dim=1)

    return _Features()


def _make_mlp(node: dict, params: dict):
    """Feedforward net as torch.nn.Sequential of Linear + activation, the
    reference's own module layout (reference nn.py:29-58)."""
    torch = _torch()
    layers = []
    n = len(node["layers"])
    for i, (wk, bk) in enumerate(node["layers"]):
        w = np.array(params[wk], dtype=np.float32)
        lin = torch.nn.Linear(w.shape[1], w.shape[0])
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(w))
            lin.bias.copy_(
                torch.from_numpy(np.array(params[bk], dtype=np.float32))
            )
        layers.append(lin)
        if i < n - 1:
            layers.append(_act_module(node["activation"]))
    return torch.nn.Sequential(*layers)


def _make_stacked_mlp(node: dict, params: dict):
    """k-head ensemble net, weights [k, d_out, d_in] — the framework's
    stacked layout for EigenFunctions / RegModel heads, computed as batched
    matmuls over the head axis (output [B, k*d_out], heads concatenated
    like the reference's per-head ModuleList cat, reference nn.py:268-272)."""
    torch = _torch()

    class _StackedLinear(torch.nn.Module):
        def __init__(self, w: np.ndarray, b: np.ndarray):
            super().__init__()
            self.register_buffer(
                "w", torch.from_numpy(np.array(w, dtype=np.float32))
            )
            self.register_buffer(
                "b", torch.from_numpy(np.array(b, dtype=np.float32))
            )

        def forward(self, h):
            # h: [k, B, d_in] -> [k, B, d_out]
            return torch.matmul(
                h, self.w.to(h.dtype).transpose(1, 2)
            ) + self.b.to(h.dtype).unsqueeze(1)

    lins = [
        _StackedLinear(params[wk], params[bk]) for wk, bk in node["layers"]
    ]
    act = _act_module(node["activation"])
    k = int(np.asarray(params[node["layers"][0][0]]).shape[0])

    class _StackedMLP(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.layers = torch.nn.ModuleList(lins)
            self.act = act
            self.k: int = k
            self.n: int = len(lins)

        def forward(self, x):
            h = x.unsqueeze(0).expand(self.k, x.size(0), x.size(1))
            i = 0
            for m in self.layers:
                h = m(h)
                if i < self.n - 1:
                    h = self.act(h)
                i += 1
            return h.permute(1, 0, 2).reshape(x.size(0), -1)

    return _StackedMLP()


def _build_node(node: dict, params: dict):
    torch = _torch()
    kind = node["kind"]
    if kind == "identity":
        return torch.nn.Identity()
    if kind == "compose":
        mods = [_build_node(s, params) for s in node["stages"]]

        class _Compose(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.stages = torch.nn.ModuleList(mods)

            def forward(self, x):
                for m in self.stages:
                    x = m(x)
                return x

        return _Compose()
    if kind == "alignment":
        return _make_alignment(node, params)
    if kind == "features":
        return _make_features(node)
    if kind == "mlp":
        return _make_mlp(node, params)
    if kind == "stacked_mlp":
        return _make_stacked_mlp(node, params)
    raise ValueError(f"unknown spec node kind '{kind}'")


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def build_torch_cv(spec: dict, params: dict):
    """Plain ``torch.nn.Module`` evaluating a numpy-CV spec graph.

    Accepts batched input ([B, *state]) or a single state (*state), like
    :func:`.deploy.eval_spec`. The module is
    ``torch.jit.script``-compilable.
    """
    torch = _torch()
    root = _build_node(spec["graph"], params)
    state_ndim = int(spec.get("state_ndim", 1))

    class TorchCV(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net = root
            self.state_ndim: int = state_ndim

        def forward(self, x):
            if x.dim() == self.state_ndim:
                return self.net(x.unsqueeze(0)).squeeze(0)
            return self.net(x)

    return TorchCV()


def _spec_of(cv_model: Any):
    from .deploy import build_spec, _state_ndim

    params: dict[str, np.ndarray] = {}
    graph = build_spec(cv_model, params)
    return {"state_ndim": _state_ndim(graph), "graph": graph}, params


def export_torchscript_cv(cv_model: Any, out_dir: str) -> str:
    """Write the reference's deployment artifact ``scripted_cv_cpu.pt``
    (reference core.py:212-227) for a CV model of this package.

    The scripted module is consumable by any libtorch-based tool exactly
    like a reference-trained CV: load with ``torch.jit.load``, call on
    ``[B, *state]`` (or a single state), take ``torch.autograd.grad`` of a
    bias along the CV for forces.

    Args:
        cv_model: a :class:`.export.ColvarModel` (what
            ``task.colvar_model()`` returns) or any spec-supported pp layer
            / model module.
        out_dir: directory to place the artifact in.

    Returns:
        the path of the written ``.pt`` file.

    Raises:
        :class:`.deploy.UnsupportedLayerError` for CV components with no
        dependency-free representation (``Lambda``, ``FusedAlignmentLayer``).
    """
    torch = _torch()
    spec, params = _spec_of(cv_model)
    scripted = torch.jit.script(build_torch_cv(spec, params))
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, SCRIPTED_NAME)
    scripted.save(path)
    return path


def torchscript_from_numpy_cv(artifact_dir: str, out_dir: str | None = None) -> str:
    """Convert a saved numpy-CV artifact (``cv_numpy_spec.json`` +
    ``cv_numpy.npz``, see :func:`.deploy.save_numpy_cv`) into
    ``scripted_cv_cpu.pt``, from the artifact alone, on a deployment host
    without this package's models.
    """
    import json

    from .deploy import FORMAT, PARAMS_NAME, SPEC_NAME

    torch = _torch()
    with open(os.path.join(artifact_dir, SPEC_NAME)) as f:
        spec = json.load(f)
    if spec.get("format") != FORMAT:
        raise ValueError(f"not a {FORMAT} artifact: {spec.get('format')!r}")
    with np.load(os.path.join(artifact_dir, PARAMS_NAME)) as data:
        params = {k: data[k] for k in data.files}
    scripted = torch.jit.script(build_torch_cv(spec, params))
    out_dir = artifact_dir if out_dir is None else out_dir
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, SCRIPTED_NAME)
    scripted.save(path)
    return path

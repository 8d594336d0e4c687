r"""Molecular feature transforms (port of
``colvarsfinder_tpu/ops/features.py``; ``coordination_pairs`` is copied
from its :147).

Parameter-free ``nn.Module`` layers mapping coordinates ``[batch, N, 3]`` to
features ``[batch, d_r]``, differentiable w.r.t. the input. Feature types
and encodings are those of the JAX package:

==================  ==============  =======================================
type                output dim      value
==================  ==============  =======================================
``position``        3 * n_atoms     flattened coordinates
``bond``            1               distance |r_ab|
``angle``           1               cosine of the angle a-b-c
``angle_rad``       1               the angle a-b-c in radians
``dihedral``        2               (cos phi, sin phi) of a-b-c-d
``dihedral_rad``    1               the torsion a-b-c-d in radians
``contact``         1               rational switching s(|r_ab|)
``coordination``    1               sum of s(|r_ab|) over a pair list
==================  ==============  =======================================

A run of two or more consecutive ``bond`` features is evaluated as one
pair list (:func:`pair_distances`): one int32 ``[P, 2]`` index buffer,
which the plain version and the kernel both read, and one gathered
evaluation for the run, in place of one of each per distance. On a CUDA
tensor without a box that evaluation is kernel K5
(:func:`.pair_cuda.pair_distances_cuda`). The recorder counts the
distances in ``cvf.features.pairs_grouped`` (B P per grouped evaluation)
and ``cvf.features.pairs_single`` (B per lone ``bond`` evaluated on its
own).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..logging_utils import count

__all__ = [
    "Feature",
    "FeatureLayer",
    "Identity",
    "Lambda",
    "PreprocessingANN",
    "as_pp_layer",
    "bend_angle",
    "bend_angle_cos",
    "bond_length",
    "coordination_pairs",
    "dihedral_angle",
    "dihedral_cos_sin",
    "minimum_image",
    "pair_distances",
    "switching_rational",
]


def bond_length(ra, rb):
    """|r_ab| for coordinates [..., 3]."""
    d = rb - ra
    return torch.sqrt((d * d).sum(dim=-1))


def bend_angle_cos(ra, rb, rc):
    """cos of the bend angle at b formed by a-b-c."""
    u = ra - rb
    v = rc - rb
    nu = torch.sqrt((u * u).sum(dim=-1))
    nv = torch.sqrt((v * v).sum(dim=-1))
    return (u * v).sum(dim=-1) / (nu * nv)


def bend_angle(ra, rb, rc):
    """Bend angle at b in radians, via atan2."""
    u = ra - rb
    v = rc - rb
    cross = torch.linalg.cross(u, v)
    sin_t = torch.sqrt((cross * cross).sum(dim=-1))
    cos_t = (u * v).sum(dim=-1)
    return torch.atan2(sin_t, cos_t)


def _dihedral_cos_sin(ra, rb, rc, rd):
    b1 = rb - ra
    b2 = rc - rb
    b3 = rd - rc
    n1 = torch.linalg.cross(b1, b2)
    n2 = torch.linalg.cross(b2, b3)
    m1 = torch.linalg.cross(n1, b2 / torch.linalg.norm(b2, dim=-1, keepdim=True))
    x = (n1 * n2).sum(dim=-1)
    y = (m1 * n2).sum(dim=-1)
    norm = torch.sqrt(x * x + y * y)
    return x / norm, y / norm


def dihedral_cos_sin(ra, rb, rc, rd):
    """(cos phi, sin phi) of the torsion a-b-c-d (IUPAC sign convention)."""
    c, s = _dihedral_cos_sin(ra, rb, rc, rd)
    return torch.stack([c, s], dim=-1)


def dihedral_angle(ra, rb, rc, rd):
    """Torsion angle in radians in (-pi, pi]."""
    c, s = _dihedral_cos_sin(ra, rb, rc, rd)
    return torch.atan2(s, c)


def switching_rational(r, r0, d0=0.0, nn=6, mm=12):
    """PLUMED RATIONAL switching s = (1 - x^nn) / (1 - x^mm),
    x = max(0, (r - d0) / r0); the removable singularity at x = 1 is taken
    by its first-order series."""
    nn, mm = int(nn), int(mm)
    x = torch.clamp((r - d0) / r0, min=0.0)
    near1 = (x - 1.0).abs() < 1e-8
    xs = torch.where(near1, torch.full_like(x, 0.5), x)
    s = (1.0 - xs**nn) / (1.0 - xs**mm)
    lim = nn / mm + nn * (nn - mm) / (2.0 * mm) * (x - 1.0)
    return torch.where(near1, lim, s)


def minimum_image(d: torch.Tensor, box) -> torch.Tensor:
    """Minimum-image displacement for an orthogonal box (lengths [3])."""
    b = torch.as_tensor(box, dtype=d.dtype, device=d.device)
    return d - b * torch.round(d / b)


def coordination_pairs(group_a, group_b):
    """Flattened all-cross pair list (i1, j1, i2, j2, ...) between two
    atom groups, skipping self-pairs — the atom_indices for a
    ``'coordination'`` Feature with PLUMED ``GROUPA``/``GROUPB``
    (non-PAIR) semantics. Accepts MDAnalysis AtomGroup-likes."""
    ga = [int(i) for i in np.asarray(getattr(group_a, "ix", group_a)).reshape(-1)]
    gb = [int(j) for j in np.asarray(getattr(group_b, "ix", group_b)).reshape(-1)]
    out = []
    for i in ga:
        for j in gb:
            if i != j:
                out.extend((i, j))
    if not out:
        raise ValueError("coordination_pairs produced an empty pair list")
    return tuple(out)


_FEATURE_ARITY = {
    "position": None,
    "bond": 2,
    "angle": 3,
    "angle_rad": 3,
    "dihedral": 4,
    "dihedral_rad": 4,
    "contact": 2,
    "coordination": None,
}

_SWITCH_TYPES = ("contact", "coordination")


def _canonical_switch_params(params) -> Tuple[Tuple[str, float], ...]:
    p = dict(params or {})
    unknown = set(p) - {"r0", "d0", "nn", "mm"}
    if unknown:
        raise ValueError(f"unknown switching params {sorted(unknown)}")
    if "r0" not in p:
        raise ValueError(
            "contact/coordination features require params={'r0': ...} "
            "(the RATIONAL switching radius)"
        )
    r0 = float(p["r0"])
    if r0 <= 0:
        raise ValueError(f"switching r0 must be > 0, got {r0}")
    d0 = float(p.get("d0", 0.0))
    nn_ = int(p.get("nn", 6))
    mm = int(p.get("mm", 2 * nn_))
    if nn_ <= 0 or mm <= nn_:
        raise ValueError(f"switching exponents need 0 < nn < mm, got {nn_},{mm}")
    return (("d0", d0), ("mm", mm), ("nn", nn_), ("r0", r0))


@dataclasses.dataclass(frozen=True)
class Feature:
    """Specification of one feature (molann ``Feature`` equivalent).

    Args:
        name: label
        feature_type: one of the types in the module docstring
        atom_indices: column indices of the participating atoms in the
            ``[batch, N, 3]`` input (an AtomGroup is accepted); for
            'coordination' a flat pair list (i1, j1, i2, j2, ...)
        params: switching parameters for 'contact'/'coordination'
    """

    name: str
    feature_type: str
    atom_indices: Tuple[int, ...]
    params: Tuple[Tuple[str, float], ...]

    def __init__(self, name, feature_type, atom_indices, params=None):
        ft = feature_type.lower()
        if ft not in _FEATURE_ARITY:
            raise ValueError(
                f"unknown feature type '{feature_type}'; "
                f"known: {sorted(_FEATURE_ARITY)}"
            )
        ix = getattr(atom_indices, "ix", atom_indices)
        idx = tuple(int(i) for i in np.asarray(ix).reshape(-1))
        arity = _FEATURE_ARITY[ft]
        if arity is not None and len(idx) != arity:
            raise ValueError(f"feature '{ft}' needs {arity} atoms, got {len(idx)}")
        if ft == "coordination" and (len(idx) < 2 or len(idx) % 2):
            raise ValueError(
                "'coordination' needs a flat even-length pair list "
                f"(i1, j1, i2, j2, ...), got {len(idx)} indices"
            )
        if ft in _SWITCH_TYPES:
            sw = _canonical_switch_params(params)
        else:
            if params:
                raise ValueError(f"feature '{ft}' takes no params")
            sw = ()
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "feature_type", ft)
        object.__setattr__(self, "atom_indices", idx)
        object.__setattr__(self, "params", sw)

    @property
    def switch_params(self) -> dict:
        return dict(self.params)

    @property
    def output_dim(self) -> int:
        if self.feature_type == "position":
            return 3 * len(self.atom_indices)
        if self.feature_type == "dihedral":
            return 2
        return 1


def _pair_distance(ra, rb, box):
    d = rb - ra
    if box is not None:
        d = minimum_image(d, box)
    return torch.sqrt((d * d).sum(dim=-1))


def pair_distances(x: torch.Tensor, pairs: torch.Tensor,
                   box=None) -> torch.Tensor:
    """|r_j - r_i| [B, P] of the frames ``x`` [B, N, 3] for every row (i, j)
    of ``pairs`` [P, 2] (int32 or int64), with the minimum image where
    ``box`` is given: the plain grouped evaluation, the CPU route and the
    reference of kernel K5."""
    return _pair_distance(x.index_select(1, pairs[:, 0]),
                          x.index_select(1, pairs[:, 1]), box)


def _grouped_distances(x, pairs, max_index: int, box):
    """:func:`pair_distances`, through kernel K5 on a CUDA tensor without
    a box; with a box (the kernel has no minimum image) or on the CPU, the
    plain grouped evaluation."""
    if box is None and x.is_cuda:
        from .pair_cuda import pair_distances_cuda  # it imports this module

        return pair_distances_cuda(x, pairs, max_index)
    return pair_distances(x, pairs, box)


class FeatureLayer(nn.Module):
    """Map coordinates [batch, N, 3] to features [batch, d_r] (molann
    ``FeatureLayer`` equivalent).

    Args:
        feature_list: the Feature specs.
        input_ag: optional training atom selection; features holding global
            topology indices are remapped to input columns.
        box: optional orthogonal box lengths; pair-distance features then
            use the minimum image.
    """

    def __init__(self, feature_list: Sequence[Feature], input_ag=None,
                 box=None):
        super().__init__()
        if len(feature_list) == 0:
            raise ValueError("feature_list must not be empty")
        if box is not None:
            box = tuple(float(v) for v in np.asarray(box).reshape(-1))
            if len(box) != 3 or any(v <= 0 for v in box):
                raise ValueError(
                    f"box must be 3 positive orthogonal lengths, got {box}"
                )
        if input_ag is not None and hasattr(input_ag, "ix"):
            lookup = {int(g): j for j, g in enumerate(np.asarray(input_ag.ix))}
            remapped = []
            for f in feature_list:
                try:
                    rel = tuple(lookup[int(i)] for i in f.atom_indices)
                except KeyError as e:
                    raise ValueError(
                        f"feature '{f.name}' references atom {e} which is "
                        "not part of input_ag"
                    ) from None
                remapped.append(
                    Feature(f.name, f.feature_type, rel, f.switch_params or None)
                )
            feature_list = remapped
        self.feature_list = tuple(feature_list)
        self.box = box
        # the order of evaluation: ("pairs", g) for the g-th run of two or
        # more consecutive bonds, ("one", n) for any other feature n
        self._plan = []
        #: (first feature, number of pairs) of each grouped run of bonds
        self.pair_groups = ()
        self._pair_max = ()  # each group's largest atom index
        run: list = []
        for n, f in enumerate(self.feature_list + (None,)):
            if f is not None and f.feature_type == "bond":
                run.append(n)
                continue
            if len(run) >= 2:
                self._add_pair_group(run)
            else:
                self._plan.extend(("one", i) for i in run)
            run = []
            if f is not None:
                self._plan.append(("one", n))
        # index tensors live on the layer's device, so evaluation never
        # copies indices from the host
        for kind, n in self._plan:
            if kind == "one":
                f = self.feature_list[n]
                self.register_buffer(
                    f"_idx{n}",
                    torch.as_tensor(f.atom_indices, dtype=torch.int64),
                    persistent=False,
                )

    def _add_pair_group(self, run: list) -> None:
        g = len(self.pair_groups)
        pairs = np.array([self.feature_list[n].atom_indices for n in run],
                         dtype=np.int32)
        self.register_buffer(f"_pairs{g}", torch.as_tensor(pairs),
                             persistent=False)
        self._plan.append(("pairs", g))
        self.pair_groups += ((run[0], len(run)),)
        self._pair_max += (int(pairs.max()),)

    @property
    def output_dimension(self) -> int:
        return sum(f.output_dim for f in self.feature_list)

    def _eval_feature(self, n: int, feat: Feature, x: torch.Tensor):
        idx_t = getattr(self, f"_idx{n}")
        idx = feat.atom_indices
        ft = feat.feature_type
        if ft == "position":
            return x.index_select(1, idx_t).reshape(x.shape[0], -1)
        if ft in _SWITCH_TYPES:
            p = feat.switch_params
            ra = x.index_select(1, idx_t[0::2])
            rb = x.index_select(1, idx_t[1::2])
            s = switching_rational(
                _pair_distance(ra, rb, self.box), p["r0"], p["d0"], p["nn"],
                p["mm"],
            )
            if ft == "coordination":
                return s.sum(dim=1, keepdim=True)
            return s
        a, b = x[:, idx[0], :], x[:, idx[1], :]
        if ft == "bond":
            count("cvf.features.pairs_single", x.shape[0])
            return _pair_distance(a, b, self.box)[:, None]
        c = x[:, idx[2], :]
        if ft == "angle":
            return bend_angle_cos(a, b, c)[:, None]
        if ft == "angle_rad":
            return bend_angle(a, b, c)[:, None]
        d = x[:, idx[3], :]
        if ft == "dihedral":
            return dihedral_cos_sin(a, b, c, d)
        return dihedral_angle(a, b, c, d)[:, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        squeeze = x.dim() == 2
        if squeeze:
            x = x[None]
        feats = [
            self._eval_pairs(n, x) if kind == "pairs"
            else self._eval_feature(n, self.feature_list[n], x)
            for kind, n in self._plan
        ]
        # one grouped run alone is the output as it is, with no copy
        out = feats[0] if len(feats) == 1 else torch.cat(feats, dim=1)
        return out[0] if squeeze else out

    def _eval_pairs(self, g: int, x: torch.Tensor) -> torch.Tensor:
        pairs = getattr(self, f"_pairs{g}")
        count("cvf.features.pairs_grouped", x.shape[0] * pairs.shape[0])
        return _grouped_distances(x, pairs, self._pair_max[g], self.box)

    def get_feature_info(self):
        import pandas as pd

        return pd.DataFrame(
            [
                {"name": f.name, "type": f.feature_type,
                 "atom_indices": f.atom_indices, "dim": f.output_dim}
                for f in self.feature_list
            ]
        )


class Identity(nn.Module):
    """Identity preprocessing layer."""

    def forward(self, x):
        return x


class Lambda(nn.Module):
    """Wrap a plain tensor function as a preprocessing layer."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


class PreprocessingANN(nn.Module):
    """r(x) = feature_layer(alignment_layer(x)); either stage may be None."""

    def __init__(self, alignment_layer, feature_layer):
        super().__init__()
        self.alignment_layer = alignment_layer
        self.feature_layer = feature_layer

    @property
    def output_dimension(self) -> int:
        return self.feature_layer.output_dimension

    def forward(self, x):
        if self.alignment_layer is not None:
            x = self.alignment_layer(x)
        if self.feature_layer is not None:
            x = self.feature_layer(x)
        return x


def as_pp_layer(pp_layer) -> nn.Module:
    """Normalize a preprocessing layer to an ``nn.Module``: None becomes
    :class:`Identity`, a plain callable is wrapped in :class:`Lambda`."""
    if pp_layer is None:
        return Identity()
    if isinstance(pp_layer, nn.Module):
        return pp_layer
    if callable(pp_layer):
        return Lambda(pp_layer)
    raise TypeError(f"preprocessing layer must be callable, got {pp_layer!r}")

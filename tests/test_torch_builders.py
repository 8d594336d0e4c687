"""PyTorch port, the feature builders and the feature functions the port
now exports: ``backbone_dihedrals``, ``heavy_atom_contacts`` (every switch)
and ``coordination_pairs`` give the JAX package's Feature lists on the same
topology, and ``bond_length`` ... ``minimum_image`` equal its functions in
float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colvarsfinder_tpu import config as jconfig
from colvarsfinder_tpu import ops as jops
from colvarsfinder_tpu.utils import io as jio

from colvarsfinder_tpu_torch import ops as tops
from colvarsfinder_tpu_torch.utils import io as tio

NAMES = ["HH31", "CH3", "HH32", "HH33", "C", "O",
         "N", "H", "CA", "HA", "CB", "HB1", "HB2", "HB3", "C", "O",
         "N", "H", "CH3", "HH31", "HH32", "HH33"]


def _topology(mod, n_res=1):
    """ACE-(ALA)n-NME: n_res alanines between the caps, 0.15 nm apart
    along a zigzag."""
    ala = NAMES[6:16]
    names = NAMES[:6] + ala * n_res + NAMES[16:]
    resids = [1] * 6 + [r for r in range(2, 2 + n_res) for _ in ala] + [
        2 + n_res] * 6
    resnames = ["ACE"] * 6 + ["ALA"] * (10 * n_res) + ["NME"] * 6
    i = np.arange(len(names))
    pos = np.stack([0.15 * i, 0.1 * (i % 2), 0.02 * (i % 3)], 1)
    return mod.Topology(names=names, resids=resids, resnames=resnames,
                        positions=pos.astype(np.float32))


def _same_features(got, want):
    assert [(f.name, f.feature_type, f.atom_indices, f.params)
            for f in got] == [(f.name, f.feature_type, f.atom_indices,
                               f.params) for f in want]


@pytest.mark.parametrize("kind", ["dihedral", "dihedral_rad"])
@pytest.mark.parametrize("n_res", [1, 3])
def test_backbone_dihedrals_match_jax(kind, n_res):
    t, j = _topology(tio, n_res), _topology(jio, n_res)
    got = tops.backbone_dihedrals(t.atoms, kind=kind)
    _same_features(got, jops.backbone_dihedrals(j.atoms, kind=kind))
    if n_res == 1:
        assert {f.name: f.atom_indices for f in got} == {
            "phi_2": (4, 6, 8, 14), "psi_2": (6, 8, 14, 16)}
    for mod, top in ((tops, t), (jops, j)):
        with pytest.raises(ValueError, match="kind"):
            mod.backbone_dihedrals(top.atoms, kind="angle")
        with pytest.raises(ValueError, match="no backbone"):
            mod.backbone_dihedrals(top.select_atoms("resname ACE"))


@pytest.mark.parametrize("kw", [
    {},
    dict(cutoff=2.0),
    dict(min_resid_sep=None),
    dict(min_resid_sep=1, cutoff=0.5),
    dict(r0=0.3, d0=0.05, nn=8, mm=14),
    dict(as_coordination=True),
    dict(as_coordination=True, cutoff=2.5, mm=10),
    dict(second="resname NME"),
    dict(second="resname NME", min_resid_sep=None, as_coordination=True),
])
def test_heavy_atom_contacts_match_jax(kw):
    kw = dict(kw)
    second = kw.pop("second", None)
    out = []
    for ops, io in ((tops, tio), (jops, jio)):
        top = _topology(io, 3)
        a = top.select_atoms("not resname NME") if second else top.atoms
        b = top.select_atoms(second) if second else None
        out.append(ops.heavy_atom_contacts(a, b, **kw))
    _same_features(*out)
    for ops, io in ((tops, tio), (jops, jio)):
        with pytest.raises(ValueError, match="no contact pairs"):
            ops.heavy_atom_contacts(_topology(io).atoms, cutoff=1e-3)


def test_coordination_pairs_match_jax():
    t, j = _topology(tio, 2), _topology(jio, 2)
    for a, b in (("resid 2", "resid 3"), ("type C", "type N O"),
                 ("name CA", "name CA")):
        got = tops.coordination_pairs(t.select_atoms(a), t.select_atoms(b))
        assert got == jops.coordination_pairs(j.select_atoms(a),
                                              j.select_atoms(b))
        assert all(type(i) is int for i in got)
    assert tops.coordination_pairs([0, 1], np.array([1, 2])) == (0, 1, 0, 2,
                                                                 1, 2)
    for ops in (tops, jops):
        with pytest.raises(ValueError, match="empty pair list"):
            ops.coordination_pairs([3], [3])


@pytest.fixture
def jax_float64():
    jconfig.set_default_dtype("float64")
    yield
    jconfig.set_default_dtype("float32")


@pytest.mark.parametrize("name,n_args,kw", [
    ("bond_length", 2, {}),
    ("bend_angle_cos", 3, {}),
    ("bend_angle", 3, {}),
    ("dihedral_angle", 4, {}),
    ("dihedral_cos_sin", 4, {}),
    ("switching_rational", 1, dict(r0=0.8, d0=0.1, nn=6, mm=12)),
    ("minimum_image", 1, dict(box=(1.5, 2.0, 2.5))),
])
def test_exported_feature_functions_match_jax(name, n_args, kw, jax_float64):
    assert name in tops.__all__
    rng = np.random.default_rng(5)
    args = [rng.standard_normal((64, 3)) * 2.0 for _ in range(n_args)]
    if name == "switching_rational":
        # around r0 + d0 too, where the series takes over
        args = [np.concatenate([np.abs(rng.standard_normal(60)) * 2.0,
                                0.9 + np.array([0.0, 1e-9, -1e-9, 0.5])])]
    got = getattr(tops, name)(*[torch.from_numpy(a) for a in args], **kw)
    want = getattr(jops, name)(*[jnp.asarray(a) for a in args], **kw)
    if name == "dihedral_cos_sin":
        want = jnp.stack(want, axis=-1) if isinstance(want, tuple) else want
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)

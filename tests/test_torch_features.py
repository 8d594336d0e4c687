"""PyTorch port, feature layers against the JAX package: every feature type
on the same numpy frames, with and without a periodic box, runs of
consecutive bonds (which the port evaluates as one pair list) in value and
input gradient, and the PreprocessingANN composition of alignment and
features."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colvarsfinder_tpu.ops import alignment as jal
from colvarsfinder_tpu.ops import features as jft

from colvarsfinder_tpu_torch.ops import alignment as tal
from colvarsfinder_tpu_torch.ops import features as tft
from colvarsfinder_tpu_torch.ops.kabsch_cuda import FusedAlignmentLayer

SPECS = [
    ("position", (0, 2, 5), None),
    ("bond", (1, 4), None),
    ("angle", (0, 1, 2), None),
    ("angle_rad", (3, 1, 2), None),
    ("dihedral", (0, 1, 2, 3), None),
    ("dihedral_rad", (2, 3, 4, 5), None),
    ("contact", (0, 5), {"r0": 1.5}),
    ("coordination", (0, 3, 1, 4, 2, 5), {"r0": 1.2, "nn": 4, "mm": 10}),
]


# feature lists with runs of consecutive bonds: every pair of 6 atoms (one
# run), and runs of three and two beside a lone bond and other types
RUNS = {
    "all_pairs": [("bond", p, None)
                  for p in itertools.combinations(range(6), 2)],
    "mixed": [
        ("angle", (0, 1, 2), None),
        ("bond", (0, 1), None),
        ("bond", (1, 2), None),
        ("bond", (0, 3), None),
        ("dihedral", (0, 1, 2, 3), None),
        ("bond", (2, 4), None),
        ("contact", (1, 4), {"r0": 1.5}),
        ("bond", (3, 5), None),
        ("bond", (5, 2), None),
    ],
}


def _x(B=23, N=6, seed=0):
    return np.random.default_rng(seed).standard_normal((B, N, 3)).astype(
        np.float32)


@pytest.mark.parametrize("box", [None, (2.5, 3.0, 3.5)])
@pytest.mark.parametrize("ftype,idx,params", SPECS)
def test_feature_matches_jax(ftype, idx, params, box):
    x = _x()
    jl = jft.FeatureLayer([jft.Feature("f", ftype, idx, params)], box=box)
    tl = tft.FeatureLayer([tft.Feature("f", ftype, idx, params)], box=box)
    out_j = np.asarray(jl(jnp.asarray(x)))
    out_t = tl(torch.from_numpy(x)).numpy()
    assert tl.output_dimension == jl.output_dimension == out_j.shape[1]
    # f32 elementwise geometry in two libraries
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("box", [None, (2.5, 3.0, 3.5)])
@pytest.mark.parametrize("run", sorted(RUNS))
def test_runs_of_bonds_match_jax(run, box):
    """The port's grouped pair distances against the JAX layer's one
    distance per feature: values and the gradient w.r.t. the frames."""
    x = _x(seed=2)
    specs = RUNS[run]
    jl = jft.FeatureLayer([jft.Feature(f"f{i}", *s)
                           for i, s in enumerate(specs)], box=box)
    tl = tft.FeatureLayer([tft.Feature(f"f{i}", *s)
                           for i, s in enumerate(specs)], box=box)
    assert tl.pair_groups  # the grouped evaluation is taken
    cot = np.random.default_rng(3).standard_normal(
        (x.shape[0], jl.output_dimension)).astype(np.float32)
    out_j, vjp = jax.vjp(jl, jnp.asarray(x))
    (grad_j,) = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_()
    out_t = tl(xt)
    (grad_t,) = torch.autograd.grad(out_t, xt, torch.from_numpy(cot))
    assert out_t.shape == out_j.shape
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad_t.numpy(), np.asarray(grad_j),
                               rtol=1e-4, atol=1e-4)


def test_preprocessing_ann_matches_jax():
    x = _x(B=31, N=7, seed=1)
    ref = x[0, :5]
    feats = [("position", tuple(range(7)), None), ("bond", (0, 6), None)]
    j_pp = jft.PreprocessingANN(
        jal.AlignmentLayer(ref, list(range(5))),
        jft.FeatureLayer([jft.Feature(f"f{i}", *s) for i, s in
                          enumerate(feats)]),
    )
    for align in (tal.AlignmentLayer(ref, list(range(5))),
                  FusedAlignmentLayer(ref, list(range(5)))):
        t_pp = tft.PreprocessingANN(
            align,
            tft.FeatureLayer([tft.Feature(f"f{i}", *s) for i, s in
                              enumerate(feats)]),
        )
        assert t_pp.output_dimension == 22
        np.testing.assert_allclose(
            t_pp(torch.from_numpy(x)).numpy(), np.asarray(j_pp(jnp.asarray(x))),
            atol=2e-5,
        )


def test_as_pp_layer():
    assert isinstance(tft.as_pp_layer(None), tft.Identity)
    lam = tft.as_pp_layer(lambda z: 2 * z)
    assert isinstance(lam, tft.Lambda)
    assert torch.equal(lam(torch.ones(2)), torch.full((2,), 2.0))
    with pytest.raises(TypeError):
        tft.as_pp_layer(3)
    with pytest.raises(ValueError, match="needs 2 atoms"):
        tft.Feature("b", "bond", (0, 1, 2))

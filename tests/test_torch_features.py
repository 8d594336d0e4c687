"""PyTorch port, feature layers against the JAX package: every feature type
on the same numpy frames, with and without a periodic box, and the
PreprocessingANN composition of alignment and features."""

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

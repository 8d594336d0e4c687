"""PyTorch port, models: EigenFunctions and the exp-form tanh against the
JAX package, with the JAX model's parameters transplanted."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colvarsfinder_tpu.models import EigenFunctions as JaxEigenFunctions
from colvarsfinder_tpu.models.module import _tanh_precise as jax_tanh

from colvarsfinder_tpu_torch.models import EigenFunctions
from colvarsfinder_tpu_torch.models.module import _tanh_precise


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_params(model):
    return [{"weight": np.asarray(p["weight"]), "bias": np.asarray(p["bias"])}
            for p in model.params]


@pytest.mark.parametrize("k,dims", [(1, [5, 7, 1]), (3, [12, 10, 10, 1])])
def test_eigenfunctions_forward_matches_jax(k, dims):
    jm = JaxEigenFunctions(dims, k, seed=3)
    tm = EigenFunctions.from_numpy(_np_params(jm), device="cpu")
    x = np.random.default_rng(0).standard_normal((64, dims[0])).astype(np.float32)
    y_j = np.asarray(jm(jnp.asarray(x)))
    y_t = tm(torch.from_numpy(x)).detach().numpy()
    assert y_t.shape == (64, k)
    # f32 products of a few layers in two libraries: rounding order only
    np.testing.assert_allclose(y_t, y_j, atol=1e-6)
    # a single state, like torch.nn.Linear on a vector
    np.testing.assert_allclose(
        tm(torch.from_numpy(x[0])).detach().numpy(), y_j[0], atol=1e-6
    )


def test_from_numpy_and_cv_params():
    jm = JaxEigenFunctions([4, 6, 1], 2, seed=1)
    tm = EigenFunctions.from_numpy(_np_params(jm))
    assert tm.layer_dims == (4, 6, 1) and tm.k == 2
    for (name_j, p_j), (name_t, p_t) in zip(jm.get_params_of_cv(1),
                                            tm.get_params_of_cv(1)):
        assert name_j == name_t
        np.testing.assert_array_equal(np.asarray(p_j), p_t.detach().numpy())


def test_reordered_matches_jax():
    jm = JaxEigenFunctions([6, 8, 8, 1], 3, seed=2)
    tm = EigenFunctions.from_numpy(_np_params(jm))
    cvec = [2, 0, 1]
    x = np.random.default_rng(1).standard_normal((10, 6)).astype(np.float32)
    y_j = np.asarray(jm.reordered(cvec)(jnp.asarray(x)))
    y_t = tm.reordered(cvec)(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(y_t, y_j, atol=1e-6)
    np.testing.assert_allclose(
        y_t, tm(torch.from_numpy(x)).detach().numpy()[:, cvec], atol=0
    )
    with pytest.raises(ValueError, match="permutation"):
        tm.reordered([0, 0, 1])


def test_init_is_seeded_and_in_bounds():
    a = EigenFunctions([9, 5, 1], 2, seed=7)
    b = EigenFunctions([9, 5, 1], 2, seed=7)
    c = EigenFunctions([9, 5, 1], 2, seed=8)
    for pa, pb, pc in zip(a.parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb) and not torch.equal(pa, pc)
    assert a.weights[0].abs().max() <= 1 / 3  # U(+-1/sqrt(9))
    assert a.weights[0].shape == (2, 5, 9) and a.biases[1].shape == (2, 1)


def test_tanh_precise_matches_jax():
    x = np.concatenate([
        np.linspace(-30, 30, 2001), [0.0, 1e-8, -1e-8, 19.9, 20.1]
    ]).astype(np.float32)
    t = _tanh_precise(torch.from_numpy(x)).numpy()
    j = np.asarray(jax_tanh(jnp.asarray(x)))
    # same f32 formula in both libraries; exp may differ by an ulp
    np.testing.assert_allclose(t, j, atol=2e-7)
    np.testing.assert_allclose(t, np.tanh(x.astype(np.float64)), atol=3e-6)
    # the clip zeroes the gradient outside [-20, 20]
    xt = torch.tensor([-25.0, 0.0, 25.0], requires_grad=True)
    _tanh_precise(xt).sum().backward()
    assert xt.grad[0] == 0 and xt.grad[2] == 0 and xt.grad[1] == 1

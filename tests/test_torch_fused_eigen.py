"""PyTorch port, fused transfer-operator statistics: transfer_stats (the
plain version of kernels K3/K4 on CPU tensors) against the JAX
transfer_stats, whose Pallas kernels run in interpret mode here as in
test_fused_eigen; parameter gradients against jax.grad; the loss from the
stats against the JAX eigen_loss. The JAX model's parameters are
transplanted into the port's model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colvarsfinder_tpu.core.losses import eigen_loss as jax_eigen_loss
from colvarsfinder_tpu.models import EigenFunctions as JaxEigenFunctions
from colvarsfinder_tpu.ops import fused_eigen as jfe

from colvarsfinder_tpu_torch.models import EigenFunctions
from colvarsfinder_tpu_torch.ops import _cuda
from colvarsfinder_tpu_torch.ops import fused_eigen as tfe


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(k, B=700, d=12, seed=0):
    rng = np.random.default_rng(seed)
    jm = JaxEigenFunctions([d, 10, 10, 1], k, seed=seed)
    tm = EigenFunctions.from_numpy(
        [{n: np.asarray(v) for n, v in p.items()} for p in jm.params]
    )
    data = [rng.standard_normal((B, d)), rng.standard_normal((B, d)),
            rng.uniform(0.5, 1.5, B), rng.uniform(0.5, 1.5, B)]
    data = [a.astype(np.float32) for a in data]
    return jm, tm, data


def _jax_data(data):
    return [jnp.asarray(a) for a in data]


def _torch_data(data):
    return [torch.from_numpy(a) for a in data]


@pytest.mark.parametrize("k", [1, 2, 3])
def test_stats_match_jax_kernel(k):
    jm, tm, data = _setup(k)
    _cuda.reset_launch_counts()
    s_t = tfe.transfer_stats(tfe.params_t_of(tm), *_torch_data(data))
    assert _cuda.LAUNCHES["stats_fwd"] == 0  # CPU tensors: plain version
    s_j = jfe.transfer_stats(jfe.params_t_of(jm), *_jax_data(data))
    n_stats, _ = tfe.stats_layout(k)
    assert s_t.shape == (n_stats,)
    # the JAX package's kernel-vs-oracle bar: f32 sums in another order
    np.testing.assert_allclose(s_t.detach().numpy(), np.asarray(s_j),
                               rtol=5e-6, atol=1e-4)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_param_grads_match_jax(k):
    jm, tm, data = _setup(k, seed=k)
    coef = np.random.default_rng(1).standard_normal(
        tfe.stats_layout(k)[0]).astype(np.float32)

    g_j = jax.grad(
        lambda p: (coef * jfe.transfer_stats(p, *_jax_data(data))).sum()
    )(jfe.params_t_of(jm))
    s_t = tfe.transfer_stats(tfe.params_t_of(tm), *_torch_data(data))
    (torch.from_numpy(coef) * s_t).sum().backward()
    for li, (gw_j, gb_j) in enumerate(g_j):
        # params_t holds W transposed: dW_t = dW^T
        gw_t = tm.weights[li].grad.transpose(1, 2).numpy()
        gb_t = tm.biases[li].grad.numpy()
        # the JAX package's kernel-vs-oracle bar for the gradients
        np.testing.assert_allclose(gw_t, np.asarray(gw_j), rtol=2e-3,
                                   atol=1e-3)
        np.testing.assert_allclose(gb_t, np.asarray(gb_j), rtol=2e-3,
                                   atol=1e-3)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_loss_from_stats_matches_jax_eigen_loss(k):
    jm, tm, data = _setup(k, seed=10 + k)
    eig_w = [1.0, 0.4, 0.2][:k]
    s_t = tfe.transfer_stats_reference(tfe.params_t_of(tm), *_torch_data(data))
    loss_t, (eig_t, np_t, pen_t, cvec_t) = tfe.eigen_loss_from_stats(
        s_t, k=k, alpha=7.0, eig_w=eig_w, lag_idx=5, traj_dt=0.002,
        sort_eigvals=True,
    )
    F, Fl, w, wl = _jax_data(data)
    loss_j, aux = jax_eigen_loss(
        jm, lambda z: z, F, w, Fl, wl, k=k, alpha=7.0, eig_w=eig_w,
        beta=1.0, diag_coeff=None, lag_idx=5, traj_dt=0.002,
        sort_eigvals=True,
    )
    # f32 sums of the same terms in two orders (the JAX package's bar)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(eig_t.numpy(), np.asarray(aux.eig_vals),
                               rtol=1e-5)
    np.testing.assert_allclose(np_t.item(), float(aux.non_penalty_loss),
                               rtol=1e-5)
    np.testing.assert_allclose(pen_t.item(), float(aux.penalty), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_array_equal(cvec_t.numpy(), np.asarray(aux.cvec))


def test_fused_tile_limits():
    # the main path's model fits the largest tile
    assert tfe.fused_tile((30, 20, 20, 20, 1), 2) == 128
    # far past the JAX limits (k * hidden <= 256, k <= 9), still in shared
    # memory
    assert tfe.fused_tile((30, 32, 32, 1), 12) == 32
    # what does not fit one block's 227 KB raises, naming the limit
    with pytest.raises(ValueError, match="shared memory"):
        tfe.fused_tile((30, 256, 256, 1), 2)
    with pytest.raises(ValueError, match="scalar heads"):
        tfe.fused_tile((30, 20, 2), 2)
    with pytest.raises(ValueError, match="layers"):
        tfe.fused_tile((4,) + (4,) * 17 + (1,), 1)

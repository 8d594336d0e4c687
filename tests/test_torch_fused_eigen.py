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


def _old_k3_smem(dims, k, tile):
    """K3's shared memory per block as the one-thread-per-sample design
    computed it (all heads' weights, Y, w, w_l, one input tile, two hidden
    buffers), in bytes: the limit the redesign must not tighten."""
    P = tile + 1
    n_params = sum(k * a * b + k * b for a, b in zip(dims[:-1], dims[1:]))
    return 4 * (n_params + 2 * k * tile + 2 * tile + dims[0] * P
                + 2 * max(dims[1:-1], default=0) * P)


@pytest.mark.parametrize(
    "dims,k,tile",
    [((30, 20, 20, 20, 1), 2, tfe.TILES[0]),
     # far past the JAX limits (k * hidden <= 256, k <= 9)
     ((30, 32, 32, 1), 12, tfe.TILES[0]),
     # all eight heads' weights in one block: fits only at the 32-sample tile
     ((30, 65, 65, 1), 8, 32)],
)
def test_fwd_launch_shape(dims, k, tile):
    shape = tfe.fwd_launch_shape(dims, k)
    assert shape.tile == tile
    assert shape.threads == tfe.THREADS_PER_SAMPLE * tile
    assert shape.smem_bytes == tfe.stats_smem_bytes(dims, k, tile,
                                                    backward=False)
    assert shape.smem_bytes <= tfe.SMEM_LIMIT
    assert shape.blocks_per_sm >= 1
    if dims == (30, 20, 20, 20, 1):
        # the main path's model: 1,250 samples resident per SM, so
        # B = 20,000 runs in one wave of blocks on 132 SMs
        assert shape.blocks_per_sm * shape.tile * 132 >= 20000


def test_fwd_launch_shape_limits():
    # what does not fit one block's 227 KB raises, naming the limit
    with pytest.raises(ValueError, match="shared memory"):
        tfe.fwd_launch_shape((30, 256, 256, 1), 2)
    with pytest.raises(ValueError, match="scalar heads"):
        tfe.fwd_launch_shape((30, 20, 2), 2)
    with pytest.raises(ValueError, match="layers"):
        tfe.fwd_launch_shape((4,) + (4,) * 17 + (1,), 1)


@pytest.mark.parametrize("k", [1, 8, 40])
def test_fwd_launch_shape_keeps_every_model_k3_took(k):
    # the widest [30, h, h, 1] model that the one-thread-per-sample K3 took
    # (its block at the 32-sample tile within the limit) is still taken,
    # and its block is no larger; one unit wider is refused by both
    h = 1
    while _old_k3_smem((30, h + 1, h + 1, 1), k, 32) <= tfe.SMEM_LIMIT:
        h += 1
    dims = (30, h, h, 1)
    shape = tfe.fwd_launch_shape(dims, k)
    assert (tfe.stats_smem_bytes(dims, k, 32, backward=False)
            <= _old_k3_smem(dims, k, 32))
    assert shape.smem_bytes <= tfe.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        tfe.fwd_launch_shape((30, h + 1, h + 1, 1), k)


@pytest.mark.parametrize(
    "dims,k,tile",
    [((30, 20, 20, 20, 1), 2, 64), ((30, 32, 32, 1), 12, 64),
     # a head of ~17k floats: its block fits only at the 32-sample tile
     ((30, 110, 110, 1), 1, 32)],
)
def test_bwd_launch_shape(dims, k, tile):
    shape = tfe.bwd_launch_shape(dims, k)
    assert shape.tile == tile
    assert shape.threads == tfe.THREADS_PER_SAMPLE * tile
    assert shape.smem_bytes == tfe.stats_smem_bytes(dims, k, tile,
                                                    backward=True)
    assert shape.smem_bytes <= tfe.SMEM_LIMIT
    assert shape.blocks_per_sm >= 1
    if dims == (30, 20, 20, 20, 1):
        # the main path's model: 3 blocks of 8 warps on each SM
        assert shape.warps_per_sm >= 16


def test_bwd_launch_shape_limits():
    with pytest.raises(ValueError, match="shared memory"):
        tfe.bwd_launch_shape((30, 256, 256, 1), 2)
    with pytest.raises(ValueError, match="scalar heads"):
        tfe.bwd_launch_shape((30, 20, 2), 2)
    # K4 holds one head's weights, so its block does not grow with k
    assert (tfe.bwd_launch_shape((30, 20, 1), 64)
            == tfe.bwd_launch_shape((30, 20, 1), 1))

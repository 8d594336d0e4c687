"""PyTorch port, transfer-operator eigen_loss against the JAX package, with
heads whose eigenvalue order differs from their index, so that both
preserved quirks (unsorted numerator over sorted denominator; penalty over
unsorted heads) change the result."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colvarsfinder_tpu.core.losses import eigen_loss as jax_eigen_loss
from colvarsfinder_tpu.models import EigenFunctions as JaxEigenFunctions

from colvarsfinder_tpu_torch.core.losses import eigen_loss
from colvarsfinder_tpu_torch.models import EigenFunctions
from colvarsfinder_tpu_torch.ops import Identity


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


K, EIG_W = 3, [1.0, 0.5, 0.25]
CONST = dict(k=K, alpha=5.0, eig_w=EIG_W, lag_idx=2, traj_dt=0.01)


def _case(seed):
    rng = np.random.default_rng(seed)
    jm = JaxEigenFunctions([8, 10, 1], K, seed=seed)
    tm = EigenFunctions.from_numpy(
        [{n: np.asarray(v) for n, v in p.items()} for p in jm.params]
    )
    F = rng.standard_normal((300, 8))
    Fl = F + 0.3 * rng.standard_normal((300, 8))
    w, wl = rng.uniform(0.5, 1.5, 300), rng.uniform(0.5, 1.5, 300)
    return jm, tm, [a.astype(np.float32) for a in (F, w, Fl, wl)]


# seeds 2 and 3 give the eigenvalue orders [2, 0, 1] and [2, 1, 0]
@pytest.mark.parametrize("seed,sort", [(2, True), (3, True), (2, False)])
def test_transfer_eigen_loss_matches_jax(seed, sort):
    jm, tm, data = _case(seed)
    loss_j, aux_j = jax_eigen_loss(
        jm, lambda z: z, *[jnp.asarray(a) for a in data], beta=1.0,
        diag_coeff=None, sort_eigvals=sort, **CONST,
    )
    loss_t, aux_t = eigen_loss(
        tm, Identity(), *[torch.from_numpy(a) for a in data],
        sort_eigvals=sort, **CONST,
    )
    cvec = aux_t.cvec.numpy()
    np.testing.assert_array_equal(cvec, np.asarray(aux_j.cvec))
    if sort:
        assert not np.array_equal(cvec, np.arange(K))  # the quirks bite
    # f32 sums of the same terms in two libraries
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(aux_t.eig_vals.numpy(),
                               np.asarray(aux_j.eig_vals), rtol=1e-5)
    np.testing.assert_allclose(aux_t.non_penalty_loss.item(),
                               float(aux_j.non_penalty_loss), rtol=1e-5)
    np.testing.assert_allclose(aux_t.penalty.item(), float(aux_j.penalty),
                               rtol=1e-4, atol=1e-6)
    assert not aux_t.eig_vals.requires_grad  # eigenvalues are detached

    # parameter gradients of the whole loss
    g_j = jax.jit(jax.grad(lambda m: jax_eigen_loss(
        m, lambda z: z, *[jnp.asarray(a) for a in data], beta=1.0,
        diag_coeff=None, sort_eigvals=sort, **CONST)[0]))(jm)
    loss_t.backward()
    for li, p in enumerate(g_j.params):
        np.testing.assert_allclose(tm.weights[li].grad.numpy(),
                                   np.asarray(p["weight"]), rtol=1e-3,
                                   atol=1e-5)
        np.testing.assert_allclose(tm.biases[li].grad.numpy(),
                                   np.asarray(p["bias"]), rtol=1e-3,
                                   atol=1e-5)


def test_quirks_are_kept():
    """The loss differs from the one with a sorted numerator and sorted
    penalty heads: the preserved indexing is really in effect."""
    _, tm, data = _case(2)
    X, w, Xl, wl = [torch.from_numpy(a) for a in data]
    loss, aux = eigen_loss(tm, Identity(), X, w, Xl, wl, sort_eigvals=True,
                           **CONST)
    y, yl = tm(X), tm(Xl)
    tw = w.sum()
    var = (y**2 * w[:, None]).sum(0) / tw - ((y * w[:, None]).sum(0) / tw) ** 2
    varl = (yl**2 * wl[:, None]).sum(0) / wl.sum() - (
        (yl * wl[:, None]).sum(0) / wl.sum()) ** 2
    num = ((yl - y) ** 2 * w[:, None]).sum(0) / tw
    c = aux.cvec
    sorted_np = (torch.tensor(EIG_W) * num[c] / (var[c] + varl[c])).sum() / (
        CONST["traj_dt"] * CONST["lag_idx"])
    assert not torch.isclose(aux.non_penalty_loss, sorted_np, rtol=1e-3)

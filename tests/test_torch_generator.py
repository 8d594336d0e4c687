"""PyTorch port, the generator eigenfunction loss (``lag_tau == 0``) against
the JAX package on the same numpy inputs, weights carried across with
``from_numpy`` and the split injected: the loss and its parameter
gradients through the per-sample input gradients (the vjp path) and
through a precomputed Gram matrix (the Gram path), the Gram precompute,
bf16 Gram storage, whole training runs, the second-order gradient through
the kernel layers K1 and K2, and the task's guards. float64 on both sides
unless a test says otherwise."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colvarsfinder_tpu import config as jconfig
from colvarsfinder_tpu.core import EigenFunctionTask as JaxTask
from colvarsfinder_tpu.core.eigenfunction import _gram_fn
from colvarsfinder_tpu.core.losses import eigen_loss as jax_eigen_loss
from colvarsfinder_tpu.models import EigenFunctions as JaxEigenFunctions
from colvarsfinder_tpu.ops.alignment import AlignmentLayer as JaxAlign
from colvarsfinder_tpu.ops.features import Feature as JaxFeature
from colvarsfinder_tpu.ops.features import FeatureLayer as JaxFeatureLayer
from colvarsfinder_tpu.ops.features import PreprocessingANN as JaxPP
from colvarsfinder_tpu.ops.kabsch_pallas import FusedAlignmentLayer as JaxFused
from colvarsfinder_tpu.utils import WeightedTrajectory as JaxTraj

import colvarsfinder_tpu_torch as port
from colvarsfinder_tpu_torch import config as pconfig
from colvarsfinder_tpu_torch.core.eigenfunction import gram_batch
from colvarsfinder_tpu_torch.core.losses import eigen_loss

N_ATOMS, K, B = 5, 2, 48
FEATS = [("p", "position", [0, 1, 2, 3, 4]), ("b", "bond", [0, 3]),
         ("a", "angle", [1, 2, 4])]
D_R = 15 + 1 + 1
EIG_W = [1.0, 0.4]
CONST = dict(k=K, alpha=6.0, eig_w=EIG_W, beta=2.0, lag_idx=0, traj_dt=0.01,
             sort_eigvals=True)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def f64():
    """Both packages in float64 mode, float32 restored afterwards."""
    jconfig.set_default_dtype("float64")
    pconfig.set_default_dtype("float64")
    yield
    jconfig.set_default_dtype("float32")
    pconfig.set_default_dtype("float32")


def _frames(n, seed=0, noise=0.3):
    rng = np.random.default_rng(seed)
    ref = 1.5 * rng.standard_normal((N_ATOMS, 3))
    x = ref[None] + noise * rng.standard_normal((n, N_ATOMS, 3))
    return ref, x


def _pp(lib, ref, kind="align"):
    """The same preprocessing from either package: ``align`` (alignment
    and features), ``fused`` (K2's layer and features) or ``cuda`` (K1's
    route and features)."""
    jax_lib = lib == "jax"
    feats = [(JaxFeature if jax_lib else port.Feature)(*f) for f in FEATS]
    layer = (JaxFeatureLayer if jax_lib else port.FeatureLayer)(feats)
    idx = list(range(N_ATOMS))
    if kind == "fused":
        al = (JaxFused if jax_lib else port.FusedAlignmentLayer)(ref, idx)
    elif jax_lib:
        al = JaxAlign(ref, idx, method="pallas" if kind == "cuda" else
                      "quaternion")
    else:
        al = port.AlignmentLayer(ref, idx, method=kind if kind != "align"
                                 else "quaternion")
    return (JaxPP if jax_lib else port.PreprocessingANN)(al, layer)


def _models(d_in, seed=1, dims=(8, 8, 1)):
    jm = JaxEigenFunctions([d_in, *dims], K, seed=seed)
    params = [{n: np.asarray(v) for n, v in p.items()} for p in jm.params]
    return jm, port.EigenFunctions.from_numpy(params)


def _weights(n, seed=2):
    return np.random.default_rng(seed).uniform(0.5, 1.5, n)


def _grads_close(jgrad, tm, rtol):
    """Parameter gradients within ``rtol`` of the JAX ones, entries near
    zero against the largest gradient entry: the output bias's gradient is
    exactly zero (the loss does not change when a head's output shifts),
    and what both packages compute for it is rounding residue."""
    got = [(tm.weights[li].grad, p["weight"]) for li, p in
           enumerate(jgrad.params)]
    got += [(tm.biases[li].grad, p["bias"]) for li, p in
            enumerate(jgrad.params)]
    scale = max(float(np.abs(np.asarray(want)).max()) for _, want in got)
    for g, want in got:
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=rtol,
                                   atol=rtol * scale)


def _loss_close(loss_t, aux_t, loss_j, aux_j, rtol):
    np.testing.assert_array_equal(aux_t.cvec.numpy(), np.asarray(aux_j.cvec))
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=rtol)
    np.testing.assert_allclose(aux_t.eig_vals.numpy(),
                               np.asarray(aux_j.eig_vals), rtol=rtol)
    np.testing.assert_allclose(aux_t.non_penalty_loss.item(),
                               float(aux_j.non_penalty_loss), rtol=rtol)
    np.testing.assert_allclose(aux_t.penalty.item(), float(aux_j.penalty),
                               rtol=rtol)
    assert not aux_t.eig_vals.requires_grad


@pytest.mark.parametrize("pp_kind", ["identity", "align"])
def test_generator_eigen_loss_matches_jax(f64, pp_kind):
    ref, x = _frames(B)
    if pp_kind == "identity":
        X = x.reshape(B, -1)
        pp_j, pp_t, d_in = (lambda z: z), port.ops.Identity(), X.shape[1]
    else:
        X = x
        pp_j, pp_t, d_in = _pp("jax", ref), _pp("port", ref), D_R
    dc = np.random.default_rng(3).uniform(0.2, 3.0, 3 * N_ATOMS)
    w = _weights(B)
    jm, tm = _models(d_in)

    def jloss(m):
        return jax_eigen_loss(m, pp_j, jnp.asarray(X), jnp.asarray(w), None,
                              None, diag_coeff=jnp.asarray(dc), **CONST)

    loss_j, aux_j = jloss(jm)
    loss_t, aux_t = eigen_loss(tm, pp_t, torch.from_numpy(X),
                               torch.from_numpy(w), None, None,
                               diag_coeff=torch.from_numpy(dc), **CONST)
    _loss_close(loss_t, aux_t, loss_j, aux_j, 1e-10)
    loss_t.backward()
    _grads_close(jax.grad(lambda m: jloss(m)[0])(jm), tm, 1e-10)


def _gram_case(seed=4):
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((B, D_R))
    A = rng.standard_normal((B, D_R, 3 * N_ATOMS))
    M = np.einsum("bid,bjd->bij", A, A) / (3 * N_ATOMS)
    return H, M, _weights(B)


def test_pp_gram_branch_matches_jax(f64):
    H, M, w = _gram_case()
    jm, tm = _models(D_R)

    def jloss(m):
        return jax_eigen_loss(m, None, jnp.asarray(H), jnp.asarray(w), None,
                              None, diag_coeff=None, pp_gram=jnp.asarray(M),
                              **CONST)

    loss_j, aux_j = jloss(jm)
    loss_t, aux_t = eigen_loss(tm, None, torch.from_numpy(H),
                               torch.from_numpy(w), None, None,
                               pp_gram=torch.from_numpy(M), **CONST)
    _loss_close(loss_t, aux_t, loss_j, aux_j, 1e-10)
    loss_t.backward()
    _grads_close(jax.grad(lambda m: jloss(m)[0])(jm), tm, 1e-10)


def test_bf16_gram_on_the_cpu_matches_jax():
    """float32 with M stored in bfloat16: both packages upcast M on the
    CPU, from the same bf16 values."""
    H, M, w = (a.astype(np.float32) for a in _gram_case())
    jm, tm = _models(D_R)
    Mj = jnp.asarray(M).astype(jnp.bfloat16)
    Mt = torch.from_numpy(M).to(torch.bfloat16)
    np.testing.assert_array_equal(np.asarray(Mj.astype(jnp.float32)),
                                  Mt.float().numpy())

    def jloss(m):
        return jax_eigen_loss(m, None, jnp.asarray(H), jnp.asarray(w), None,
                              None, diag_coeff=None, pp_gram=Mj, **CONST)

    loss_j, aux_j = jloss(jm)
    loss_t, aux_t = eigen_loss(tm, None, torch.from_numpy(H),
                               torch.from_numpy(w), None, None, pp_gram=Mt,
                               **CONST)
    _loss_close(loss_t, aux_t, loss_j, aux_j, 1e-6)
    loss_t.backward()
    _grads_close(jax.grad(lambda m: jloss(m)[0])(jm), tm, 1e-6)
    # bf16 storage changes the loss against float32 storage
    loss_f32, _ = eigen_loss(tm, None, torch.from_numpy(H),
                             torch.from_numpy(w), None, None,
                             pp_gram=torch.from_numpy(M), **CONST)
    assert loss_f32.item() != loss_t.item()


def test_gram_precompute_matches_jax(f64):
    ref, x = _frames(B, seed=5)
    dc = np.random.default_rng(6).uniform(0.2, 3.0, 3 * N_ATOMS)
    H_j, M_j = _gram_fn((N_ATOMS, 3), 3 * N_ATOMS)(
        _pp("jax", ref), jnp.asarray(dc), jnp.asarray(x.reshape(B, -1)))
    H_t, M_t = gram_batch(_pp("port", ref), torch.from_numpy(x),
                          torch.from_numpy(dc), D_R)
    assert M_t.shape == (B, D_R, D_R) and not M_t.requires_grad
    np.testing.assert_allclose(H_t.numpy(), np.asarray(H_j), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(M_t.numpy(), np.asarray(M_j), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("per_pass", [1, 2, 5])
def test_gram_precompute_in_groups(f64, monkeypatch, per_pass):
    """The feature rows taken ``per_pass`` copies of the batch at a time
    (the last group short) give the Gram matrices of one pass over all."""
    from colvarsfinder_tpu_torch.core import eigenfunction

    ref, x = _frames(B, seed=5)
    dc = torch.from_numpy(np.random.default_rng(6).uniform(0.2, 3.0,
                                                           3 * N_ATOMS))
    X = torch.from_numpy(x)
    H_1, M_1 = gram_batch(_pp("port", ref), X, dc, D_R)
    monkeypatch.setattr(eigenfunction, "GRAM_PASS_FRAMES", per_pass * B)
    H_g, M_g = gram_batch(_pp("port", ref), X, dc, D_R)
    torch.testing.assert_close(H_g, H_1, rtol=1e-12, atol=0)
    torch.testing.assert_close(M_g, M_1, rtol=1e-12, atol=1e-14)


def test_gram_precompute_through_k2_matches_the_plain_layer():
    """float32: the Gram path of a FusedAlignmentLayer (K2's route, where
    the JAX package's jvp precompute raises) against the plain layer's,
    and the loss on each."""
    ref, x = (a.astype(np.float32) for a in _frames(B, seed=7))
    dc = torch.from_numpy(
        np.random.default_rng(8).uniform(0.2, 3.0, 3 * N_ATOMS)
        .astype(np.float32))
    X = torch.from_numpy(x)
    H_f, M_f = gram_batch(_pp("port", ref, "fused"), X, dc, D_R)
    H_p, M_p = gram_batch(_pp("port", ref), X, dc, D_R)
    torch.testing.assert_close(H_f, H_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(M_f, M_p, rtol=1e-5, atol=1e-6)
    w = torch.from_numpy(_weights(B).astype(np.float32))
    _, tm = _models(D_R)
    losses = [eigen_loss(tm, None, H, w, None, None, pp_gram=M, **CONST)[0]
              for H, M in ((H_f, M_f), (H_p, M_p))]
    torch.testing.assert_close(*losses, rtol=1e-5, atol=0)


def _second_order_jax(layer, x, theta):
    def f(t):
        gx = jax.grad(lambda xx: (t * jnp.tanh(layer(xx))).sum())(
            jnp.asarray(x))
        return (gx**2).sum()

    return np.asarray(jax.grad(f)(jnp.asarray(theta)))


def _second_order_port(layer, x, theta):
    xt = torch.tensor(x, requires_grad=True)
    th = torch.tensor(theta, requires_grad=True)
    (gx,) = torch.autograd.grad((th * torch.tanh(layer(xt))).sum(), xt,
                                create_graph=True)
    assert gx.grad_fn is not None, "the input gradient records no graph"
    (g,) = torch.autograd.grad((gx**2).sum(), th)
    return g.numpy()


@pytest.mark.parametrize("method", ["fused", "cuda", "quaternion"])
def test_second_order_gradient_through_the_alignment_matches_jax(method):
    """float32: gx = d/dx sum theta * tanh(layer(x)) with a recorded graph,
    then d(sum gx^2)/d theta. The JAX kernel layers' custom_vjp backward
    is jax.vjp of the plain formulation, which JAX differentiates again;
    the port's K1 and K2 backward must be as differentiable."""
    rng = np.random.default_rng(9)
    ref = rng.standard_normal((N_ATOMS, 3)).astype(np.float32)
    x = (ref[None] + 0.3 * rng.standard_normal((16, N_ATOMS, 3))).astype(
        np.float32)
    theta = rng.standard_normal((N_ATOMS, 3)).astype(np.float32)
    idx = list(range(N_ATOMS))
    if method == "fused":
        layer = port.FusedAlignmentLayer(ref, idx)
    else:
        layer = port.AlignmentLayer(ref, idx, method=method)
    got = _second_order_port(layer, x, theta)
    for jlayer in (JaxFused(ref, idx), JaxAlign(ref, idx, method="pallas")):
        want = _second_order_jax(jlayer, x, theta)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the task
N_FRAMES, DT = 400, 0.01
TASK_ARGS = dict(alpha=6.0, eig_weights=EIG_W, lag_tau=0.0, k=K, beta=2.0,
                 learning_rate=0.01, batch_size=96, num_epochs=3,
                 test_ratio=0.25, verbose=False, tensorboard=False, seed=0,
                 debug_mode=False, save_model_every_step=0)


def _split():
    perm = np.random.default_rng(10).permutation(N_FRAMES)
    return perm[100:], perm[:100]


def _task_pair(tmp_path, gram, jax_too=True, **kw):
    ref, x = _frames(N_FRAMES, seed=11)
    w = _weights(N_FRAMES)
    dc = np.random.default_rng(12).uniform(0.2, 3.0, 3 * N_ATOMS)
    jm, tm = _models(D_R, seed=13)
    args = {**TASK_ARGS, "diag_coeff": dc, "gram_pp": gram,
            "split_indices": _split(), **kw}
    jt = JaxTask(JaxTraj(trajectory=x, weights=w, dt=DT, verbose=False),
                 _pp("jax", ref), jm, str(tmp_path / "jax"), export_cv=False,
                 **args) if jax_too else None
    pt = port.EigenFunctionTask(
        port.WeightedTrajectory(trajectory=x, weights=w, dt=DT,
                                verbose=False),
        _pp("port", ref), tm, str(tmp_path / "port"), device="cpu", **args)
    return jt, pt


@pytest.mark.parametrize("gram", [True, False])
def test_generator_task_curves_match_jax(f64, tmp_path, gram):
    jt, pt = _task_pair(tmp_path, gram)
    jt.train()
    pt.train()
    assert jt._gram is pt._gram is gram
    np.testing.assert_allclose(pt.train_loss, jt.train_loss_df.to_numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(pt.test_loss, jt.test_loss_df.to_numpy(),
                               rtol=1e-6)
    np.testing.assert_array_equal(pt._cvec, jt._cvec)
    assert pt.loss_names == list(jt.train_loss_df.columns)


def test_bf16_gram_task_tracks_the_f32_gram_task(tmp_path):
    """float32; the JAX test's bar (tests/test_gram_dtype.py)."""
    runs = []
    for gram_dtype in (None, "bfloat16"):
        _, pt = _task_pair(tmp_path / str(gram_dtype), True, False,
                           gram_dtype=gram_dtype)
        pt.train()
        assert pt._gram and pt._gram_dtype == gram_dtype
        runs.append(pt)
    (H, M, _) = runs[1]._prepared[0][0]
    assert M.dtype == torch.bfloat16 and H.dtype == torch.float32
    assert np.isfinite(runs[1].train_loss).all()
    np.testing.assert_allclose(runs[1].train_loss[:, 0],
                               runs[0].train_loss[:, 0], rtol=2e-2)
    assert not np.array_equal(runs[1].train_loss, runs[0].train_loss)


@pytest.mark.parametrize("given,want", [(None, None), ("float32", None),
                                        (np.float32, None),
                                        ("bfloat16", "bfloat16")])
def test_gram_dtype_normalisation(tmp_path, given, want):
    _, pt = _task_pair(tmp_path, None, False, gram_dtype=given)
    assert pt._gram_dtype == want


def test_gram_default_and_auto_limit(tmp_path, monkeypatch, capsys):
    _, pt = _task_pair(tmp_path, None, False, verbose=True)
    assert pt._gram_requested and not pt._gram_explicit
    ident = port.EigenFunctionTask(
        pt.traj_obj, None, port.EigenFunctions([3 * N_ATOMS, 4, 1], K),
        str(tmp_path / "ident"), device="cpu",
        **{**TASK_ARGS, "split_indices": _split()})
    assert not ident._gram_requested
    # above the limit: the vjp path, silently for the default, with a
    # warning where gram_pp=True was explicit
    monkeypatch.setattr(port.EigenFunctionTask, "GRAM_AUTO_LIMIT_BYTES", 1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pt._prepare_data()
    assert not pt._gram and "falling back" in capsys.readouterr().out
    _, explicit = _task_pair(tmp_path / "x", True, False)
    with pytest.warns(UserWarning, match="gram_pp=True could not be honored"):
        explicit._prepare_data()
    assert not explicit._gram
    assert len(explicit._prepared[0][0]) == 2  # (X, w): the vjp path


def test_generator_guards(tmp_path):
    for kw in (dict(precompute_features=True), dict(fused_step=True)):
        with pytest.raises(ValueError, match="transfer-operator"):
            _task_pair(tmp_path, None, False, **kw)
    with pytest.raises(ValueError, match="gram_pp applies"):
        _task_pair(tmp_path, True, False, lag_tau=2 * DT)
    with pytest.raises(ValueError, match="diag_coeff"):
        _task_pair(tmp_path, None, False, diag_coeff=np.ones(4))
    with pytest.raises(ValueError, match="gram_dtype"):
        _task_pair(tmp_path, None, False, gram_dtype="float16")


def test_graph_key_takes_in_the_generator_settings(tmp_path):
    _, pt = _task_pair(tmp_path, True, False)
    pt._prepare_data()
    key = pt._graph_key()[0]
    for attr, value in (("_beta", 3.0), ("_gram", False),
                        ("_gram_dtype", "bfloat16")):
        old = getattr(pt, attr)
        setattr(pt, attr, value)
        assert pt._graph_key()[0] != key, attr
        setattr(pt, attr, old)
    assert pt._graph_key()[0] == key
    assert any(o is pt._diag_coeff for o in pt._graph_key()[1])

"""PyTorch port, the regularized autoencoder: ``RegAutoEncoder``,
``RegModel``, the time-lagged reconstruction loss, the encoder constraints
and the eigenfunction regularizer against the JAX package on the same numpy
inputs, and ``RegAutoEncoderTask`` training against the JAX task (all six
terms, the generator regularizer on its vjp and Gram paths,
``precompute_features``, ``freeze_encoder``), weights carried across with
``RegAutoEncoder.from_numpy`` and the split injected; the guards, the graph
key, the per-term methods and resume. float64 on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colvarsfinder_tpu import config as jconfig
from colvarsfinder_tpu.core import RegAutoEncoderTask as JaxTask
from colvarsfinder_tpu.core.eigenfunction import _gram_fn
from colvarsfinder_tpu.core.losses import enc_grad_loss as jax_enc_grad
from colvarsfinder_tpu.core.losses import enc_norm_loss as jax_enc_norm
from colvarsfinder_tpu.core.losses import enc_orthogonality_loss as jax_enc_orth
from colvarsfinder_tpu.core.losses import reg_eigen_loss as jax_reg_eigen
from colvarsfinder_tpu.core.losses import weighted_mse_lagged_loss as jax_lagged
from colvarsfinder_tpu.models import RegAutoEncoder as JaxRegAE
from colvarsfinder_tpu.models import RegModel as JaxRegModel
from colvarsfinder_tpu.ops.alignment import AlignmentLayer as JaxAlign
from colvarsfinder_tpu.ops.features import Feature as JaxFeature
from colvarsfinder_tpu.ops.features import FeatureLayer as JaxFeatureLayer
from colvarsfinder_tpu.ops.features import PreprocessingANN as JaxPP
from colvarsfinder_tpu.utils import WeightedTrajectory as JaxTraj

import colvarsfinder_tpu_torch as port
from colvarsfinder_tpu_torch import config as pconfig
from colvarsfinder_tpu_torch.core.losses import (
    enc_grad_loss,
    enc_norm_loss,
    enc_orthogonality_loss,
    reg_eigen_loss,
    weighted_mse_lagged_loss,
)

N_ATOMS, K, B = 5, 2, 48
FEATS = [("p", "position", [0, 1, 2, 3, 4]), ("b", "bond", [0, 3])]
D_R = 3 * N_ATOMS + 1
E_DIMS, D_DIMS, R_DIMS = [D_R, 10, 10, 2], [2, 10, 10, D_R], [2, 8, 1]
EIG_W = [1.0, 0.5]
DT = 0.01


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


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    ref = 1.5 * rng.standard_normal((N_ATOMS, 3))
    return ref, ref[None] + 0.3 * rng.standard_normal((n, N_ATOMS, 3))


def _pp(lib, ref):
    """The same preprocessing from either package: the alignment, then
    positions and one bond."""
    jax_lib = lib == "jax"
    feats = [(JaxFeature if jax_lib else port.Feature)(*f) for f in FEATS]
    layer = (JaxFeatureLayer if jax_lib else port.FeatureLayer)(feats)
    al = (JaxAlign if jax_lib else port.AlignmentLayer)(
        ref, list(range(N_ATOMS)))
    return (JaxPP if jax_lib else port.PreprocessingANN)(al, layer)


def _np(params):
    return [{n: np.asarray(v) for n, v in p.items()} for p in params]


def _models(seed=1, activation="tanh"):
    jm = JaxRegAE(E_DIMS, D_DIMS, R_DIMS, K=K, activation=activation,
                  seed=seed)
    return jm, port.RegAutoEncoder.from_numpy(
        _np(jm.encoder.params), _np(jm.decoder.params), _np(jm.reg),
        activation)


def _jax_named(m):
    """A JAX regularized autoencoder's parameters (or gradients) under the
    port's parameter names."""
    out = {}
    for part in ("encoder", "decoder"):
        for li, layer in enumerate(getattr(m, part).params):
            for name in ("weight", "bias"):
                out[f"{part}.{li + 1}.{name}"] = np.asarray(layer[name])
    for li, layer in enumerate(m.reg):
        out[f"reg.weights.{li}"] = np.asarray(layer["weight"])
        out[f"reg.biases.{li}"] = np.asarray(layer["bias"])
    return out


def _grads_close(jgrad, tm, rtol):
    """Every parameter gradient within ``rtol`` of the JAX one, entries near
    zero against the largest gradient entry (a head's output bias has an
    exactly zero gradient in the eigenfunction terms, and what both
    packages compute for it is rounding residue). A parameter the loss
    does not reach has no gradient in the port and a zero one in JAX."""
    want = _jax_named(jgrad)
    scale = max(float(np.abs(v).max()) for v in want.values())
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        g = np.zeros_like(want[name]) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(g, want[name], rtol=rtol,
                                   atol=rtol * scale, err_msg=name)


# ---------------------------------------------------------------------------
# the models
def test_reg_autoencoder_matches_jax(f64):
    jm, tm = _models()
    assert tm.num_reg == jm.num_reg == K and tm.encoded_dim == 2
    x = np.random.default_rng(0).standard_normal((20, D_R))
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    with torch.no_grad():
        for fn in ("forward_ae", "forward_reg", "forward"):
            np.testing.assert_allclose(
                getattr(tm, fn)(xt).numpy(), np.asarray(getattr(jm, fn)(xj)),
                rtol=1e-12, atol=1e-12, err_msg=fn)
        assert tm(xt).shape == (20, D_R + K)
        for cvec in ([0, 1], [1, 0]):
            rj, rt = JaxRegModel(jm, cvec), port.RegModel(tm, cvec)
            assert rt.cvec == tuple(cvec) and rt.num_reg == K
            np.testing.assert_allclose(rt(xt).numpy(), np.asarray(rj(xj)),
                                       rtol=1e-12, atol=1e-12)
    # the reordered heads are a copy; the encoder is the model's own
    assert rt.encoder is tm.encoder
    assert rt.reg.weights[0].data_ptr() != tm.reg.weights[0].data_ptr()
    for cv in range(2):
        pj, pt = jm.get_params_of_cv(cv), tm.get_params_of_cv(cv)
        assert [n for n, _ in pt] == [n for n, _ in pj]
        for (_, a), (_, b) in zip(pt, pj):
            np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))


def test_reg_autoencoder_init_and_guards():
    a = port.RegAutoEncoder(E_DIMS, D_DIMS, R_DIMS, K, seed=3)
    b = port.RegAutoEncoder(E_DIMS, D_DIMS, R_DIMS, K, seed=3)
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    assert a.reg.weights[0].shape == (K, R_DIMS[1], R_DIMS[0])
    assert a.activation == "tanh"
    none = port.RegAutoEncoder(E_DIMS, D_DIMS, R_DIMS, 0)
    assert none.num_reg == 0 and none.reg is None
    with pytest.raises(ValueError, match="not positive"):
        none.forward_reg(torch.zeros(3, D_R))
    with pytest.raises(ValueError, match="regulator part"):
        port.RegAutoEncoder(E_DIMS, D_DIMS, [3, 8, 1], K)
    with pytest.raises(ValueError, match="do not match"):
        port.RegAutoEncoder([4, 3], [2, 4], [3, 1], K)


@pytest.mark.parametrize("cvec,match", [([0, 0], "permutation"),
                                        ([0, 2], "permutation"),
                                        ([0], "length of cvec")])
def test_reg_model_refuses_a_cvec_as_jax_does(cvec, match):
    jm, tm = _models()
    with pytest.raises(AssertionError):
        JaxRegModel(jm, cvec)
    with pytest.raises(ValueError, match=match):
        port.RegModel(tm, cvec)


# ---------------------------------------------------------------------------
# the losses
def _batch(seed, n=B):
    ref, x = _frames(n + 3, seed)
    w = np.random.default_rng(seed + 1).uniform(0.5, 1.5, n + 3)
    return ref, x[:n], x[3:], w[:n], w[3:]


def _check(jfn, tfn, jm, tm, rtol=1e-10):
    """Value and every parameter gradient of one loss, port against JAX."""
    val_j = jfn(jm)
    val_t = tfn(tm)
    np.testing.assert_allclose(val_t.item(), float(val_j), rtol=rtol)
    assert val_t.item() != 0.0
    val_t.backward()
    _grads_close(jax.grad(jfn)(jm), tm, rtol)


def test_weighted_mse_lagged_loss_matches_jax(f64):
    ref, x, xl, w, _ = _batch(2)
    jm, tm = _models()
    pj, pt = _pp("jax", ref), _pp("port", ref)
    _check(lambda m: jax_lagged(m.forward_ae, pj, jnp.asarray(x),
                                jnp.asarray(xl), jnp.asarray(w)),
           lambda m: weighted_mse_lagged_loss(
               m.forward_ae, pt, torch.from_numpy(x), torch.from_numpy(xl),
               torch.from_numpy(w)),
           jm, tm)


@pytest.mark.parametrize("term", ["grad", "norm", "orthogonality"])
def test_encoder_losses_match_jax(f64, term):
    jfn = {"grad": jax_enc_grad, "norm": jax_enc_norm,
           "orthogonality": jax_enc_orth}[term]
    tfn = {"grad": enc_grad_loss, "norm": enc_norm_loss,
           "orthogonality": enc_orthogonality_loss}[term]
    ref, x, _, w, _ = _batch(3)
    jm, tm = _models()
    pj, pt = _pp("jax", ref), _pp("port", ref)
    _check(lambda m: jfn(m.encoder, pj, jnp.asarray(x), jnp.asarray(w), 2),
           lambda m: tfn(m.encoder, pt, torch.from_numpy(x),
                         torch.from_numpy(w), 2),
           jm, tm)


# a seed whose heads the eigenvalue sort swaps in all three branches
SWAP_SEED = 1


def _reg_eigen_case(branch, seed):
    """Both packages' ``reg_eigen_loss`` on one batch: the transfer
    operator (lag 3), the generator through the preprocessing layer (vjp),
    or the generator on features with a Gram matrix."""
    ref, x, xl, w, wl = _batch(seed)
    jm, tm = _models(seed=seed)
    const = dict(num_reg=K, eig_w=EIG_W, beta=2.0, traj_dt=DT)
    if branch == "transfer":
        pj, pt = _pp("jax", ref), _pp("port", ref)
        jargs = (pj, jnp.asarray(x), jnp.asarray(w), jnp.asarray(xl),
                 jnp.asarray(wl))
        targs = (pt, torch.from_numpy(x), torch.from_numpy(w),
                 torch.from_numpy(xl), torch.from_numpy(wl))
        jkw = tkw = dict(diag_coeff=None, lag_idx=3)
    elif branch == "vjp":
        pj, pt = _pp("jax", ref), _pp("port", ref)
        dc = np.ones(3 * N_ATOMS)
        jargs = (pj, jnp.asarray(x), jnp.asarray(w), None, None)
        targs = (pt, torch.from_numpy(x), torch.from_numpy(w), None, None)
        jkw = dict(diag_coeff=jnp.asarray(dc), lag_idx=0)
        tkw = dict(diag_coeff=torch.from_numpy(dc), lag_idx=0)
    else:
        H, M = _gram_fn((N_ATOMS, 3), 3 * N_ATOMS)(
            _pp("jax", ref), jnp.ones(3 * N_ATOMS),
            jnp.asarray(x.reshape(B, -1)))
        H, M = np.array(H), np.array(M)
        jargs = (None, jnp.asarray(H), jnp.asarray(w), None, None)
        targs = (None, torch.from_numpy(H), torch.from_numpy(w), None, None)
        jkw = dict(diag_coeff=None, lag_idx=0, pp_gram=jnp.asarray(M))
        tkw = dict(diag_coeff=None, lag_idx=0, pp_gram=torch.from_numpy(M))

    def jfn(m):
        return jax_reg_eigen(m, *jargs, **jkw, **const)

    def tfn(m):
        return reg_eigen_loss(m, *targs, **tkw, **const)

    return jm, tm, jfn, tfn


@pytest.mark.parametrize("branch", ["transfer", "vjp", "gram"])
def test_reg_eigen_loss_matches_jax(f64, branch):
    """Every output of the regularizer and the parameter gradients of its
    objective and its penalty, in a case where the sort swaps the heads:
    the transfer objective's numerator is then read unsorted against a
    sorted denominator (the preserved quirk)."""
    jm, tm, jfn, tfn = _reg_eigen_case(branch, SWAP_SEED)
    eig_j, np_j, pen_j, cvec_j = jfn(jm)
    eig_t, np_t, pen_t, cvec_t = tfn(tm)
    np.testing.assert_array_equal(cvec_t.numpy(), np.asarray(cvec_j))
    assert cvec_t.tolist() == [1, 0]
    np.testing.assert_allclose(eig_t.numpy(), np.asarray(eig_j), rtol=1e-10)
    assert not eig_t.requires_grad and eig_t[0] <= eig_t[1]
    np.testing.assert_allclose(np_t.item(), float(np_j), rtol=1e-10)
    np.testing.assert_allclose(pen_t.item(), float(pen_j), rtol=1e-10)
    for part in (1, 2):
        for p in tm.parameters():
            p.grad = None
        tfn(tm)[part].backward()
        _grads_close(jax.grad(lambda m: jfn(m)[part])(jm), tm, 1e-10)
    if branch == "transfer":
        # the quirk, spelled out: the unsorted numerator over the sorted
        # denominator is not the sorted objective
        ref, x, xl, w, wl = _batch(SWAP_SEED)
        with torch.no_grad():
            pt = _pp("port", ref)
            y = tm.forward_reg(pt(torch.from_numpy(x)))
            yl = tm.forward_reg(pt(torch.from_numpy(xl)))
            wt, wlt = torch.from_numpy(w), torch.from_numpy(wl)

            def var(v, ww):
                m = (v * ww[:, None]).sum(0) / ww.sum()
                return (v**2 * ww[:, None]).sum(0) / ww.sum() - m**2

            num = (((yl - y) ** 2) * wt[:, None]).sum(0) / wt.sum()
            den = var(y, wt) + var(yl, wlt)
            c = cvec_t
            quirk = (torch.tensor(EIG_W) * num / den[c]).sum() / (3 * DT)
            sorted_ = (torch.tensor(EIG_W) * num[c] / den[c]).sum() / (3 * DT)
        np.testing.assert_allclose(np_t.item(), quirk.item(), rtol=1e-12)
        assert abs(sorted_.item() - quirk.item()) > 1e-3 * abs(quirk.item())


# ---------------------------------------------------------------------------
# the task
N_FRAMES = 400
MAX_LAG = 8
TASK_ARGS = dict(learning_rate=0.01, batch_size=96, num_epochs=3,
                 test_ratio=0.25, verbose=False, tensorboard=False, seed=0,
                 debug_mode=False, save_model_every_step=0,
                 eig_weights=EIG_W, alpha=1.0, gamma=[0.7, 3.0],
                 eta=[0.05, 0.1, 0.2], beta=1.0)
# transfer regularizer, lagged reconstruction: all six terms
ALL_SIX = dict(lag_tau_ae=3 * DT, lag_tau_reg=2 * DT)
CASES = {
    "all_six": ALL_SIX,
    "gen_vjp": dict(lag_tau_ae=3 * DT, lag_tau_reg=0.0, gram_pp=False),
    "gen_gram": dict(lag_tau_ae=3 * DT, lag_tau_reg=0.0),
    "precompute": dict(ALL_SIX, precompute_features=True),
    "freeze": dict(ALL_SIX, freeze_encoder=True),
    # one lag for both lagged terms: one gather and one pass of the lagged
    # frames
    "same_lag": dict(lag_tau_ae=2 * DT, lag_tau_reg=2 * DT),
}


def _split():
    perm = np.random.default_rng(10).permutation(N_FRAMES - MAX_LAG)
    return perm[100:], perm[:100]


def _task_pair(tmp_path, jax_too=True, **kw):
    ref, x = _frames(N_FRAMES, seed=11)
    w = np.random.default_rng(12).uniform(0.5, 1.5, N_FRAMES)
    jm, tm = _models(seed=13)
    args = {**TASK_ARGS, "split_indices": _split(), **kw}
    jt = JaxTask(JaxTraj(trajectory=x, weights=w, dt=DT, verbose=False),
                 _pp("jax", ref), jm, str(tmp_path / "jax"), export_cv=False,
                 **args) if jax_too else None
    pt = port.RegAutoEncoderTask(
        port.WeightedTrajectory(trajectory=x, weights=w, dt=DT,
                                verbose=False),
        _pp("port", ref), tm, str(tmp_path / "port"), device="cpu", **args)
    return jt, pt, x


@pytest.mark.parametrize("case", list(CASES))
def test_regae_task_curves_match_jax(f64, tmp_path, case):
    jt, pt, x = _task_pair(tmp_path, **CASES[case])
    enc0 = [p.detach().clone() for p in pt.model.encoder.parameters()]
    jt.train()
    pt.train()
    assert jt._gram is pt._gram is (case == "gen_gram")
    if case == "same_lag":
        assert all(b[2] is b[1] for b in pt._prepared[0] + pt._prepared[1])
    assert pt.loss_names == list(jt.train_loss_df.columns)
    np.testing.assert_allclose(pt.train_loss, jt.train_loss_df.to_numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(pt.test_loss, jt.test_loss_df.to_numpy(),
                               rtol=1e-6)
    # every term in play
    assert (np.abs(pt.train_loss) > 0).all()
    np.testing.assert_array_equal(pt._cvec, jt._cvec)
    trained = [p.detach() for p in pt.model.encoder.parameters()]
    if case == "freeze":
        for a, b in zip(trained, enc0):
            assert torch.equal(a, b)
        for li, layer in enumerate(jt.model.encoder.params):
            np.testing.assert_array_equal(np.asarray(layer["weight"]),
                                          enc0[2 * li].numpy())
    else:
        assert not torch.equal(trained[0], enc0[0])
    # the CV and the reordered heads, against the JAX task's. No term
    # changes when a head's output shifts, so its output bias gets a
    # gradient of rounding residue, which Adam scales to steps of about
    # the learning rate in either package: the heads agree up to a
    # constant per head
    xj, xt = jnp.asarray(x[:9]), torch.from_numpy(x[:9])
    with torch.no_grad():
        np.testing.assert_allclose(pt.colvar_model()(xt).numpy(),
                                   np.asarray(jt.colvar_model()(xj)),
                                   rtol=1e-6, atol=1e-9)
        heads_t = pt.reg_model()(xt).numpy()
    heads_j = np.asarray(jt.reg_model()(xj))
    np.testing.assert_allclose(heads_t - heads_t.mean(0),
                               heads_j - heads_j.mean(0), rtol=1e-6,
                               atol=1e-9)


def test_regae_guards_raise_as_jax_does(tmp_path):
    for kw, match in (
        (dict(eig_weights=[1.0]), "number of weights"),
        (dict(lag_tau_ae=0.015), "not divisable"),
        (dict(lag_tau_reg=0.0, precompute_features=True), "precompute"),
        (dict(lag_tau_reg=2 * DT, gram_pp=True), "gram_pp applies"),
        (dict(gamma=[0.0, 0.0], gram_pp=True), "gram_pp applies"),
    ):
        args = {**ALL_SIX, **kw}
        with pytest.raises(AssertionError):
            _task_pair(tmp_path, **args)
        with pytest.raises(ValueError, match=match):
            _task_pair(tmp_path, jax_too=False, **args)
    x = np.zeros((20, D_R), np.float32)
    with pytest.raises(TypeError, match="RegAutoEncoder"):
        port.RegAutoEncoderTask(
            port.WeightedTrajectory(trajectory=x, dt=DT, verbose=False),
            None, port.AutoEncoder(E_DIMS, D_DIMS), str(tmp_path),
            device="cpu")


def test_graph_key_takes_in_the_term_weights(tmp_path):
    _, pt, _ = _task_pair(tmp_path, jax_too=False, lag_tau_reg=0.0)
    pt._prepare_data()
    key, held = pt._graph_key()
    assert pt._gram and any(o is pt._diag_coeff for o in held)
    for attr, value in (("alpha", 2.0), ("gamma", [0.7, 2.0]),
                        ("eta", [0.05, 0.1, 0.3]), ("freeze_encoder", True),
                        ("_beta", 3.0), ("_gram", False)):
        old = getattr(pt, attr)
        setattr(pt, attr, value)
        assert pt._graph_key()[0] != key, attr
        setattr(pt, attr, old)
    assert pt._graph_key()[0] == key
    # the head weights: the step bakes them in, and the key holds them by
    # value
    batch = pt._prepared[0][0]
    loss = pt._batch_metrics(*batch)[0].item()
    pt._eig_w = [2.0, 0.25]
    assert pt._graph_key()[0] != key
    assert pt._batch_metrics(*batch)[0].item() != loss


def test_per_term_methods_match_jax(f64, tmp_path):
    jt, pt, x = _task_pair(tmp_path, **ALL_SIX)
    w = np.random.default_rng(5).uniform(0.5, 1.5, 40)
    X, Xl, wl = x[:40], x[2:42], w[::-1].copy()
    for name, args in (("weighted_MSE_loss", (X, Xl, w)),
                       ("reg_enc_grad_loss", (X, w)),
                       ("reg_enc_norm_loss", (X, w)),
                       ("reg_enc_orthognal_loss", (X, w))):
        np.testing.assert_allclose(getattr(pt, name)(*args).item(),
                                   float(getattr(jt, name)(*args)),
                                   rtol=1e-10, err_msg=name)
    got = pt.reg_eigen_loss(X, w, Xl, wl)
    want = jt.reg_eigen_loss(X, w, Xl, wl)
    for g, v in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(v),
                                   rtol=1e-10)


def test_resume_save_and_plot(tmp_path):
    """Two epochs, then two more after loading the first run's state,
    equal four in one go; the plot callback gets the CV and the reordered
    heads; save_model writes the encoder's CV artifacts."""
    calls = []

    class Plot:
        def plot(self, cv, reg, epoch):
            calls.append((type(cv.head).__name__, type(reg.head).__name__,
                          epoch))

    runs = {}
    for name, epochs in (("whole", 4), ("first", 2), ("resumed", 2)):
        _, runs[name], _ = _task_pair(tmp_path / name, jax_too=False,
                                      num_epochs=epochs, **ALL_SIX)
    runs["whole"].plot_class, runs["whole"].plot_frequency = Plot(), 2
    runs["whole"].train()
    assert calls == [("Sequential", "RegModel", 1),
                     ("Sequential", "RegModel", 3)]
    runs["first"].train()
    state = str(tmp_path / "state.pt")
    runs["first"].save_training_state(1, state)
    assert runs["resumed"].load_training_state(state) == 1
    runs["resumed"].train()
    np.testing.assert_array_equal(runs["resumed"].train_loss,
                                  runs["whole"].train_loss[2:])
    runs["whole"].save_model(3)
    saved = {p.name for p in (tmp_path / "whole" / "port" / "latest")
             .iterdir()}
    assert {"model.pt", "train_state.pt", "1_3_bias.txt",
            "cv_numpy_spec.json", "scripted_cv_cpu.pt"} <= saved

"""PyTorch port, the autoencoder: ``AutoEncoder`` and ``weighted_mse_loss``
against the JAX package on the same numpy inputs, and ``AutoEncoderTask``
training against the JAX task, weights carried across with
``AutoEncoder.from_numpy`` and the split injected; through the plain
alignment and through K2's route (the JAX side's Pallas kernel in interpret
mode). Also ``reg_model()`` on every task and the AE's resume. float64 on
both sides unless a test says otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colvarsfinder_tpu import config as jconfig
from colvarsfinder_tpu.core import AutoEncoderTask as JaxTask
from colvarsfinder_tpu.core.losses import weighted_mse_loss as jax_mse
from colvarsfinder_tpu.models import AutoEncoder as JaxAutoEncoder
from colvarsfinder_tpu.ops.alignment import AlignmentLayer as JaxAlign
from colvarsfinder_tpu.ops.features import Feature as JaxFeature
from colvarsfinder_tpu.ops.features import FeatureLayer as JaxFeatureLayer
from colvarsfinder_tpu.ops.features import PreprocessingANN as JaxPP
from colvarsfinder_tpu.ops.kabsch_pallas import FusedAlignmentLayer as JaxFused
from colvarsfinder_tpu.utils import WeightedTrajectory as JaxTraj

import colvarsfinder_tpu_torch as port
from colvarsfinder_tpu_torch import config as pconfig
from colvarsfinder_tpu_torch.core.losses import weighted_mse_loss

N_ATOMS, B = 5, 48
FEATS = [("p", "position", [0, 1, 2, 3, 4]), ("b", "bond", [0, 3])]
D_R = 3 * N_ATOMS + 1
E_DIMS, D_DIMS = [D_R, 10, 10, 2], [2, 10, 10, D_R]


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


def _pp(lib, ref, kind="align"):
    """The same preprocessing from either package: the plain alignment
    (``align``) or K2's layer (``fused``), then the features."""
    jax_lib = lib == "jax"
    feats = [(JaxFeature if jax_lib else port.Feature)(*f) for f in FEATS]
    layer = (JaxFeatureLayer if jax_lib else port.FeatureLayer)(feats)
    idx = list(range(N_ATOMS))
    if kind == "fused":
        al = (JaxFused if jax_lib else port.FusedAlignmentLayer)(ref, idx)
    else:
        al = (JaxAlign if jax_lib else port.AlignmentLayer)(ref, idx)
    return (JaxPP if jax_lib else port.PreprocessingANN)(al, layer)


def _np_params(seq):
    return [{n: np.asarray(v) for n, v in p.items()} for p in seq.params]


def _models(seed=1, activation="tanh"):
    jm = JaxAutoEncoder(E_DIMS, D_DIMS, activation, seed=seed)
    return jm, port.AutoEncoder.from_numpy(
        _np_params(jm.encoder), _np_params(jm.decoder), activation)


def _jax_named(m):
    """A JAX autoencoder's parameters (or gradients) under the port's
    parameter names."""
    out = {}
    for part in ("encoder", "decoder"):
        for li, layer in enumerate(getattr(m, part).params):
            for name in ("weight", "bias"):
                out[f"{part}.{li + 1}.{name}"] = np.asarray(layer[name])
    return out


def _grads_close(jgrad, tm, rtol):
    """Every parameter gradient within ``rtol`` of the JAX one, entries
    near zero against the largest gradient entry."""
    want = _jax_named(jgrad)
    scale = max(float(np.abs(v).max()) for v in want.values())
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=rtol,
                                   atol=rtol * scale, err_msg=name)


# ---------------------------------------------------------------------------
# the model and the loss
@pytest.mark.parametrize("activation", ["tanh", "gelu"])
def test_autoencoder_matches_jax(f64, activation):
    jm, tm = _models(activation=activation)
    assert tm.encoded_dim == jm.encoded_dim == 2
    x = np.random.default_rng(0).standard_normal((20, D_R))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
        enc = tm.encoder(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(enc, np.asarray(jm.encoder(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    for cv in range(2):
        pj, pt = jm.get_params_of_cv(cv), tm.get_params_of_cv(cv)
        assert [n for n, _ in pt] == [n for n, _ in pj]
        for (_, a), (_, b) in zip(pt, pj):
            np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="range"):
        tm.get_params_of_cv(2)


def test_autoencoder_init():
    a = port.AutoEncoder(E_DIMS, D_DIMS, seed=3)
    b = port.AutoEncoder(E_DIMS, D_DIMS, "relu", seed=3)
    assert a.encoder.activation == "tanh" and b.decoder.activation == "relu"
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)  # the seed alone decides the weights
    assert a.encoder.layer_dims == tuple(E_DIMS)
    assert a.decoder.layer_dims == tuple(D_DIMS)
    with pytest.raises(ValueError, match="do not match"):
        port.AutoEncoder([4, 3], [2, 4])


def test_weighted_mse_loss_matches_jax(f64):
    rng = np.random.default_rng(2)
    X, w = rng.standard_normal((B, D_R)), rng.uniform(0.5, 1.5, B)
    jm, tm = _models()

    def jloss(m):
        return jax_mse(m, jnp.asarray(X), jnp.asarray(w))

    loss_t = weighted_mse_loss(tm, torch.from_numpy(X), torch.from_numpy(w))
    np.testing.assert_allclose(loss_t.item(), float(jloss(jm)), rtol=1e-10)
    loss_t.backward()
    _grads_close(jax.grad(jloss)(jm), tm, 1e-10)


# ---------------------------------------------------------------------------
# the task
N_FRAMES, DT = 400, 0.01
TASK_ARGS = dict(learning_rate=0.01, batch_size=96, num_epochs=3,
                 test_ratio=0.25, verbose=False, tensorboard=False, seed=0,
                 debug_mode=False, save_model_every_step=0)


def _split():
    perm = np.random.default_rng(10).permutation(N_FRAMES)
    return perm[100:], perm[:100]


def _task_pair(tmp_path, kind="align", jax_too=True, **kw):
    ref, x = _frames(N_FRAMES, seed=11)
    w = np.random.default_rng(12).uniform(0.5, 1.5, N_FRAMES)
    jm, tm = _models(seed=13)
    args = {**TASK_ARGS, "split_indices": _split(), **kw}
    jt = JaxTask(JaxTraj(trajectory=x, weights=w, dt=DT, verbose=False),
                 _pp("jax", ref, kind), jm, str(tmp_path / "jax"),
                 export_cv=False, **args) if jax_too else None
    pt = port.AutoEncoderTask(
        port.WeightedTrajectory(trajectory=x, weights=w, dt=DT,
                                verbose=False),
        _pp("port", ref, kind), tm, str(tmp_path / "port"), device="cpu",
        **args)
    return jt, pt, x


@pytest.mark.parametrize("kind", ["align", "fused"])
def test_autoencoder_task_curves_match_jax(f64, tmp_path, kind):
    """``fused``: K2's route on both sides (the port's plain version on the
    CPU, the JAX kernel in interpret mode), both in float32 inside."""
    jt, pt, x = _task_pair(tmp_path, kind)
    # the features, once for the whole trajectory: float64 through the
    # plain layer; K2's float32 bar against the JAX kernel
    # (tests/test_torch_alignment.py)
    tol = dict(rtol=1e-10, atol=1e-12) if kind == "align" else dict(atol=2e-4)
    np.testing.assert_allclose(pt._feature_traj.numpy(),
                               np.asarray(jt._feature_traj), **tol)
    jt.train()
    pt.train()
    assert pt.loss_names == list(jt.train_loss_df.columns) == ["loss"]
    np.testing.assert_allclose(pt.train_loss, jt.train_loss_df.to_numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(pt.test_loss, jt.test_loss_df.to_numpy(),
                               rtol=1e-6)
    assert pt.train_loss[-1, 0] < pt.train_loss[0, 0]
    # the CV: the preprocessing layer and the trained encoder
    with torch.no_grad():
        cv = pt.colvar_model()(torch.from_numpy(x[:9])).numpy()
    np.testing.assert_allclose(cv, np.asarray(jt.colvar_model()(
        jnp.asarray(x[:9]))), rtol=1e-6, atol=1e-9)
    assert pt.reg_model() is None and jt.reg_model() is None
    # the per-batch loss method on the trained model
    X = pt._feature_traj[:20].numpy()
    w = np.linspace(0.5, 1.5, 20)
    np.testing.assert_allclose(pt.weighted_MSE_loss(X, w).item(),
                               float(jt.weighted_MSE_loss(X, w)), rtol=1e-6)


def test_identity_preprocessing_keeps_the_trajectory(tmp_path):
    x = np.random.default_rng(0).standard_normal((50, D_R)).astype(np.float32)
    task = port.AutoEncoderTask(
        port.WeightedTrajectory(trajectory=x, dt=DT, verbose=False), None,
        port.AutoEncoder(E_DIMS, D_DIMS), str(tmp_path), device="cpu",
        **{**TASK_ARGS, "batch_size": 10})
    # no copy: the features are the trajectory's own memory
    assert np.shares_memory(task._feature_traj.numpy(), x)
    task.train()
    assert np.isfinite(task.train_loss).all()


def test_task_checks_its_model(tmp_path):
    x = np.zeros((20, D_R), np.float32)
    traj = port.WeightedTrajectory(trajectory=x, dt=DT, verbose=False)
    for model in (port.EigenFunctions([D_R, 4, 1], 2),
                  port.RegAutoEncoder(E_DIMS, D_DIMS, [2, 4, 1], 2)):
        with pytest.raises(TypeError, match="class AutoEncoder"):
            port.AutoEncoderTask(traj, None, model, str(tmp_path),
                                 device="cpu")


def test_resume_and_save(tmp_path):
    """Two epochs, then two more after loading the first run's state,
    equal four in one go; save_model writes the encoder's CV dumps and
    artifacts."""
    x = np.random.default_rng(3).standard_normal((200, D_R)).astype(
        np.float32)
    runs = {}
    for name, epochs in (("whole", 4), ("first", 2), ("resumed", 2)):
        runs[name] = port.AutoEncoderTask(
            port.WeightedTrajectory(trajectory=x, dt=DT, verbose=False),
            None, port.AutoEncoder(E_DIMS, D_DIMS, seed=5),
            str(tmp_path / name), device="cpu",
            **{**TASK_ARGS, "batch_size": 40, "num_epochs": epochs})
    runs["whole"].train()
    runs["first"].train()
    state = str(tmp_path / "state.pt")
    runs["first"].save_training_state(1, state)
    assert runs["resumed"].load_training_state(state) == 1
    runs["resumed"].train()
    np.testing.assert_array_equal(runs["resumed"].train_loss,
                                  runs["whole"].train_loss[2:])
    runs["whole"].save_model(3)
    saved = {p.name for p in (tmp_path / "whole" / "latest").iterdir()}
    assert {"model.pt", "train_state.pt", "0_1_weight.txt", "1_3_bias.txt",
            "cv_numpy_spec.json", "scripted_cv_cpu.pt"} <= saved
    assert "2_1_weight.txt" not in saved  # two CVs: the encoder's outputs


def test_reg_model_on_every_task(tmp_path):
    """None on the eigenfunction, committor and autoencoder tasks; the
    reordered heads on the regularized autoencoder's."""
    x = np.random.default_rng(4).standard_normal((60, 2)).astype(np.float32)
    traj = port.WeightedTrajectory(trajectory=x, dt=DT, verbose=False)
    common = dict(device="cpu", verbose=False, tensorboard=False)
    tasks = [
        port.EigenFunctionTask(traj, None, port.EigenFunctions([2, 4, 1], 1),
                               str(tmp_path), alpha=1.0, eig_weights=[1.0],
                               **common),
        port.CommittorTask(traj, None, port.create_sequential_nn([2, 4, 1]),
                           str(tmp_path), region_a=x[:, 0] < -1,
                           region_b=x[:, 0] > 1, **common),
        port.AutoEncoderTask(traj, None, port.AutoEncoder([2, 4, 1],
                                                          [1, 4, 2]),
                             str(tmp_path), **common),
    ]
    assert all(t.reg_model() is None for t in tasks)
    reg = port.RegAutoEncoderTask(
        traj, None, port.RegAutoEncoder([2, 4, 1], [1, 4, 2], [1, 3, 1], 2),
        str(tmp_path), eig_weights=[1.0, 0.5], **common)
    rm = reg.reg_model()
    assert isinstance(rm, port.ColvarModel)
    assert isinstance(rm.head, port.RegModel) and rm.head.cvec == (0, 1)
    reg._cvec = np.array([1, 0])
    with torch.no_grad():
        xt = torch.from_numpy(x)
        np.testing.assert_array_equal(
            reg.reg_model()(xt).numpy(),
            reg.model.forward_reg(xt).numpy()[:, ::-1])

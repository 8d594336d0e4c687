"""PyTorch port, the committor: ``Sequential`` and its helpers, the
committor loss on the vjp and Gram paths, and ``CommittorTask`` training
against the JAX package on the same numpy trajectory, weights carried
across with ``params_from_numpy`` and the split injected; the task's
region checks, resume and committor values. float64 on both sides unless a
test says otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colvarsfinder_tpu import config as jconfig
from colvarsfinder_tpu.core import CommittorTask as JaxTask
from colvarsfinder_tpu.core.eigenfunction import _gram_fn
from colvarsfinder_tpu.core.losses import committor_loss as jax_committor_loss
from colvarsfinder_tpu.models import create_sequential_nn as jax_create
from colvarsfinder_tpu.ops.alignment import AlignmentLayer as JaxAlign
from colvarsfinder_tpu.ops.features import Feature as JaxFeature
from colvarsfinder_tpu.ops.features import FeatureLayer as JaxFeatureLayer
from colvarsfinder_tpu.ops.features import PreprocessingANN as JaxPP
from colvarsfinder_tpu.utils import WeightedTrajectory as JaxTraj

import colvarsfinder_tpu_torch as port
from colvarsfinder_tpu_torch import config as pconfig
from colvarsfinder_tpu_torch.core.losses import committor_loss
from colvarsfinder_tpu_torch.models import (
    Sequential,
    create_sequential_nn,
    params_from_numpy,
)

N_ATOMS, B = 5, 48
D_R = 3 * N_ATOMS + 1
DIMS = [D_R, 10, 10, 1]
HYPER = (40.0, 2.0)


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
    """Frames of a structure whose first atom moves along x between two
    ends, with noise on every atom."""
    rng = np.random.default_rng(seed)
    ref = 1.5 * rng.standard_normal((N_ATOMS, 3))
    x = ref[None] + 0.3 * rng.standard_normal((n, N_ATOMS, 3))
    x[:, 0, 0] += np.linspace(-1.5, 1.5, n)[rng.permutation(n)]
    return ref, x


def _pp(lib, ref):
    jax_lib = lib == "jax"
    feats = [(JaxFeature if jax_lib else port.Feature)(*f) for f in
             (("p", "position", list(range(N_ATOMS))), ("b", "bond", [0, 3]))]
    layer = (JaxFeatureLayer if jax_lib else port.FeatureLayer)(feats)
    al = (JaxAlign if jax_lib else port.AlignmentLayer)(
        ref, list(range(N_ATOMS)))
    return (JaxPP if jax_lib else port.PreprocessingANN)(al, layer)


def _models(seed=1, dims=DIMS, activation="tanh"):
    jm = jax_create(dims, activation, seed=seed)
    named = {n: np.asarray(v) for n, v in jm.named_parameters()}
    return jm, params_from_numpy(named, dims, activation)


def _grads_close(jgrad, tm, rtol):
    """Parameter gradients within ``rtol`` of the JAX ones, entries near
    zero against the largest gradient entry."""
    want = {n: np.asarray(v) for n, v in jgrad.named_parameters()}
    scale = max(float(np.abs(v).max()) for v in want.values())
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=rtol,
                                   atol=rtol * scale)


# ---------------------------------------------------------------------------
# Sequential
@pytest.mark.parametrize("activation", ["tanh", "gelu", "softplus"])
def test_sequential_matches_jax(activation):
    jm, tm = _models(dims=[6, 9, 7, 3], activation=activation)
    assert isinstance(tm, Sequential)
    assert [n for n, _ in tm.named_parameters()] == [
        n for n, _ in jm.named_parameters()]
    assert tm.layer_dims == tuple(jm.layer_dims) and tm.num_layers == 3
    x = np.random.default_rng(0).standard_normal((20, 6)).astype(np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    for cv in range(3):
        pj, pt = jm.get_params_of_cv(cv), tm.get_params_of_cv(cv)
        assert [n for n, _ in pt] == [n for n, _ in pj]
        for (_, a), (_, b) in zip(pt, pj):
            np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="range"):
        tm.get_params_of_cv(3)


def test_create_sequential_nn():
    a = create_sequential_nn([4, 6, 1], seed=3)
    b = create_sequential_nn([4, 6, 1], "relu", seed=3)
    assert a.activation == "tanh" and b.activation == "relu"
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)  # the seed alone decides the weights
    # torch.nn.Linear's default: U(-1/sqrt(d_in), 1/sqrt(d_in))
    assert a.params[0]["weight"].abs().max() <= 0.5
    assert a.params[1]["bias"].abs().max() <= 6 ** -0.5
    assert not torch.equal(create_sequential_nn([4, 6, 1], seed=4)
                           .params[0]["weight"], a.params[0]["weight"])
    with pytest.raises(ValueError, match="at least 2 layers"):
        create_sequential_nn([4])


# ---------------------------------------------------------------------------
# the loss
def _loss_inputs(seed=2):
    ref, x = _frames(B, seed)
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 1.5, B)
    a = (x[:, 0, 0] < np.quantile(x[:, 0, 0], 0.2)).astype(np.float64)
    b = (x[:, 0, 0] > np.quantile(x[:, 0, 0], 0.8)).astype(np.float64)
    dc = rng.uniform(0.2, 3.0, 3 * N_ATOMS)
    return ref, x, w, a, b, dc


@pytest.mark.parametrize("path", ["vjp", "gram"])
def test_committor_loss_matches_jax(f64, path):
    ref, x, w, a, b, dc = _loss_inputs()
    jm, tm = _models()
    pp_j, pp_t = _pp("jax", ref), _pp("port", ref)
    if path == "gram":
        H, M = _gram_fn((N_ATOMS, 3), 3 * N_ATOMS)(
            pp_j, jnp.asarray(dc), jnp.asarray(x.reshape(B, -1)))
        H, M = np.asarray(H), np.asarray(M)
        jargs = (None, jnp.asarray(H))
        jkw = dict(pp_gram=jnp.asarray(M))
        targs = (None, torch.from_numpy(H))
        tkw = dict(pp_gram=torch.from_numpy(M))
    else:
        jargs = (pp_j, jnp.asarray(x))
        jkw = dict(diag_coeff=jnp.asarray(dc))
        targs = (pp_t, torch.from_numpy(x))
        tkw = dict(diag_coeff=torch.from_numpy(dc))
    rest_j = [jnp.asarray(v) for v in (w, a, b)]
    rest_t = [torch.from_numpy(v) for v in (w, a, b)]

    def jloss(m):
        return jax_committor_loss(m, *jargs, *rest_j, HYPER, **jkw)

    loss_j, parts_j = jloss(jm)
    loss_t, parts_t = committor_loss(tm, *targs, *rest_t, HYPER, **tkw)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-10)
    for pt, pj in zip(parts_t, parts_j):
        np.testing.assert_allclose(pt.item(), float(pj), rtol=1e-10)
    assert all(float(p) > 0 for p in parts_j)  # every term is in play
    loss_t.backward()
    _grads_close(jax.grad(lambda m: jloss(m)[0])(jm), tm, 1e-10)


# ---------------------------------------------------------------------------
# the task
N_FRAMES, DT = 400, 0.01
TASK_ARGS = dict(alpha=HYPER[0], beta=HYPER[1], learning_rate=0.01,
                 batch_size=96, num_epochs=3, test_ratio=0.25, verbose=False,
                 tensorboard=False, seed=0, debug_mode=False,
                 save_model_every_step=0)


def _split():
    perm = np.random.default_rng(10).permutation(N_FRAMES)
    return perm[100:], perm[:100]


def _regions(x):
    c = x[:, 0, 0]
    hi = np.quantile(c, 0.85)
    return c < np.quantile(c, 0.15), lambda X: X[:, 0, 0] > hi


def _task_pair(tmp_path, gram, jax_too=True, **kw):
    ref, x = _frames(N_FRAMES, seed=11)
    w = np.random.default_rng(12).uniform(0.5, 1.5, N_FRAMES)
    dc = np.random.default_rng(13).uniform(0.2, 3.0, 3 * N_ATOMS)
    region_a, region_b = _regions(x)
    jm, tm = _models(seed=14)
    args = {**TASK_ARGS, "diag_coeff": dc, "gram_pp": gram,
            "split_indices": _split(), "region_a": region_a,
            "region_b": region_b, **kw}
    jt = JaxTask(JaxTraj(trajectory=x, weights=w, dt=DT, verbose=False),
                 _pp("jax", ref), jm, str(tmp_path / "jax"), export_cv=False,
                 **args) if jax_too else None
    pt = port.CommittorTask(
        port.WeightedTrajectory(trajectory=x, weights=w, dt=DT,
                                verbose=False),
        _pp("port", ref), tm, str(tmp_path / "port"), device="cpu", **args)
    return jt, pt, x


@pytest.mark.parametrize("gram", [True, False])
def test_committor_task_curves_match_jax(f64, tmp_path, gram):
    jt, pt, x = _task_pair(tmp_path, gram)
    jt.train()
    pt.train()
    assert jt._gram is pt._gram is gram
    assert pt.loss_names == list(jt.train_loss_df.columns)
    np.testing.assert_allclose(pt.train_loss, jt.train_loss_df.to_numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(pt.test_loss, jt.test_loss_df.to_numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(pt.committor_values(x[:50]),
                               jt.committor_values(x[:50]), rtol=1e-6)
    q = pt.committor_values(x)
    assert q.shape == (N_FRAMES,) and ((q > 0) & (q < 1)).all()
    # the CV is the logit of q
    with torch.no_grad():
        logit = pt.colvar_model()(torch.from_numpy(x[:7]))[:, 0].numpy()
    np.testing.assert_allclose(1 / (1 + np.exp(-logit)), q[:7], rtol=1e-12)


def test_gram_default_and_limit(tmp_path, monkeypatch):
    _, pt, _ = _task_pair(tmp_path, None, False)
    assert pt._gram_requested and not pt._gram_explicit
    ident, _ = _small(tmp_path / "ident")
    assert not ident._gram_requested
    monkeypatch.setattr(port.CommittorTask, "GRAM_AUTO_LIMIT_BYTES", 1)
    _, explicit, _ = _task_pair(tmp_path / "x", True, False)
    with pytest.warns(UserWarning, match="gram_pp=True could not be honored"):
        explicit._prepare_data()
    assert not explicit._gram
    assert len(explicit._prepared[0][0]) == 4  # (X, w, a, b): the vjp path


def _small(tmp_path, model=None, **kw):
    x = np.random.default_rng(0).standard_normal((100, 1)).astype(np.float32)
    traj = port.WeightedTrajectory(trajectory=x, dt=0.1, verbose=False)
    args = dict(region_a=lambda X: X[:, 0] < -1,
                region_b=lambda X: X[:, 0] > 1, verbose=False,
                device="cpu", tensorboard=False)
    args.update(kw)
    model = create_sequential_nn([1, 8, 1], seed=1) if model is None else model
    return port.CommittorTask(traj, None, model, str(tmp_path), **args), x


def test_region_validation(tmp_path):
    with pytest.raises(ValueError, match="no trajectory frame"):
        _small(tmp_path, region_a=lambda X: X[:, 0] > 99.0)
    with pytest.raises(ValueError, match="overlap"):
        _small(tmp_path, region_a=lambda X: X[:, 0] > 0,
               region_b=lambda X: X[:, 0] > -1)
    with pytest.raises(ValueError, match="values for"):
        _small(tmp_path, region_a=np.zeros(5, bool))
    # boolean arrays and callables mark the same frames
    task, x = _small(tmp_path)
    task2, _ = _small(tmp_path, region_a=x[:, 0] < -1,
                      region_b=list(x[:, 0] > 1))
    np.testing.assert_array_equal(task._mask_a, task2._mask_a)
    np.testing.assert_array_equal(task._mask_b, task2._mask_b)


@pytest.mark.parametrize("out", ["two_outputs", "rank_one"])
def test_a_non_scalar_model_raises(tmp_path, out):
    if out == "two_outputs":
        model = create_sequential_nn([1, 8, 2], seed=1)
    else:
        model = port.ops.Lambda(lambda x: x.sum(dim=-1))
    with pytest.raises(ValueError, match=r"\[B, 1\]"):
        _small(tmp_path, model=model)


def test_boundary_frames_must_reach_training(tmp_path):
    x = np.random.default_rng(3).standard_normal((40, 1)).astype(np.float32)
    traj = port.WeightedTrajectory(trajectory=x, dt=0.1, verbose=False)
    task = port.CommittorTask(
        traj, None, create_sequential_nn([1, 8, 1]), str(tmp_path),
        region_a=np.arange(40) < 5, region_b=np.arange(40) >= 35,
        num_epochs=1, batch_size=8, verbose=False, device="cpu",
        tensorboard=False, split_indices=(np.arange(8, 40), np.arange(8)))
    with pytest.raises(ValueError, match="training batches"):
        task._prepare_data()


def test_resume_and_save(tmp_path):
    """Two epochs, then two more after loading the first run's state,
    equal four in one go; save_model writes the CV dumps and artifacts."""
    runs = {}
    for name, epochs in (("whole", 4), ("first", 2), ("resumed", 2)):
        runs[name], _ = _small(tmp_path / name, num_epochs=epochs,
                               batch_size=20, seed=0)
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
    assert {"model.pt", "train_state.pt", "0_1_weight.txt", "0_2_bias.txt",
            "cv_numpy_spec.json", "scripted_cv_cpu.pt"} <= saved

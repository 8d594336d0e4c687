"""PyTorch port, the slice as a whole: transfer-operator EigenFunctionTask
training with AlignmentLayer + position features against the JAX task, on
the same numpy trajectory, transplanted initial weights and injected
split; the port's own split against scikit-learn's; save_model's files;
``loss_func`` against the JAX task's in float64; the JAX package's batch
layouts (``prebatch=`` / ``unroll_batches=``), which change no result, and
their refusals."""

import math

import numpy as np
import pytest
import torch

from colvarsfinder_tpu import config as jconfig
from colvarsfinder_tpu.core import CommittorTask as JaxComTask
from colvarsfinder_tpu.core import EigenFunctionTask as JaxTask
from colvarsfinder_tpu.core import RegAutoEncoderTask as JaxRegTask
from colvarsfinder_tpu.models import EigenFunctions as JaxEigenFunctions
from colvarsfinder_tpu.models import RegAutoEncoder as JaxRegAE
from colvarsfinder_tpu.models import create_sequential_nn as jax_seq
from colvarsfinder_tpu.ops.alignment import AlignmentLayer as JaxAlign
from colvarsfinder_tpu.ops.features import Feature as JaxFeature
from colvarsfinder_tpu.ops.features import FeatureLayer as JaxFeatureLayer
from colvarsfinder_tpu.ops.features import PreprocessingANN as JaxPP
from colvarsfinder_tpu.utils import WeightedTrajectory as JaxTraj

from colvarsfinder_tpu_torch import (
    AlignmentLayer,
    CommittorTask,
    EigenFunctions,
    EigenFunctionTask,
    Feature,
    FeatureLayer,
    PreprocessingANN,
    RegAutoEncoder,
    RegAutoEncoderTask,
    WeightedTrajectory,
    create_sequential_nn,
)
from colvarsfinder_tpu_torch import config as pconfig
from colvarsfinder_tpu_torch.core.task import train_test_split
from colvarsfinder_tpu_torch.ops import _cuda

N_FRAMES, N_ATOMS, DT, LAG = 1200, 6, 0.01, 2
DIMS, K = [18, 10, 10, 1], 2


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trajectory(seed=0):
    """A structure whose atoms wander as slow AR(1) processes."""
    rng = np.random.default_rng(seed)
    base = 1.5 * rng.standard_normal((N_ATOMS, 3))
    noise = np.zeros((N_FRAMES, N_ATOMS, 3))
    for t in range(1, N_FRAMES):
        noise[t] = 0.95 * noise[t - 1] + 0.1 * rng.standard_normal((N_ATOMS, 3))
    x = (base[None] + noise).astype(np.float32)
    w = rng.uniform(0.5, 1.5, N_FRAMES)
    return x, w


COMMON = dict(alpha=8.0, eig_weights=[1.0, 0.5], lag_tau=LAG * DT, k=K,
              learning_rate=0.005, batch_size=400, num_epochs=4,
              test_ratio=0.2, verbose=False, tensorboard=False, seed=0,
              debug_mode=False)


def _sk_split():
    # the port reproduces scikit-learn's split without it; compare where it
    # is installed
    return pytest.importorskip("sklearn.model_selection").train_test_split


def _split(n_pairs):
    return _sk_split()(np.arange(n_pairs), test_size=COMMON["test_ratio"],
                    random_state=0)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    x, w = _trajectory()
    split = _split(N_FRAMES - LAG)
    jm = JaxEigenFunctions(DIMS, K, seed=3)
    params = [{n: np.asarray(v) for n, v in p.items()} for p in jm.params]
    pp = JaxPP(JaxAlign(x[0], list(range(N_ATOMS))),
               JaxFeatureLayer([JaxFeature("p", "position",
                                           list(range(N_ATOMS)))]))
    task = JaxTask(JaxTraj(trajectory=x, weights=w, dt=DT, verbose=False),
                   pp, jm, str(tmp_path_factory.mktemp("jax")),
                   save_model_every_step=0, split_indices=split,
                   export_cv=False, **COMMON)
    task.train()
    return dict(x=x, w=w, split=split, params=params,
                loss=task.train_loss_df.to_numpy(),
                test=task.test_loss_df.to_numpy(), cvec=task._cvec)


def _port_task(run, path, fused, method="quaternion", **kw):
    traj = WeightedTrajectory(trajectory=run["x"], weights=run["w"], dt=DT,
                              verbose=False)
    pp = PreprocessingANN(
        AlignmentLayer(run["x"][0], list(range(N_ATOMS)), method=method),
        FeatureLayer([Feature("p", "position", list(range(N_ATOMS)))]),
    )
    model = EigenFunctions.from_numpy(run["params"])
    args = {**COMMON, "save_model_every_step": 0, **kw}
    return EigenFunctionTask(traj, pp, model, str(path), device="cpu",
                             fused_step=fused, **args)


@pytest.mark.parametrize(
    "fused,method,rtol_loss,rtol_eig",
    [
        # same plain math in two libraries, 8 Adam steps: f32 rounding only
        (False, "quaternion", 1e-4, 1e-4),
        # the fused step's sums run in another order: the JAX package's own
        # fused-vs-plain bar (test_fused_eigen)
        (True, "quaternion", 2e-3, 5e-3),
        # 'cuda' alignment takes K1's plain version on the CPU
        (False, "cuda", 1e-4, 1e-4),
    ],
)
def test_training_curves_match_jax(jax_run, tmp_path, fused, method,
                                   rtol_loss, rtol_eig):
    _cuda.reset_launch_counts()
    task = _port_task(jax_run, tmp_path, fused, method,
                      split_indices=jax_run["split"])
    task.train()
    assert sum(_cuda.launch_counts().values()) == 0  # CPU: no kernel
    assert task.train_loss.shape == jax_run["loss"].shape == (4, 3 + K)
    assert task.loss_names == ["loss", "eigen_non_penalty", "eigen_penalty",
                               "eig_1", "eig_2"]
    for got, want in ((task.train_loss, jax_run["loss"]),
                      (task.test_loss, jax_run["test"])):
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=rtol_loss)
        np.testing.assert_allclose(got[:, 3:], want[:, 3:], rtol=rtol_eig)
    np.testing.assert_array_equal(task._cvec, jax_run["cvec"])
    assert list(task.train_loss_df.columns) == task.loss_names


def test_save_model_and_resume(jax_run, tmp_path):
    task = _port_task(jax_run, tmp_path, fused=True, save_model_every_step=2,
                      debug_mode=True)
    task.train()
    assert task._cvec is not None and len(task.epoch_times) == 4
    latest = tmp_path / "latest"
    for name in ("model.pt", "train_state.pt", "0_1_weight.txt",
                 "1_3_bias.txt", "cv_exported.bin", "cv_grad_exported.bin"):
        assert (latest / name).is_file(), name
    # every save (two periodic, and "best" whenever the test loss fell)
    # wrote the programs traced once
    assert len(task._export_cache) == 2
    assert (tmp_path / "best" / "model.pt").is_file()
    assert (tmp_path / "models" / "model_3.pt").is_file()
    np.testing.assert_allclose(
        np.loadtxt(latest / "1_1_weight.txt"),
        task.model.weights[0][1].detach().numpy(), rtol=1e-6)
    # the full training state restores the parameters, Adam's moments and
    # the epoch
    fresh = _port_task(jax_run, tmp_path / "r", fused=True)
    assert fresh.load_training_state(str(latest / "train_state.pt")) == 3
    for a, b in zip(fresh.model.parameters(), task.model.parameters()):
        assert torch.equal(a, b)
    st_a = fresh.optimizer.state_dict()["state"]
    st_b = task.optimizer.state_dict()["state"]
    assert torch.equal(st_a[0]["exp_avg_sq"], st_b[0]["exp_avg_sq"])
    # the CV model orders the heads by the last cvec
    cv = task.colvar_model()
    xb = torch.from_numpy(jax_run["x"][:5])
    np.testing.assert_allclose(
        cv(xb).detach().numpy(),
        task.model(task.preprocessing_layer(xb)).detach().numpy()[:, task._cvec],
        rtol=1e-6,
    )


@pytest.mark.parametrize("n,ratio,seed", [(1198, 0.2, 0), (120000, 0.001, 0),
                                          (997, 0.33, 7)])
def test_split_equals_sklearn(n, ratio, seed):
    sk_split = _sk_split()
    idx = np.arange(n) * 3 + 1
    tr, te = train_test_split(idx, ratio, seed)
    sk_tr, sk_te = sk_split(idx, test_size=ratio, random_state=seed)
    np.testing.assert_array_equal(tr, sk_tr)
    np.testing.assert_array_equal(te, sk_te)
    assert len(te) == math.ceil(ratio * n)


def test_task_split_and_segments_equal_sklearn(jax_run, tmp_path):
    sk_split = _sk_split()
    task = _port_task(jax_run, tmp_path, fused=False)
    tr, te = task._lagged_split(LAG)
    sk_tr, sk_te = _split(N_FRAMES - LAG)
    np.testing.assert_array_equal(tr, sk_tr)
    np.testing.assert_array_equal(te, sk_te)
    # multi-segment data: only lagged pairs inside one segment are drawn
    segs = [0, 500, 900]
    traj = WeightedTrajectory(trajectory=jax_run["x"], dt=DT, verbose=False,
                              segment_starts=segs)
    jtraj = JaxTraj(trajectory=jax_run["x"], dt=DT, verbose=False,
                    segment_starts=segs)
    cand = traj.valid_lagged_starts(LAG)
    np.testing.assert_array_equal(cand, jtraj.valid_lagged_starts(LAG))
    task.traj_obj = traj
    tr, te = task._lagged_split(LAG)
    sk_tr, sk_te = sk_split(cand, test_size=0.2, random_state=0)
    np.testing.assert_array_equal(tr, sk_tr)
    np.testing.assert_array_equal(te, sk_te)
    assert not np.isin(np.concatenate([tr, te]), [498, 499, 898, 899]).any()


def test_task_guards(jax_run, tmp_path):
    # export_cv defaults to True, as in the JAX package
    assert _port_task(jax_run, tmp_path, fused=False).export_cv is True
    with pytest.raises(ValueError, match="shared memory"):
        traj = WeightedTrajectory(trajectory=jax_run["x"], dt=DT,
                                  verbose=False)
        EigenFunctionTask(traj, None, EigenFunctions([18, 512, 512, 1], 2),
                          str(tmp_path), device="cpu", fused_step=True,
                          **{**COMMON, "save_model_every_step": 0})


@pytest.fixture
def f64():
    """Both packages in float64, float32 restored afterwards."""
    jconfig.set_default_dtype("float64")
    pconfig.set_default_dtype("float64")
    yield
    jconfig.set_default_dtype("float32")
    pconfig.set_default_dtype("float32")


@pytest.mark.parametrize("lag", [LAG, 0], ids=["transfer", "generator"])
def test_loss_func_matches_jax(f64, tmp_path, lag):
    """One batch through both tasks' ``loss_func`` in float64: the loss,
    eigenvalues, non-penalty loss and penalty within 1e-9, the same cvec;
    the generator with a non-uniform ``diag_coeff`` and beta 2."""
    x, w = _trajectory()
    x = x.astype(np.float64)
    jm = JaxEigenFunctions(DIMS, K, seed=3)
    params = [{n: np.asarray(v) for n, v in p.items()} for p in jm.params]
    common = {**COMMON, "lag_tau": lag * DT, "save_model_every_step": 0}
    if lag == 0:
        common.update(beta=2.0, diag_coeff=np.random.default_rng(4).uniform(
            0.5, 2.0, 3 * N_ATOMS))
    atoms = list(range(N_ATOMS))
    jpp = JaxPP(JaxAlign(x[0], atoms),
                JaxFeatureLayer([JaxFeature("p", "position", atoms)]))
    tpp = PreprocessingANN(AlignmentLayer(x[0], atoms),
                           FeatureLayer([Feature("p", "position", atoms)]))
    jtask = JaxTask(JaxTraj(trajectory=x, weights=w, dt=DT, verbose=False),
                    jpp, jm, str(tmp_path / "j"), export_cv=False, **common)
    ttask = EigenFunctionTask(
        WeightedTrajectory(trajectory=x, weights=w, dt=DT, verbose=False),
        tpp, EigenFunctions.from_numpy(params), str(tmp_path / "t"),
        device="cpu", **common)
    n = 300
    batch = (x[:n], w[:n]) + ((x[lag:n + lag], w[lag:n + lag]) if lag
                              else (None, None))
    jout = jtask.loss_func(*batch)
    tout = ttask.loss_func(*batch)
    assert tout[0].dtype == torch.float64 and tout[0].requires_grad
    for name, a, b in zip(("loss", "eig_vals", "non_penalty", "penalty"),
                          tout[:4], jout[:4]):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=1e-9, err_msg=name)
    np.testing.assert_array_equal(tout[4].numpy(), np.asarray(jout[4]))


@pytest.fixture(scope="module")
def default_curves(jax_run, tmp_path_factory):
    task = _port_task(jax_run, tmp_path_factory.mktemp("layout"), False)
    task.train()
    return task.train_loss, task.test_loss


@pytest.mark.parametrize("layout", [
    dict(prebatch=True), dict(prebatch=False), dict(unroll_batches=True),
    dict(unroll_batches=False)], ids=["prebatch", "gather_per_step",
                                      "unrolled", "scanned"])
def test_batch_layouts_leave_the_curves_unchanged(jax_run, default_curves,
                                                  tmp_path, layout):
    task = _port_task(jax_run, tmp_path, False, **layout)
    task.train()
    np.testing.assert_array_equal(task.train_loss, default_curves[0])
    np.testing.assert_array_equal(task.test_loss, default_curves[1])


def _flat_task(lib, family, path, **kw):
    """A small task of ``family`` on flat 4-dimensional frames, through the
    JAX package (``lib='jax'``) or the port."""
    rng = np.random.default_rng(5)
    x = np.cumsum(0.1 * rng.standard_normal((400, 4)), axis=0).astype(
        np.float32)
    jax = lib == "jax"
    traj = (JaxTraj if jax else WeightedTrajectory)(trajectory=x, dt=DT,
                                                    verbose=False)
    args = dict(batch_size=100, num_epochs=2, test_ratio=0.25,
                save_model_every_step=0, verbose=False, debug_mode=False,
                tensorboard=False, seed=0, **kw)
    if not jax:
        args["device"] = "cpu"
    if family == "eigen":
        model = (JaxEigenFunctions([4, 6, 1], 2, seed=1) if jax
                 else EigenFunctions([4, 6, 1], 2))
        cls = JaxTask if jax else EigenFunctionTask
        args.update(alpha=1.0, eig_weights=[1.0, 0.5], lag_tau=DT, k=2)
    elif family == "regae":
        dims = ([4, 6, 2], [2, 6, 4], [2, 5, 1])
        model = JaxRegAE(*dims, K=2, seed=1) if jax else RegAutoEncoder(
            *dims, 2)
        cls = JaxRegTask if jax else RegAutoEncoderTask
        args.update(eig_weights=[1.0, 0.5], gamma=(0.5, 0.0), lag_tau_reg=DT)
    else:
        model = jax_seq([4, 6, 1], seed=1) if jax else create_sequential_nn(
            [4, 6, 1])
        cls = JaxComTask if jax else CommittorTask
        args.update(region_a=x[:, 0] < np.quantile(x[:, 0], 0.2),
                    region_b=x[:, 0] > np.quantile(x[:, 0], 0.8))
    return cls(traj, None, model, str(path), **args)


@pytest.mark.parametrize("family,layout", [
    ("regae", dict(prebatch=True)), ("regae", dict(prebatch=False)),
    ("committor", dict(unroll_batches=True)),
    ("committor", dict(unroll_batches=False))])
def test_other_families_accept_the_layouts(tmp_path, family, layout):
    plain = _flat_task("port", family, tmp_path / "a")
    plain.train()
    task = _flat_task("port", family, tmp_path / "b", **layout)
    task.train()
    np.testing.assert_array_equal(task.train_loss, plain.train_loss)


@pytest.mark.parametrize("family", ["eigen", "regae"])
def test_streaming_refuses_per_step_gathers_as_jax(tmp_path, family):
    """``streaming=True`` with ``prebatch=False`` raises ``ValueError``
    where the JAX package asserts, with its message."""
    with pytest.raises(AssertionError) as jerr:
        _flat_task("jax", family, tmp_path / "j", streaming=True,
                   prebatch=False, export_cv=False)
    with pytest.raises(ValueError) as terr:
        _flat_task("port", family, tmp_path / "t", streaming=True,
                   prebatch=False)
    assert str(terr.value) == str(jerr.value)
    assert "prebatch=False" in str(terr.value)
    with pytest.raises(ValueError, match="incompatible with shard_traj"):
        _flat_task("port", family, tmp_path / "s", prebatch=True,
                   shard_trajectory=True)

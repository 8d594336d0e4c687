"""PyTorch port, the slice as a whole: transfer-operator EigenFunctionTask
training with AlignmentLayer + position features against the JAX task, on
the same numpy trajectory, transplanted initial weights and injected
split; the port's own split against scikit-learn's; save_model's files."""

import math

import numpy as np
import pytest
import torch

from colvarsfinder_tpu.core import EigenFunctionTask as JaxTask
from colvarsfinder_tpu.models import EigenFunctions as JaxEigenFunctions
from colvarsfinder_tpu.ops.alignment import AlignmentLayer as JaxAlign
from colvarsfinder_tpu.ops.features import Feature as JaxFeature
from colvarsfinder_tpu.ops.features import FeatureLayer as JaxFeatureLayer
from colvarsfinder_tpu.ops.features import PreprocessingANN as JaxPP
from colvarsfinder_tpu.utils import WeightedTrajectory as JaxTraj

from colvarsfinder_tpu_torch import (
    AlignmentLayer,
    EigenFunctions,
    EigenFunctionTask,
    Feature,
    FeatureLayer,
    PreprocessingANN,
    WeightedTrajectory,
)
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
                 "1_3_bias.txt"):
        assert (latest / name).is_file(), name
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _port_task(jax_run, tmp_path, fused=False, export_cv=True)
    with pytest.raises(ValueError, match="shared memory"):
        traj = WeightedTrajectory(trajectory=jax_run["x"], dt=DT,
                                  verbose=False)
        EigenFunctionTask(traj, None, EigenFunctions([18, 512, 512, 1], 2),
                          str(tmp_path), device="cpu", fused_step=True,
                          **{**COMMON, "save_model_every_step": 0})

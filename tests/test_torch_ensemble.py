"""PyTorch port, replica sweeps (parallel/ensemble.py): the port's
train_hyperparameter_sweep and train_replica_ensemble against the JAX
package's on the same grid, initial parameters and split, in float64 on
both sides, for all four task families; every sweep replica against the
port's own solo train(); chunking, refusals, adopt_sweep_result, the task
left untouched, the sweep scorers, explore_then_finetune,
train_architecture_ensemble, the replica optimizer against torch.optim and
optax, and the functional input Jacobian. Small shapes: 2-D toy data or
four-atom frames, [2, 10, 1]-sized heads, three epochs."""

import types

import numpy as np
import pytest
import torch

import optax
import jax
import jax.numpy as jnp

from colvarsfinder_tpu import config as jconfig
from colvarsfinder_tpu.core import AutoEncoderTask as JaxAETask
from colvarsfinder_tpu.core import CommittorTask as JaxComTask
from colvarsfinder_tpu.core import EigenFunctionTask as JaxEigTask
from colvarsfinder_tpu.core import RegAutoEncoderTask as JaxRegTask
from colvarsfinder_tpu.models import AutoEncoder as JaxAE
from colvarsfinder_tpu.models import EigenFunctions as JaxEF
from colvarsfinder_tpu.models import RegAutoEncoder as JaxRegAE
from colvarsfinder_tpu.models import create_sequential_nn as jax_seq
from colvarsfinder_tpu.ops.alignment import AlignmentLayer as JaxAlign
from colvarsfinder_tpu.ops.features import Feature as JaxFeature
from colvarsfinder_tpu.ops.features import FeatureLayer as JaxFeatureLayer
from colvarsfinder_tpu.ops.features import PreprocessingANN as JaxPP
from colvarsfinder_tpu.parallel import ensemble as jens
from colvarsfinder_tpu.utils import WeightedTrajectory as JaxTraj

import colvarsfinder_tpu_torch as port
from colvarsfinder_tpu_torch import config as pconfig
from colvarsfinder_tpu_torch.core.losses import _input_jacobian, input_jacobian
from colvarsfinder_tpu_torch.core.task import train_test_split
from colvarsfinder_tpu_torch.models.module import params_from_numpy
from colvarsfinder_tpu_torch.parallel import (
    Incompatible,
    SweepResult,
    adopt_sweep_result,
    explore_then_finetune,
    sweep_committor_checks,
    sweep_vamp_scores,
    train_architecture_ensemble,
    train_hyperparameter_sweep,
    train_replica_ensemble,
)
from colvarsfinder_tpu_torch.parallel import ensemble as pens

N, DT, TEST_RATIO = 256, 0.1, 0.25
COMMON = dict(batch_size=64, num_epochs=3, test_ratio=TEST_RATIO,
              save_model_every_step=0, verbose=False, tensorboard=False,
              debug_mode=False, seed=0)
# float64 on both sides; the two libraries sum in other orders, and Adam
# normalizes each step, so curves agree to ~1e-12 after 9 steps (the
# training bar, PERF.md §2, is 2e-3 in float32)
RTOL_JAX = 1e-9
# the port's sweep against its own solo train(): a vmapped bmm against the
# solo baddbmm, ~1e-14 after 9 steps
RTOL_SOLO = 1e-10


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def f64():
    """Both packages in float64, float32 restored afterwards."""
    jconfig.set_default_dtype("float64")
    pconfig.set_default_dtype("float64")
    yield
    jconfig.set_default_dtype("float32")
    pconfig.set_default_dtype("float32")


def _toy(seed, n=N):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 2)).astype(np.float32),
            rng.uniform(0.5, 1.5, n))


def _frames(seed=3, n=N):
    """Four atoms wandering about a reference, the first moving along x."""
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal((4, 3))
    x = ref[None] + 0.2 * rng.standard_normal((n, 4, 3))
    x[:, 0, 0] += np.linspace(-1.0, 1.0, n)[rng.permutation(n)]
    return ref, x.astype(np.float32), rng.uniform(0.5, 1.5, n)


def _pp(lib, ref):
    if ref is None:
        return None
    if lib == "jax":
        return JaxPP(JaxAlign(ref, [0, 1, 2, 3]),
                     JaxFeatureLayer([JaxFeature("p", "position",
                                                 [0, 1, 2, 3])]))
    return port.PreprocessingANN(
        port.AlignmentLayer(ref, [0, 1, 2, 3]),
        port.FeatureLayer([port.Feature("p", "position", [0, 1, 2, 3])]))


def _np(params):
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


class Family:
    """One task family's pair of tasks (JAX, port) on the same data, split
    and initial parameters, a grid, and a factory of port tasks with
    overridden hyperparameters."""

    def __init__(self, name, tmp_path, seed=0, data_seed=3):
        self.name, self.tmp = name, tmp_path
        self.seed = seed
        if name in ("transfer", "ae", "regae"):
            self.ref = None
            self.x, self.w = _toy(data_seed)
        else:
            self.ref, self.x, self.w = _frames(data_seed)
        lag = 2 if name in ("transfer", "regae") else 0
        n = len(self.x) - lag
        self.split = train_test_split(np.arange(n), TEST_RATIO, seed)
        self.grid = {
            "transfer": {"learning_rate": [0.005, 0.02, 0.05],
                         "alpha": [5.0, 20.0, 80.0]},
            "gen_gram": {"learning_rate": [0.005, 0.02],
                         "alpha": [5.0, 40.0]},
            "ae": {"learning_rate": [0.001, 0.03]},
            "regae": {"gamma": [(0.5, 0.25), (1.0, 0.1)],
                      "eta": [(0.1, 0.1, 0.1), (0.2, 0.05, 0.3)]},
            "committor": {"alpha": [50.0, 200.0], "beta": [1.0, 2.0]},
        }[name]
        self._jax_model()

    def _jax_model(self):
        s = self.seed
        if self.name == "transfer":
            self.jm = JaxEF([2, 10, 1], k=2, seed=s)
        elif self.name == "gen_gram":
            self.jm = JaxEF([12, 10, 1], k=2, seed=s)
        elif self.name == "ae":
            self.jm = JaxAE([2, 12, 1], [1, 12, 2], seed=s)
        elif self.name == "regae":
            self.jm = JaxRegAE([2, 12, 1], [1, 12, 2], [1, 8, 1], K=2, seed=s)
        else:
            self.jm = jax_seq([12, 10, 1], seed=s)

    def port_model(self):
        jm = self.jm
        if self.name in ("transfer", "gen_gram"):
            return port.EigenFunctions.from_numpy(_np(jm.params))
        if self.name == "ae":
            return port.AutoEncoder.from_numpy(_np(jm.encoder.params),
                                               _np(jm.decoder.params))
        if self.name == "regae":
            return port.RegAutoEncoder.from_numpy(
                _np(jm.encoder.params), _np(jm.decoder.params), _np(jm.reg))
        named = {n: np.asarray(v) for n, v in jm.named_parameters()}
        return params_from_numpy(named, [12, 10, 1])

    def _args(self, hyper):
        name = self.name
        a = dict(COMMON, seed=self.seed, split_indices=self.split,
                 learning_rate=0.01)
        if name in ("transfer", "gen_gram"):
            a.update(alpha=10.0, eig_weights=[1.0, 0.5], k=2,
                     lag_tau=2 * DT if name == "transfer" else 0.0)
        elif name == "regae":
            a.update(eig_weights=[1.0, 0.5], alpha=1.0, gamma=(0.5, 0.25),
                     eta=(0.1, 0.1, 0.1), lag_tau_reg=2 * DT)
        elif name == "committor":
            c = self.x[:, 0, 0]
            a.update(alpha=100.0, beta=1.0,
                     region_a=c < np.quantile(c, 0.15),
                     region_b=c > np.quantile(c, 0.85))
        a.update(hyper)
        return a

    def jax_task(self, **hyper):
        cls = {"transfer": JaxEigTask, "gen_gram": JaxEigTask,
               "ae": JaxAETask, "regae": JaxRegTask,
               "committor": JaxComTask}[self.name]
        traj = JaxTraj(trajectory=self.x, weights=self.w, dt=DT,
                       verbose=False)
        return cls(traj, _pp("jax", self.ref), self.jm,
                   str(self.tmp / "jax"), export_cv=False,
                   **self._args(hyper))

    def port_task(self, model=None, **hyper):
        cls = {"transfer": port.EigenFunctionTask,
               "gen_gram": port.EigenFunctionTask,
               "ae": port.AutoEncoderTask, "regae": port.RegAutoEncoderTask,
               "committor": port.CommittorTask}[self.name]
        traj = port.WeightedTrajectory(trajectory=self.x, weights=self.w,
                                       dt=DT, verbose=False)
        return cls(traj, _pp("port", self.ref),
                   model if model is not None else self.port_model(),
                   str(self.tmp / "port"), device="cpu",
                   **self._args(hyper))

    def replica(self, r):
        return {k: v[r] for k, v in self.grid.items()}


FAMILIES = ["transfer", "gen_gram", "ae", "regae", "committor"]


def _curves_close(got, want, rtol):
    """Per-epoch curves [epochs, n] within rtol of the largest entry of
    each column (a metric such as a penalty can pass through zero)."""
    want = np.asarray(want)
    scale = np.maximum(np.abs(want).max(axis=0), 1e-300)
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale,
                               rtol=0, atol=rtol)


@pytest.mark.parametrize("family", FAMILIES)
def test_sweep_matches_jax_and_solo(f64, tmp_path, family):
    fam = Family(family, tmp_path)
    jres = jens.train_hyperparameter_sweep(fam.jax_task(), fam.grid)
    task = fam.port_task()
    pres = train_hyperparameter_sweep(task, fam.grid)
    assert len(pres) == len(jres) == len(next(iter(fam.grid.values())))
    for r, (j, p) in enumerate(zip(jres, pres)):
        assert p.hyperparams == fam.replica(r)
        assert p.loss_names == list(j.train_loss_df.columns)
        _curves_close(p.train_loss, j.train_loss_df.to_numpy(), RTOL_JAX)
        _curves_close(p.test_loss, j.test_loss_df.to_numpy(), RTOL_JAX)
        if j.cvec is None:
            assert p.cvec is None
        else:
            np.testing.assert_array_equal(p.cvec, j.cvec)
        solo = fam.port_task(**fam.replica(r))
        solo.train()
        _curves_close(p.train_loss, solo.train_loss, RTOL_SOLO)
        _curves_close(p.test_loss, solo.test_loss, RTOL_SOLO)
        # the replica's final parameters are the solo run's (the output
        # bias of an eigenfunction head excepted: the loss is invariant to
        # it, so its gradient is a rounding residue that Adam normalizes
        # to a step of the learning rate's size)
        for n, q in solo.model.named_parameters():
            if n in ("biases.1", "reg.biases.1"):
                continue
            np.testing.assert_allclose(p.model[n].numpy(),
                                       q.detach().numpy(), rtol=0,
                                       atol=1e-9)


@pytest.mark.parametrize("family", ["transfer", "ae"])
def test_replica_ensemble_matches_jax_and_solo(f64, tmp_path, family):
    """Each replica its own data, split, initial model and
    hyperparameters."""
    fams = [Family(family, tmp_path / str(r), seed=r, data_seed=10 + r)
            for r in range(3)]
    hyper = [{"learning_rate": 0.01 * (r + 1)} for r in range(3)]
    if family != "ae":
        for r in range(3):
            hyper[r]["alpha"] = 10.0 * (r + 1)
    jt = [f.jax_task(**h) for f, h in zip(fams, hyper)]
    jens.train_replica_ensemble(jt)
    pt = [f.port_task(**h) for f, h in zip(fams, hyper)]
    train_replica_ensemble(pt)
    for f, h, j, p in zip(fams, hyper, jt, pt):
        _curves_close(p.train_loss, j.train_loss_df.to_numpy(), RTOL_JAX)
        _curves_close(p.test_loss, j.test_loss_df.to_numpy(), RTOL_JAX)
        solo = f.port_task(**h)
        solo.train()
        _curves_close(p.train_loss, solo.train_loss, RTOL_SOLO)
        assert len(p.loss_list) == p.num_epochs
        if family == "transfer":
            np.testing.assert_array_equal(p._cvec, solo._cvec)
        # the task continues from the ensemble's model and Adam state as
        # from its own train()
        p.train()
        solo.train()
        _curves_close(p.train_loss, solo.train_loss, RTOL_SOLO)


@pytest.mark.parametrize("family", ["gen_gram", "committor"])
def test_replica_ensemble_with_distinct_references(f64, tmp_path, family):
    """Replicas whose preprocessing layers hold different reference
    structures (the JAX ensemble stacks those constants into one traced
    tree and refuses them): each replica's features and Gram matrices come
    from its own layer, and each replica trains as its solo run."""
    fams = [Family(family, tmp_path / str(r), seed=r, data_seed=20 + r)
            for r in range(2)]
    hyper = [{"alpha": 5.0 * (r + 1), "learning_rate": 0.01 * (r + 1)}
             for r in range(2)]
    pt = [f.port_task(**h) for f, h in zip(fams, hyper)]
    train_replica_ensemble(pt)
    for f, h, p in zip(fams, hyper, pt):
        solo = f.port_task(**h)
        solo.train()
        _curves_close(p.train_loss, solo.train_loss, RTOL_SOLO)
        _curves_close(p.test_loss, solo.test_loss, RTOL_SOLO)


def test_chunked_equals_unchunked(f64, tmp_path):
    fam = Family("transfer", tmp_path)
    grid = {"learning_rate": [0.005, 0.01, 0.02, 0.04, 0.08],
            "alpha": [5.0, 10.0, 20.0, 40.0, 80.0]}
    task = fam.port_task()
    full = train_hyperparameter_sweep(task, grid)
    chunked = train_hyperparameter_sweep(task, grid, chunk_size=2)
    assert len(chunked) == len(full) == 5
    for a, b in zip(full, chunked):
        assert a.hyperparams == b.hyperparams
        # the same arithmetic per replica at another width: bit for bit
        np.testing.assert_array_equal(a.train_loss, b.train_loss)
        np.testing.assert_array_equal(a.test_loss, b.test_loss)


def _refusal_cases(tmp_path):
    fam = Family("transfer", tmp_path)
    reg = Family("regae", tmp_path)
    ae = Family("ae", tmp_path)
    yield ("fused_step", Incompatible, "fused_step",
           lambda: train_hyperparameter_sweep(
               port.EigenFunctionTask(
                   port.WeightedTrajectory(trajectory=fam.x, weights=fam.w,
                                           dt=DT, verbose=False),
                   None, fam.port_model(), str(tmp_path / "f"),
                   device="cpu", fused_step=True,
                   **fam._args({})),
               {"alpha": [1.0, 2.0]}))
    yield ("mixed types", Incompatible, "same task type",
           lambda: train_replica_ensemble([fam.port_task(),
                                           ae.port_task()]))
    yield ("static config", Incompatible, "static configuration",
           lambda: train_replica_ensemble([
               fam.port_task(),
               fam.port_task(lag_tau=4 * DT, split_indices=None)]))
    yield ("gate toggle", ValueError, "gate",
           lambda: train_hyperparameter_sweep(reg.port_task(),
                                              {"alpha": [0.0, 1.0]}))
    yield ("unknown name", ValueError, "not sweepable",
           lambda: train_hyperparameter_sweep(fam.port_task(),
                                              {"gamma": [(1, 1), (2, 2)]}))
    yield ("unequal lengths", ValueError, "equal length",
           lambda: train_hyperparameter_sweep(
               fam.port_task(), {"alpha": [1.0, 2.0],
                                 "learning_rate": [0.1]}))
    # a mesh of two ranks (what the sweeps read of one): one replica does
    # not divide over it, refused before any collective
    two = types.SimpleNamespace(get_local_rank=lambda: 0, size=lambda: 2,
                                get_group=lambda: None)
    yield ("mesh", Incompatible, "do not divide",
           lambda: train_hyperparameter_sweep(fam.port_task(),
                                              {"alpha": [1.0]}, mesh=two))
    yield ("ensemble mesh", Incompatible, "do not divide",
           lambda: train_replica_ensemble([fam.port_task()], mesh=two))


REFUSALS = ["fused_step", "mixed types", "static config", "gate toggle",
            "unknown name", "unequal lengths", "mesh", "ensemble mesh"]


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals(tmp_path, case):
    cases = {name: (exc, match, fn)
             for name, exc, match, fn in _refusal_cases(tmp_path)}
    exc, match, fn = cases[case]
    with pytest.raises(exc, match=match):
        fn()


def test_adopt_then_train_continues(f64, tmp_path):
    fam = Family("transfer", tmp_path)
    task = fam.port_task()
    results = train_hyperparameter_sweep(task, fam.grid)
    winner = results[1]
    assert adopt_sweep_result(task, winner) is task
    assert task.learning_rate == fam.grid["learning_rate"][1]
    assert task._alpha == fam.grid["alpha"][1]
    np.testing.assert_array_equal(task._cvec, winner.cvec)
    for n, p in task.model.named_parameters():
        assert torch.equal(p.detach(), winner.model[n])
    assert task.optimizer.param_groups[0]["lr"] == fam.grid["learning_rate"][1]
    task.train()
    solo = fam.port_task(**fam.replica(1))
    solo.train()
    solo.train()
    _curves_close(task.train_loss, solo.train_loss, RTOL_SOLO)
    # the RegAE's vector hyperparameters land on its list attributes
    reg = Family("regae", tmp_path)
    rt = reg.port_task()
    rres = train_hyperparameter_sweep(rt, reg.grid)
    adopt_sweep_result(rt, rres[1])
    assert rt.gamma == [1.0, 0.1] and rt.eta == [0.2, 0.05, 0.3]
    assert rt.alpha == 1.0


def _snapshot(task):
    return ({n: p.detach().clone() for n, p in task.model.named_parameters()},
            {k: (v.clone() if torch.is_tensor(v) else v)
             for k, v in task.optimizer.state_dict()["state"].items()},
            dict(task.__dict__))


def _untouched(task, snap):
    params, state, attrs = snap
    for n, p in task.model.named_parameters():
        assert torch.equal(p.detach(), params[n]), n
    assert task.optimizer.state_dict()["state"].keys() == state.keys()
    for k, v in attrs.items():
        assert task.__dict__[k] is v, k


@pytest.mark.parametrize("raise_at", [None, "load", "loss"])
def test_task_left_untouched(f64, tmp_path, monkeypatch, raise_at):
    """A sweep reads the task's model, optimizer and hyperparameters and
    changes none of them, nor the compute dtype, also when it raises part
    way; what it may add is the prepared batches, as train() would."""
    fam = Family("regae", tmp_path)
    task = fam.port_task()
    task.train()  # prepared batches, Adam state and a graph-free task
    snap = _snapshot(task)
    if raise_at == "load":
        monkeypatch.setattr(pens._Replicas, "load",
                            lambda *a: (_ for _ in ()).throw(
                                RuntimeError("stop")))
    elif raise_at == "loss":
        monkeypatch.setattr(type(task), "_replica_loss",
                            lambda *a: (_ for _ in ()).throw(
                                RuntimeError("stop")))
    pens.release_sweeps()
    try:
        train_hyperparameter_sweep(task, fam.grid, compute_dtype="float32",
                                   bf16_style="acc32")
    except RuntimeError as err:
        assert raise_at is not None and "stop" in str(err)
    else:
        assert raise_at is None
    assert pconfig.compute_dtype_name() == "float32"
    assert pconfig.bf16_style() == "pure"
    _untouched(task, snap)
    pens.release_sweeps()


def test_unprepared_task_trains_as_its_twin(tmp_path):
    """A sweep on a task that never trained: its train() afterwards is
    bit for bit that of a twin the sweep never saw, and a bfloat16 sweep
    restores the compute dtype."""
    fam = Family("transfer", tmp_path)
    task, twin = fam.port_task(), fam.port_task()
    train_hyperparameter_sweep(task, fam.grid, compute_dtype="bfloat16")
    assert pconfig.compute_dtype_name() == "float32"
    task.train()
    twin.train()
    np.testing.assert_array_equal(task.train_loss, twin.train_loss)
    pens.release_sweeps()


def test_sweep_vamp_scores_match_jax(f64, tmp_path):
    fam = Family("transfer", tmp_path)
    jt = fam.jax_task()
    jres = jens.train_hyperparameter_sweep(jt, fam.grid)
    task = fam.port_task()
    pres = train_hyperparameter_sweep(task, fam.grid)
    # the port's replicas in the JAX model pytree
    jin = []
    for j, p in zip(jres, pres):
        params = tuple({"weight": jnp.asarray(p.model[f"weights.{i}"].numpy()),
                        "bias": jnp.asarray(p.model[f"biases.{i}"].numpy())}
                       for i in range(2))
        jin.append(j._replace(model=_with_params(j.model, params),
                              cvec=p.cvec))
    # the frames in float64 on both sides (the JAX CV keeps a float32
    # input's dtype; the port places frames in the default dtype)
    x = fam.x.astype(np.float64)
    want = jens.sweep_vamp_scores(jt, jin, frames=x, weights=fam.w)
    got = sweep_vamp_scores(task, pres, frames=x, weights=fam.w)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    assert got.shape == (3,)
    # the task's own trajectory by default
    np.testing.assert_allclose(sweep_vamp_scores(task, pres), got,
                               rtol=1e-6)
    # held-out frames with a lag of their own
    x2, w2 = _toy(99)
    x2 = x2.astype(np.float64)
    want = jens.sweep_vamp_scores(jt, jin, lag=3, frames=x2, weights=w2)
    got = sweep_vamp_scores(task, pres, lag=3, frames=x2, weights=w2)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    with pytest.raises(ValueError, match="lag"):
        sweep_vamp_scores(Family("ae", tmp_path).port_task(), pres[:1])


def _with_params(model, params):
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(model),
        jax.tree_util.tree_leaves(params))


def test_sweep_committor_checks_match_jax(f64, tmp_path):
    fam = Family("committor", tmp_path)
    jt = fam.jax_task()
    jres = jens.train_hyperparameter_sweep(jt, fam.grid)
    task = fam.port_task()
    pres = train_hyperparameter_sweep(task, fam.grid)
    jin = []
    for j, p in zip(jres, pres):
        names = [n for n, _ in j.model.named_parameters()]
        leaves = [jnp.asarray(p.model[n].numpy()) for n in names]
        jin.append(j._replace(model=_with_params(j.model, _ordered(
            j.model, dict(zip(names, leaves))))))
    # the frames in float64 on both sides, as in the VAMP test
    c = fam.x[:, 0, 0]
    masks = dict(in_a=c < np.quantile(c, 0.15), in_b=c > np.quantile(c, 0.85))
    x = fam.x.astype(np.float64)
    want = jens.sweep_committor_checks(jt, jin, lag=1, frames=x,
                                       weights=fam.w, **masks)
    got = sweep_committor_checks(task, pres, lag=1, frames=x, weights=fam.w,
                                 **masks)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    np.testing.assert_allclose(sweep_committor_checks(task, pres, lag=1),
                               got, rtol=1e-5)
    with pytest.raises(TypeError, match="CommittorTask"):
        sweep_committor_checks(Family("ae", tmp_path).port_task(), pres, 1)


def _ordered(model, named):
    """``named`` (torch-style names) in the order of the JAX model's
    pytree leaves."""
    out = []
    for i, layer in enumerate(model.params):
        for key in sorted(layer):
            out.append(named[f"{i + 1}.{key}"])
    return out


def test_explore_then_finetune(tmp_path):
    fam = Family("transfer", tmp_path)
    task = fam.port_task()
    out = explore_then_finetune(task, fam.grid, finetune_epochs=2)
    assert pconfig.compute_dtype_name() == "float32"
    finals = [r.train_loss[-1, 0] for r in out.results]
    assert out.best_index == int(np.argmin(finals))
    assert out.best_hyperparams == fam.replica(out.best_index)
    assert task.train_loss.shape == (2, 5) and task.num_epochs == 3
    assert task.learning_rate == fam.grid["learning_rate"][out.best_index]
    out = explore_then_finetune(task, fam.grid, metric="vamp",
                                compute_dtype="float32")
    assert 0 <= out.best_index < 3
    with pytest.raises(ValueError, match="metric"):
        explore_then_finetune(task, fam.grid, metric="median")
    pens.release_sweeps()


def test_architecture_ensemble(f64, tmp_path):
    """Two widths times two seeds: one ensemble per width; a task with a
    trajectory of another length falls back to its own train()."""
    fam = Family("transfer", tmp_path)
    tasks, solos = [], []
    for width in (8, 10):
        for seed in (0, 1):
            for out in (tasks, solos):
                model = port.EigenFunctions([2, width, 1], 2, seed=seed)
                out.append(fam.port_task(model=model))
    x, w = _toy(5, n=300)
    odd = port.EigenFunctionTask(
        port.WeightedTrajectory(trajectory=x, weights=w, dt=DT,
                                verbose=False),
        None, port.EigenFunctions([2, 8, 1], 2, seed=2),
        str(tmp_path / "odd"), device="cpu",
        **dict(fam._args({}), split_indices=None))
    out = train_architecture_ensemble(tasks + [odd], verbose=True)
    assert out[-1] is odd and odd.train_loss.shape == (3, 5)
    for t, s in zip(tasks, solos):
        s.train()
        _curves_close(t.train_loss, s.train_loss, RTOL_SOLO)


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_replica_optimizer_matches_torch_and_optax(f64, name):
    """Three replicas with their own learning rates, against three
    torch.optim runs and optax.inject_hyperparams runs, over ten steps of
    seeded gradients spanning five decades."""
    R, shape, steps = 3, (4, 5), 10
    rng = np.random.default_rng(0)
    lrs = [1e-3, 1e-2, 1e-1]
    p0 = rng.standard_normal((R,) + shape)
    grads = [rng.standard_normal((R,) + shape) * 10.0 ** -(s % 5)
             for s in range(steps)]
    stacked = torch.tensor(p0, requires_grad=True)
    opt = pens._ReplicaOptimizer(name, [stacked],
                                 torch.tensor(lrs, dtype=torch.float64))
    solo = [torch.tensor(p0[r], requires_grad=True) for r in range(R)]
    make = port.TrainingTask.make_optimizer
    torch_opts = [make(name, [solo[r]], lrs[r]) for r in range(R)]
    inner = {"adam": optax.adam, "sgd": optax.sgd}[name]
    jopt = optax.inject_hyperparams(inner)(learning_rate=0.0)
    jp = [jnp.asarray(p0[r]) for r in range(R)]
    jst = [jopt.init(jp[r]) for r in range(R)]
    for r in range(R):
        jst[r].hyperparams["learning_rate"] = jnp.asarray(lrs[r])
    for g in grads:
        stacked.grad = torch.tensor(g)
        opt.step()
        for r in range(R):
            solo[r].grad = torch.tensor(g[r])
            torch_opts[r].step()
            upd, jst[r] = jopt.update(jnp.asarray(g[r]), jst[r], jp[r])
            jp[r] = optax.apply_updates(jp[r], upd)
    for r in range(R):
        # the same update in another rounding order (torch's CPU Adam
        # computes its step size in Python floats)
        np.testing.assert_allclose(stacked[r].detach().numpy(),
                                   solo[r].detach().numpy(), rtol=1e-13,
                                   atol=1e-15)
        np.testing.assert_allclose(stacked[r].detach().numpy(),
                                   np.asarray(jp[r]), rtol=1e-13, atol=1e-15)
    # a replica's state through torch.optim's state dict and back
    sd = torch_opts[1].state_dict()
    host = [t.clone() for t in opt.state_tensors()]
    mine = opt.replica_state_dict(host, 1, lrs[1], sd)
    if name == "adam":
        for key in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(mine["state"][0][key].numpy(),
                                       sd["state"][0][key].numpy(),
                                       rtol=1e-12)
        assert float(mine["state"][0]["step"]) == steps
        opt.load_replica(2, sd)
        assert torch.equal(opt.exp_avg[0][2], sd["state"][0]["exp_avg"])
    assert mine["param_groups"][0]["lr"] == lrs[1]


@pytest.mark.parametrize("k", [1, 2])
def test_functional_input_jacobian_matches_autograd(f64, k):
    model = port.EigenFunctions([3, 7, 1], k, seed=4)
    X = torch.tensor(np.random.default_rng(1).standard_normal((20, 3)))
    y1, j1 = _input_jacobian(model, X, k)
    y2, j2 = input_jacobian(model, X, k)
    torch.testing.assert_close(y2, y1, rtol=0, atol=0)
    torch.testing.assert_close(j2, j1, rtol=0, atol=0)
    # and its parameter gradient (double backprop) inside a replica map
    names = [n for n, _ in model.named_parameters()]
    stacked = [p.detach()[None].repeat(2, *[1] * p.dim()).requires_grad_()
               for p in model.parameters()]

    def loss(params, X):
        bound = pens._Bound(model, dict(zip(names, params)))
        _, J = input_jacobian(bound, X, k)
        return (J**2).sum()

    torch.func.vmap(loss, in_dims=(0, None))(stacked, X).sum().backward()
    _, J = _input_jacobian(model, X, k)
    want = torch.autograd.grad((J**2).sum(), list(model.parameters()),
                               allow_unused=True)
    for s, g in zip(stacked, want):
        # the output bias does not reach the input gradients
        assert (s.grad is None) == (g is None)
        if g is not None:
            torch.testing.assert_close(s.grad[1], g, rtol=1e-13, atol=1e-15)


def test_bf16_quadratic_form_vmap_rule(monkeypatch):
    """The bf16 Gram form's vmap rule (replicas folded into the heads, or
    into the samples) against one call per replica. The card's bf16 x
    bf16 -> f32 ``bmm`` has no CPU kernel; here it is the float32 product
    of the same bfloat16 values, exact per product."""
    from colvarsfinder_tpu_torch.core import losses

    bmm = torch.bmm

    def bmm_f32(a, b, out_dtype=None):
        return bmm(a.float(), b.float())

    monkeypatch.setattr(torch, "bmm", bmm_f32)
    rng = np.random.default_rng(2)
    R, k, B, d = 3, 2, 5, 4
    G = torch.tensor(rng.standard_normal((R, k, B, d)), dtype=torch.float32,
                     requires_grad=True)
    M = torch.tensor(rng.standard_normal((R, B, d, d))).to(torch.bfloat16)
    apply = losses._Bf16QuadraticForm.apply
    for m_dims, Ms in ((None, M[0]), (0, M)):
        out = torch.func.vmap(lambda g, m: apply(g, m)[0],
                              in_dims=(0, m_dims))(G, Ms)
        want = torch.stack([apply(G[r], Ms if m_dims is None else Ms[r])[0]
                            for r in range(R)])
        torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
        gv, = torch.autograd.grad(out.sum(), G)
        gw, = torch.autograd.grad(want.sum(), G)
        torch.testing.assert_close(gv, gw, rtol=1e-6, atol=1e-6)


def test_last_run_seconds_and_results(tmp_path):
    from colvarsfinder_tpu_torch import parallel

    fam = Family("ae", tmp_path)
    res = train_hyperparameter_sweep(fam.port_task(), fam.grid)
    assert parallel.last_run_seconds == pens.last_run_seconds > 0
    assert isinstance(res[0], SweepResult) and res[0].cvec is None
    assert res[0].train_loss.shape == (3, 1)
    assert set(res[0].model) == {n for n, _ in
                                 fam.port_model().named_parameters()}
    pens.release_sweeps()

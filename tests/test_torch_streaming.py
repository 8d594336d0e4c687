"""PyTorch port, the streaming layout: the trajectory stays in host memory
(a ``np.memmap`` included) and the batches are gathered, copied and
trained on as they arrive (``TrainingTask._stream_epochs``). Every family's
streamed run against the JAX package's streaming run on the same numpy
inputs, parameters carried across and split injected, in float64; the
port's streamed runs against its resident runs bit for bit on in-RAM data,
across prefetch depths and packing; a memmap run against the in-RAM run;
the auto decision against JAX's; the pipeline's failure handling, the
in-flight window, the wire dtype and the refusal of sweeps. The JAX
package's own list is ``tests/test_streaming.py``."""

import threading
import time
import types
import warnings

import numpy as np
import pytest
import torch
from numpy.lib.format import open_memmap

from colvarsfinder_tpu import config as jconfig
from colvarsfinder_tpu.core import AutoEncoderTask as JaxAETask
from colvarsfinder_tpu.core import CommittorTask as JaxComTask
from colvarsfinder_tpu.core import EigenFunctionTask as JaxEigTask
from colvarsfinder_tpu.core import RegAutoEncoderTask as JaxRegTask
from colvarsfinder_tpu.core.task import TrainingTask as JaxTrainingTask
from colvarsfinder_tpu.models import AutoEncoder as JaxAE
from colvarsfinder_tpu.models import EigenFunctions as JaxEF
from colvarsfinder_tpu.models import RegAutoEncoder as JaxRegAE
from colvarsfinder_tpu.models import create_sequential_nn as jax_seq
from colvarsfinder_tpu.ops.alignment import AlignmentLayer as JaxAlign
from colvarsfinder_tpu.ops.features import Feature as JaxFeature
from colvarsfinder_tpu.ops.features import FeatureLayer as JaxFeatureLayer
from colvarsfinder_tpu.ops.features import Identity as JaxIdentity
from colvarsfinder_tpu.ops.features import PreprocessingANN as JaxPP
from colvarsfinder_tpu.utils import WeightedTrajectory as JaxTraj

import colvarsfinder_tpu_torch as port
from colvarsfinder_tpu_torch import config as pconfig
from colvarsfinder_tpu_torch.core.streaming import ALIGN_BYTES, StreamIO
from colvarsfinder_tpu_torch.core.task import TrainingTask, train_test_split
from colvarsfinder_tpu_torch.models.module import params_from_numpy
from colvarsfinder_tpu_torch.parallel import (
    Incompatible,
    train_hyperparameter_sweep,
    train_replica_ensemble,
)

N, N_ATOMS, DT, LAG = 640, 4, 0.01, 2
COMMON = dict(batch_size=96, num_epochs=3, test_ratio=0.2,
              save_model_every_step=0, verbose=False, tensorboard=False,
              debug_mode=False, seed=0, learning_rate=0.01)
# float64 on both sides: the two libraries sum in other orders, and Adam
# normalizes each step; 12 steps keep the curves within ~1e-12 (the
# replica-sweep tests' bar, tests/test_torch_ensemble.py)
RTOL_JAX = 1e-9
# a memmap's batches are gathered in sorted order, which reorders the sums
# within a batch: float64 rounding, ~1e-15 per step
RTOL_MEMMAP = 1e-12
FAMILIES = ["transfer", "generator", "precompute", "committor", "ae",
            "regae"]


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


def _data(seed=3, n=N):
    """Frames of four atoms wandering about a reference, the first moving
    along x, and non-uniform weights."""
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal((N_ATOMS, 3))
    x = ref[None] + 0.2 * rng.standard_normal((n, N_ATOMS, 3))
    x[:, 0, 0] += np.linspace(-1.0, 1.0, n)[rng.permutation(n)]
    return ref, x.astype(np.float32), rng.uniform(0.5, 1.5, n)


def _np(params):
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


class Family:
    """One family's task in either package on the same data, split and
    initial parameters: ``transfer`` (lag 2) and ``precompute`` (the
    transfer operator on features computed beforehand) through the
    alignment and position features; ``generator`` (lag 0, the vjp path),
    ``committor``, ``ae`` and ``regae`` (all six terms, both lags 2) on the
    flattened frames through the identity (JAX compiles an input-gradient
    step through the alignment in ~20 s)."""

    def __init__(self, name, x=None, w=None):
        self.name = name
        self.ref, x0, w0 = _data()
        self.x = x0 if x is None else x
        self.w = w0 if w is None else w
        self.flat = name in ("generator", "committor", "ae", "regae")
        lag = LAG if name in ("transfer", "precompute", "regae") else 0
        self.split = train_test_split(np.arange(N - lag), 0.2, 0)
        d = 3 * N_ATOMS
        if name in ("transfer", "generator", "precompute"):
            self.jm = JaxEF([d, 10, 1], k=2, seed=1)
        elif name == "committor":
            self.jm = jax_seq([d, 10, 1], seed=1)
        elif name == "ae":
            self.jm = JaxAE([d, 10, 2], [2, 10, d], seed=1)
        else:
            self.jm = JaxRegAE([d, 10, 2], [2, 10, d], [2, 6, 1], K=2, seed=1)

    def traj(self, lib, x=None):
        x = self.x if x is None else x
        if self.flat:
            x = x.reshape(x.shape[0], -1)
        cls = JaxTraj if lib == "jax" else port.WeightedTrajectory
        return cls(trajectory=x, weights=self.w, dt=DT, verbose=False)

    def pp(self, lib):
        jax_lib = lib == "jax"
        if self.flat:
            return JaxIdentity() if jax_lib else None
        atoms = list(range(N_ATOMS))
        al = (JaxAlign if jax_lib else port.AlignmentLayer)(self.ref, atoms)
        feat = (JaxFeature if jax_lib else port.Feature)("p", "position",
                                                         atoms)
        layer = (JaxFeatureLayer if jax_lib else port.FeatureLayer)([feat])
        return (JaxPP if jax_lib else port.PreprocessingANN)(al, layer)

    def model(self, lib):
        jm = self.jm
        if lib == "jax":
            return jm
        if self.name in ("transfer", "generator", "precompute"):
            return port.EigenFunctions.from_numpy(_np(jm.params))
        if self.name == "committor":
            named = {n: np.asarray(v) for n, v in jm.named_parameters()}
            return params_from_numpy(named, list(jm.layer_dims))
        if self.name == "ae":
            return port.AutoEncoder.from_numpy(_np(jm.encoder.params),
                                               _np(jm.decoder.params))
        return port.RegAutoEncoder.from_numpy(
            _np(jm.encoder.params), _np(jm.decoder.params), _np(jm.reg))

    def args(self):
        a = dict(COMMON, split_indices=self.split)
        if self.name in ("transfer", "generator", "precompute"):
            a.update(alpha=10.0, eig_weights=[1.0, 0.5], k=2,
                     lag_tau=0.0 if self.name == "generator" else LAG * DT,
                     precompute_features=self.name == "precompute")
        elif self.name == "committor":
            c = self.x[:, 0, 0]  # the first atom's x
            a.update(alpha=100.0, beta=1.0,
                     region_a=c < np.quantile(c, 0.15),
                     region_b=c > np.quantile(c, 0.85))
        elif self.name == "regae":
            a.update(eig_weights=[1.0, 0.5], alpha=1.0, gamma=(0.5, 0.25),
                     eta=(0.1, 0.1, 0.1), lag_tau_ae=LAG * DT,
                     lag_tau_reg=LAG * DT)
        return a

    def task(self, lib, path, x=None, model=None, **kw):
        cls = {
            "transfer": (JaxEigTask, port.EigenFunctionTask),
            "generator": (JaxEigTask, port.EigenFunctionTask),
            "precompute": (JaxEigTask, port.EigenFunctionTask),
            "committor": (JaxComTask, port.CommittorTask),
            "ae": (JaxAETask, port.AutoEncoderTask),
            "regae": (JaxRegTask, port.RegAutoEncoderTask),
        }[self.name][lib != "jax"]
        args = {**self.args(), **kw}
        extra = (dict(export_cv=False) if lib == "jax"
                 else dict(device="cpu"))
        return cls(self.traj(lib, x), self.pp(lib),
                   model if model is not None else self.model(lib),
                   str(path / lib), **args, **extra)


def _rows(task):
    """Every batch's metric row of every epoch, train then test."""
    return np.stack([np.concatenate(epoch) for epoch in task.loss_list])


def _assert_same_run(a, b):
    np.testing.assert_array_equal(_rows(a), _rows(b))
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)


# ---------------------------------------------------------------------------
# against the JAX package's streaming runs
@pytest.mark.parametrize("name", FAMILIES)
def test_streamed_run_matches_jax_streaming(f64, tmp_path, name):
    fam = Family(name)
    jt = fam.task("jax", tmp_path, streaming=True)
    pt = fam.task("port", tmp_path, streaming=True)
    assert jt._streaming and pt._streaming
    jt.train()
    pt.train()
    if name in ("generator", "committor"):
        # the Gram path is off under streaming in both packages
        assert not pt._gram and not jt._gram
    if name == "precompute":
        # the chunked feature pass, host numpy
        assert isinstance(pt._traj_np, np.ndarray)
        np.testing.assert_allclose(pt._traj_np, np.asarray(jt._traj_np),
                                   rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(pt.train_loss, jt.train_loss_df.to_numpy(),
                               rtol=RTOL_JAX)
    np.testing.assert_allclose(pt.test_loss, jt.test_loss_df.to_numpy(),
                               rtol=RTOL_JAX)
    if name in ("transfer", "generator", "precompute", "regae"):
        np.testing.assert_array_equal(pt._cvec, jt._cvec)


# ---------------------------------------------------------------------------
# against the port's resident runs
@pytest.mark.parametrize("name", FAMILIES + ["fused"])
def test_streamed_run_equals_resident_run(tmp_path, name):
    """In-RAM data keeps the resident batch order and gather: bit for bit.
    ``fused``: the transfer operator with ``fused_step`` (K3/K4's plain
    version on the CPU)."""
    fam = Family("transfer" if name == "fused" else name)
    kw = dict(fused_step=True) if name == "fused" else {}
    if name in ("generator", "committor"):
        kw["gram_pp"] = False  # the resident default is the Gram path
    resident = fam.task("port", tmp_path / "r", **kw)
    streamed = fam.task("port", tmp_path / "s", streaming=True, **kw)
    assert not resident._streaming and streamed._prepare_data()[0] is None
    resident.train()
    streamed.train()
    _assert_same_run(resident, streamed)
    if name == "regae":
        # equal lags: one gather of the lagged frames serves both terms
        io = streamed._stream_io[1]
        assert [leaf.positions for leaf in io.leaves] == [(0,), (1, 2),
                                                          (3,), (4,)]
        batch = io.batch()
        assert batch[2] is batch[1]


@pytest.mark.parametrize("depth", [0, 1, 2])
@pytest.mark.parametrize("packed", [True, False])
def test_prefetch_depths_and_packing_equal_bitwise(tmp_path, depth, packed):
    fam = Family("transfer")
    ref = fam.task("port", tmp_path / "ref", streaming=True)
    ref.stream_prefetch = 0
    ref.train()
    task = fam.task("port", tmp_path / "run", streaming=True)
    task.stream_prefetch = depth
    task.stream_pack_transfers = packed
    task.stream_transfer_workers = 3
    task.train()
    _assert_same_run(ref, task)
    train_io = task._stream_io[1]
    assert len(train_io.host) == depth + (3 if depth else 1)
    assert len(train_io.inputs) == (1 if packed else 4)


def test_a_second_call_continues_and_a_changed_setting_rebuilds(tmp_path):
    fam = Family("transfer")
    whole = fam.task("port", tmp_path / "whole", streaming=True,
                     num_epochs=4)
    whole.train()
    task = fam.task("port", tmp_path / "split", streaming=True,
                    num_epochs=2)
    task.train()
    first = _rows(task)
    ios = task._stream_io
    task.stream_pack_transfers = False
    task.train()
    assert task._stream_io is not ios
    np.testing.assert_array_equal(np.concatenate([first, _rows(task)]),
                                  _rows(whole))


# ---------------------------------------------------------------------------
# memmap trajectories
def _memmap(path, x):
    mm = open_memmap(str(path), mode="w+", dtype=x.dtype, shape=x.shape)
    mm[:] = x
    mm.flush()
    del mm
    return np.load(str(path), mmap_mode="r")


@pytest.mark.parametrize("name", ["transfer", "ae"])
def test_memmap_run_matches_the_in_ram_run(f64, tmp_path, name):
    """A read-only float32 memmap stays mapped (WeightedTrajectory and the
    task hold views of it), is cast to float64 per batch, and its batches
    are gathered in sorted order."""
    fam = Family(name)
    x = fam.x.reshape(N, -1) if fam.flat else fam.x
    mm = _memmap(tmp_path / "traj.npy", x)
    traj = port.WeightedTrajectory(trajectory=mm, weights=fam.w, dt=DT,
                                   verbose=False)
    assert isinstance(traj.trajectory, np.memmap)
    in_ram = fam.task("port", tmp_path / "ram", streaming=True)
    mapped = fam.task("port", tmp_path / "mm", x=mm, streaming=True)
    held = mapped._feature_traj if name == "ae" else mapped._traj_np
    assert np.shares_memory(held, mm) and mapped._sorted_gather(held)
    assert not in_ram._sorted_gather(in_ram._traj_np
                                     if name != "ae" else
                                     in_ram._feature_traj)
    with warnings.catch_warnings():
        # torch.from_numpy warns on a read-only array: never wrap the map
        warnings.simplefilter("error")
        mapped.train()
    in_ram.train()
    np.testing.assert_allclose(mapped.train_loss, in_ram.train_loss,
                               rtol=RTOL_MEMMAP)
    np.testing.assert_allclose(mapped.test_loss, in_ram.test_loss,
                               rtol=RTOL_MEMMAP)


def test_sorted_gather_rule(tmp_path):
    task = Family("transfer").task("port", tmp_path, streaming=True)
    mm = _memmap(tmp_path / "m.npy", np.zeros((10, 3), np.float32))
    assert task._sorted_gather(mm)
    assert task._sorted_gather(np.asarray(mm)[2:])  # a view of one
    assert not task._sorted_gather(np.zeros((10, 3)))
    task.stream_sorted_gather = False
    assert not task._sorted_gather(mm)
    task.stream_sorted_gather = True
    assert task._sorted_gather(np.zeros((10, 3)))


def test_weighted_trajectory_keeps_a_memmap(tmp_path):
    x = np.random.default_rng(0).standard_normal((50, 3)).astype(np.float32)
    mm = _memmap(tmp_path / "t.npy", x)
    w = np.linspace(0.5, 1.5, 50)
    kept = port.WeightedTrajectory(trajectory=mm, weights=w, verbose=False)
    # an all-kept weight filter neither copies nor materializes the map
    assert kept.trajectory is mm and isinstance(kept.trajectory, np.memmap)
    # a filter that drops frames gathers the kept ones
    cut = port.WeightedTrajectory(trajectory=mm, weights=w, min_w=0.8,
                                  verbose=False)
    assert cut.n_frames < 50 and not np.shares_memory(cut.trajectory, mm)
    np.testing.assert_array_equal(cut.trajectory, x[w / w.mean() > 0.8])


# ---------------------------------------------------------------------------
# the decision and the helpers
@pytest.mark.parametrize("streaming", [None, True, False])
@pytest.mark.parametrize("mesh", [False, True])
@pytest.mark.parametrize("shard", [False, True])
def test_resolve_streaming_decides_as_jax(streaming, mesh, shard):
    """Over sizes at and around the limit: the port decides as JAX does,
    over a mesh too; where JAX asserts (shard_trajectory) the port raises
    ValueError."""
    limit = TrainingTask.STREAMING_AUTO_LIMIT_BYTES
    assert limit == JaxTrainingTask.STREAMING_AUTO_LIMIT_BYTES == 8 << 30
    for nbytes in (0, limit, limit + 1, 100 * limit):
        fakes = [types.SimpleNamespace(
            STREAMING_AUTO_LIMIT_BYTES=limit, shard_trajectory=shard,
            batch_size=64,
            mesh=types.SimpleNamespace(devices=np.zeros(2)) if mesh else None)
            for _ in range(2)]
        try:
            want = JaxTrainingTask._resolve_streaming(fakes[0], streaming,
                                                      nbytes)
        except AssertionError:
            with pytest.raises(ValueError, match="shard_trajectory"):
                TrainingTask._resolve_streaming(fakes[1], streaming, nbytes)
            continue
        assert TrainingTask._resolve_streaming(fakes[1], streaming,
                                               nbytes) is want


def test_streaming_auto_triggers_above_the_limit(tmp_path, monkeypatch):
    fam = Family("ae")
    monkeypatch.setattr(TrainingTask, "STREAMING_AUTO_LIMIT_BYTES",
                        N * 3 * N_ATOMS * 4 - 1)
    task = fam.task("port", tmp_path)
    assert task._streaming
    task.train()
    assert np.isfinite(task.train_loss).all()
    monkeypatch.setattr(TrainingTask, "STREAMING_AUTO_LIMIT_BYTES",
                        N * 3 * N_ATOMS * 4)
    assert not fam.task("port", tmp_path)._streaming


def test_chunked_apply_matches_the_direct_call(tmp_path):
    x = np.random.default_rng(0).standard_normal((1000, 4, 3)).astype(
        np.float32)
    layer = Family("transfer").pp("port")
    with torch.no_grad():
        want = layer(torch.from_numpy(x)).numpy()
    for arr in (x, _memmap(tmp_path / "x.npy", x)):
        got = TrainingTask._chunked_apply(layer, arr, chunk=256,
                                          device="cpu")
        assert isinstance(got, np.ndarray) and got.shape == (1000, 12)
        np.testing.assert_array_equal(got, want)


def test_stream_io_layout():
    """512-byte aligned leaves, one buffer per dtype when packed, the wire
    dtype for frames only, one tensor for a gather used twice."""
    traj = np.arange(40 * 3 * 2, dtype=np.float32).reshape(40, 3, 2)
    w = np.linspace(1.0, 2.0, 40).astype(np.float32)
    i = np.array([5, 1, 7])
    lagged = (traj, i + 2)
    leaves = ((traj, i), lagged, None, lagged, (w, i))
    io = StreamIO(leaves, device="cpu", dtype=torch.float32,
                  wire=torch.bfloat16, packed=True, n_host=2, n_slots=1,
                  width=4)
    assert [buf.dtype for buf in io.inputs] == [torch.bfloat16,
                                                torch.float32]
    assert [leaf.positions for leaf in io.leaves] == [(0,), (1, 3), (4,)]
    for leaf in io.leaves:
        assert leaf.offset * io.inputs[leaf.group].element_size() \
            % ALIGN_BYTES == 0
    io.gather(1, leaves)
    io.consume(1)
    X, X_l, none, X_l2, wt = io.batch()
    assert none is None and X_l2 is X_l and X.dtype == torch.float32
    want = torch.from_numpy(traj[i]).to(torch.bfloat16).float()
    assert torch.equal(X, want)
    assert torch.equal(wt, torch.from_numpy(w[i]))
    with pytest.raises(ValueError, match="rows"):
        io.gather(0, ((traj, i[:2]), lagged, None, lagged, (w, i)))
    with pytest.raises(IndexError):
        io.gather(0, ((traj, i + 40), lagged, None, lagged, (w, i)))


# ---------------------------------------------------------------------------
# the pipeline: failures, the in-flight window, the wire dtype
def _wait_threads(before, timeout=10.0):
    end = time.monotonic() + timeout
    while threading.active_count() > before and time.monotonic() < end:
        time.sleep(0.01)
    return threading.active_count()


@pytest.mark.parametrize("where", ["gather", "step"])
def test_a_failure_reaches_train_and_every_thread_ends(tmp_path, where):
    """A gather thread's exception (the JAX pipeline delivered it to one
    queue and left the other threads blocked, task.py:774) and a step's
    exception both surface in train(), and the gather threads end."""
    fam = Family("transfer")
    task = fam.task("port", tmp_path, streaming=True, num_epochs=3)
    task.stream_transfer_workers = 3
    train_b = task._prepare_data()[2]
    pack, failing = task._stream_pack, train_b[2]
    if where == "gather":
        def boom(rows):
            if np.array_equal(rows, failing):
                raise RuntimeError("pack exploded")
            return pack(rows)

        task._stream_pack = boom
    else:
        metrics, calls = task._batch_metrics, []

        def boom(*batch):
            calls.append(1)
            if len(calls) == 4:
                raise RuntimeError("step exploded")
            return metrics(*batch)

        task._batch_metrics = boom
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="exploded"):
        task.train()
    assert _wait_threads(before) == before


def test_stream_inflight_zero_trains(tmp_path):
    """The JAX loop divides by the window (task.py:840); the port clamps
    it to 1."""
    fam = Family("transfer")
    ref = fam.task("port", tmp_path / "ref", streaming=True)
    ref.train()
    task = fam.task("port", tmp_path / "zero", streaming=True)
    task.stream_inflight = 0
    task.train()
    _assert_same_run(ref, task)


@pytest.mark.parametrize("wire", ["float16", "bfloat16"])
def test_wire_dtype_rounds_the_frames_only(tmp_path, wire):
    """Equal bit for bit to the resident run on frames rounded to the wire
    dtype on the host (numpy for float16, torch for bfloat16, both round to
    nearest even), with the weights unrounded (the JAX pipeline rounds them
    as well, task.py:596)."""
    fam = Family("transfer")
    fam.w = np.random.default_rng(4).uniform(0.5, 1.5, N) * (1 + 1e-4)
    if wire == "float16":
        rounded = fam.x.astype(np.float16).astype(np.float32)
    else:
        rounded = torch.from_numpy(fam.x).to(torch.bfloat16).float().numpy()
    assert not np.array_equal(rounded, fam.x)
    resident = fam.task("port", tmp_path / "r", x=rounded)
    resident.train()
    task = fam.task("port", tmp_path / "s", streaming=True)
    task.stream_wire_dtype = wire
    task.train()
    _assert_same_run(resident, task)
    assert task._stream_io[1].inputs[0].dtype == getattr(torch, wire)
    with pytest.raises(ValueError, match="stream_wire_dtype"):
        task.stream_wire_dtype = "int8"
        task.train()


def test_stream_timing_fills_the_stage_times(tmp_path):
    task = Family("transfer").task("port", tmp_path, streaming=True,
                                   num_epochs=2)
    task.stream_timing = True
    task.train()
    st = task.stream_stats
    nb = len(task._prepare_data()[2]) + len(task._prepare_data()[3])
    assert st["gather_s"].shape == (2 * nb,) and st["wall_s"] > 0
    # the copy and step device times are the card's only
    assert st["h2d_ms"].size == st["step_ms"].size == 0
    assert st["host_bytes"] > 0


# ---------------------------------------------------------------------------
# what streaming turns off or refuses
def test_explicit_gram_pp_warns_and_takes_the_vjp_path(tmp_path):
    fam = Family("generator")
    task = fam.task("port", tmp_path, streaming=True, gram_pp=True,
                    num_epochs=1)
    with pytest.warns(UserWarning, match="gram_pp=True could not"):
        task.train()
    assert not task._gram


def test_sweeps_refuse_a_streaming_task(tmp_path):
    fam = Family("transfer")
    task = fam.task("port", tmp_path / "a", streaming=True)
    with pytest.raises(Incompatible, match="streaming") as err:
        train_hyperparameter_sweep(task, {"learning_rate": [0.01, 0.02]})
    assert isinstance(err.value, ValueError)
    other = fam.task("port", tmp_path / "b", streaming=True)
    with pytest.raises(ValueError, match="streaming"):
        train_replica_ensemble([task, other])

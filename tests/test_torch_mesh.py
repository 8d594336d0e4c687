"""PyTorch port, the data mesh (``parallel/mesh.py``, ``mesh=`` and
``shard_trajectory=`` on every task family, streaming and the replica
sweeps over a mesh). Three processes train every case: two ranks of a gloo
group (W = 2) and one process that trains it on a mesh of one rank and
without a mesh (``tests/torch_mesh_worker.py``, which imports no JAX). Each
W = 2 run is held against the JAX package's meshed run on its virtual CPU
devices (``Mesh(jax.devices()[:2], ('data',))``) on the same numpy inputs,
initial parameters and split, in float64; against the port's W = 1 run; and
rank 0 against rank 1, bit for bit. The W = 1 run is bit for bit the
unmeshed run. The JAX package's own list is ``tests/test_parallel.py``,
``tests/test_streaming.py:164-196``, ``tests/test_ensemble.py:428-495`` and
``tests/test_fused_eigen.py:150-170``."""

import os
import pickle
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

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
from colvarsfinder_tpu.ops.features import Identity as JaxIdentity
from colvarsfinder_tpu.ops.features import PreprocessingANN as JaxPP
from colvarsfinder_tpu.utils import WeightedTrajectory as JaxTraj

from colvarsfinder_tpu_torch import config as pconfig
from colvarsfinder_tpu_torch.parallel import (
    make_data_mesh,
    shard_batches,
    shard_frames,
    train_hyperparameter_sweep,
    train_replica_ensemble,
)

import torch_mesh_worker as worker

# float64 on both sides: the two libraries sum in other orders (the
# streaming and sweep tests' bar)
RTOL_JAX, ATOL_JAX = 1e-9, 1e-12
# W = 2 against W = 1: each rank's matmuls over half the batch and the sum
# of two gradients reassociate float64 sums, ~1e-16 per step
TOL_W = 1e-12
#: seconds the three rank processes may take together
JOIN_S = 240
#: the parameters whose gradient is a rounding residue: an eigenfunction
#: head's output bias (the loss does not change when a head's output
#: shifts), which Adam normalizes to a step of the learning rate's size
#: (tests/test_torch_ensemble.py)
RESIDUE = ("biases.1", "reg.biases.1")


def _np(params):
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


def _jax_models():
    """The initial models of every family, from JAX seeds, in float64 (JAX
    draws other values for another dtype)."""
    prev = jconfig.default_dtype()
    jconfig.set_default_dtype("float64")
    try:
        return _models()
    finally:
        jconfig.set_default_dtype(prev)


def _models():
    d = 3 * worker.N_ATOMS
    return {
        "transfer": JaxEF([d, 10, 1], k=2, seed=1),
        "transfer_wide": JaxEF([d, 14, 1], k=2, seed=2),
        "generator": JaxEF([d, 10, 1], k=2, seed=1),
        "generator_gram": JaxEF([d + 1, 10, 1], k=2, seed=1),
        "committor": jax_seq([d, 10, 1], seed=1),
        "ae": JaxAE([d, 10, 2], [2, 10, d], seed=1),
        "regae": JaxRegAE([d, 10, 2], [2, 10, d], [2, 6, 1], K=2, seed=1),
    }


def _params(family, jm):
    """A JAX model's parameters as ``torch_mesh_worker.port_model`` takes
    them."""
    if family == "committor":
        return {n: np.asarray(v) for n, v in jm.named_parameters()}
    if family == "ae":
        return _np(jm.encoder.params), _np(jm.decoder.params)
    if family == "regae":
        return (_np(jm.encoder.params), _np(jm.decoder.params),
                _np(jm.reg))
    return _np(jm.params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every worker's results: ``mesh2_rank0``, ``mesh2_rank1`` and
    ``single1_rank0``; the three processes run together, and a process
    that fails or outlives :data:`JOIN_S` fails the tests that read it."""
    tmp = tmp_path_factory.mktemp("mesh")
    spec = tmp / "spec.pkl"
    with open(spec, "wb") as f:
        pickle.dump({k: _params(k.replace("_wide", ""), m)
                     for k, m in _jax_models().items()}, f)
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    procs = {}
    for mode, world, rank in (("mesh", 2, 0), ("mesh", 2, 1),
                              ("single", 1, 0)):
        name = f"{mode}{world}_rank{rank}"
        log = open(tmp / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(
            [sys.executable, worker.__file__, mode, str(spec), str(tmp),
             str(rank), str(world), str(tmp / f"init_{mode}")],
            stdout=log, stderr=subprocess.STDOUT, env=env), log)
    failed = {}
    try:
        for name, (proc, log) in procs.items():
            try:
                rc = proc.wait(timeout=JOIN_S)
            except subprocess.TimeoutExpired:
                rc = "timed out"
            log.close()
            if rc != 0:
                failed[name] = (rc, (tmp / f"{name}.log").read_text()[-3000:])
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        pytest.fail(f"mesh workers failed: {failed}")
    return {name: dict(np.load(tmp / f"{name}.npz")) for name in procs}


@pytest.fixture
def f64():
    """Both packages in float64, float32 restored afterwards."""
    jconfig.set_default_dtype("float64")
    pconfig.set_default_dtype("float64")
    yield
    jconfig.set_default_dtype("float32")
    pconfig.set_default_dtype("float32")


def _jax_pp(family, ref):
    atoms = list(range(worker.N_ATOMS))
    if worker.flat(family):
        return JaxIdentity()
    feats = [JaxFeature("p", "position", atoms)]
    if family == "generator_gram":
        return JaxFeatureLayer(feats + [JaxFeature("b", "bond", [0, 3])])
    return JaxPP(JaxAlign(ref, atoms), JaxFeatureLayer(feats))


def _jax_run(case, tmp_path):
    """The JAX package's meshed run of ``case`` on two virtual devices:
    its metric rows and its final parameters, named as the port names
    them."""
    family, kw = worker.CASES[case]
    ref, x, w = worker.data()
    if worker.flat(family):
        x = x.reshape(worker.N, -1)
    cls = {"committor": JaxComTask, "ae": JaxAETask,
           "regae": JaxRegTask}.get(family, JaxEigTask)
    jm = _jax_models()[family]
    task = cls(JaxTraj(trajectory=x, weights=w, dt=worker.DT, verbose=False),
               _jax_pp(family, ref), jm, str(tmp_path / "jax"),
               export_cv=False, mesh=Mesh(np.array(jax.devices()[:2]),
                                          ("data",)),
               split_indices=worker.split(family),
               **worker.COMMON, **worker.task_args(family), **kw)
    task.train()
    rows = worker.rows_of(task)
    model = worker.port_model(family, _params(family, task.model))
    return rows, {n: p.detach().numpy()
                  for n, p in model.named_parameters()}


def _params_of(res, tag, case):
    pre = f"{tag}/{case}/param/"
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", list(worker.CASES))
def test_meshed_run_matches_jax_meshed_run(f64, runs, tmp_path, case):
    rows, params = _jax_run(case, tmp_path)
    got = runs["mesh2_rank0"]
    mine = got[f"mesh/{case}/rows"]
    _close(mine, rows.reshape(mine.shape), RTOL_JAX, ATOL_JAX)
    mine = _params_of(got, "mesh", case)
    assert sorted(mine) == sorted(params)
    for n, v in params.items():
        if n not in RESIDUE:
            _close(mine[n], v, RTOL_JAX, ATOL_JAX)


@pytest.mark.parametrize("case", list(worker.CASES))
def test_two_ranks_match_one_rank(runs, case):
    two, one = runs["mesh2_rank0"], runs["single1_rank0"]
    _close(two[f"mesh/{case}/rows"], one[f"mesh/{case}/rows"], TOL_W, TOL_W)
    a, b = _params_of(two, "mesh", case), _params_of(one, "mesh", case)
    for n in a:
        if n not in RESIDUE:
            _close(a[n], b[n], TOL_W, TOL_W)


@pytest.mark.parametrize("case", list(worker.CASES))
def test_ranks_hold_the_same_bits(runs, case):
    r0, r1 = runs["mesh2_rank0"], runs["mesh2_rank1"]
    keys = [k for k in r0 if k.startswith(f"mesh/{case}/")
            and not k.endswith("/bytes")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


@pytest.mark.parametrize("case", list(worker.CASES))
def test_one_rank_is_the_unmeshed_run_bit_for_bit(runs, case):
    one = runs["single1_rank0"]
    keys = [k for k in one if k.startswith(f"mesh/{case}/")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(
            one[k], one[k.replace("mesh/", "plain/", 1)], err_msg=k)


@pytest.mark.parametrize("case", ["transfer", "shard_trajectory",
                                  "generator_gram"])
def test_each_rank_prepares_its_share(runs, case):
    """Each rank's prepared batches (the Gram matrices included) hold half
    of the unmeshed run's bytes, within 1/W + 5%; with shard_trajectory
    the same layout as without it."""
    half = runs["mesh2_rank0"][f"mesh/{case}/bytes"]
    whole = runs["single1_rank0"][f"plain/{case}/bytes"]
    assert half <= (0.5 + 0.05) * whole
    assert half == runs["mesh2_rank1"][f"mesh/{case}/bytes"]


@pytest.mark.parametrize("kind", ["sweep", "chunked", "ensemble", "arch"])
def test_sharded_sweeps_equal_unsharded(runs, kind):
    """R = 4 replicas over two ranks (each rank trains two with the same
    replica program, no collective during training) against the unsharded
    sweep: the same arithmetic per replica, bit for bit, on both ranks."""
    one = runs["single1_rank0"]
    keys = [k for k in one if k.startswith(f"plain/{kind}/")]
    assert keys
    for rank in (0, 1):
        got = runs[f"mesh2_rank{rank}"]
        for k in keys:
            np.testing.assert_array_equal(
                got[k.replace("plain/", "mesh/", 1)], one[k], err_msg=k)
    # and one rank's sweep equals the unmeshed one
    for k in keys:
        np.testing.assert_array_equal(one[k.replace("plain/", "mesh/", 1)],
                                      one[k], err_msg=k)


REFUSAL_MATCH = {
    "fused_step": "single device",
    "train_batch": "train batches hold 63",
    "test_batch": "test batches hold 63",
    "replicas": "3 replicas do not divide",
    "meshed_task": "own data mesh",
    "wire_dtype": "stream_wire_dtype",
}


@pytest.mark.parametrize("name", worker.REFUSALS)
def test_refusals_on_a_mesh(runs, name):
    for rank in (0, 1):
        kind, message = runs[f"mesh2_rank{rank}"][f"refusal/{name}"]
        assert "ValueError" in kind.split("|")[1:], (kind, message)
        assert REFUSAL_MATCH[name] in message, message


def test_make_data_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="init_process_group"):
        make_data_mesh()


@pytest.mark.parametrize("quantity", ["value", "grad", "theta_grad"])
def test_gather_backward_is_not_scaled_by_the_world_size(runs, quantity):
    """L = (t_0 + t_1)^2 at t = (1, 2): every rank holds L = 9 and
    dL/dt_r = 6; an autograd all-gather that sums cotangents would give
    12. With t_r = theta * x_r, x = (1, 2) and (3, 4), theta = 0.5, the
    gradient summed over the ranks is 2 * 5 * 10 = 100."""
    want = {"value": [1.0, 2.0], "grad": [6.0], "theta_grad": 100.0}
    for rank in (0, 1):
        np.testing.assert_array_equal(
            runs[f"mesh2_rank{rank}"][f"gather/{quantity}"], want[quantity])


def test_replicate_and_shard_helpers(runs):
    r0, r1 = runs["mesh2_rank0"], runs["mesh2_rank1"]
    np.testing.assert_array_equal(r0["replicate/weight"],
                                  r1["replicate/weight"])
    np.testing.assert_array_equal(r0["shard/batches"], [[0, 1, 2],
                                                        [6, 7, 8]])
    np.testing.assert_array_equal(r1["shard/batches"], [[3, 4, 5],
                                                        [9, 10, 11]])
    np.testing.assert_array_equal(r0["shard/frames"], [0, 1, 2])
    np.testing.assert_array_equal(r1["shard/frames"], [3, 4, 0])


def _fake_mesh(rank, size):
    """What the helpers read of a mesh: its rank, size and group."""
    return types.SimpleNamespace(get_local_rank=lambda: rank,
                                 size=lambda: size, get_group=lambda: None)


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_shard_helpers_take_contiguous_shares(rank):
    mesh = _fake_mesh(rank, 3)
    t = torch.arange(24).reshape(2, 12)
    assert torch.equal(shard_batches(t, mesh),
                       t[:, 4 * rank:4 * rank + 4])
    assert shard_batches(t, None) is t
    np.testing.assert_array_equal(shard_frames(np.arange(9), mesh),
                                  np.arange(3 * rank, 3 * rank + 3))
    with pytest.raises(ValueError, match="does not divide"):
        shard_frames(np.arange(10), mesh)
    with pytest.raises(ValueError, match="does not divide"):
        shard_batches(np.zeros((2, 7)), mesh)
    padded = shard_frames(torch.ones(10, 2), mesh, pad=True)
    assert padded.shape == (4, 2)
    assert padded.sum().item() == (8.0 if rank < 2 else 4.0)


def test_sweep_refuses_replicas_that_do_not_divide(tmp_path):
    """Before any collective: R = 3 replicas, or chunks of 3, over two
    ranks."""
    params = _params("transfer", _jax_models()["transfer"])
    task = worker.port_task("transfer", params, tmp_path)
    grid = {"alpha": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]}
    with pytest.raises(ValueError, match="do not divide"):
        train_hyperparameter_sweep(task, {"alpha": [1.0, 2.0, 3.0]},
                                   mesh=_fake_mesh(0, 2))
    with pytest.raises(ValueError, match="3 replicas do not divide"):
        train_hyperparameter_sweep(task, grid, chunk_size=3,
                                   mesh=_fake_mesh(0, 2))
    with pytest.raises(ValueError, match="do not divide"):
        train_replica_ensemble([task] * 3, mesh=_fake_mesh(0, 2))

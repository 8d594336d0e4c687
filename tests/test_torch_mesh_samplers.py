"""PyTorch port, ``mesh=`` of the four enhanced samplers
(``utils/enhanced.py``): metadynamics walkers, umbrella windows, steered
pulls and replica-exchange slots sharded over the ranks of a mesh. Three
processes run every case (``tests/torch_mesh_sampler_worker.py``, which
imports no JAX): two ranks of a gloo group (W = 2) and one process that
runs it on a mesh of one rank and without a mesh. Each is fed the JAX
package's random draws through the port's noise seam, recorded here from
the port's unmeshed call. The W = 2 run is held against the JAX package's
meshed run on two of its virtual CPU devices
(``Mesh(jax.devices()[:2], ('data',))``) at the sampler bar of
``test_torch_sampling.py`` (``F32_ATOL`` for states, ten times it for what
sums or scales them; replica exchange's swaps and counts exactly), rank 0
against rank 1 bit for bit, and the W = 2 and W = 1 runs against the
unmeshed run bit for bit (these CVs and potentials are elementwise, so
nothing rounds differently over half the chains).

Metadynamics runs 1,000 steps of 8 walkers at beta 8 across a barrier:
there the port's unmeshed run parts from the JAX package's (meshed or not)
by 5.0e-6 in the states, growth of rounding that the mesh takes no part in
(the W = 2 run is the unmeshed run bit for bit). Its states are held at
the JAX package's own meshed-test bar at these sizes, 1e-5
(``tests/test_metad_reweight.py:186``), and what sums or scales them at
ten times that. The JAX package's own tests are
``tests/test_metad_reweight.py::test_mesh_sharded_walkers``,
``tests/test_umbrella.py::test_mesh_sharded_windows``,
``tests/test_steered.py::test_mesh_sharded_realizations`` and
``tests/test_remd.py::test_mesh_sharded_replicas``."""

import os
import pickle
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from colvarsfinder_tpu.utils import enhanced as jenh

from colvarsfinder_tpu_torch.utils import enhanced as tenh
from colvarsfinder_tpu_torch.utils import sampling as tsampling
from test_torch_sampling import F32_ATOL, JaxNoise

import torch_mesh_sampler_worker as worker

#: the states' bar by case (F32_ATOL unless named); ten times it for the
#: arrays that sum or scale them, and the EXACT ones exactly
STATE_ATOL = {"metadynamics": 1e-5}
STATES = ("frames", "cv_values", "hill_centers")
EXACT = ("swap_history", "pair_attempts", "pair_accepts", "centers",
         "kappas", "betas")
#: seconds the three rank processes may take together
JOIN_S = 120


class Recording(JaxNoise):
    """The JAX package's draws of one call, kept by ``(stream, index)``."""

    def __init__(self, seed, scheme, n_chains, log):
        super().__init__(seed, scheme, n_chains)
        self.log = log

    def normal(self, out, stream, i):
        super().normal(out, stream, i)
        self.log[(stream, i)] = out.numpy().copy()

    def uniform(self, out, stream, i):
        super().uniform(out, stream, i)
        self.log[(stream, i)] = out.numpy().copy()


def _record(case):
    """Every draw the port's unmeshed call of ``case`` asks for."""
    log = {}
    scheme, n_chains = worker.SCHEMES[case]
    make = tsampling._make_noise
    tsampling._make_noise = lambda seed, device: Recording(
        seed, scheme, n_chains, log)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            worker.run(tenh, torch, case, device="cpu")
    finally:
        tsampling._make_noise = make
    return log


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every worker's results and files: ``mesh2_rank0``, ``mesh2_rank1``
    and ``single1_rank0``, run together; a process that fails or outlives
    :data:`JOIN_S` fails the tests that read it."""
    tmp = tmp_path_factory.mktemp("mesh_samplers")
    spec = tmp / "draws.pkl"
    with open(spec, "wb") as f:
        pickle.dump({case: _record(case) for case in worker.CASES}, f)
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
        pytest.fail(f"mesh sampler workers failed: {failed}")
    out = {name: dict(np.load(tmp / f"{name}.npz")) for name in procs}
    out["files"] = tmp / "files"
    return out


def _jax_mesh():
    return Mesh(np.array(jax.devices()[:2]), ("data",))


@pytest.fixture(scope="module")
def jax_meshed():
    """The JAX package's meshed run of every case, on two devices."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return {case: worker.arrays(worker.run(jenh, jnp, case,
                                               mesh=_jax_mesh()))
                for case in worker.CASES}


def _of(res, tag, case):
    pre = f"{tag}/{case}/"
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


@pytest.mark.parametrize("case", list(worker.CASES))
def test_two_ranks_match_the_jax_meshed_run(runs, jax_meshed, case):
    want = jax_meshed[case]
    got = _of(runs["mesh2_rank0"], "mesh", case)
    assert sorted(got) == sorted(want)
    for name, j in want.items():
        t = got[name]
        assert t.shape == j.shape and t.dtype == j.dtype, name
        atol = STATE_ATOL.get(case, F32_ATOL)
        if name in EXACT:
            np.testing.assert_array_equal(t, j, err_msg=name)
        else:
            np.testing.assert_allclose(
                np.asarray(t, np.float64), np.asarray(j, np.float64), rtol=0,
                atol=atol if name in STATES else 10 * atol, err_msg=name)
    if case == "remd":
        # the exchanges cross the ranks: swaps happened, on both halves
        swaps = got["swap_history"]
        assert swaps[:, :4].any() and swaps[:, 4:].any()


@pytest.mark.parametrize("case", list(worker.CASES))
def test_ranks_hold_the_same_bits(runs, case):
    r0 = _of(runs["mesh2_rank0"], "mesh", case)
    r1 = _of(runs["mesh2_rank1"], "mesh", case)
    assert r0 and sorted(r0) == sorted(r1)
    for name in r0:
        np.testing.assert_array_equal(r0[name], r1[name], err_msg=name)


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("case", list(worker.CASES))
def test_meshed_run_is_the_unmeshed_run_bit_for_bit(runs, case, world):
    one = runs["single1_rank0"]
    meshed = _of(runs[("single1_rank0", "mesh2_rank0")[world - 1]], "mesh",
                 case)
    plain = _of(one, "plain", case)
    assert meshed and sorted(meshed) == sorted(plain)
    for name in meshed:
        np.testing.assert_array_equal(meshed[name], plain[name],
                                      err_msg=name)


@pytest.mark.parametrize("case", list(worker.WRITES))
def test_only_rank_0_writes_files(runs, case):
    files = runs["files"]
    rank0 = files / "mesh2_rank0" / case
    one = files / "single1_rank0"
    names = sorted(os.listdir(one / f"{case}_plain"))
    assert names and sorted(os.listdir(rank0)) == names
    assert not (files / "mesh2_rank1" / case).exists()
    for name in names:
        # the one-rank mesh writes the unmeshed run's bytes
        assert (one / case / name).read_bytes() == (
            one / f"{case}_plain" / name).read_bytes(), name


@pytest.mark.parametrize("case", list(worker.CASES))
def test_a_count_that_does_not_divide_is_refused(runs, case):
    """Three walkers, windows, pulls or slots on two ranks: the JAX
    package's ``ValueError``, word for word, on both ranks."""
    with pytest.raises(ValueError, match="divisible") as jerr:
        worker.odd(jenh, jnp, case, mesh=_jax_mesh())
    for rank in (0, 1):
        got = str(runs[f"mesh2_rank{rank}"][f"refusal/{case}"])
        assert got == str(jerr.value)

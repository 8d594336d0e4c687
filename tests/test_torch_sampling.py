"""PyTorch port, the samplers of ``utils/sampling.py`` against the JAX
package's: overdamped Euler–Maruyama and BAOAB on the CPU with the JAX
package's own random draws fed through the port's noise seam
(``sampling._make_noise``), the host numpy loops bit for bit, the output
files, the OpenMM wrapper with a fake engine, and two statistical checks
with the port's own draws.

Tolerances: the states are O(1) float32 numbers after at most 170 steps of
a contracting force; the two libraries round in other orders (XLA fuses
the step), and the trajectories here part by 1-2 float32 ulps (1.2e-7 to
1.8e-7; energies of O(10) by 1.1e-6). ``F32_ATOL`` = 2e-6 is ten times
that, about 17 ulps of 1.0; energies take ten times ``F32_ATOL``."""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colvarsfinder_tpu.utils import sampling as jsampling

from colvarsfinder_tpu_torch import graphs
from colvarsfinder_tpu_torch.utils import sampling as tsampling

F32_ATOL = 2e-6


def triple_well(xp, beta=8.0):
    """examples/enhanced_sampling.py's TripleWellCircle in ``xp``."""

    class TripleWellCircle:
        dim = 2

        def V(self, x):
            theta = xp.arctan2(x[1], x[0])
            r = xp.sqrt(x[0] ** 2 + x[1] ** 2)
            return 1.0 + xp.cos(3.0 * theta) + 8.0 * (r - 1.0) ** 2

    pot = TripleWellCircle()
    pot.beta = beta
    return pot


def double_well(xp, with_grad=False, beta=3.0):
    """``(x1^2 - 1)^2 + 4 x2^2``, with or without its gradient."""

    class DoubleWell:
        dim = 2

        def V(self, x):
            return (x[0] ** 2 - 1.0) ** 2 + 4.0 * x[1] ** 2

    if with_grad:
        DoubleWell.gradV = lambda self, x: xp.stack(
            [4.0 * x[0] * (x[0] ** 2 - 1.0), 8.0 * x[1]])
    pot = DoubleWell()
    pot.beta = beta
    return pot


class NumpyWell:
    """A potential written in numpy: the port takes its host loop."""

    dim = 3
    beta = 2.0

    def V(self, x):
        x = np.asarray(x, dtype=np.float64)
        return float(np.sum((x**2 - 1.0) ** 2) + 0.5 * x[0] * x[1])


class NumpyWellWithGrad(NumpyWell):
    def gradV(self, x):
        x = np.asarray(x, dtype=np.float64)
        g = 4.0 * x * (x**2 - 1.0)
        g[0] += 0.5 * x[1]
        g[1] += 0.5 * x[0]
        return g


class JaxNoise:
    """The JAX package's draws for one sampler call, served through the
    port's seam by stream name (``sampling._Noise``): the default starts
    split off the call's key first, then the scan's keys (``_em_scan``,
    ``_baoab_scan``, ``_steered_scan``: burn and main; ``_metad_scan``: a
    burn and a main key per walker; ``_remd_scan``: burn, main and
    exchange), each block's increments from ``fold_in(key, block)``."""

    def __init__(self, seed, scheme="em", n_chains=1):
        self.key = jax.random.PRNGKey(seed)
        self.scheme = scheme
        self.n_chains = n_chains
        self.keys = None

    def _scan_keys(self):
        if self.keys is None:
            if self.scheme == "metad":
                pairs = [jax.random.split(k)
                         for k in jax.random.split(self.key, self.n_chains)]
                self.keys = ([p[0] for p in pairs], [p[1] for p in pairs])
            elif self.scheme == "remd":
                self.keys = tuple(jax.random.split(self.key, 3))
            else:
                self.keys = tuple(jax.random.split(self.key))
        return self.keys

    def normal(self, out, stream, i):
        shape = tuple(out.shape)
        if stream in ("x0", "v0"):
            self.key, sub = jax.random.split(self.key)
            val = jax.random.normal(sub, shape)
        elif self.scheme == "metad":
            burn, main = self._scan_keys()
            one = (shape[0], shape[2])
            if stream == "metad_burn":
                val = jnp.stack([jax.random.normal(k, one) for k in burn], 1)
            else:
                val = jnp.stack([jax.random.normal(jax.random.fold_in(k, i),
                                                   one) for k in main], 1)
        else:
            key = self._scan_keys()[0 if stream == "burn" else 1]
            val = jax.random.normal(jax.random.fold_in(key, i), shape)
        out.copy_(torch.from_numpy(np.array(val, dtype=np.float32)))

    def uniform(self, out, stream, i):
        ex = self._scan_keys()[2]
        val = jax.random.uniform(jax.random.fold_in(ex, i), tuple(out.shape))
        out.copy_(torch.from_numpy(np.array(val, dtype=np.float32)))


@pytest.fixture
def jax_noise(monkeypatch):
    """Feed the port the JAX package's draws: ``jax_noise(scheme,
    n_chains)`` before a call."""

    def use(scheme="em", n_chains=1):
        monkeypatch.setattr(
            tsampling, "_make_noise",
            lambda seed, device: JaxNoise(seed, scheme, n_chains))

    return use


@pytest.mark.parametrize("case", ["v_only", "grad_chains_burn",
                                  "default_start"])
def test_overdamped_matches_jax(tmp_path, jax_noise, case):
    jax_noise("em")
    grad = case == "grad_chains_burn"
    kw = dict(n_steps=100, report_interval=50, step_size=0.01, seed=3,
              verbose=False)
    if case == "grad_chains_burn":
        # three chains, a burn-in whose second block is partial (70 = 50 + 20)
        kw.update(n_chains=3, pre_steps=70, X0=[0.9, -0.2])
    elif case == "v_only":
        kw.update(X0=[1.1, 0.3])
    jf, je = jsampling.integrate_sde_overdamped(
        double_well(jnp, grad), sampling_output_path=str(tmp_path / "j"),
        **kw)
    tf, te = tsampling.integrate_sde_overdamped(
        double_well(torch, grad), sampling_output_path=str(tmp_path / "t"),
        device="cpu", **kw)
    assert tf.shape == jf.shape and te.shape == je.shape
    assert tf.dtype == jf.dtype == np.float64
    np.testing.assert_allclose(tf, jf, rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(te, je, rtol=0, atol=10 * F32_ATOL)


def test_langevin_matches_jax(tmp_path, jax_noise):
    """BAOAB with per-dimension masses, X0 and V0 drawn by each package,
    a partial burn-in block, two chains, velocities returned."""
    jax_noise("em")
    kw = dict(n_steps=100, report_interval=50, step_size=0.02, seed=5,
              friction=2.0, masses=[1.0, 2.5], pre_steps=30, n_chains=2,
              return_velocities=True, verbose=False)
    jout = jsampling.integrate_sde_langevin(
        triple_well(jnp), sampling_output_path=str(tmp_path / "j"), **kw)
    tout = tsampling.integrate_sde_langevin(
        triple_well(torch), sampling_output_path=str(tmp_path / "t"),
        device="cpu", **kw)
    for t, j, tol in zip(tout, jout, (F32_ATOL, 10 * F32_ATOL, F32_ATOL)):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, rtol=0, atol=tol)


@pytest.mark.parametrize("pot", [NumpyWell, NumpyWellWithGrad])
def test_numpy_host_loops_match_jax_bit_for_bit(tmp_path, pot):
    """A numpy potential takes the JAX package's numpy loop in both
    packages: float64, ``np.random.default_rng(seed)``, the same bits."""
    X0 = np.array([[0.5, -1.2, 0.1], [1.0, 0.0, -0.7]])
    kw = dict(n_steps=40, report_interval=7, pre_steps=5, seed=11,
              n_chains=2, X0=X0, verbose=False)
    with pytest.warns(UserWarning, match="falling back to host numpy"):
        jf, je = jsampling.integrate_sde_overdamped(
            pot(), sampling_output_path=str(tmp_path / "j1"), **kw)
    with pytest.warns(UserWarning, match="falling back to host numpy"):
        tf, te = tsampling.integrate_sde_overdamped(
            pot(), sampling_output_path=str(tmp_path / "t1"), device="cpu",
            **kw)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(te, je)
    kw.update(V0=[0.3, -0.1, 0.2], masses=2.0, friction=0.5,
              return_velocities=True)
    with pytest.warns(UserWarning, match="falling back to host numpy"):
        jout = jsampling.integrate_sde_langevin(
            pot(), sampling_output_path=str(tmp_path / "j2"), **kw)
    with pytest.warns(UserWarning, match="falling back to host numpy"):
        tout = tsampling.integrate_sde_langevin(
            pot(), sampling_output_path=str(tmp_path / "t2"), device="cpu",
            **kw)
    for t, j in zip(tout, jout):
        np.testing.assert_array_equal(t, j)
    # the files of both packages, byte for byte (pandas' CSV on the JAX
    # side, the standard library's on the port's)
    for sub in ("1", "2"):
        jd, td = tmp_path / f"j{sub}", tmp_path / f"t{sub}"
        names = sorted(os.listdir(jd))
        assert names == sorted(os.listdir(td)) == [
            "output.csv", "output_chain1.csv", "traj.txt",
            "traj_chain1.txt"]
        for name in names:
            assert (td / name).read_bytes() == (jd / name).read_bytes(), name


def test_torch_path_files_match_jax(tmp_path, jax_noise):
    """On the torch path the files hold the same rows as JAX's, within the
    float32 bar, under the same names and header."""
    jax_noise("em")
    kw = dict(n_steps=120, report_interval=40, seed=2, X0=[0.2, 0.9],
              n_chains=2, traj_txt_filename="t.txt", csv_filename="e.csv",
              verbose=False)
    jsampling.integrate_sde_overdamped(
        triple_well(jnp), sampling_output_path=str(tmp_path / "j"), **kw)
    tsampling.integrate_sde_overdamped(
        triple_well(torch), sampling_output_path=str(tmp_path / "t"),
        device="cpu", **kw)
    jd, td = tmp_path / "j", tmp_path / "t"
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td)) == [
        "e.csv", "e_chain1.csv", "t.txt", "t_chain1.txt"]
    for name in ("t.txt", "t_chain1.txt"):
        np.testing.assert_allclose(np.loadtxt(td / name),
                                   np.loadtxt(jd / name), atol=1e-6 + F32_ATOL)
    for name in ("e.csv", "e_chain1.csv"):
        assert (td / name).read_text().splitlines()[0] == "Time,Energy"
        np.testing.assert_allclose(
            np.loadtxt(td / name, delimiter=",", skiprows=1),
            np.loadtxt(jd / name, delimiter=",", skiprows=1),
            atol=10 * F32_ATOL)


def test_csv_values_are_written_as_pandas_writes_them(tmp_path):
    pd = pytest.importorskip("pandas")
    times = np.array([0.0, 0.1, 1e-5, 3.0, 12345.678])
    energies = np.array([[np.nan, 1e20, -0.0, np.float32(0.3), 2.5e-300]])
    tsampling._write_chains(str(tmp_path), "t.txt", "e.csv",
                            np.zeros((1, 5, 1)), times, energies)
    want = pd.DataFrame({"Time": times, "Energy": energies[0]}).to_csv(
        index=False)
    assert (tmp_path / "e.csv").read_text() == want


def test_recorder_chunks_give_the_same_frames(tmp_path, monkeypatch):
    """Reports fetched once per chunk of rows equal one fetch per call, and
    the eager prefix (graphs.eager(blocks=4)) equals the start of a full
    run."""
    kw = dict(n_steps=500, report_interval=25, seed=9, X0=[1.0, 0.0],
              n_chains=2, verbose=False, device="cpu")
    pot = triple_well(torch)
    full, _ = tsampling.integrate_sde_overdamped(
        pot, sampling_output_path=str(tmp_path / "a"), **kw)
    monkeypatch.setattr(tsampling, "_CHUNK_BYTES", 3 * 2 * 2 * 4)
    chunked, _ = tsampling.integrate_sde_overdamped(
        pot, sampling_output_path=str(tmp_path / "b"), **kw)
    np.testing.assert_array_equal(chunked, full)
    with graphs.eager(blocks=4):
        prefix, _ = tsampling.integrate_sde_overdamped(
            pot, sampling_output_path=str(tmp_path / "c"), **kw)
    np.testing.assert_array_equal(prefix[:, :4], full[:, :4])
    assert not prefix[:, 4:].any()


def test_the_potential_is_probed_up_front(tmp_path):
    """One call on a CPU tensor decides: a numpy potential takes the host
    loop, a torch potential's own error raises (nothing falls back)."""
    assert tsampling._is_torch_potential(triple_well(torch), [1.0, 0.0])
    assert not tsampling._is_torch_potential(NumpyWell(), [1.0, 0.0, 0.0])

    class Broken:
        dim, beta = 2, 1.0

        def V(self, x):
            return x.sum()

        def gradV(self, x):
            raise ZeroDivisionError("broken gradient")

    with pytest.raises(ZeroDivisionError, match="broken gradient"):
        tsampling.integrate_sde_overdamped(
            Broken(), 10, str(tmp_path), X0=[0.0, 0.0], seed=0,
            device="cpu", verbose=False)


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device exists")
    for fn in (tsampling.integrate_sde_overdamped,
               tsampling.integrate_sde_langevin):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(triple_well(torch), 10, str(tmp_path), verbose=False)


def test_harmonic_chain_mean_and_variance(tmp_path):
    """The port's own draws sample exp(-beta V): a harmonic well's mean and
    variance from 2,048 chains, overdamped (the Euler–Maruyama stationary
    variance 1 / (beta k (1 - k dt / 2))) and BAOAB (exact configurational
    variance 1 / (beta k) for a harmonic force). 50 reports per chain after
    ~6 relaxation times, correlated over ~6 reports: ~17,000 independent
    samples, a variance known to ~1.1%; the bar is 5%."""

    class Harmonic:
        dim, beta, k = 1, 2.0, 4.0

        def V(self, x):
            return 0.5 * self.k * torch.sum((x - 0.5) ** 2)

    pot, dt, c = Harmonic(), 0.02, 2048
    kw = dict(n_steps=800, report_interval=10, seed=0, X0=[0.5],
              n_chains=c, pre_steps=200, step_size=dt, verbose=False,
              device="cpu")
    frames, _ = tsampling.integrate_sde_overdamped(
        pot, sampling_output_path=str(tmp_path / "o"), **kw)
    var_em = 1.0 / (pot.beta * pot.k * (1.0 - pot.k * dt / 2.0))
    x = frames[:, 30:, 0]
    se_mean = np.sqrt(var_em / (c * x.shape[1] / 6.0))
    assert abs(x.mean() - 0.5) < 5 * se_mean
    assert abs(x.var() / var_em - 1.0) < 0.05
    frames, _ = tsampling.integrate_sde_langevin(
        pot, sampling_output_path=str(tmp_path / "b"), friction=2.0, **kw)
    x = frames[:, 30:, 0]
    assert abs(x.mean() - 0.5) < 5 * se_mean
    assert abs(x.var() * pot.beta * pot.k - 1.0) < 0.05


# ---------------------------------------------------------------------------
# integrate_md_langevin with a fake OpenMM (tests/test_md_sampler.py:55-80)
class _FakeSimulation:
    instances = []

    def __init__(self, topology, system, integrator):
        self.topology, self.system = topology, system
        self.context = types.SimpleNamespace(
            setPositions=lambda p: None,
            getPlatform=lambda: types.SimpleNamespace(getName=lambda: "Fake"),
        )
        self.minimized = False
        self.step_calls = []
        self.reporters = []
        _FakeSimulation.instances.append(self)

    def minimizeEnergy(self):
        self.minimized = True

    def step(self, n):
        self.step_calls.append(n)


@pytest.fixture
def fake_openmm(monkeypatch):
    _FakeSimulation.instances = []
    reporter_log = []

    def _reporter(kind):
        class R:
            def __init__(self, target, interval, **kw):
                reporter_log.append((kind, target, interval, kw))
        return R

    app = types.ModuleType("openmm.app")
    app.Simulation = _FakeSimulation
    app.DCDReporter = _reporter("dcd")
    app.StateDataReporter = _reporter("state")
    openmm_mod = types.ModuleType("openmm")
    openmm_mod.app = app
    plumed_forces = []

    class PlumedForce:
        def __init__(self, script):
            self.script = script
            plumed_forces.append(self)

    plumed = types.ModuleType("openmmplumed")
    plumed.PlumedForce = PlumedForce
    monkeypatch.setitem(sys.modules, "openmm", openmm_mod)
    monkeypatch.setitem(sys.modules, "openmm.app", app)
    monkeypatch.setitem(sys.modules, "openmmplumed", plumed)
    return types.SimpleNamespace(reporters=reporter_log,
                                 plumed_forces=plumed_forces)


@pytest.mark.parametrize("pre_steps, plumed", [(0, None), (250, "d: X")])
def test_integrate_md_langevin_drives_the_engine_as_jax_does(
        tmp_path, fake_openmm, pre_steps, plumed):
    """Both packages make the same calls on the engine and return the same
    paths."""
    outs = []
    for mod in (jsampling, tsampling):
        forces = []
        system = types.SimpleNamespace(addForce=forces.append)
        pdb = types.SimpleNamespace(topology="top", positions="pos")
        dcd, csv, elapsed = mod.integrate_md_langevin(
            pdb, system, "integrator", n_steps=1000,
            sampling_output_path=str(tmp_path / "md"), pre_steps=pre_steps,
            report_interval=20, report_interval_stdout=50,
            plumed_script=plumed, verbose=False)
        sim = _FakeSimulation.instances[-1]
        assert sim.minimized and isinstance(elapsed, float)
        outs.append((dcd, csv, sim.step_calls, len(sim.reporters),
                     [f.script for f in forces]))
    assert outs[0] == outs[1]
    assert outs[1][2] == ([pre_steps, 1000] if pre_steps else [1000])
    assert outs[1][4] == ([plumed] if plumed else [])
    half = len(fake_openmm.reporters) // 2
    strip = [(k, os.path.basename(str(t)) if k == "dcd" or t != sys.stdout
              else "stdout", i, kw) for k, t, i, kw in fake_openmm.reporters]
    assert strip[:half] == strip[half:]


def test_integrate_md_langevin_without_openmm(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "openmm", None)
    monkeypatch.setitem(sys.modules, "openmm.app", None)
    with pytest.raises(ImportError, match="integrate_sde_overdamped"):
        tsampling.integrate_md_langevin(None, None, None, 10, str(tmp_path))

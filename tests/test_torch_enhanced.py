"""PyTorch port, the samplers of ``utils/enhanced.py`` against the JAX
package's: metadynamics (hills included), :class:`BiasedPotential`,
umbrella sampling, steered pulls (works included) and replica exchange
(the swap history included), each fed the JAX package's random draws
through the port's noise seam; MBAR, the result dataclasses and the PLUMED
readers on the same inputs; the output files; the validation errors; the
slice as a whole (metadynamics along an aligned CV, the port's
``FusedAlignmentLayer`` against the JAX package's SVD layer); and a
metadynamics run that crosses a barrier with the port's own draws.

Tolerances as in ``test_torch_sampling.py`` (``F32_ATOL``, float32 states
of O(1) after at most 170 steps); CV values, hill heights, works and
energies, which sum or scale those states, take ten times it."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colvarsfinder_tpu.export import ColvarModel as JaxColvarModel
from colvarsfinder_tpu.models import EigenFunctions as JaxEigenFunctions
from colvarsfinder_tpu.ops.alignment import AlignmentLayer as JaxAlign
from colvarsfinder_tpu.ops.features import Feature as JaxFeature
from colvarsfinder_tpu.ops.features import FeatureLayer as JaxFeatureLayer
from colvarsfinder_tpu.ops.features import PreprocessingANN as JaxPP
from colvarsfinder_tpu.utils import enhanced as jenh
from colvarsfinder_tpu.utils import sampling as jsampling

import colvarsfinder_tpu_torch as port
from colvarsfinder_tpu_torch.ops import _cuda
from colvarsfinder_tpu_torch.utils import enhanced as tenh
from colvarsfinder_tpu_torch.utils import sampling as tsampling
from test_torch_sampling import (  # noqa: F401  (the fixture)
    F32_ATOL,
    double_well,
    jax_noise,
    triple_well,
)

LOOSE = 10 * F32_ATOL


def cv2(xp):
    """A two-component CV: ``(x_1, x_2^2)``, on one state (JAX) or a chain
    batch (the port)."""
    return lambda x: xp.concatenate([x[..., :1], x[..., 1:] ** 2], axis=-1)


def angle(xp):
    return lambda x: xp.arctan2(x[..., 1], x[..., 0])


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=0, atol=atol)


def _same_files(jd, td, names, atol):
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td)) == sorted(names)
    for name in names:
        j, t = (jd / name).read_text(), (td / name).read_text()
        # the same header and comment lines, the same numbers
        jh = [ln for ln in j.splitlines() if not ln[:1].isdigit()
              and not ln.startswith("-")]
        th = [ln for ln in t.splitlines() if not ln[:1].isdigit()
              and not ln.startswith("-")]
        assert jh == th, name
        sep = "," if name.endswith(".csv") else None
        skip = 1 if name.endswith(".csv") else 0
        _close(np.loadtxt(td / name, delimiter=sep, skiprows=skip),
               np.loadtxt(jd / name, delimiter=sep, skiprows=skip), atol)


@pytest.mark.parametrize("bias_factor", [None, 6.0])
def test_metadynamics_matches_jax(tmp_path, jax_noise, bias_factor):
    """Two walkers, a burn-in of one draw taken in a full and a partial
    block (30 = 20 + 10), two hills each, standard and well-tempered."""
    jax_noise("metad", n_chains=2)
    kw = dict(n_steps=40, deposit_interval=20, pre_steps=30, step_size=0.01,
              hill_height=0.4, hill_width=0.3, bias_factor=bias_factor,
              n_chains=2, seed=7, X0=[[0.9, 0.1], [-0.2, 1.0]],
              verbose=False)
    jr = jenh.integrate_sde_metadynamics(
        triple_well(jnp), cv2(jnp), sampling_output_path=str(tmp_path / "j"),
        **kw)
    tr = tenh.integrate_sde_metadynamics(
        triple_well(torch), cv2(torch),
        sampling_output_path=str(tmp_path / "t"), device="cpu", **kw)
    assert isinstance(tr, tenh.MetadynamicsResult)
    for name in ("frames", "cv_values", "hill_centers", "hill_heights"):
        j, t = getattr(jr, name), getattr(tr, name)
        assert t.shape == j.shape and t.dtype == j.dtype == np.float32, name
        _close(t, j, F32_ATOL if name == "frames" else LOOSE)
    assert (tr.hill_width, tr.bias_factor, tr.beta) == (
        jr.hill_width, jr.bias_factor, jr.beta)
    _same_files(tmp_path / "j", tmp_path / "t",
                ["traj.txt", "traj_chain1.txt", "HILLS", "HILLS_chain1"],
                atol=2e-6 + LOOSE)
    # the numpy methods on the same arrays give the same numbers
    t1 = tenh.MetadynamicsResult(**{f.name: getattr(jr, f.name) for f in
                                    tenh.dataclasses.fields(jr)})
    j1, t1 = jr.select_walker(1), t1.select_walker(1)
    s = np.linspace(-1.0, 1.0, 6).reshape(3, 2)
    np.testing.assert_array_equal(t1.bias(s), j1.bias(s))
    np.testing.assert_array_equal(t1.free_energy(s), j1.free_energy(s))
    for method in ("final-bias", "tiwary"):
        np.testing.assert_array_equal(
            t1.frame_weights(method, grid_points=17),
            j1.frame_weights(method, grid_points=17))


def test_biased_potential_matches_jax(tmp_path, jax_noise):
    jax_noise("em")
    kw = dict(n_steps=100, report_interval=50, X0=[0.8, 0.2], n_chains=2,
              pre_steps=20, seed=4, verbose=False)
    jpot = jenh.BiasedPotential(double_well(jnp), cv2(jnp),
                                jenh.harmonic_restraint([0.3, 0.1], 5.0))
    tpot = tenh.BiasedPotential(double_well(torch), cv2(torch),
                                tenh.harmonic_restraint([0.3, 0.1], 5.0))
    x = np.array([0.7, -0.4], np.float32)
    _close(tpot.V(torch.from_numpy(x)), jpot.V(jnp.asarray(x)), 1e-6)
    jf, je = jsampling.integrate_sde_overdamped(
        jpot, sampling_output_path=str(tmp_path / "j"), **kw)
    tf, te = tsampling.integrate_sde_overdamped(
        tpot, sampling_output_path=str(tmp_path / "t"), device="cpu", **kw)
    _close(tf, jf, F32_ATOL)
    _close(te, je, LOOSE)


def test_umbrella_matches_jax(tmp_path, jax_noise):
    jax_noise("em")
    centers = np.array([-0.5, 0.0, 0.5])
    kw = dict(n_steps=100, report_interval=50, pre_steps=30,
              X0=[1.0, 0.05], seed=12, verbose=False)
    jr = jenh.integrate_sde_umbrella(
        triple_well(jnp), angle(jnp), centers, [10.0, 20.0, 30.0],
        sampling_output_path=str(tmp_path / "j"), **kw)
    tr = tenh.integrate_sde_umbrella(
        triple_well(torch), angle(torch), centers, [10.0, 20.0, 30.0],
        sampling_output_path=str(tmp_path / "t"), device="cpu", **kw)
    assert tr.frames.shape == jr.frames.shape == (3, 2, 2)
    assert tr.cv_values.shape == jr.cv_values.shape == (3, 2, 1)
    _close(tr.frames, jr.frames, F32_ATOL)
    _close(tr.cv_values, jr.cv_values, LOOSE)
    np.testing.assert_array_equal(tr.centers, jr.centers)
    np.testing.assert_array_equal(tr.kappas, jr.kappas)
    assert (tmp_path / "t" / "windows.csv").read_bytes() == (
        tmp_path / "j" / "windows.csv").read_bytes()
    _same_files(tmp_path / "j", tmp_path / "t",
                ["windows.csv"] + [f"traj_win{k}.txt" for k in range(3)],
                atol=F32_ATOL)


def test_umbrella_result_methods_match_jax():
    """MBAR of the windows (the restraints evaluated in torch), the pooled
    weighted trajectory and the subsample, on the JAX result's arrays."""
    rng = np.random.default_rng(0)
    K, n = 4, 300
    centers = np.linspace(-1.0, 1.0, K)[:, None]
    walk = np.cumsum(0.2 * rng.standard_normal((K, n, 1)), axis=1)
    cvs = (centers[:, None, :] + 0.3 * np.tanh(walk)).astype(np.float32)
    frames = np.concatenate([cvs, -cvs], axis=-1)
    args = dict(frames=frames, cv_values=cvs, centers=centers,
                kappas=np.full(K, 8.0), beta=2.0, dt=0.5)
    jr, tr = jenh.UmbrellaResult(**args), tenh.UmbrellaResult(**args)
    jm, tm = jr.mbar(), tr.mbar()
    np.testing.assert_allclose(tm.free_energies, jm.free_energies,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.concatenate(tm.weights),
                               np.concatenate(jm.weights), rtol=1e-6)
    assert tm.converged and jm.converged
    jt, tt = jr.to_weighted_trajectory(jm), tr.to_weighted_trajectory(tm)
    np.testing.assert_array_equal(tt.trajectory, jt.trajectory)
    np.testing.assert_array_equal(tt.weights, jt.weights)
    np.testing.assert_array_equal(tt.segment_starts, jt.segment_starts)
    js, ts = jr.subsample(), tr.subsample()
    assert ts.dt == js.dt > jr.dt
    np.testing.assert_array_equal(ts.frames, js.frames)


def test_mbar_weights_match_jax_on_the_same_energies():
    rng = np.random.default_rng(3)
    n_k = [120, 80, 150, 60]
    cvs = [rng.normal(c, 0.4, size=n) for c, n in zip((-1, -0.3, 0.4, 1), n_k)]
    pooled = np.concatenate(cvs)
    u = 3.0 * (pooled[None, :] - np.array([-1, -0.3, 0.4, 1])[:, None]) ** 2
    jm = jenh.mbar_weights(cvs, u_kn=u)
    tm = tenh.mbar_weights(cvs, u_kn=u)
    np.testing.assert_allclose(tm.free_energies, jm.free_energies,
                               rtol=0, atol=1e-10)
    for a, b in zip(tm.weights, jm.weights):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=0)
    assert (tm.n_iter, tm.converged) == (jm.n_iter, jm.converged)
    with pytest.warns(UserWarning, match="did not converge"):
        tenh.mbar_weights(cvs, u_kn=u, max_iter=2)


def test_steered_matches_jax(tmp_path, jax_noise):
    jax_noise("em")
    kw = dict(n_steps=100, report_interval=50, pre_steps=30, n_realizations=3,
              X0=[1.0, 0.0], step_size=0.005, seed=8, verbose=False)
    jr = jenh.integrate_sde_steered(triple_well(jnp), angle(jnp), 0.0, 0.8,
                                    40.0, **kw)
    tr = tenh.integrate_sde_steered(triple_well(torch), angle(torch), 0.0,
                                    0.8, 40.0, device="cpu", **kw)
    assert isinstance(tr, tenh.SteeredResult)
    _close(tr.frames, jr.frames, F32_ATOL)
    _close(tr.cv_values, jr.cv_values, LOOSE)
    _close(tr.works, jr.works, LOOSE)
    np.testing.assert_array_equal(tr.schedule, jr.schedule)
    assert tr.works.dtype == tr.schedule.dtype == np.float64
    # the estimators and the umbrella seeds on the same arrays
    t2 = tenh.SteeredResult(**{f.name: getattr(jr, f.name) for f in
                               tenh.dataclasses.fields(jr)})
    np.testing.assert_array_equal(t2.jarzynski(), jr.jarzynski())
    np.testing.assert_array_equal(t2.cumulant(), jr.cumulant())
    np.testing.assert_array_equal(t2.dissipated_work, jr.dissipated_work)
    np.testing.assert_array_equal(t2.window_starts([0.2, 0.7]),
                                  jr.window_starts([0.2, 0.7]))


def test_remd_matches_jax(tmp_path, jax_noise):
    """Four slots at close temperatures (so that swaps are accepted), an
    exchange attempt before each of two blocks (even, then odd pairs), a
    partial burn-in block."""
    jax_noise("remd")
    kw = dict(n_steps=100, report_interval=50, exchange_interval=50,
              pre_steps=60, X0=[-1.0, 0.0], step_size=0.004, seed=1,
              verbose=False)
    betas = [4.0, 3.5, 3.0, 2.5]
    jr = jenh.integrate_sde_remd(double_well(jnp), betas,
                                 sampling_output_path=str(tmp_path / "j"),
                                 **kw)
    tr = tenh.integrate_sde_remd(double_well(torch), betas,
                                 sampling_output_path=str(tmp_path / "t"),
                                 device="cpu", **kw)
    assert isinstance(tr, tenh.REMDResult)
    _close(tr.frames, jr.frames, F32_ATOL)
    _close(tr.energies, jr.energies, LOOSE)
    np.testing.assert_array_equal(tr.swap_history, jr.swap_history)
    assert tr.swap_history.any()
    np.testing.assert_array_equal(tr.pair_attempts, jr.pair_attempts)
    np.testing.assert_array_equal(tr.pair_accepts, jr.pair_accepts)
    np.testing.assert_array_equal(tr.betas, jr.betas)
    assert tr.dt == jr.dt
    _same_files(tmp_path / "j", tmp_path / "t",
                ["replicas.csv"] + [f"traj_replica{k}.txt" for k in range(4)],
                atol=F32_ATOL)
    # temperature MBAR, the pooled trajectory and the subsample on the
    # same arrays
    t2 = tenh.REMDResult(**{f.name: getattr(jr, f.name) for f in
                            tenh.dataclasses.fields(jr)})
    np.testing.assert_array_equal(t2.pair_acceptance, jr.pair_acceptance)
    np.testing.assert_allclose(t2.mbar().free_energies,
                               jr.mbar().free_energies, rtol=0, atol=1e-10)
    jt, tt = jr.to_weighted_trajectory(), t2.to_weighted_trajectory()
    np.testing.assert_allclose(tt.weights, jt.weights, rtol=1e-10)
    np.testing.assert_array_equal(tt.segment_starts, jt.segment_starts)
    js, ts = jr.subsample(g=2), t2.subsample(g=2)
    np.testing.assert_array_equal(ts.swap_history, js.swap_history)
    np.testing.assert_array_equal(ts.frames, js.frames)


def test_plumed_readers_match_jax(tmp_path):
    """The HILLS file the JAX package writes, and a COLVAR file with a
    restart block, read by both packages; the reweighting on them."""
    jenh.integrate_sde_metadynamics(
        triple_well(jnp), cv2(jnp), n_steps=200, deposit_interval=20,
        bias_factor=5.0, X0=[1.0, 0.0], seed=2, hill_width=0.25,
        sampling_output_path=str(tmp_path), verbose=False)
    hills = str(tmp_path / "HILLS")
    jh, th = jenh.read_plumed_hills(hills), tenh.read_plumed_hills(hills)
    for f in tenh.dataclasses.fields(th):
        np.testing.assert_array_equal(getattr(th, f.name),
                                      getattr(jh, f.name))
    colvar = tmp_path / "COLVAR"
    rng = np.random.default_rng(5)
    rows = np.column_stack([np.arange(12) * 0.05,
                            rng.normal(size=(12, 2)), rng.normal(size=12)])
    lines = ["#! FIELDS time cv_0 cv_1 extra"]
    lines += [" ".join(f"{v:.6f}" for v in r) for r in rows[:7]]
    lines += ["#! FIELDS time cv_0 cv_1 extra", "#! SET min 0"]
    lines += [" ".join(f"{v:.6f}" for v in r) for r in rows[7:]]
    colvar.write_text("\n".join(lines) + "\n")
    for fields in (None, ["cv_1", "cv_0"]):
        jc = jenh.read_plumed_colvar(str(colvar), fields)
        tc = tenh.read_plumed_colvar(str(colvar), fields)
        np.testing.assert_array_equal(tc[0], jc[0])
        np.testing.assert_array_equal(tc[1], jc[1])
        assert tc[2] == jc[2]
    t, vals, _ = tenh.read_plumed_colvar(str(colvar), ["cv_0", "cv_1"])
    for method in ("final-bias", "tiwary"):
        np.testing.assert_array_equal(
            tenh.metad_frame_weights(vals, th, t * 100, beta=8.0,
                                     method=method, grid_points=21),
            jenh.metad_frame_weights(vals, jh, t * 100, beta=8.0,
                                     method=method, grid_points=21))


def _errors(lib, xp):
    """Calls that each package must refuse with the same message."""
    tw, ang, two = triple_well(xp), angle(xp), cv2(xp)
    kw = dict(verbose=False)
    if lib is tenh:
        kw["device"] = "cpu"
    return {
        "metad_gamma": lambda: lib.integrate_sde_metadynamics(
            tw, ang, 100, deposit_interval=10, bias_factor=1.0, **kw),
        "metad_short": lambda: lib.integrate_sde_metadynamics(
            tw, ang, 5, deposit_interval=10, **kw),
        "umbrella_steps": lambda: lib.integrate_sde_umbrella(
            tw, ang, [0.0, 1.0], 5.0, 0, **kw),
        "umbrella_x0": lambda: lib.integrate_sde_umbrella(
            tw, ang, [0.0, 1.0], 5.0, 10, X0=np.zeros((3, 2)), **kw),
        "umbrella_cv": lambda: lib.integrate_sde_umbrella(
            tw, ang, np.zeros((2, 2)), 5.0, 10, X0=[1.0, 0.0], **kw),
        "steered_ends": lambda: lib.integrate_sde_steered(
            tw, ang, [0.0, 1.0], 1.0, 5.0, 100, pre_steps=1, **kw),
        "steered_multiple": lambda: lib.integrate_sde_steered(
            tw, ang, 0.0, 1.0, 5.0, 150, pre_steps=1, **kw),
        "steered_x0": lambda: lib.integrate_sde_steered(
            tw, ang, 0.0, 1.0, 5.0, 100, n_realizations=2, pre_steps=1,
            X0=np.zeros((3, 2)), **kw),
        "steered_cv": lambda: lib.integrate_sde_steered(
            tw, two, 0.0, 1.0, 5.0, 100, pre_steps=1, X0=[1.0, 0.0], **kw),
        "remd_betas": lambda: lib.integrate_sde_remd(tw, [1.0], 10, **kw),
        "remd_negative": lambda: lib.integrate_sde_remd(
            tw, [1.0, -2.0], 10, **kw),
        "remd_steps": lambda: lib.integrate_sde_remd(tw, [1.0, 2.0], 0, **kw),
        "remd_exchange": lambda: lib.integrate_sde_remd(
            tw, [1.0, 2.0], 10, report_interval=10, exchange_interval=15,
            **kw),
        "remd_x0": lambda: lib.integrate_sde_remd(
            tw, [1.0, 2.0], 10, X0=np.zeros((3, 2)), **kw),
        "mbar_nothing": lambda: lib.mbar_weights([np.zeros(3)]),
        "mbar_windows": lambda: lib.mbar_weights(
            [np.zeros(3)], [lambda s: s, lambda s: s]),
        "mbar_shape": lambda: lib.mbar_weights([np.zeros(3)],
                                               u_kn=np.zeros((1, 4))),
        "metad_walkers": lambda: lib.MetadynamicsResult(
            np.zeros((2, 3, 2)), np.zeros((2, 3, 1)), np.zeros((2, 3, 1)),
            np.zeros((2, 3)), 0.1, None, 1.0).bias([0.0]),
        "hills_grid": lambda: lib.metad_frame_weights(
            np.zeros((4, 3)), lib.PlumedHills(
                np.arange(2.0), np.zeros((2, 3)), np.ones((2, 3)),
                np.ones(2), None), frame_times=np.arange(4.0)),
    }


@pytest.mark.parametrize("case", sorted(_errors(jenh, jnp)))
def test_validation_errors_match_jax(case):
    with pytest.raises(ValueError) as jerr:
        _errors(jenh, jnp)[case]()
    with pytest.raises(ValueError) as terr:
        _errors(tenh, torch)[case]()
    assert str(terr.value) == str(jerr.value)


class _TwoRanks:
    """What the samplers read of a 1-axis ``DeviceMesh`` of two ranks
    before any work (``parallel.mesh.mesh_coords``)."""

    mesh_dim_names = ("data",)

    def __init__(self, device_type="cpu"):
        self.device_type = device_type

    def get_local_rank(self):
        return 0

    def size(self):
        return 2

    def get_group(self):
        return None


def _odd_counts(lib, xp, mesh, **kw):
    """Each sampler with three walkers, windows, pulls or slots."""
    tw, ang = triple_well(xp), angle(xp)
    kw = dict(kw, mesh=mesh, verbose=False)
    return (
        lambda: lib.integrate_sde_metadynamics(tw, ang, 20,
                                               deposit_interval=10,
                                               n_chains=3, **kw),
        lambda: lib.integrate_sde_umbrella(tw, ang, [0.0, 0.5, 1.0], 5.0, 10,
                                           **kw),
        lambda: lib.integrate_sde_steered(tw, ang, 0.0, 1.0, 5.0, 100,
                                          n_realizations=3, pre_steps=1,
                                          **kw),
        lambda: lib.integrate_sde_remd(tw, [1.0, 2.0, 3.0], 10, **kw),
    )


def test_mesh_is_roadmap_item_14b():
    """``mesh=`` (ROADMAP item 14b, done): a count that does not divide over
    the mesh's ranks raises the JAX package's ``ValueError`` word for word
    before any work, and so does a mesh over other devices than the
    call's. Meshed runs are held against JAX in
    ``tests/test_torch_mesh_samplers.py``."""
    import jax
    from jax.sharding import Mesh

    jmesh = Mesh(jax.devices()[:2], ("data",))
    for jcall, tcall in zip(_odd_counts(jenh, jnp, jmesh),
                            _odd_counts(tenh, torch, _TwoRanks(),
                                        device="cpu")):
        with pytest.raises(ValueError, match="divisible") as jerr:
            jcall()
        with pytest.raises(ValueError, match="divisible") as terr:
            tcall()
        assert str(terr.value) == str(jerr.value)
    tw, ang = triple_well(torch), angle(torch)
    with pytest.raises(ValueError, match="the mesh is over 'cuda'"):
        tenh.integrate_sde_umbrella(tw, ang, [0.0, 1.0], 5.0, 10,
                                    mesh=_TwoRanks("cuda"), device="cpu")


def test_samplers_refuse_a_numpy_potential():
    class NumpyPot:
        dim, beta = 2, 1.0

        def V(self, x):
            return float(np.sum(np.asarray(x) ** 2))

    with pytest.raises(TypeError, match="potential written in torch"):
        tenh.integrate_sde_remd(NumpyPot(), [1.0, 2.0], 10, device="cpu",
                                verbose=False)


def test_metadynamics_along_an_aligned_cv_matches_jax(jax_noise):
    """The slice as a whole: metadynamics on 15-dimensional states (5 atoms)
    in a harmonic well, biased along a CV of aligned positions with two
    tanh heads. The port's CV runs ``FusedAlignmentLayer`` (on the CPU,
    K2's plain version, no launch); the JAX package's its
    ``AlignmentLayer(method='svd')``, which computes the same alignment."""
    rng = np.random.default_rng(0)
    n = 5
    ref = rng.standard_normal((n, 3)).astype(np.float32)
    idx = list(range(n))
    head = JaxEigenFunctions([3 * n, 6, 1], 2, seed=3)
    params = [{k: np.asarray(v) for k, v in p.items()} for p in head.params]
    jcv = JaxColvarModel(
        JaxPP(JaxAlign(ref, idx, method="svd"),
              JaxFeatureLayer([JaxFeature("p", "position", idx)])), head)
    tcv = port.ColvarModel(
        port.PreprocessingANN(
            port.FusedAlignmentLayer(ref, idx),
            port.FeatureLayer([port.Feature("p", "position", idx)])),
        port.EigenFunctions.from_numpy(params))

    def well(xp):
        class Well:
            dim, beta = 3 * n, 4.0

            def V(self, s):
                return 2.0 * xp.sum((s - xp.asarray(ref.reshape(-1))) ** 2)

        return Well()

    jax_noise("metad", n_chains=2)
    x0 = ref.reshape(-1) + 0.3 * rng.standard_normal((2, 3 * n))
    kw = dict(n_steps=20, deposit_interval=10, step_size=0.01, hill_width=0.2,
              hill_height=2.0, bias_factor=4.0, n_chains=2, seed=5, X0=x0,
              verbose=False)
    jr = jenh.integrate_sde_metadynamics(
        well(jnp), lambda s: jcv(s.reshape(1, n, 3))[0], **kw)
    _cuda.reset_launch_counts()
    tr = tenh.integrate_sde_metadynamics(
        well(torch), lambda s: tcv(s.reshape(-1, n, 3)), device="cpu", **kw)
    assert _cuda.launch_counts()["fused_align"] == 0
    _close(tr.frames, jr.frames, F32_ATOL)
    _close(tr.cv_values, jr.cv_values, LOOSE)
    _close(tr.hill_heights, jr.hill_heights, LOOSE)


def test_metadynamics_crosses_a_double_well_barrier():
    """The port's own draws: along the CV x of V = 2 (x^2 - 1)^2 at beta 5,
    a 10 kT barrier (Kramers: about one crossing in 10^4 time units
    unbiased), one walker crosses under well-tempered metadynamics within
    4,000 steps of 0.005 (20 time units) and comes back."""

    class DoubleWell1D:
        dim, beta = 1, 5.0

        def V(self, x):
            return 2.0 * (x[0] ** 2 - 1.0) ** 2

    res = tenh.integrate_sde_metadynamics(
        DoubleWell1D(), lambda x: x, 4_000, X0=[-1.0], step_size=0.005,
        deposit_interval=40, hill_height=0.3, hill_width=0.15,
        bias_factor=10.0, seed=3, verbose=False, device="cpu")
    x = res.frames[:, 0]
    first = int(np.argmax(x > 0.8))
    assert x[first] > 0.8 and (x[first:] < -0.8).any()
    # hills were deposited in both wells
    assert (res.cv_values[:, 0] > 0.5).any() and res.bias([1.0])[0] > 0.0

"""PyTorch port, the MD branch end to end: Universe -> WeightedTrajectory
against the JAX package's (segment starts from a file list, the weight
filter), concatenate_trajectories and wrap/unwrap, a .gro with two .xtc
files training one epoch of EigenFunctionTask against the JAX task, and the
text, weight-file and reweighting paths with pandas blocked."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from colvarsfinder_tpu.core import EigenFunctionTask as JaxTask
from colvarsfinder_tpu.models import EigenFunctions as JaxEigenFunctions
from colvarsfinder_tpu.ops.alignment import AlignmentLayer as JaxAlign
from colvarsfinder_tpu.ops.features import Feature as JaxFeature
from colvarsfinder_tpu.ops.features import FeatureLayer as JaxFeatureLayer
from colvarsfinder_tpu.ops.features import PreprocessingANN as JaxPP
from colvarsfinder_tpu.utils import io as jio
from colvarsfinder_tpu.utils import trajectory as jtr
from colvarsfinder_tpu.utils import xtc as jxtc

import colvarsfinder_tpu_torch as port
from colvarsfinder_tpu_torch.core.task import train_test_split
from colvarsfinder_tpu_torch.utils import io as tio
from colvarsfinder_tpu_torch.utils import trajectory as ttr

REPO = Path(port.__file__).resolve().parents[1]
NAMES = ["HH31", "CH3", "HH32", "HH33", "C", "O",
         "N", "H", "CA", "HA", "CB", "HB1", "HB2", "HB3", "C", "O",
         "N", "H", "CH3", "HH31", "HH32", "HH33"]
SEGMENT, DT_PS, LAG = 150, 2.0, 2
HEAVY = "type C or type O or type N"


def _md_files(tmp_path):
    """A .gro and a restart chain of two .xtc files of atoms that wander
    as slow AR(1) processes, written by the JAX package."""
    rng = np.random.default_rng(0)
    base = 1.5 + 0.5 * rng.standard_normal((22, 3))
    top = jio.Topology(names=list(NAMES),
                       resids=[1] * 6 + [2] * 10 + [3] * 6,
                       resnames=["ACE"] * 6 + ["ALA"] * 10 + ["NME"] * 6,
                       positions=base.astype(np.float32),
                       box=np.array([4.0, 4.0, 4.0]))
    gro = str(tmp_path / "top.gro")
    jio.write_gro(gro, top)
    noise = np.zeros((2 * SEGMENT, 22, 3))
    for t in range(1, 2 * SEGMENT):
        noise[t] = 0.95 * noise[t - 1] + 0.05 * rng.standard_normal((22, 3))
    x = (base[None] + noise).astype(np.float32)
    paths = [str(tmp_path / f"md_{i}.xtc") for i in range(2)]
    for i, p in enumerate(paths):
        jxtc.write_xtc(p, x[i * SEGMENT:(i + 1) * SEGMENT], dt_ps=DT_PS,
                       t0_ps=i * SEGMENT * DT_PS)
    return gro, paths


def _same_traj(t, j):
    assert t.trajectory.tobytes() == j.trajectory.tobytes()
    assert t.trajectory.shape == j.trajectory.shape
    assert t.weights.tobytes() == j.weights.tobytes()
    assert (t.n_frames, t.dt) == (j.n_frames, j.dt)
    if j.segment_starts is None:
        assert t.segment_starts is None
    else:
        np.testing.assert_array_equal(t.segment_starts, j.segment_starts)
        assert t.segment_starts.dtype == j.segment_starts.dtype
    for lag in (0, LAG, 40):
        np.testing.assert_array_equal(t.valid_lagged_starts(lag),
                                      j.valid_lagged_starts(lag))


@pytest.mark.parametrize("case", ["all atoms", "heavy", "weights filtered",
                                  "one file"])
def test_universe_to_weighted_trajectory_matches_jax(case, tmp_path):
    gro, paths = _md_files(tmp_path)
    files = paths[:1] if case == "one file" else paths
    out = []
    for io, tr in ((tio, ttr), (jio, jtr)):
        u = io.Universe(gro, files)
        kw = dict(verbose=False)
        if case != "all atoms":
            kw["input_ag"] = u.select_atoms(HEAVY)
        if case == "weights filtered":
            w = np.random.default_rng(1).uniform(0.0, 2.0, 2 * SEGMENT)
            kw.update(weights=w, min_w=0.2, max_w=1.9)
        out.append(tr.WeightedTrajectory(universe=u, **kw))
    _same_traj(*out)
    if case == "heavy":
        np.testing.assert_array_equal(out[0].segment_starts, [0, SEGMENT])
        assert out[0].trajectory.shape == (2 * SEGMENT, 10, 3)
        assert out[0].dt == DT_PS * 1e-3


def test_concatenate_and_wrap_match_jax():
    rng = np.random.default_rng(2)
    pieces = [(rng.standard_normal((n, 4, 3)).astype(np.float32),
               rng.uniform(0.5, 1.5, n), seg) for n, seg in
              ((30, None), (20, [0, 7]), (25, None))]
    for renormalize in (True, False):
        out = []
        for tr in (ttr, jtr):
            trajs = [tr.WeightedTrajectory(trajectory=x, weights=w, dt=0.1,
                                           segment_starts=seg, verbose=False)
                     for x, w, seg in pieces]
            out.append(tr.concatenate_trajectories(trajs,
                                                   renormalize=renormalize))
        _same_traj(*out)
    np.testing.assert_array_equal(out[0].segment_starts, [0, 30, 37, 50])
    for tr in (ttr, jtr):
        a = tr.WeightedTrajectory(trajectory=pieces[0][0], verbose=False)
        b = tr.WeightedTrajectory(trajectory=pieces[1][0], dt=0.2,
                                  verbose=False)
        with pytest.raises(ValueError, match="dt differs"):
            tr.concatenate_trajectories([a, b])
        with pytest.raises(ValueError, match="at least one"):
            tr.concatenate_trajectories([])
    box = np.array([1.5, 2.0, 2.5])
    walk = np.cumsum(0.2 * rng.standard_normal((40, 5, 3)), axis=0)
    for dtype in (np.float32, np.float64):
        wrapped = ttr.wrap_trajectory(walk.astype(dtype), box)
        assert wrapped.tobytes() == jtr.wrap_trajectory(
            walk.astype(dtype), box).tobytes()
        unwrapped = ttr.unwrap_trajectory(wrapped, box)
        assert unwrapped.tobytes() == jtr.unwrap_trajectory(
            wrapped, box).tobytes()
        np.testing.assert_allclose(unwrapped - unwrapped[:1],
                                   walk - walk[:1], atol=1e-5)
    with pytest.raises(ValueError, match="box"):
        ttr.unwrap_trajectory(wrapped, [1.0, 0.0, 1.0])


def test_gro_and_two_xtc_train_one_epoch_like_jax(tmp_path):
    """The reference workflow, Universe(gro, [xtc, xtc]) -> heavy atoms ->
    WeightedTrajectory -> EigenFunctionTask, one epoch on both packages
    from the same parameters and split."""
    gro, paths = _md_files(tmp_path)
    common = dict(alpha=8.0, eig_weights=[1.0, 0.5], lag_tau=LAG * DT_PS *
                  1e-3, k=2, learning_rate=0.005, batch_size=100,
                  num_epochs=1, test_ratio=0.2, verbose=False,
                  tensorboard=False, seed=0, debug_mode=False,
                  save_model_every_step=0)
    jm = JaxEigenFunctions([30, 10, 10, 1], 2, seed=3)
    params = [{n: np.asarray(v) for n, v in p.items()} for p in jm.params]
    ju = jio.Universe(gro, paths)
    jsel = ju.select_atoms(HEAVY)
    jtraj = jtr.WeightedTrajectory(universe=ju, input_ag=jsel, verbose=False)
    split = train_test_split(jtraj.valid_lagged_starts(LAG), 0.2, 0)
    jpp = JaxPP(JaxAlign(jsel.positions, list(range(10))),
                JaxFeatureLayer([JaxFeature("p", "position",
                                            list(range(10)))]))
    jtask = JaxTask(jtraj, jpp, jm, str(tmp_path / "jax"),
                    split_indices=split, export_cv=False, **common)
    jtask.train()

    tu = port.utils.Universe(gro, paths)
    tsel = tu.select_atoms(HEAVY)
    ttraj = port.WeightedTrajectory(universe=tu, input_ag=tsel,
                                    verbose=False)
    tpp = port.PreprocessingANN(
        port.AlignmentLayer(tsel.positions, list(range(10))),
        port.FeatureLayer([port.Feature("p", "position", list(range(10)))]))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        task = port.EigenFunctionTask(
            ttraj, tpp, port.EigenFunctions.from_numpy(params),
            str(tmp_path / "port"), device="cpu", split_indices=split,
            **common)
        task.train()
    finally:
        torch.set_num_threads(n)
    # the eigenfunction parity tests' bar for the plain step
    # (tests/test_torch_eigenfunction_task.py): float32 rounding only
    for got, want in ((task.train_loss, jtask.train_loss_df.to_numpy()),
                      (task.test_loss, jtask.test_loss_df.to_numpy())):
        assert got.shape == want.shape == (1, 5)
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-4)
        np.testing.assert_allclose(got[:, 3:], want[:, 3:], rtol=1e-4)
    np.testing.assert_array_equal(task._cvec, jtask._cvec)


# the port's text, weight and reweighting paths in a process where pandas
# cannot be imported, once through the native reader and once through the
# numpy fallback
_NO_PANDAS = """
import json, sys
sys.modules["pandas"] = None
import numpy as np
from colvarsfinder_tpu_torch.utils import native_io
from colvarsfinder_tpu_torch.utils import trajectory as ttr

d = sys.argv[1]
if sys.argv[2] == "numpy":
    native_io.load_time_series = lambda *a, **k: None
else:
    assert native_io.available()
w = ttr.calc_weights(d + "/stats.csv", 1.0, 1.5, d + "/w_port.txt",
                     energy_col_idx=2, verbose=False)
t = ttr.WeightedTrajectory(traj_filename=d + "/traj.txt",
                           weight_filename=d + "/w_port.txt", max_w=2.0,
                           verbose=False)
np.savez(d + "/port.npz", w=w, traj=t.trajectory, weights=t.weights,
         dt=t.dt, n=t.n_frames)
print(json.dumps(sorted(m for m, mod in sys.modules.items()
                        if m.split(".")[0] == "pandas" and mod is not None)))
"""


@pytest.mark.parametrize("reader", ["native", "numpy"])
def test_text_weights_and_calc_weights_without_pandas(reader, tmp_path):
    rng = np.random.default_rng(3)
    n = 60
    data = np.column_stack([np.arange(n) * 0.25,
                            rng.standard_normal((n, 3)) * 10.0])
    np.savetxt(tmp_path / "traj.txt", data)
    energy = rng.standard_normal(n) * 30.0
    # an OpenMM StateDataReporter-like CSV, every number at full precision
    (tmp_path / "stats.csv").write_text(
        '#"Step","Time (ps)","Potential Energy (kJ/mole)"\n' + "".join(
            f"{i},{i * 0.25!r},{float(e)!r}\n" for i, e in enumerate(energy)))
    out = subprocess.run([sys.executable, "-c", _NO_PANDAS, str(tmp_path),
                          reader], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == []
    got = np.load(tmp_path / "port.npz")
    w = jtr.calc_weights(str(tmp_path / "stats.csv"), 1.0, 1.5,
                         str(tmp_path / "w_jax.txt"), energy_col_idx=2,
                         verbose=False)
    assert (tmp_path / "w_port.txt").read_bytes() == (
        tmp_path / "w_jax.txt").read_bytes()
    assert got["w"].tobytes() == w.tobytes()
    j = jtr.WeightedTrajectory(traj_filename=str(tmp_path / "traj.txt"),
                               weight_filename=str(tmp_path / "w_jax.txt"),
                               max_w=2.0, verbose=False)
    assert got["traj"].tobytes() == j.trajectory.tobytes()
    assert (float(got["dt"]), int(got["n"])) == (j.dt, j.n_frames)
    # the weight file's numbers parsed to the nearest double; the JAX
    # package reads them through pandas, whose parser may land one ulp away
    np.testing.assert_allclose(got["weights"], j.weights, rtol=1e-15)

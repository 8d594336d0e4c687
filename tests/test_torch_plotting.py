"""PyTorch port, ``plotting`` (matplotlib, Agg): each of the eleven figure
functions draws the same data as the JAX package's on the same inputs
(every line's, collection's and bar's coordinates equal, the same labels
and scales); a port task's loss curves are read from its arrays, equal to
the JAX package's figure of the same numbers as a dataframe; a torch CV's
contour equals the numpy CV's; and a port task plots in a process where
pandas cannot be imported."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

mpl = pytest.importorskip("matplotlib")
mpl.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import pandas as pd  # noqa: E402

from colvarsfinder_tpu import analysis as jan  # noqa: E402
from colvarsfinder_tpu import plotting as jplot  # noqa: E402
from colvarsfinder_tpu.utils.enhanced import SteeredResult  # noqa: E402

import colvarsfinder_tpu_torch as port  # noqa: E402
from colvarsfinder_tpu_torch import plotting as tplot  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _close_figs():
    yield
    plt.close("all")


def _drawn(ax):
    """The data an axes draws: lines, collections, bars, labels, scales."""
    out = {"xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
           "title": ax.get_title(), "yscale": ax.get_yscale(),
           "lines": [(np.asarray(ln.get_xdata(), float),
                      np.asarray(ln.get_ydata(), float), ln.get_label(),
                      ln.get_linestyle(), ln.get_color())
                     for ln in ax.get_lines()],
           "bars": [(p.get_x(), p.get_y(), p.get_width(), p.get_height(),
                     p.get_label()) for p in ax.patches],
           "yticklabels": [t.get_text() for t in ax.get_yticklabels()],
           "collections": []}
    for c in ax.collections:
        arr = c.get_array()
        paths = [p.vertices for p in c.get_paths()]
        out["collections"].append(
            (np.asarray(c.get_offsets(), float),
             None if arr is None else np.ma.filled(np.asarray(arr, float),
                                                   np.nan),
             [np.asarray(v, float) for v in paths]))
    legend = ax.get_legend()
    out["legend"] = (None if legend is None
                     else [t.get_text() for t in legend.get_texts()])
    return out


def _same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _both(fn_name, *args, **kw):
    """Draw with each package's function; the drawn data must be equal."""
    ja = getattr(jplot, fn_name)(*args, **kw)
    ta = getattr(tplot, fn_name)(*args, **kw)
    if isinstance(ja, np.ndarray):  # plot_msm_ck's grid of axes
        for x, y in zip(ja.ravel(), ta.ravel()):
            _same(_drawn(x), _drawn(y))
    else:
        _same(_drawn(ja), _drawn(ta))
        assert len(ja.figure.axes) == len(ta.figure.axes)  # colorbars
    return ta


def _ar1(n, rho, k=1, seed=0):
    rng = np.random.default_rng(seed)
    x = np.zeros((n, k))
    for t in range(1, n):
        x[t] = rho * x[t - 1] + rng.normal(0, 1, k)
    return x


def _loss_df(n=20, cols=("loss", "eig_1", "eig_2")):
    rng = np.random.default_rng(0)
    data = {"epoch": np.arange(n)}
    for c in cols:
        data[c] = np.exp(-0.1 * np.arange(n)) + 0.05 * rng.random(n)
    return pd.DataFrame(data)


def _steered():
    M, T = 6, 20
    rng = np.random.default_rng(8)
    sched = np.linspace(0.0, 1.0, T)[:, None]
    return SteeredResult(
        frames=rng.standard_normal((M, T, 2)),
        cv_values=sched[None].repeat(M, axis=0),
        works=np.cumsum(np.abs(rng.standard_normal((M, T))) * 0.05, axis=1),
        schedule=sched, kappa=50.0, beta=1.0, dt=0.1)


def _sens():
    rng = np.random.default_rng(5)
    W = rng.standard_normal((2, 6))
    return jan.cv_sensitivity(lambda x: x @ W.T, rng.standard_normal((500, 6)))


def _numpy_cv(pts):
    return np.stack([pts[:, 0] ** 2 + pts[:, 1], pts[:, 1]], axis=1)


FIGURES = {
    "plot_loss_curves": lambda: (
        (_loss_df(), _loss_df()), dict(columns=("loss", "eig_1"), log=True)),
    "plot_eigenvalues": lambda: ((_loss_df(),), dict(k=2)),
    "plot_cv_contour": lambda: (
        (_numpy_cv, (-2, 2), (-2, 2)),
        dict(cv_index=1, n_grid=24,
             trajectory=np.random.default_rng(1).normal(0, 1, (200, 2)))),
    "plot_cv_scatter": lambda: (
        tuple(np.random.default_rng(2).uniform(-3, 3, (2, 300)))
        + (np.cos(np.linspace(0, 9, 300)),), {}),
    "plot_free_energy": lambda: (
        jan.free_energy_profile(np.random.default_rng(3).normal(0, 1, 5000),
                                bins=30, n_bootstrap=8, block_frames=50), {}),
    "plot_ck_test": lambda: ((jan.ck_test(_ar1(4000, 0.95, 2), lag=5,
                                          n_multiples=3),), {}),
    "plot_timescales": lambda: (
        ([1, 2, 5, 10],) + jan.timescales_vs_lag_bootstrap(
            _ar1(8000, 0.96, seed=7), [1, 2, 5, 10], dt=0.5, n_bootstrap=12,
            seed=0)[:1],
        dict(dt=0.5, t_lo=np.ones((4, 1)), t_hi=np.full((4, 1), 40.0))),
    "plot_msm_ck": lambda: ((jan.msm_ck_test(
        (np.random.default_rng(9).uniform(size=3000) < 0.5).astype(np.int64),
        lag=1, n_sets=2, n_multiples=3),), {}),
    "plot_cv_sensitivity": lambda: ((_sens(),), dict(top_n=4)),
    "plot_committor_check": lambda: ((jan.CommittorCheck(
        np.linspace(0.05, 0.95, 10), np.linspace(0.05, 0.95, 10) + 0.02,
        np.full(10, 20.0)),), {}),
    "plot_steered_work": lambda: ((_steered(),), {}),
}


def test_every_figure_is_ported():
    assert sorted(tplot.__all__) == sorted(jplot.__all__)
    assert sorted(n for n in tplot.__all__ if n.startswith("plot_")) == \
        sorted(FIGURES)
    assert tplot.CATEGORICAL_COLORS == jplot.CATEGORICAL_COLORS


@pytest.mark.parametrize("name", sorted(FIGURES))
def test_figures_draw_the_same_data(name):
    args, kw = FIGURES[name]()
    _both(name, *args, **kw)


def test_free_energy_surface_and_sensitivity_subset():
    s = np.random.default_rng(4).normal(0, 1, (5000, 2))
    _both("plot_free_energy", *jan.free_energy_profile(s, bins=20))
    _both("plot_cv_sensitivity", _sens(), cv_idx=np.int64(1))


def _trained_task(tmp_path, device="cpu"):
    x = np.random.default_rng(0).standard_normal((400, 2)).astype(np.float32)
    traj = port.WeightedTrajectory(trajectory=x, dt=0.1, verbose=False)
    task = port.EigenFunctionTask(
        traj, None, port.EigenFunctions([2, 6, 1], 2, seed=0), str(tmp_path),
        alpha=10.0, eig_weights=[1.0, 0.5], lag_tau=0.1, k=2,
        batch_size=100, num_epochs=3, save_model_every_step=0,
        verbose=False, tensorboard=False, device=device)
    task.train()
    return task


def test_port_task_loss_curves_from_arrays(tmp_path):
    """A port task's arrays draw what the JAX package draws from the same
    numbers as dataframes."""
    task = _trained_task(tmp_path)
    train = pd.DataFrame(task.train_loss, columns=task.loss_names)
    test = pd.DataFrame(task.test_loss, columns=task.loss_names)
    cols = ("loss", "eig_1")
    _same(_drawn(tplot.plot_loss_curves(task, columns=cols)),
          _drawn(jplot.plot_loss_curves(train, test, columns=cols)))
    _same(_drawn(tplot.plot_eigenvalues(task)),
          _drawn(jplot.plot_eigenvalues(train)))
    # a dataframe still works
    _same(_drawn(tplot.plot_loss_curves(train, test)),
          _drawn(jplot.plot_loss_curves(train, test)))


def test_torch_cv_contour_equals_numpy_cv(tmp_path):
    """The contour of a torch CV, evaluated on its device through the
    analysis module's reader, equals the contour of its numpy values."""
    cv = _trained_task(tmp_path).colvar_model()

    def numpy_cv(pts):
        with torch.no_grad():
            return cv(torch.from_numpy(pts)).numpy()

    kw = dict(cv_index=1, n_grid=16)
    _same(_drawn(tplot.plot_cv_contour(cv, (-2, 2), (-1, 1), **kw)),
          _drawn(jplot.plot_cv_contour(numpy_cv, (-2, 2), (-1, 1), **kw)))


_NO_PANDAS = """
import json, sys
sys.modules["pandas"] = None
import matplotlib
matplotlib.use("Agg")
import numpy as np
import colvarsfinder_tpu_torch as port
from colvarsfinder_tpu_torch import plotting

x = np.random.default_rng(0).standard_normal((400, 2)).astype(np.float32)
traj = port.WeightedTrajectory(trajectory=x, dt=0.1, verbose=False)
task = port.EigenFunctionTask(
    traj, None, port.EigenFunctions([2, 6, 1], 2, seed=0), sys.argv[1],
    alpha=10.0, eig_weights=[1.0, 0.5], lag_tau=0.1, k=2, batch_size=100,
    num_epochs=3, save_model_every_step=0, verbose=False, tensorboard=False,
    device="cpu")
task.train()
ax = plotting.plot_loss_curves(task, columns=("loss", "eig_1"))
assert len(ax.get_lines()) == 4
assert len(plotting.plot_eigenvalues(task).get_lines()) == 2
plotting.plot_cv_contour(task.colvar_model(), (-2, 2), (-2, 2), n_grid=8)
print(json.dumps(sorted(m for m, mod in sys.modules.items()
                        if m.split(".")[0] == "pandas" and mod is not None)))
"""


def test_port_task_plots_without_pandas(tmp_path):
    out = subprocess.run([sys.executable, "-c", _NO_PANDAS, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []

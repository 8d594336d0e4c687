r"""Publication-style matplotlib helpers for the CV-discovery workflow (port
of ``colvarsfinder_tpu/plotting.py``, copied but for the two readers below).

The reference judges training runs visually — CV contours over the 2D
potential (reference: examples/2d/2d.ipynb cell 14), CV-colored
Ramachandran scatters (examples/dipeptide/main.ipynb cell 21), and loss
curves from the task dataframes — but leaves every figure to ad-hoc
notebook code. This module packages those figures, plus plots for the
:mod:`colvarsfinder_tpu_torch.analysis` validation battery (free-energy
profiles, Chapman–Kolmogorov panels, implied-timescale convergence), as
one-call helpers with consistent, colorblind-safe styling.

Conventions:

* every function takes ``ax=None`` (a new figure is created when omitted)
  and returns the matplotlib ``Axes``;
* categorical series use the Okabe–Ito palette in fixed order (the
  standard CVD-safe scientific set); magnitude fields use a single
  perceptually-uniform sequential colormap (viridis);
* matplotlib is imported lazily — the rest of the package works without
  it, and these helpers raise a clear error when it is missing.

Everything here is host-side numpy; CV callables (``task.colvar_model()``
or a :func:`~colvarsfinder_tpu_torch.deploy.load_numpy_cv` deployment artifact)
are evaluated once per figure.

A port task's loss curves are read from its arrays (``task.train_loss``,
``task.test_loss``, ``task.loss_names``), not from ``train_loss_df``, which
needs pandas; a dataframe passed in still works. A torch CV is evaluated on
its device through the analysis module's reader (``analysis._cv_on_numpy``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from .analysis import _cv_on_numpy

__all__ = [
    "CATEGORICAL_COLORS",
    "SEQUENTIAL_CMAP",
    "plot_loss_curves",
    "plot_eigenvalues",
    "plot_cv_contour",
    "plot_cv_scatter",
    "plot_free_energy",
    "plot_ck_test",
    "plot_cv_sensitivity",
    "plot_committor_check",
    "plot_msm_ck",
    "plot_steered_work",
    "plot_timescales",
]

#: Okabe–Ito colorblind-safe palette, assigned to series in this fixed
#: order (never cycled past the end — fold extra series before that).
CATEGORICAL_COLORS: Tuple[str, ...] = (
    "#0072B2",  # blue
    "#E69F00",  # orange
    "#009E73",  # green
    "#D55E00",  # vermillion
    "#CC79A7",  # purple
    "#56B4E9",  # sky blue
    "#F0E442",  # yellow
    "#000000",  # black
)

#: Single perceptually-uniform sequential colormap for magnitude fields.
SEQUENTIAL_CMAP = "viridis"

_GRID_KW = dict(alpha=0.25, linewidth=0.6)


def _require_mpl():
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:  # pragma: no cover - environment-dependent
        raise ImportError(
            "colvarsfinder_tpu_torch.plotting requires matplotlib "
            "(pip install matplotlib)"
        ) from e
    return plt


def _new_ax(ax):
    plt = _require_mpl()
    if ax is None:
        _fig, ax = plt.subplots(figsize=(5.2, 3.6), constrained_layout=True)
    return ax


def _style(ax):
    ax.grid(True, **_GRID_KW)
    ax.set_axisbelow(True)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    return ax


def _color(i: int) -> str:
    return CATEGORICAL_COLORS[i % len(CATEGORICAL_COLORS)]


class _LossTable(dict):
    """A task's per-epoch metric rows ``[epochs, len(names)]`` as columns by
    name, read as the plots read a dataframe: ``col in t``, ``t[col]``,
    ``t.columns`` and ``len(t)`` (the number of epochs)."""

    def __init__(self, names, rows):
        rows = np.asarray(rows)
        super().__init__({name: rows[:, i] for i, name in enumerate(names)})
        self.columns = list(names)
        self.n_rows = rows.shape[0]

    def __len__(self):
        return self.n_rows


def _loss_frames(task_or_df, test_df):
    """Accept a trained task, a dataframe, or (train_df, test_df). A port
    task's loss arrays are read without pandas."""
    if hasattr(task_or_df, "loss_names") and hasattr(task_or_df,
                                                     "train_loss"):
        test = getattr(task_or_df, "test_loss", None)
        return (_LossTable(task_or_df.loss_names, task_or_df.train_loss),
                None if test is None
                else _LossTable(task_or_df.loss_names, test))
    if hasattr(task_or_df, "train_loss_df"):
        return task_or_df.train_loss_df, getattr(
            task_or_df, "test_loss_df", None
        )
    return task_or_df, test_df


def plot_loss_curves(
    task_or_df,
    test_df=None,
    columns: Sequence[str] = ("loss",),
    log: bool = False,
    ax=None,
):
    """Train/test loss curves from the task's loss dataframes.

    Args:
        task_or_df: a trained task (``train_loss_df``/``test_loss_df``
            attributes) or the train dataframe itself.
        test_df: the test dataframe when ``task_or_df`` is a dataframe.
        columns: dataframe columns to draw (one hue each; train solid,
            test dashed).
        log: log-scale the y axis.
        ax: target axes (new figure when omitted).
    """
    train, test = _loss_frames(task_or_df, test_df)
    ax = _new_ax(ax)
    for i, col in enumerate(columns):
        c = _color(i)
        epochs = np.asarray(train["epoch"]) if "epoch" in train else np.arange(
            len(train)
        )
        ax.plot(epochs, np.asarray(train[col]), color=c, linewidth=1.8,
                label=f"{col} (train)")
        if test is not None and col in test:
            te = np.asarray(test["epoch"]) if "epoch" in test else np.arange(
                len(test)
            )
            ax.plot(te, np.asarray(test[col]), color=c, linewidth=1.4,
                    linestyle="--", label=f"{col} (test)")
    if log:
        ax.set_yscale("log")
    ax.set_xlabel("epoch")
    ax.set_ylabel(columns[0] if len(columns) == 1 else "value")
    ax.legend(frameon=False, fontsize=8)
    return _style(ax)


def plot_eigenvalues(task_or_df, test_df=None, k: Optional[int] = None, ax=None):
    """Per-epoch eigenvalue (rate) estimates ``eig_1..k`` from an
    eigenfunction/RegAE task's loss dataframe — all heads share a unit
    (1/time), so one axis carries them."""
    train, _test = _loss_frames(task_or_df, test_df)
    cols = [c for c in train.columns if c.startswith("eig_")]
    if k is not None:
        cols = cols[:k]
    if not cols:
        raise ValueError("no eig_* columns in the loss dataframe")
    ax = _new_ax(ax)
    epochs = np.asarray(train["epoch"]) if "epoch" in train else np.arange(
        len(train)
    )
    for i, col in enumerate(cols):
        ax.plot(epochs, np.asarray(train[col]), color=_color(i),
                linewidth=1.8, label=col)
    ax.set_xlabel("epoch")
    ax.set_ylabel("eigenvalue estimate (rate)")
    ax.legend(frameon=False, fontsize=8)
    return _style(ax)


def _eval_cv(cv_fn: Callable, points: np.ndarray) -> np.ndarray:
    out = _cv_on_numpy(cv_fn, points)
    return out.reshape(len(points), -1)


def plot_cv_contour(
    cv_fn: Callable,
    xlim: Tuple[float, float],
    ylim: Tuple[float, float],
    cv_index: int = 0,
    n_grid: int = 100,
    trajectory: Optional[np.ndarray] = None,
    levels: int = 24,
    ax=None,
):
    """Learned CV as a filled contour over a 2D input domain (the
    reference's 2d-example diagnostic, 2d.ipynb cell 14).

    Args:
        cv_fn: callable mapping ``[m, 2]`` points to ``[m, k]`` (or
            ``[m]``) CV values — ``task.colvar_model()`` or a deployed
            evaluator.
        xlim / ylim: domain to rasterize.
        cv_index: which CV column to draw.
        n_grid: grid resolution per axis.
        trajectory: optional ``[n, 2]`` samples scattered (in neutral
            gray) over the contour to show data support.
        levels: contour level count.
    """
    ax = _new_ax(ax)
    plt = _require_mpl()
    xs = np.linspace(xlim[0], xlim[1], n_grid)
    ys = np.linspace(ylim[0], ylim[1], n_grid)
    XX, YY = np.meshgrid(xs, ys)
    pts = np.stack([XX.ravel(), YY.ravel()], axis=1).astype(np.float32)
    Z = _eval_cv(cv_fn, pts)[:, cv_index].reshape(n_grid, n_grid)
    m = ax.contourf(XX, YY, Z, levels=levels, cmap=SEQUENTIAL_CMAP)
    if trajectory is not None:
        tr = np.asarray(trajectory)
        ax.scatter(tr[:, 0], tr[:, 1], s=2, c="#555555", alpha=0.25,
                   linewidths=0, rasterized=True)
    plt.colorbar(m, ax=ax, label=f"CV {cv_index + 1}")
    ax.set_xlabel("$x_1$")
    ax.set_ylabel("$x_2$")
    return ax


def plot_cv_scatter(
    x,
    y,
    cv_values,
    xlabel: str = "$\\phi$",
    ylabel: str = "$\\psi$",
    ax=None,
):
    """Scatter of two physical coordinates colored by the learned CV —
    the Ramachandran-style check of the dipeptide workflow
    (main.ipynb cell 21: :math:`(\\phi, \\psi)` colored by CV 1)."""
    ax = _new_ax(ax)
    plt = _require_mpl()
    cv = np.asarray(cv_values).reshape(len(np.asarray(x)), -1)[:, 0]
    m = ax.scatter(np.asarray(x), np.asarray(y), c=cv, s=4,
                   cmap=SEQUENTIAL_CMAP, linewidths=0, rasterized=True)
    plt.colorbar(m, ax=ax, label="CV")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    return _style(ax)


def plot_free_energy(
    centers,
    F,
    F_err=None,
    unit: str = "$k_B T$",
    ax=None,
):
    """Free-energy profile/surface from
    :func:`colvarsfinder_tpu_torch.analysis.free_energy_profile` — accepts its
    return tuple directly: ``plot_free_energy(*free_energy_profile(...))``.

    1D profiles draw a line with a shaded ±err band; 2D surfaces draw a
    masked pcolormesh with a colorbar.
    """
    ax = _new_ax(ax)
    plt = _require_mpl()
    F = np.asarray(F)
    if F.ndim == 1:
        c = np.asarray(centers)
        finite = np.isfinite(F)
        col = _color(0)
        ax.plot(c[finite], F[finite], color=col, linewidth=1.8)
        if F_err is not None:
            err = np.asarray(F_err)
            band = finite & np.isfinite(err)
            ax.fill_between(
                c[band], (F - err)[band], (F + err)[band],
                color=col, alpha=0.22, linewidth=0,
            )
        ax.set_xlabel("CV")
        ax.set_ylabel(f"$F$ [{unit}]")
        return _style(ax)
    xc, yc = centers
    Fm = np.ma.masked_invalid(F)
    m = ax.pcolormesh(
        np.asarray(xc), np.asarray(yc), Fm.T, cmap=SEQUENTIAL_CMAP,
        shading="nearest",
    )
    plt.colorbar(m, ax=ax, label=f"$F$ [{unit}]")
    ax.set_xlabel("CV 1")
    ax.set_ylabel("CV 2")
    return ax


def plot_ck_test(ck, ax=None):
    """Chapman–Kolmogorov panel from
    :func:`colvarsfinder_tpu_torch.analysis.ck_test`: per CV head, the
    estimated autocorrelation at lag multiples (solid, markers) against
    the Markovian prediction :math:`\\rho(\\tau)^i` (dashed)."""
    ax = _new_ax(ax)
    lags = np.asarray(ck.lags)
    est = np.atleast_2d(np.asarray(ck.estimated))
    pred = np.atleast_2d(np.asarray(ck.predicted))
    for h in range(est.shape[1]):
        c = _color(h)
        ax.plot(lags, est[:, h], color=c, linewidth=1.8, marker="o",
                markersize=4, label=f"head {h + 1} estimated")
        ax.plot(lags, pred[:, h], color=c, linewidth=1.4, linestyle="--",
                label=f"head {h + 1} predicted")
    ax.set_xlabel("lag (frames)")
    ax.set_ylabel("autocorrelation")
    ax.legend(frameon=False, fontsize=8)
    return _style(ax)


def plot_timescales(
    lags, timescales, dt: float = 1.0, t_lo=None, t_hi=None, ax=None
):
    """Implied-timescale convergence plot from
    :func:`colvarsfinder_tpu_torch.analysis.timescales_vs_lag`: one curve per
    head on a log time axis, with the unresolvable region
    :math:`t < \\mathrm{lag}` shaded — curves must plateau above it.

    Args:
        lags: integer frame lags the timescales were evaluated at.
        timescales: ``[len(lags), k]`` (physical units).
        dt: physical time per frame, to place the shaded region.
        t_lo / t_hi: optional per-head confidence bounds of the same
            shape (e.g. from
            :func:`colvarsfinder_tpu_torch.analysis.timescales_vs_lag_bootstrap`)
            drawn as shaded bands.
    """
    ax = _new_ax(ax)
    lags = np.asarray(lags, dtype=np.float64)
    ts = np.atleast_2d(np.asarray(timescales, dtype=np.float64))
    if ts.shape[0] != len(lags):
        ts = ts.T
    phys = lags * float(dt)
    lo = hi = None
    if t_lo is not None and t_hi is not None:
        lo = np.atleast_2d(np.asarray(t_lo, dtype=np.float64))
        hi = np.atleast_2d(np.asarray(t_hi, dtype=np.float64))
        if lo.shape[0] != len(lags):
            lo, hi = lo.T, hi.T
    for h in range(ts.shape[1]):
        good = np.isfinite(ts[:, h])
        ax.plot(phys[good], ts[good, h], color=_color(h), linewidth=1.8,
                marker="o", markersize=4, label=f"head {h + 1}")
        if lo is not None:
            band = good & np.isfinite(lo[:, h]) & np.isfinite(hi[:, h])
            ax.fill_between(phys[band], lo[band, h], hi[band, h],
                            color=_color(h), alpha=0.2, linewidth=0)
    ax.fill_between(phys, 0, phys, color="#888888", alpha=0.25,
                    linewidth=0)
    ax.set_yscale("log")
    ax.set_xlabel("lag time")
    ax.set_ylabel("implied timescale")
    ax.legend(frameon=False, fontsize=8)
    return _style(ax)


def plot_msm_ck(result, axes=None):
    """Set-level Chapman–Kolmogorov panel grid from
    :func:`colvarsfinder_tpu_torch.analysis.msm_ck_test`: one subplot per
    (from-set, to-set) pair, estimated (solid, markers) against the
    tau-model prediction (dashed).

    Args:
        result: an ``MSMCKResult``.
        axes: optional ``[n, n]`` array of axes (a new figure grid is
            created when omitted).

    Returns:
        the ``[n, n]`` array of axes.
    """
    plt = _require_mpl()
    n = result.n_sets
    if axes is None:
        _fig, axes = plt.subplots(
            n, n, figsize=(2.6 * n, 2.2 * n), sharex=True, sharey=True,
            constrained_layout=True, squeeze=False,
        )
    axes = np.asarray(axes).reshape(n, n)
    lags = np.asarray(result.lags)
    for i in range(n):
        for j in range(n):
            ax = axes[i, j]
            c = _color(0)
            ax.plot(lags, result.estimated[:, i, j], color=c,
                    linewidth=1.8, marker="o", markersize=4,
                    label="estimated")
            ax.plot(lags, result.predicted[:, i, j], color=c,
                    linewidth=1.4, linestyle="--", label="predicted")
            ax.set_title(f"{i + 1} → {j + 1}", fontsize=9)
            _style(ax)
            if i == n - 1:
                ax.set_xlabel("lag (frames)")
            if j == 0:
                ax.set_ylabel("probability")
    axes[0, 0].legend(frameon=False, fontsize=8)
    return axes


def plot_cv_sensitivity(result, cv_idx=None, top_n: int = 20, ax=None):
    """Horizontal bar chart of input importances from
    :func:`colvarsfinder_tpu_torch.analysis.cv_sensitivity`: the ``top_n``
    inputs by total relative importance, one bar group per CV component.

    Args:
        result: a :class:`~colvarsfinder_tpu_torch.analysis.SensitivityResult`.
        cv_idx: int or list of CV components to show (default: all).
        top_n: keep only the strongest inputs (by summed relative
            importance across the shown components).
        ax: existing axes (optional).
    """
    ax = _new_ax(ax)
    rel = np.atleast_2d(np.asarray(result.relative))
    if cv_idx is not None:
        idx = [int(cv_idx)] if np.ndim(cv_idx) == 0 else list(cv_idx)
        rel = rel[idx]
        names = [f"CV {i + 1}" for i in idx]
    else:
        names = [f"CV {i + 1}" for i in range(rel.shape[0])]
    order = np.argsort(rel.sum(axis=0))[::-1][:top_n][::-1]
    y = np.arange(len(order), dtype=float)
    h = 0.8 / rel.shape[0]
    for i in range(rel.shape[0]):
        ax.barh(
            y + (i - (rel.shape[0] - 1) / 2) * h,
            rel[i, order],
            height=h,
            color=_color(i),
            label=names[i],
        )
    ax.set_yticks(y)
    ax.set_yticklabels([result.labels[j] for j in order], fontsize=8)
    ax.set_xlabel("relative importance")
    ax.legend(frameon=False, fontsize=8)
    return _style(ax)


def plot_committor_check(chk, ax=None):
    """Committor self-consistency panel from
    :func:`colvarsfinder_tpu_torch.analysis.committor_self_consistency`: the
    MSM-estimated committor of each predicted-q bin against the model's
    own labels — points on the diagonal = self-consistent."""
    ax = _new_ax(ax)
    ok = np.isfinite(chk.msm_committor) & (chk.counts > 0)
    ax.plot([0, 1], [0, 1], color="0.6", linewidth=1.0, linestyle="--",
            label="self-consistent")
    ax.plot(
        np.asarray(chk.bin_centers)[ok], np.asarray(chk.msm_committor)[ok],
        color=_color(0), marker="o", markersize=4, linewidth=1.6,
        label=f"MSM estimate (max dev {chk.max_deviation:.3f})",
    )
    ax.set_xlabel("predicted committor (bin mean)")
    ax.set_ylabel("MSM committor of the bin")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(frameon=False, fontsize=8)
    return _style(ax)


def plot_steered_work(result, ax=None):
    """Work accounting of a steered pull
    (:class:`~colvarsfinder_tpu_torch.utils.enhanced.SteeredResult`):
    per-realization cumulative work traces (thin), their mean, and the
    Jarzynski + second-order-cumulant free-energy profiles along the
    pulling schedule. A widening gap between the mean work and the
    Jarzynski curve is the dissipation; Jarzynski/cumulant disagreement
    flags non-Gaussian work (pull slower or add realizations).

    For multi-dimensional schedules the x axis is the schedule's first
    CV component.
    """
    ax = _new_ax(ax)
    c = np.asarray(result.schedule)[:, 0]
    for w in result.works:
        ax.plot(c, w, color="0.75", linewidth=0.5, zorder=1)
    ax.plot(
        c, result.works.mean(axis=0), color=_color(3), linewidth=1.8,
        label=r"$\langle W \rangle$",
    )
    ax.plot(
        c, result.jarzynski(), color=_color(0), linewidth=1.8,
        label=r"$\Delta F$ (Jarzynski)",
    )
    ax.plot(
        c, result.cumulant(), color=_color(2), linewidth=1.4,
        linestyle="--", label=r"$\Delta F$ (cumulant)",
    )
    ax.set_xlabel("restraint center (CV)")
    ax.set_ylabel("work / free energy")
    ax.legend(frameon=False, fontsize=8)
    return _style(ax)

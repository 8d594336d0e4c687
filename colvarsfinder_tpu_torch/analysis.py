"""Post-training analysis of learned collective variables (port of
``colvarsfinder_tpu/analysis.py``).

Host-side numpy, copied from the JAX module function by function:
:func:`implied_timescales` (``:94``), :func:`free_energy_profile` with
``_block_bootstrap_indices`` (``:143-301``), :func:`cv_consistency`
(``:304``), :func:`autocorrelation`, :func:`ck_test`,
:func:`timescales_vs_lag` (``:413-563``), :func:`vamp_score` (``:582``),
:func:`discretize`, :class:`MSMResult`, :func:`msm` (``:660-1058``),
:class:`LinearCV`, :func:`tica`, :func:`pca` (``:1061-1250``),
:func:`validate_cv` (``:1252-1343``), :func:`timescales_vs_lag_bootstrap`
(``:1346``), :func:`msm_ck_test` (``:1461-1577``),
:func:`committor_self_consistency` (``:1758-1885``),
:func:`statistical_inefficiency` and :func:`decorrelated_indices`
(``:1888-2022``).

Two functions evaluate a CV. Both take the CV by type, through
``_cv_on_numpy``: an ``nn.Module`` (a :class:`.export.ColvarModel`,
``task.colvar_model()``) runs on the device and in the dtype of its
parameters, without grad and in chunks; any other callable is probed once
on two frames, and runs there when it returns a ``torch.Tensor``; a
callable that returns numpy (a deployed numpy CV) is called as it is.

* :func:`cv_consistency` compares the CVs' values on ``X``;
* :func:`cv_sensitivity` takes the input gradients of a torch CV on its
  device by autograd: one forward per chunk of ``batch_size`` frames and
  one reverse pass of each head's batch sum (the rows are independent, so
  each sum's gradient is every row's own). Only a CV that returns numpy
  takes central finite differences. The JAX module takes
  ``jax.jacrev`` and falls back to finite differences on any exception;
  here an error in a torch CV (a kernel, its backward) raises. Not
  ``torch.func.jacrev``: it maps the reverse pass with ``vmap``, which the
  kernel layers' ``autograd.Function`` s do not support.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "CKResult",
    "CVValidation",
    "LinearCV",
    "MSMResult",
    "autocorrelation",
    "ck_test",
    "cv_consistency",
    "cv_sensitivity",
    "committor_self_consistency",
    "CommittorCheck",
    "SensitivityResult",
    "free_energy_profile",
    "discretize",
    "implied_timescales",
    "msm",
    "pca",
    "tica",
    "statistical_inefficiency",
    "decorrelated_indices",
    "timescales_vs_lag",
    "timescales_vs_lag_bootstrap",
    "msm_ck_test",
    "MSMCKResult",
    "validate_cv",
    "vamp_score",
]


def _torch_target(cv_fn, probe: np.ndarray):
    """``(device, dtype)`` a torch CV runs in, or None for a CV that
    returns numpy. An ``nn.Module`` takes its first floating parameter's
    (or buffer's); another callable is called once on ``probe`` and is
    torch when it returns a tensor (float64 stays float64, anything else
    runs in float32)."""
    if isinstance(cv_fn, torch.nn.Module):
        from .config import default_dtype
        from .utils.enhanced import _module_placement

        return (_module_placement(cv_fn)
                or (torch.device("cpu"), default_dtype()))
    out = cv_fn(probe)
    if not isinstance(out, torch.Tensor):
        return None
    return out.device, (torch.float64 if out.dtype == torch.float64
                        else torch.float32)


def _cv_on_numpy(cv_fn, X) -> np.ndarray:
    """``cv_fn`` of the frames ``X`` as numpy: a torch CV on its device and
    in its dtype, without grad, in chunks (``utils/enhanced.py:_eval_cv``);
    a CV that returns numpy called on ``X`` as it is."""
    X = np.asarray(X)
    target = _torch_target(cv_fn, X[:2])
    if target is None:
        return np.asarray(cv_fn(X))
    from .utils.enhanced import _eval_cv

    return _eval_cv(cv_fn, X, *target)


def _jacobian_torch(cv_fn, target, d_flat: int):
    """``xb -> [B, k, d]`` input Jacobian of a torch CV, float64 on the
    host: one forward on the device and one reverse pass of each head's
    batch sum. An error in the CV or its backward raises."""
    device, dtype = target

    def jac(xb):
        B = xb.shape[0]
        x = torch.from_numpy(np.array(xb, dtype=str(dtype).replace(
            "torch.", ""))).to(device).requires_grad_()
        with torch.enable_grad():
            y = torch.as_tensor(cv_fn(x)).reshape(B, -1)
            k = y.shape[1]
            rows = [torch.autograd.grad(y[:, i].sum(), x,
                                        retain_graph=i < k - 1)[0]
                    for i in range(k)]
        J = torch.stack([g.reshape(B, d_flat) for g in rows], dim=1)
        return J.detach().cpu().numpy().astype(np.float64)

    return jac


def implied_timescales(
    eig_vals, lag_time: Optional[float] = None, method: str = "rate"
) -> np.ndarray:
    """Physical timescales implied by trained eigenvalue estimates.

    Both eigenfunction objectives report eigenvalue estimates as
    relaxation RATES :math:`\\lambda_i` (units 1/time) — the generator
    loss as Dirichlet-form Rayleigh quotients, the transfer-operator
    loss as lagged mean-square differences normalized by the lag
    (``core/losses.py`` ``eigen_loss``; the per-epoch ``eig_i`` columns
    of ``train_loss_df``).

    Args:
        eig_vals: rate estimates, e.g.
            ``task.train_loss_df[["eig_1", "eig_2"]].iloc[-1]``.
        lag_time: the physical lag :math:`\\tau` used in training
            (``traj_dt * lag_idx``); required for ``method='log'``.
        method:
            - ``'rate'`` (default): :math:`t_i = 1/\\lambda_i` — exact
              for generator eigenvalues, first order in
              :math:`\\lambda\\tau` for transfer-operator estimates.
            - ``'log'``: :math:`t_i = -\\tau / \\ln(1 - \\lambda_i\\tau)`
              — the standard Markov-state-model formula, undoing the
              finite-lag first-order bias of the transfer-operator
              estimate (its quotient approximates
              :math:`(1 - \\rho_i)/\\tau` where :math:`\\rho_i` is the
              lagged autocorrelation).

    Returns:
        timescales, same shape as ``eig_vals``. Non-decaying estimates
        (:math:`\\lambda \\le 0`, or :math:`\\lambda\\tau \\ge 1` under
        ``'log'``) map to ``inf`` / ``nan`` respectively rather than
        raising.
    """
    lam = np.asarray(eig_vals, dtype=np.float64)
    if method == "rate":
        with np.errstate(divide="ignore"):
            return np.where(lam > 0, 1.0 / np.where(lam > 0, lam, 1.0), np.inf)
    if method != "log":
        raise ValueError(f"unknown method {method!r}; expected 'rate' or 'log'")
    if lag_time is None:
        raise ValueError("method='log' requires lag_time (traj_dt * lag_idx)")
    rho = 1.0 - lam * float(lag_time)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = -float(lag_time) / np.log(rho)
    t = np.where(lam <= 0, np.inf, t)
    return np.where(rho <= 0, np.nan, t)


def _block_bootstrap_indices(rng, starts_pool, block: int, n_blocks: int,
                             n: int) -> np.ndarray:
    """One moving-block bootstrap resample: ``n_blocks`` random blocks of
    ``block`` contiguous frames (starts drawn from ``starts_pool``),
    concatenated and truncated to ``n`` frames."""
    starts = rng.choice(starts_pool, size=n_blocks)
    return (starts[:, None] + np.arange(block)[None, :]).reshape(-1)[:n]


def free_energy_profile(
    cv_values,
    weights=None,
    beta: float = 1.0,
    bins: int = 50,
    value_range=None,
    n_bootstrap: int = 0,
    block_frames: Optional[int] = None,
    seed: int = 0,
    segment_starts=None,
):
    """Free-energy surface along one or two learned CVs.

    :math:`F(s) = -\\beta^{-1} \\ln p(s)`, with :math:`p` the
    (Boltzmann-reweighted) histogram of the CV values — the standard
    product of a CV-discovery run, shifted so :math:`\\min F = 0`.

    Args:
        cv_values: ``[n]`` or ``[n, 1]`` for a 1-D profile, ``[n, 2]``
            for a 2-D surface (e.g. the first two columns of
            ``colvar_model()(trajectory)``).
        weights: optional per-frame statistical weights (e.g.
            ``WeightedTrajectory.weights``); uniform if omitted.
        beta: inverse temperature of the TARGET ensemble (must match
            the beta the weights reweight to).
        bins: histogram bins per dimension.
        value_range: optional histogram range, as for numpy.
        n_bootstrap: number of moving-block bootstrap replicas for
            per-bin uncertainties (0 disables — the default).
        block_frames: bootstrap block length in frames. MD frames are
            time-correlated, so frames are resampled in contiguous
            blocks; choose at least the CV's correlation time
            (:func:`autocorrelation`). Default ``max(n // 50, 1)``;
            pass ``"auto"`` to use twice the measured statistical
            inefficiency of the CV series
            (:func:`statistical_inefficiency`).
        seed: bootstrap RNG seed.
        segment_starts: source offsets of concatenated/pooled inputs
            (``WeightedTrajectory.segment_starts`` — umbrella windows,
            REMD slots, pooled runs). With it, ``block_frames='auto'``
            measures the statistical inefficiency within segments only
            (no spurious cross-window correlation), and bootstrap
            blocks never straddle a segment boundary.

    Returns:
        ``(centers, F)``: for 1-D, ``centers`` is ``[bins]`` and ``F``
        is ``[bins]``; for 2-D, ``centers`` is a ``(x_centers,
        y_centers)`` tuple and ``F`` is ``[bins, bins]`` indexed
        ``F[ix, iy]``. Empty bins hold ``inf``. With
        ``n_bootstrap > 0``, returns ``(centers, F, F_err)`` where
        ``F_err`` is the per-bin bootstrap standard deviation (replicas
        anchored at the full-profile minimum bin, so the errors are
        shape errors; ``inf`` where fewer than two replicas populate
        the bin).
    """
    s = np.asarray(cv_values, dtype=np.float64)
    if s.ndim == 2 and s.shape[1] == 1:
        s = s[:, 0]
    w = None if weights is None else np.asarray(weights, dtype=np.float64)

    if s.ndim == 1:
        _hist, edges = np.histogram(
            s, bins=bins, range=value_range, weights=w, density=True
        )
        centers = 0.5 * (edges[:-1] + edges[1:])

        def hist_of(idx):
            h, _ = np.histogram(
                s[idx], bins=edges,
                weights=None if w is None else w[idx], density=True,
            )
            return h

        hist = _hist
    elif s.ndim == 2 and s.shape[1] == 2:
        _hist, ex, ey = np.histogram2d(
            s[:, 0], s[:, 1], bins=bins, range=value_range, weights=w,
            density=True,
        )
        centers = (0.5 * (ex[:-1] + ex[1:]), 0.5 * (ey[:-1] + ey[1:]))

        def hist_of(idx):
            h, _, _ = np.histogram2d(
                s[idx, 0], s[idx, 1], bins=(ex, ey),
                weights=None if w is None else w[idx], density=True,
            )
            return h

        hist = _hist
    else:
        raise ValueError(
            f"cv_values must be [n], [n,1] or [n,2]; got shape {s.shape}"
        )
    with np.errstate(divide="ignore"):
        F = -np.log(hist) / float(beta)
    F -= F.min()
    if n_bootstrap <= 0:
        return centers, F

    # moving-block bootstrap: frames are time-correlated, so replicas
    # resample contiguous blocks, each anchored at the full profile's
    # minimum bin so the spread measures the SHAPE uncertainty
    n = s.shape[0]
    if isinstance(block_frames, str):
        if block_frames != "auto":
            raise ValueError(
                f"block_frames must be an int or 'auto'; got {block_frames!r}"
            )
        try:
            g = float(np.max(statistical_inefficiency(s, segment_starts)))
        except ValueError:  # constant series: no correlation time
            g = 1.0
        block = 2 * int(np.ceil(g))
    else:
        block = int(block_frames) if block_frames else max(n // 50, 1)
    block = min(max(block, 1), n)
    anchor = np.unravel_index(np.argmin(F), F.shape)
    rng = np.random.default_rng(seed)
    n_blocks = int(np.ceil(n / block))
    starts_pool = np.arange(n - block + 1)
    if segment_starts is not None:
        # blocks must not straddle pooled-segment boundaries
        bounds = np.asarray(segment_starts, dtype=np.int64)
        bounds = bounds[(bounds > 0) & (bounds < n)]
        if bounds.size:
            seg_of = np.searchsorted(bounds, np.arange(n), side="right")
            ok = seg_of[starts_pool] == seg_of[starts_pool + block - 1]
            if not np.any(ok):
                raise ValueError(
                    f"bootstrap block length {block} exceeds every "
                    "segment; pass a smaller block_frames"
                )
            starts_pool = starts_pool[ok]
    reps = []
    for _ in range(int(n_bootstrap)):
        idx = _block_bootstrap_indices(rng, starts_pool, block, n_blocks, n)
        with np.errstate(divide="ignore"):
            Fb = -np.log(hist_of(idx)) / float(beta)
        Fb = Fb - Fb[anchor]
        reps.append(Fb)
    reps = np.stack(reps)
    finite = np.isfinite(reps)
    cnt = finite.sum(axis=0)
    mean = np.where(cnt > 0, np.nansum(np.where(finite, reps, 0), axis=0)
                    / np.maximum(cnt, 1), np.nan)
    var = np.nansum(
        np.where(finite, (reps - mean) ** 2, 0), axis=0
    ) / np.maximum(cnt - 1, 1)
    F_err = np.where(cnt >= 2, np.sqrt(var), np.inf)
    return centers, F, F_err


def cv_consistency(
    cvs: Sequence[Callable], X, center: bool = True
) -> np.ndarray:
    """Pairwise subspace agreement of independently-trained CV maps.

    Learned CVs are identified only up to invertible linear mixing
    (head order/sign for eigenfunctions, any basis for encoders), so
    raw outputs of two seeds never match — but their *spans* should.
    For each pair this computes the mean canonical correlation between
    the two CV output subspaces evaluated on ``X`` (the singular values
    of :math:`Q_i^T Q_j` with :math:`Q` an orthonormal basis of the
    centered outputs): 1.0 = identical learned subspace, ~0 = unrelated.

    The convergence/identifiability check for a seed ensemble
    (:func:`~colvarsfinder_tpu_torch.parallel.train_architecture_ensemble`
    with one architecture and S seeds): a low off-diagonal mean says
    the CV is not determined by the data/objective at this
    architecture, regardless of how good the losses look.

    Args:
        cvs: CV callables ``[n, dim] -> [n, k]`` (ColvarModel, deployed
            numpy CVs, ...). ``k`` may differ per model; the canonical
            correlations are over the smaller head count of each pair.
        X: evaluation frames ``[n, dim]`` (use held-out frames).
        center: subtract each output column's mean first (default; set
            False to compare affine spans including the constant).

    Returns:
        ``[R, R]`` symmetric matrix, unit diagonal.
    """
    X = np.asarray(X)
    Qs = []
    for cv in cvs:
        y = np.asarray(_cv_on_numpy(cv, X), dtype=np.float64)
        if y.ndim == 1:
            y = y[:, None]
        if center:
            y = y - y.mean(axis=0)
        q, r = np.linalg.qr(y)
        # drop numerically-dead directions (constant/zero heads)
        keep = np.abs(np.diag(r)) > 1e-10 * max(1.0, np.abs(r).max())
        Qs.append(q[:, keep])
    R = len(Qs)
    M = np.eye(R)
    for i in range(R):
        for j in range(i + 1, R):
            k = min(Qs[i].shape[1], Qs[j].shape[1])
            if k == 0:
                M[i, j] = M[j, i] = 0.0
                continue
            s = np.linalg.svd(Qs[i].T @ Qs[j], compute_uv=False)
            M[i, j] = M[j, i] = float(np.clip(s[:k].mean(), 0.0, 1.0))
    return M


# ---------------------------------------------------------------------------
# Markovianity validation of the learned CV time series
# ---------------------------------------------------------------------------


def _as_series(cv_values) -> np.ndarray:
    y = np.asarray(cv_values, dtype=np.float64)
    if y.ndim == 1:
        y = y[:, None]
    if y.ndim != 2:
        raise ValueError(
            f"cv_values must be a [n] or [n, k] time series; got {y.shape}"
        )
    return y


def _as_frame_lags(lags) -> np.ndarray:
    """Lags as an int64 array, REJECTING non-integral values.

    A float like ``lag_tau / dt`` = 6.999999999999999 must not silently
    floor to 6 — that would skew every lag-based comparison (CK
    multiples, implied timescales) without any error.
    """
    arr = np.asarray(list(np.atleast_1d(lags)))
    rounded = np.round(arr.astype(np.float64))
    if not np.allclose(arr.astype(np.float64), rounded, rtol=0, atol=1e-9):
        raise ValueError(
            f"lags must be integer frame counts; got {arr} "
            "(use round(lag_tau / dt))"
        )
    return rounded.astype(np.int64)


def _pair_starts(n: int, lag: int, segment_starts) -> np.ndarray:
    """Start frames of valid lagged pairs: all of ``range(n - lag)`` for
    one contiguous trajectory; segment-interior starts when
    ``segment_starts`` marks concatenated sources
    (``WeightedTrajectory.segment_starts``). Raises if no segment is
    longer than ``lag`` frames."""
    if segment_starts is None:
        return np.arange(n - lag, dtype=np.int64)
    bounds = np.append(np.asarray(segment_starts, dtype=np.int64), n)
    parts = [
        np.arange(bounds[s], bounds[s + 1] - lag, dtype=np.int64)
        for s in range(bounds.size - 1)
        if bounds[s + 1] - bounds[s] > lag
    ]
    if not parts:
        raise ValueError(
            f"no trajectory segment is longer than lag={lag} frames"
        )
    return np.concatenate(parts)


def autocorrelation(cv_values, lags, weights=None, segment_starts=None) -> np.ndarray:
    """Weighted autocorrelation of each CV head at the given lags.

    The estimator matches the transfer-operator objective's convention
    (``core/losses.py`` ``eigen_loss``; reference core.py:1010-1023):
    lagged pairs ``(y_t, y_{t+L})`` are weighted by the LEADING frame's
    statistical weight, each side is centered by its own weighted
    windowed mean, and the correlation is normalized by the geometric
    mean of the two windowed variances — so ``1 - rho(L)`` over
    ``L*dt`` is exactly the quantity the training eigenvalues estimate.

    Args:
        cv_values: ``[n]`` or ``[n, k]`` CV time series over a SINGLE
            contiguous trajectory (evaluate ``colvar_model()`` on the
            frames IN ORDER — not on a shuffled batch).
        lags: iterable of integer lags, in FRAMES (each < n).
        weights: optional per-frame weights
            (``WeightedTrajectory.weights``); uniform if omitted.
        segment_starts: for a CV series over a CONCATENATED
            multi-trajectory dataset
            (:func:`~colvarsfinder_tpu_torch.utils.concatenate_trajectories`),
            the source offsets (``traj.segment_starts``); lagged pairs
            then never straddle two source trajectories.

    Returns:
        ``[len(lags), k]`` array of correlations in ``[-1, 1]``.
    """
    y = _as_series(cv_values)
    n = y.shape[0]
    w = (
        np.ones(n, dtype=np.float64)
        if weights is None
        else np.asarray(weights, dtype=np.float64)
    )
    if w.shape != (n,):
        raise ValueError(f"weights must be [n={n}]; got {w.shape}")
    lags = _as_frame_lags(lags)
    if np.any(lags < 0) or np.any(lags >= n):
        raise ValueError(f"lags must lie in [0, n={n}); got {lags}")
    out = np.empty((lags.size, y.shape[1]))
    for i, L in enumerate(lags):
        s = _pair_starts(n, int(L), segment_starts)
        a, b = y[s], y[s + L]
        wp = w[s]
        wp = wp / wp.sum()
        mu_a = wp @ a
        mu_b = wp @ b
        da, db = a - mu_a, b - mu_b
        cov = np.einsum("t,tk,tk->k", wp, da, db)
        var_a = np.einsum("t,tk,tk->k", wp, da, da)
        var_b = np.einsum("t,tk,tk->k", wp, db, db)
        out[i] = cov / np.sqrt(np.maximum(var_a * var_b, 1e-300))
    return out


class CKResult:
    """Outcome of :func:`ck_test`.

    Attributes:
        lags: ``[m]`` the tested lags in frames (``lag * (1..m)``).
        estimated: ``[m, k]`` directly-estimated autocorrelations
            :math:`\\rho(i\\,\\tau)`.
        predicted: ``[m, k]`` Chapman–Kolmogorov predictions
            :math:`\\rho(\\tau)^i` from the base lag alone.
        max_deviation: worst ``|estimated - predicted|`` over all
            multiples and heads — the single-number Markovianity score
            (well-sampled Markovian CVs sit well below ~0.05).
    """

    def __init__(self, lags, estimated, predicted):
        self.lags = lags
        self.estimated = estimated
        self.predicted = predicted
        self.max_deviation = float(np.max(np.abs(estimated - predicted)))

    def __repr__(self):  # pragma: no cover - cosmetic
        return (
            f"CKResult(lags={self.lags.tolist()}, "
            f"max_deviation={self.max_deviation:.4f})"
        )


def ck_test(
    cv_values, lag: int, n_multiples: int = 4, weights=None, segment_starts=None
) -> CKResult:
    """Chapman–Kolmogorov test of the learned CV at the training lag.

    If the CV heads are good slow eigenfunctions, their dynamics is
    Markovian and single-exponential, so the autocorrelation must
    satisfy :math:`\\rho(i\\,\\tau) = \\rho(\\tau)^i`. This estimates
    both sides from the trajectory — the standard MSM validation,
    applied directly to the CV time series. A large
    ``result.max_deviation`` means the training lag is too short (fast
    non-Markovian processes leak into the CV) or the CV mixes several
    timescales; retrain with a longer ``lag_tau`` or more heads.

    Args:
        cv_values: ``[n]`` or ``[n, k]`` CV series over one contiguous
            trajectory, frame-ordered.
        lag: the base lag :math:`\\tau` in FRAMES (the training
            ``lag_idx``: ``round(lag_tau / traj_dt)``).
        n_multiples: test at lags ``lag * 1 .. lag * n_multiples``.
        weights: optional per-frame weights.

    Returns:
        :class:`CKResult`.
    """
    lag = int(_as_frame_lags(lag)[0])
    if lag <= 0:
        raise ValueError(f"lag must be a positive frame count; got {lag}")
    lags = lag * np.arange(1, int(n_multiples) + 1)
    rho = autocorrelation(
        cv_values, lags, weights=weights, segment_starts=segment_starts
    )
    predicted = rho[0][None, :] ** np.arange(1, int(n_multiples) + 1)[:, None]
    return CKResult(lags, rho, predicted)


def timescales_vs_lag(
    cv_values, lags, dt: float = 1.0, weights=None, segment_starts=None
) -> np.ndarray:
    """Implied timescale of each CV head as a function of the lag time.

    :math:`t_i(L) = -L\\,dt / \\ln \\rho_i(L)` — the lag-convergence
    curve. For a converged (Markovian) CV the curve plateaus: the
    timescale stops depending on the lag. Rising-then-flat curves tell
    you the shortest usable training ``lag_tau``; curves that never
    flatten mean the head is not a clean slow mode. Complements
    :func:`ck_test` (which fixes the lag and scans its multiples).

    Args:
        cv_values: ``[n]`` or ``[n, k]`` CV series, frame-ordered.
        lags: integer lags in FRAMES to evaluate at (each >= 1).
        dt: physical time per frame (``WeightedTrajectory.dt``).
        weights: optional per-frame weights.

    Returns:
        ``[len(lags), k]`` timescales in physical units.
        Non-decaying estimates (:math:`\\rho \\le 0`) map to ``nan``;
        :math:`\\rho \\ge 1` maps to ``inf``.
    """
    lags = _as_frame_lags(lags)
    if np.any(lags < 1):
        raise ValueError(f"lags must be >= 1 frame; got {lags}")
    rho = autocorrelation(
        cv_values, lags, weights=weights, segment_starts=segment_starts
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        t = -(lags[:, None] * float(dt)) / np.log(rho)
    t = np.where(rho >= 1.0, np.inf, t)
    return np.where(rho <= 0.0, np.nan, t)


def _inv_sqrt(C: np.ndarray, epsilon: float) -> np.ndarray:
    """Truncated symmetric inverse square root of an SPSD covariance.

    Eigendirections below ``epsilon * max_eigenvalue`` (degenerate or
    constant CV heads) are dropped rather than amplified, so
    rank-deficient inputs degrade gracefully. Returns ``[k, r]`` with
    r the retained rank.
    """
    vals, vecs = np.linalg.eigh((C + C.T) / 2.0)
    floor = float(epsilon) * max(float(vals.max()), 0.0)
    keep = vals > max(floor, 0.0)
    if not np.any(keep):
        return np.zeros((C.shape[0], 0))
    return vecs[:, keep] / np.sqrt(vals[keep])


def vamp_score(
    cv_values,
    lag: int,
    weights=None,
    method: str = "VAMP-2",
    epsilon: float = 1e-10,
    segment_starts=None,
) -> float:
    """VAMP score of the learned CV at a lag — held-out model selection.

    How much slow kinetic variance the CV heads capture: with
    mean-free, weighted covariances :math:`C_{00}, C_{0\\tau},
    C_{\\tau\\tau}` over the lagged pairs, the score is a norm of the
    whitened cross-covariance
    :math:`K = C_{00}^{-1/2} C_{0\\tau} C_{\\tau\\tau}^{-1/2}` — the
    sum of its singular values (VAMP-1) or their squares (VAMP-2),
    each clipped to 1. For a single AR(1)-like head the VAMP-2 score
    is exactly :math:`\\rho(\\tau)^2`; for k independent slow heads the
    contributions add, up to a maximum of k.

    Unlike the training loss, the score is invariant under any
    invertible linear mixing of the heads, so it compares CVs across
    architectures, seeds and hyperparameters on equal footing — the
    right ranking metric for
    :func:`~colvarsfinder_tpu_torch.parallel.train_hyperparameter_sweep`
    winners, evaluated on HELD-OUT frames. (Convention: heads are
    centered, so the trivial constant singular function is excluded;
    some references report this score +1.)

    Args:
        cv_values: ``[n]`` or ``[n, k]`` CV series over one contiguous
            trajectory, frame-ordered (evaluate the CV on held-out
            frames IN ORDER).
        lag: the lag :math:`\\tau` in FRAMES (1 <= lag < n).
        weights: optional per-frame weights
            (``WeightedTrajectory.weights``); lagged pairs are weighted
            by the leading frame, matching :func:`autocorrelation`.
        method: ``'VAMP-1'`` (nuclear norm) or ``'VAMP-2'``
            (squared Frobenius, default).
        epsilon: relative eigenvalue floor below which degenerate CV
            directions are dropped from the whitening.

    Returns:
        The score, a float in ``[0, k]``.
    """
    if method not in ("VAMP-1", "VAMP-2"):
        raise ValueError(f"method must be 'VAMP-1' or 'VAMP-2'; got {method!r}")
    y = _as_series(cv_values)
    n = y.shape[0]
    lag = int(_as_frame_lags(lag)[0])
    if not 1 <= lag < n:
        raise ValueError(f"lag must lie in [1, n={n}); got {lag}")
    w = (
        np.ones(n, dtype=np.float64)
        if weights is None
        else np.asarray(weights, dtype=np.float64)
    )
    if w.shape != (n,):
        raise ValueError(f"weights must be [n={n}]; got {w.shape}")
    s = _pair_starts(n, lag, segment_starts)
    a, b = y[s], y[s + lag]
    wp = w[s]
    wp = wp / wp.sum()
    da, db = a - wp @ a, b - wp @ b
    wda = wp[:, None] * da
    C00 = wda.T @ da
    C01 = wda.T @ db
    C11 = (wp[:, None] * db).T @ db
    K = _inv_sqrt(C00, epsilon).T @ C01 @ _inv_sqrt(C11, epsilon)
    s = np.clip(np.linalg.svd(K, compute_uv=False), 0.0, 1.0)
    return float(np.sum(s if method == "VAMP-1" else s**2))


# ---------------------------------------------------------------------------
# Markov state model on CV bins: committor / MFPT / spectral timescales
# ---------------------------------------------------------------------------


def discretize(cv_values, n_bins: int = 50, value_range=None):
    """Assign each frame of a CV series to a regular-grid bin.

    1-D series get ``n_bins`` equal-width bins over the data range
    (or ``value_range``); k-D series get a ``n_bins``-per-dimension
    grid with bin indices flattened in C order. Values outside
    ``value_range`` are clipped into the edge bins.

    Args:
        cv_values: ``[n]`` or ``[n, k]`` CV series.
        n_bins: bins per dimension.
        value_range: optional ``(lo, hi)`` (1-D) or sequence of
            ``(lo, hi)`` per dimension.

    Returns:
        ``(assignments, centers)`` — ``assignments`` is ``[n]`` int64
        flat bin indices in ``[0, n_bins**k)``; ``centers`` is
        ``[n_bins]`` (1-D) or a tuple of per-dimension ``[n_bins]``
        center arrays.
    """
    y = _as_series(cv_values)
    n_bins = int(n_bins)
    if n_bins < 2:
        raise ValueError(f"n_bins must be >= 2; got {n_bins}")
    k = y.shape[1]
    if value_range is None:
        ranges = [(y[:, j].min(), y[:, j].max()) for j in range(k)]
    elif k == 1 and np.ndim(value_range[0]) == 0:
        ranges = [tuple(value_range)]
    else:
        ranges = [tuple(r) for r in value_range]
        if len(ranges) != k:
            raise ValueError(
                f"value_range must give (lo, hi) per dimension (k={k})"
            )
    idx = np.zeros(y.shape[0], dtype=np.int64)
    centers = []
    for j, (lo, hi) in enumerate(ranges):
        lo, hi = float(lo), float(hi)
        if not hi > lo:
            raise ValueError(f"degenerate range {(lo, hi)} in dimension {j}")
        edges = np.linspace(lo, hi, n_bins + 1)
        centers.append(0.5 * (edges[:-1] + edges[1:]))
        ij = np.clip(
            np.searchsorted(edges, y[:, j], side="right") - 1, 0, n_bins - 1
        )
        idx = idx * n_bins + ij
    return idx, (centers[0] if k == 1 else tuple(centers))


class MSMResult:
    """A discrete Markov state model estimated by :func:`msm`.

    States are the bins of :func:`discretize` (or user-provided
    assignments). Only ACTIVE states — visited as a pair leading frame
    — carry estimates; methods report ``nan`` for inactive states.

    Attributes:
        transition_matrix: ``[m, m]`` row-stochastic matrix over ALL
            states; inactive rows hold a self-loop.
        counts: ``[m, m]`` weighted (symmetrized, if reversible) pair
            counts.
        stationary: ``[m]`` stationary distribution (zero on inactive
            states).
        active: ``[m]`` boolean mask of active states.
        lag: the estimation lag in frames.
        n_states: m.
    """

    def __init__(self, transition_matrix, counts, lag):
        self.transition_matrix = transition_matrix
        self.counts = counts
        self.lag = int(lag)
        self.n_states = transition_matrix.shape[0]
        self.active = counts.sum(axis=1) > 0
        self.stationary = self._stationary()

    def _stationary(self) -> np.ndarray:
        a = np.flatnonzero(self.active)
        if a.size == 0:
            return np.zeros(self.n_states)
        T = self.transition_matrix[np.ix_(a, a)]
        vals, vecs = np.linalg.eig(T.T)
        i = int(np.argmin(np.abs(vals - 1.0)))
        pi = np.abs(np.real(vecs[:, i]))
        pi = pi / pi.sum()
        out = np.zeros(self.n_states)
        out[a] = pi
        return out

    def timescales(self, dt: float = 1.0, k: Optional[int] = None) -> np.ndarray:
        """Spectral implied timescales ``-lag*dt / ln |lambda_i|`` of the
        non-stationary eigenvalues, descending (``k`` largest if given)."""
        a = np.flatnonzero(self.active)
        T = self.transition_matrix[np.ix_(a, a)]
        vals = np.sort(np.abs(np.linalg.eigvals(T)))[::-1][1:]
        if k is not None:
            vals = vals[: int(k)]
        with np.errstate(divide="ignore"):
            t = -(self.lag * float(dt)) / np.log(
                np.clip(vals, 1e-300, None)
            )
        return np.where(vals >= 1.0, np.inf, t)

    def _sets(self, A, B):
        A = np.atleast_1d(np.asarray(A, dtype=np.int64))
        B = np.atleast_1d(np.asarray(B, dtype=np.int64))
        for name, S in (("A", A), ("B", B)):
            if S.size == 0:
                raise ValueError(f"set {name} is empty")
            if np.any((S < 0) | (S >= self.n_states)):
                raise ValueError(
                    f"set {name} contains states outside [0, {self.n_states})"
                )
        if np.intersect1d(A, B).size:
            raise ValueError("A and B must be disjoint")
        return A, B

    def committor(self, A, B) -> np.ndarray:
        """Forward committor ``q[i] = P(reach B before A | start in i)``.

        Solves the discrete boundary-value problem ``q=0`` on A, ``q=1``
        on B, ``(I - T) q = 0`` elsewhere, restricted to active states
        that can reach ``A ∪ B`` (unreachable or inactive states get
        ``nan``). Along a good 1-D reaction-coordinate CV the committor
        of the CV bins is a monotone sigmoid crossing 1/2 at the
        transition state.

        Args:
            A, B: disjoint iterables of state (bin) indices — e.g. the
                bins of the two free-energy minima from
                :func:`free_energy_profile` + :func:`discretize`.

        Returns:
            ``[n_states]`` committor values in ``[0, 1]`` (``nan`` where
            undefined).
        """
        A, B = self._sets(A, B)
        q = np.full(self.n_states, np.nan)
        q[A], q[B] = 0.0, 1.0
        # states that can reach A ∪ B (on the active chain)
        adj = self.counts > 0
        reach = np.zeros(self.n_states, dtype=bool)
        reach[A] = reach[B] = True
        while True:
            new = reach | (adj @ reach)
            if np.array_equal(new, reach):
                break
            reach = new
        free = self.active & reach
        free[A] = free[B] = False
        f = np.flatnonzero(free)
        if f.size:
            T = self.transition_matrix
            M = np.eye(f.size) - T[np.ix_(f, f)]
            rhs = T[np.ix_(f, np.atleast_1d(B))].sum(axis=1)
            # boundary values: contributions from transitions into A are 0
            q[f] = np.clip(np.linalg.solve(M, rhs), 0.0, 1.0)
        return q

    def mfpt(self, B, dt: float = 1.0) -> np.ndarray:
        """Mean first-passage time to the set ``B`` from every state.

        Solves ``m = lag*dt + T m`` off B, ``m = 0`` on B, on the
        active states that can reach B (``nan`` elsewhere).
        """
        B = np.atleast_1d(np.asarray(B, dtype=np.int64))
        if B.size == 0:
            raise ValueError("set B is empty")
        if np.any((B < 0) | (B >= self.n_states)):
            raise ValueError(f"B contains states outside [0, {self.n_states})")
        m = np.full(self.n_states, np.nan)
        m[B] = 0.0
        adj = self.counts > 0
        reach = np.zeros(self.n_states, dtype=bool)
        reach[B] = True
        while True:
            new = reach | (adj @ reach)
            if np.array_equal(new, reach):
                break
            reach = new
        free = self.active & reach
        free[B] = False
        f = np.flatnonzero(free)
        if f.size:
            T = self.transition_matrix
            M = np.eye(f.size) - T[np.ix_(f, f)]
            m[f] = np.linalg.solve(M, np.full(f.size, self.lag * float(dt)))
        return m

    def tpt_rate(self, A, B, dt: float = 1.0) -> float:
        r"""Transition-path-theory rate :math:`k_{AB}` (events per unit
        time) between the sets.

        Discrete TPT (Metzner, Schütte & Vanden-Eijnden 2009): with the
        forward committor :math:`q^+` (:meth:`committor`) and — on the
        reversible estimator this class builds — the backward committor
        :math:`q^- = 1 - q^+`, the total reactive flux is the flux across
        A's boundary (flux conservation makes any complete cut
        equivalent; summing the edge currents of EVERY edge instead would
        count each multi-hop reactive path once per hop):

        .. math::
            F = \sum_{i \in A} \pi_i \sum_j T_{ij}\, q^+_j,
            \qquad
            k_{AB} = \frac{F}{\tau \sum_i \pi_i q^-_i}

        with :math:`\tau` the estimation lag (``lag * dt``). For a
        two-state system this reduces to the exact escape rate; in
        general it counts reactive events per time spent "last in A"
        (validated against brute-force reactive-event counting on a
        sampled multi-state chain, tests/test_analysis.py).

        Args:
            A, B: disjoint state sets (as in :meth:`committor`).
            dt: frame spacing (time units of the returned rate).

        Returns:
            the rate (1/time); ``nan`` when A is unreachable.
        """
        q_plus = self.committor(A, B)
        A, _ = self._sets(A, B)
        ok = np.isfinite(q_plus)
        if not ok.any():
            return float("nan")
        q_minus = np.where(ok, 1.0 - q_plus, 0.0)  # reversible estimator
        pi = self.stationary
        qp = np.where(ok, q_plus, 0.0)
        F = float((pi[A] * (self.transition_matrix[A] @ qp)).sum())
        denom = float((pi * q_minus).sum()) * self.lag * float(dt)
        return float(F / denom) if denom > 0 else float("nan")

    def pcca(self, n: int) -> np.ndarray:
        """PCCA+ fuzzy memberships of the microstates in ``n`` metastable
        sets (Deuflhard–Weber Perron cluster analysis, inner-simplex
        variant): the top-``n`` eigenvectors of the reversible transition
        matrix span a simplex whose vertices are the metastable sets;
        each state's barycentric coordinates are its memberships.

        Standard MSM coarse-graining — after validating a learned CV with
        :meth:`timescales`/:func:`ck_test`, ``pcca`` names the metastable
        states the CV resolves (the sets to feed :meth:`committor` /
        :meth:`mfpt`).

        Args:
            n: number of metastable sets (2 <= n <= number of active
                states). Choose it at a spectral gap in
                :meth:`timescales`.

        Returns:
            ``[n_states, n]`` row-stochastic memberships (rows of
            inactive states are ``nan``).
        """
        a = np.flatnonzero(self.active)
        if not 2 <= int(n) <= a.size:
            raise ValueError(
                f"n must lie in [2, active={a.size}]; got {n}"
            )
        n = int(n)
        T = self.transition_matrix[np.ix_(a, a)]
        pi = self.stationary[a]
        pi = np.clip(pi, 1e-300, None)
        # reversible T is self-adjoint in the pi-weighted inner product:
        # symmetrize D^{1/2} T D^{-1/2} and use the stable Hermitian solver
        d = np.sqrt(pi)
        S = (d[:, None] * T) / d[None, :]
        S = 0.5 * (S + S.T)
        vals, vecs = np.linalg.eigh(S)
        order = np.argsort(vals)[::-1][:n]
        X = vecs[:, order] / d[:, None]  # right eigenvectors of T
        # fix the trivial eigenvector to the constant 1
        X[:, 0] = 1.0

        # inner simplex algorithm: greedily pick the n most mutually
        # distant rows as the simplex vertices
        ortho = X.copy()
        verts = []
        # start from the row farthest from the origin
        i = int(np.argmax(np.einsum("ij,ij->i", ortho, ortho)))
        for _ in range(n):
            verts.append(i)
            v = ortho[i]
            nv = np.linalg.norm(v)
            if nv > 0:
                v = v / nv
                ortho = ortho - np.outer(ortho @ v, v)
            i = int(np.argmax(np.einsum("ij,ij->i", ortho, ortho)))
        chi = X @ np.linalg.inv(X[verts])
        # clip tiny infeasibilities from finite sampling, renormalize
        chi = np.clip(chi, 0.0, None)
        chi = chi / chi.sum(axis=1, keepdims=True)

        out = np.full((self.n_states, n), np.nan)
        out[a] = chi
        return out

    def metastable_assignments(self, n: int) -> np.ndarray:
        """Crisp metastable-set index per microstate (argmax of
        :meth:`pcca` memberships; inactive states get ``-1``)."""
        chi = self.pcca(n)
        out = np.full(self.n_states, -1, dtype=np.int64)
        out[self.active] = np.argmax(chi[self.active], axis=1)
        return out

    def coarse_grain(self, n: int):
        """PCCA+ coarse-grained ``n``-state model: stationary weights
        ``pi_c = chi^T pi`` and the membership-projected transition
        matrix ``T_c = diag(pi_c)^{-1} chi^T diag(pi) T chi``.

        Returns:
            ``(T_coarse [n, n] row-stochastic, pi_coarse [n])``.
        """
        a = np.flatnonzero(self.active)
        chi = self.pcca(n)[a]
        pi = self.stationary[a]
        T = self.transition_matrix[np.ix_(a, a)]
        pi_c = chi.T @ pi
        T_c = (chi.T * pi) @ T @ chi / np.clip(
            pi_c[:, None], 1e-300, None
        )
        T_c = T_c / T_c.sum(axis=1, keepdims=True)
        return T_c, pi_c

    def __repr__(self):  # pragma: no cover - cosmetic
        return (
            f"MSMResult(n_states={self.n_states}, "
            f"active={int(self.active.sum())}, lag={self.lag})"
        )


def msm(
    assignments,
    lag: int,
    n_states: Optional[int] = None,
    weights=None,
    reversible: bool = True,
    segment_starts=None,
) -> MSMResult:
    """Estimate a discrete Markov state model from a state time series.

    Counts lagged pairs ``(s_t, s_{t+lag})`` over one contiguous
    trajectory, each weighted by the leading frame's statistical weight
    (the package convention, :func:`autocorrelation`), then
    row-normalizes into a transition matrix. With ``reversible=True``
    (default) the count matrix is symmetrized first — the standard
    fixed-pi-free reversible estimator, guaranteeing real eigenvalues
    and detailed balance w.r.t. the estimated stationary distribution.

    Args:
        assignments: ``[n]`` integer state indices, frame-ordered — the
            output of :func:`discretize` on a CV series.
        lag: estimation lag in FRAMES (1 <= lag < n).
        n_states: total number of states (default:
            ``assignments.max() + 1``); pass ``n_bins**k`` to keep grid
            geometry when edge bins are unvisited.
        weights: optional per-frame weights; uniform if omitted.
        reversible: symmetrize counts before normalizing.

    Returns:
        :class:`MSMResult`.
    """
    s = np.asarray(assignments)
    if s.ndim != 1 or not np.issubdtype(s.dtype, np.integer):
        raise ValueError(
            "assignments must be a 1-D integer series (use discretize())"
        )
    n = s.shape[0]
    lag = int(_as_frame_lags(lag)[0])
    if not 1 <= lag < n:
        raise ValueError(f"lag must lie in [1, n={n}); got {lag}")
    if np.any(s < 0):
        raise ValueError("assignments must be non-negative")
    m = int(s.max()) + 1 if n_states is None else int(n_states)
    if m <= int(s.max()):
        raise ValueError(
            f"n_states={m} but assignments reach state {int(s.max())}"
        )
    w = (
        np.ones(n, dtype=np.float64)
        if weights is None
        else np.asarray(weights, dtype=np.float64)
    )
    if w.shape != (n,):
        raise ValueError(f"weights must be [n={n}]; got {w.shape}")
    C = np.zeros((m, m))
    starts = _pair_starts(n, lag, segment_starts)
    np.add.at(C, (s[starts], s[starts + lag]), w[starts])
    if reversible:
        C = 0.5 * (C + C.T)
    rows = C.sum(axis=1)
    T = np.eye(m)
    nz = rows > 0
    T[nz] = C[nz] / rows[nz, None]
    return MSMResult(T, C, lag)


# ---------------------------------------------------------------------------
# Linear baselines: TICA and PCA
# ---------------------------------------------------------------------------


class LinearCV:
    """A fitted linear CV map ``x -> (x - mean) @ components``.

    Returned by :func:`tica` and :func:`pca`. Callable with the same
    ``[n, d] -> [n, k]`` contract as every other CV in the package, so
    it plugs directly into :func:`cv_consistency`, :func:`vamp_score`,
    :func:`free_energy_profile` and :func:`validate_cv` for
    head-to-head comparison with a trained model.

    Attributes:
        mean: ``[d]`` weighted feature mean subtracted before projection.
        components: ``[d, k]`` projection matrix, one column per CV;
            scaled so each output has unit weighted variance on the
            training data (whitened, the kinetic-map convention for
            TICA).
        eigenvalues: ``[k]`` — for TICA, the lagged autocorrelation of
            each component (descending); for PCA, the fraction of total
            weighted variance captured (descending).
        timescales: ``[k]`` implied timescales ``-lag*dt / ln(lam)``
            (TICA only; ``None`` for PCA).
        lag: the lag in frames (TICA only; ``None`` for PCA).
    """

    def __init__(self, mean, components, eigenvalues, timescales=None, lag=None):
        self.mean = mean
        self.components = components
        self.eigenvalues = eigenvalues
        self.timescales = timescales
        self.lag = lag

    def __call__(self, X) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        flat = X.reshape(X.shape[0], -1)
        if flat.shape[1] != self.mean.shape[0]:
            raise ValueError(
                f"expected features of dim {self.mean.shape[0]}; "
                f"got shape {X.shape}"
            )
        return (flat - self.mean) @ self.components

    transform = __call__

    def __repr__(self):  # pragma: no cover - cosmetic
        kind = "tica" if self.lag is not None else "pca"
        return (
            f"LinearCV({kind}, k={self.components.shape[1]}, "
            f"eigenvalues={np.round(self.eigenvalues, 4).tolist()})"
        )


def tica(
    X,
    lag: int,
    n_components: Optional[int] = None,
    weights=None,
    dt: float = 1.0,
    epsilon: float = 1e-10,
    segment_starts=None,
) -> LinearCV:
    """Time-lagged independent component analysis — the linear baseline.

    Solves the generalized eigenproblem :math:`C_{0\\tau} v = \\lambda
    C_{00} v` with symmetrized (reversible) weighted covariance
    estimates over the lagged pairs: both windows contribute to the
    mean and to :math:`C_{00}`, and :math:`C_{0\\tau}` is averaged with
    its transpose, so eigenvalues are real and bounded by 1 even on
    finite data. Weighting follows the package convention (leading
    frame's weight per pair, :func:`autocorrelation`).

    TICA is exactly the best *linear* solution of the transfer-operator
    objective the eigenfunction tasks optimize — which is what makes it
    the mandatory baseline: run it on the same preprocessed features
    (``task.pp_layer`` output) and compare eigenvalues/timescales and
    :func:`vamp_score` against the trained heads. If the network does
    not beat TICA, the extra capacity bought nothing.

    Args:
        X: ``[n, d]`` frame-ordered feature time series over one
            contiguous trajectory (trailing dims beyond the first are
            flattened, so raw ``[n, N, 3]`` coordinates work — though
            aligned/featurized input is what makes physical sense).
        lag: the lag :math:`\\tau` in FRAMES (1 <= lag < n).
        n_components: how many components to keep (default: all
            non-degenerate ones).
        weights: optional per-frame statistical weights
            (``WeightedTrajectory.weights``); uniform if omitted.
        dt: physical time per frame, for the implied timescales.
        epsilon: relative eigenvalue floor of :math:`C_{00}` below
            which degenerate feature directions are dropped.

    Returns:
        :class:`LinearCV` with autocorrelation ``eigenvalues``
        (descending) and implied ``timescales``.
    """
    X = np.asarray(X, dtype=np.float64)
    X = X.reshape(X.shape[0], -1)
    n = X.shape[0]
    lag = int(_as_frame_lags(lag)[0])
    if not 1 <= lag < n:
        raise ValueError(f"lag must lie in [1, n={n}); got {lag}")
    w = (
        np.ones(n, dtype=np.float64)
        if weights is None
        else np.asarray(weights, dtype=np.float64)
    )
    if w.shape != (n,):
        raise ValueError(f"weights must be [n={n}]; got {w.shape}")
    starts = _pair_starts(n, lag, segment_starts)
    a, b = X[starts], X[starts + lag]
    wp = w[starts]
    wp = wp / wp.sum()
    mu = 0.5 * (wp @ a + wp @ b)
    da, db = a - mu, b - mu
    wda, wdb = wp[:, None] * da, wp[:, None] * db
    C00 = 0.5 * (wda.T @ da + wdb.T @ db)
    C0t = wda.T @ db
    C0t = 0.5 * (C0t + C0t.T)
    W = _inv_sqrt(C00, epsilon)  # [d, r]
    lam, V = np.linalg.eigh(W.T @ C0t @ W)
    order = np.argsort(lam)[::-1]
    lam, V = lam[order], V[:, order]
    if n_components is not None:
        k = int(n_components)
        if not 1 <= k <= lam.size:
            raise ValueError(
                f"n_components must lie in [1, {lam.size}] "
                f"(non-degenerate feature rank); got {k}"
            )
        lam, V = lam[:k], V[:, :k]
    components = W @ V  # whitened: unit C00-variance per output
    with np.errstate(divide="ignore", invalid="ignore"):
        ts = -(lag * float(dt)) / np.log(lam)
    ts = np.where(lam >= 1.0, np.inf, ts)
    ts = np.where(lam <= 0.0, np.nan, ts)
    return LinearCV(mu, components, lam, timescales=ts, lag=lag)


def pca(X, n_components: Optional[int] = None, weights=None) -> LinearCV:
    """Weighted principal component analysis — the no-dynamics baseline.

    Projects onto the leading eigenvectors of the weighted feature
    covariance. Outputs are whitened (unit weighted variance), matching
    :func:`tica`; ``eigenvalues`` holds each component's captured
    fraction of the total weighted variance.

    PCA is the best linear solution of the (unregularized) autoencoder
    objective, so it is the natural baseline for
    :class:`~colvarsfinder_tpu_torch.core.AutoEncoderTask`: if the trained
    encoder subspace matches PCA's (:func:`cv_consistency`), the data's
    slow manifold is essentially linear.

    Args:
        X: ``[n, d]`` features (trailing dims flattened).
        n_components: components to keep (default: all non-degenerate).
        weights: optional per-frame weights; uniform if omitted.

    Returns:
        :class:`LinearCV` with variance-fraction ``eigenvalues``.
    """
    X = np.asarray(X, dtype=np.float64)
    X = X.reshape(X.shape[0], -1)
    n = X.shape[0]
    w = (
        np.ones(n, dtype=np.float64)
        if weights is None
        else np.asarray(weights, dtype=np.float64)
    )
    if w.shape != (n,):
        raise ValueError(f"weights must be [n={n}]; got {w.shape}")
    wp = w / w.sum()
    mu = wp @ X
    d = X - mu
    C = (wp[:, None] * d).T @ d
    vals, vecs = np.linalg.eigh((C + C.T) / 2.0)
    order = np.argsort(vals)[::-1]
    vals, vecs = vals[order], vecs[:, order]
    keep = vals > 1e-12 * max(float(vals.max()), 0.0)
    vals, vecs = vals[keep], vecs[:, keep]
    if n_components is not None:
        k = int(n_components)
        if not 1 <= k <= vals.size:
            raise ValueError(
                f"n_components must lie in [1, {vals.size}] "
                f"(non-degenerate feature rank); got {k}"
            )
        vals, vecs = vals[:k], vecs[:, :k]
    total = float(np.trace(C))
    components = vecs / np.sqrt(vals)  # whitened outputs
    return LinearCV(mu, components, vals / max(total, 1e-300))


class CVValidation:
    """Outcome of :func:`validate_cv` — the battery's numbers plus the
    decision rules of ``docs/validation.md`` as booleans.

    Attributes:
        ck: the :class:`CKResult` at the training lag.
        timescales: ``[4, k]`` implied timescales at lags
            ``lag * (1, 2, 4, 8)`` (``nan``/``inf`` where degenerate).
        vamp2: VAMP-2 score, in ``[0, k]``.
        markovian: ``ck.max_deviation < ck_tol`` — the CV relaxes
            single-exponentially at the training lag.
        converged: every head's finite timescale varies less than
            ``plateau_tol`` (relative) across the lag scan — the
            implied timescale no longer depends on the lag.
        passed: ``markovian and converged``.
    """

    def __init__(self, ck, timescales, vamp2, ck_tol, plateau_tol):
        self.ck = ck
        self.timescales = timescales
        self.vamp2 = float(vamp2)
        self.markovian = bool(ck.max_deviation < ck_tol)
        finite = np.isfinite(timescales)
        heads_ok = []
        for j in range(timescales.shape[1]):
            t = timescales[finite[:, j], j]
            heads_ok.append(
                t.size >= 2 and float(t.max() - t.min()) < plateau_tol * float(t.max())
            )
        self.converged = bool(heads_ok and all(heads_ok))
        self.passed = self.markovian and self.converged

    def __repr__(self):
        def mark(ok):
            return "pass" if ok else "FAIL"

        lines = [
            f"CK max deviation {self.ck.max_deviation:.4f} "
            f"[{mark(self.markovian)}]",
            "implied timescales (rows = lag x1/x2/x4/x8):\n"
            + np.array2string(self.timescales, precision=3)
            + f" [{mark(self.converged)}]",
            f"VAMP-2 {self.vamp2:.4f} of max {self.timescales.shape[1]}",
        ]
        return "CVValidation(\n  " + "\n  ".join(lines) + "\n)"


def validate_cv(
    cv_values,
    lag: int,
    dt: float = 1.0,
    weights=None,
    ck_tol: float = 0.05,
    plateau_tol: float = 0.25,
    segment_starts=None,
) -> CVValidation:
    """Run the full validation battery of ``docs/validation.md`` on a
    frame-ordered CV time series in one call.

    Bundles :func:`ck_test` (Markovianity at the training lag),
    :func:`timescales_vs_lag` at ``lag * (1, 2, 4, 8)`` (lag
    convergence), and :func:`vamp_score` (slow content), and applies
    the documented pass thresholds. The thresholds are heuristics —
    inspect the numbers (and the guide) when a verdict is borderline.

    Args:
        cv_values: ``[n]`` or ``[n, k]`` CV series over one contiguous
            trajectory, frame-ordered.
        lag: the training lag in FRAMES (``task.lag_idx``).
        dt: physical time per frame (``WeightedTrajectory.dt``).
        weights: optional per-frame weights.
        ck_tol: ``markovian`` iff CK max deviation is below this.
        plateau_tol: ``converged`` iff each head's finite timescale
            spread across the lag scan is below this fraction of its
            maximum.

    Returns:
        :class:`CVValidation` (its ``repr`` is the printable report).
    """
    lag = int(_as_frame_lags(lag)[0])
    if lag < 1:
        raise ValueError(f"lag must be >= 1 frame; got {lag}")
    ck = ck_test(
        cv_values, lag=lag, n_multiples=4, weights=weights,
        segment_starts=segment_starts,
    )
    ts = timescales_vs_lag(
        cv_values, [lag, 2 * lag, 4 * lag, 8 * lag], dt=dt, weights=weights,
        segment_starts=segment_starts,
    )
    v2 = vamp_score(cv_values, lag, weights=weights, segment_starts=segment_starts)
    return CVValidation(ck, ts, v2, ck_tol, plateau_tol)


def timescales_vs_lag_bootstrap(
    cv_values,
    lags,
    dt: float = 1.0,
    weights=None,
    segment_starts=None,
    n_bootstrap: int = 100,
    block_frames: Optional[int] = None,
    seed: int = 0,
):
    """Moving-block bootstrap confidence band for :func:`timescales_vs_lag`.

    Implied timescales are notoriously reported without uncertainties;
    this resamples the trajectory in contiguous blocks (frames are
    time-correlated) and recomputes the lag-convergence curve per
    replica. Block joints are passed to the estimator as segment
    boundaries so no time-lagged pair ever spans a joint — the replica
    estimator sees only genuine dynamics.

    Args:
        cv_values / lags / dt / weights / segment_starts: as for
            :func:`timescales_vs_lag` (lags in FRAMES, dt physical).
        n_bootstrap: bootstrap replicas.
        block_frames: block length in frames. Must exceed the largest
            lag (shorter blocks contain no pairs at that lag); default
            ``max(n // 50, 4 * max(lags))``.
        seed: RNG seed.

    Returns:
        ``(t, t_lo, t_hi)``, each ``[len(lags), k]``: the point estimate
        (full data) and the 16th/84th bootstrap percentiles (a ~1-sigma
        band). Non-decaying replicas contribute ``nan``/``inf`` and are
        ignored by the nan-aware percentiles; bins where fewer than two
        replicas are finite return ``nan`` bounds.
    """
    x = _as_series(cv_values)
    lags = _as_frame_lags(lags)
    n = x.shape[0]
    max_lag = int(lags.max())
    block = (
        int(block_frames)
        if block_frames
        else max(n // 50, 4 * max_lag)
    )
    if block <= max_lag:
        raise ValueError(
            f"block_frames ({block}) must exceed the largest lag "
            f"({max_lag}) or the replicas contain no pairs at that lag"
        )
    block = min(block, n)
    w = None if weights is None else np.asarray(weights, dtype=np.float64)

    t_point = timescales_vs_lag(
        x, lags, dt=dt, weights=w, segment_starts=segment_starts
    )

    # valid block starts: blocks must not span source-trajectory joints
    if segment_starts is not None and len(np.atleast_1d(segment_starts)) > 1:
        seg = np.asarray(segment_starts, dtype=np.int64)
        bounds = np.concatenate([seg, [n]])
        ok, dropped = [], 0
        for a, b in zip(bounds[:-1], bounds[1:]):
            if b - a >= block:
                ok.append(np.arange(a, b - block + 1))
            else:
                dropped += int(b - a)
        if not ok:
            raise ValueError(
                "no source trajectory is as long as one block; "
                "shorten block_frames"
            )
        if dropped:
            import warnings

            warnings.warn(
                f"{dropped} frames belong to source trajectories shorter "
                f"than one block ({block}); they enter the point estimate "
                "but no bootstrap replica — shorten block_frames to "
                "include them in the band"
            )
        starts_pool = np.concatenate(ok)
    else:
        starts_pool = np.arange(n - block + 1)

    rng = np.random.default_rng(seed)
    n_blocks = int(np.ceil(n / block))
    joints = np.arange(n_blocks) * block  # replica segment boundaries
    reps = []
    for _ in range(int(n_bootstrap)):
        idx = _block_bootstrap_indices(rng, starts_pool, block, n_blocks, n)
        reps.append(
            timescales_vs_lag(
                x[idx], lags, dt=dt,
                weights=None if w is None else w[idx],
                segment_starts=joints,
            )
        )
    reps = np.stack(reps)  # [B, L, k]
    finite = np.isfinite(reps)
    cnt = finite.sum(axis=0)
    masked = np.where(finite, reps, np.nan)
    import warnings

    with warnings.catch_warnings():
        # bins with zero finite replicas hit nanpercentile's 'All-NaN
        # slice' RuntimeWarning — that path is the documented nan-bounds
        # degradation, not a user error
        warnings.simplefilter("ignore", RuntimeWarning)
        lo = np.nanpercentile(masked, 16, axis=0)
        hi = np.nanpercentile(masked, 84, axis=0)
    lo = np.where(cnt >= 2, lo, np.nan)
    hi = np.where(cnt >= 2, hi, np.nan)
    return t_point, lo, hi


class MSMCKResult:
    """Outcome of :func:`msm_ck_test` (set-level Chapman–Kolmogorov).

    Attributes:
        lags: ``[n_multiples]`` frame lags ``lag * (1..n_multiples)``.
        estimated: ``[n_multiples, n, n]`` set-to-set transition
            probabilities re-estimated at each lag.
        predicted: ``[n_multiples, n, n]`` the tau-model propagated,
            ``T(tau)^k`` projected onto the same sets.
        sets: ``[n_states]`` metastable-set index per microstate
            (-1 = inactive), from PCCA+ on the tau-model.
    """

    def __init__(self, lags, estimated, predicted, sets):
        self.lags = np.asarray(lags)
        self.estimated = np.asarray(estimated)
        self.predicted = np.asarray(predicted)
        self.sets = np.asarray(sets)

    @property
    def n_sets(self) -> int:
        return self.estimated.shape[1]

    @property
    def max_deviation(self) -> float:
        """max |estimated - predicted| over lags and set pairs."""
        return float(np.nanmax(np.abs(self.estimated - self.predicted)))

    def __repr__(self):  # pragma: no cover - cosmetic
        return (
            f"MSMCKResult(n_sets={self.n_sets}, lags={self.lags.tolist()}, "
            f"max_deviation={self.max_deviation:.4f})"
        )


def msm_ck_test(
    assignments,
    lag: int,
    n_sets: int = 2,
    n_multiples: int = 4,
    weights=None,
    segment_starts=None,
    n_states: Optional[int] = None,
) -> MSMCKResult:
    """Set-level Chapman–Kolmogorov test of a CV-bin MSM.

    The matrix-level complement of :func:`ck_test` (which tests the CV
    autocorrelation): estimate an MSM at lag :math:`\\tau`, coarse-grain
    its states into ``n_sets`` metastable sets (PCCA+), and compare the
    set-to-set transition probabilities **predicted** by propagating the
    :math:`\\tau`-model (:math:`T(\\tau)^k`) against those
    **re-estimated** from the data at lag :math:`k\\tau` — the standard
    MSM validation. Both sides are projected with the
    :math:`\\tau`-model's stationary distribution and sets, so the
    comparison isolates Markovianity.

    Args:
        assignments: ``[n]`` integer state series (:func:`discretize`).
        lag: base lag :math:`\\tau` in frames.
        n_sets: metastable sets to coarse-grain into.
        n_multiples: test at ``lag * (1 .. n_multiples)``.
        weights / segment_starts / n_states: as for :func:`msm`.

    Returns:
        :class:`MSMCKResult`; ``result.max_deviation`` below ~0.05-0.1
        is the usual pass band. Plot with
        :func:`colvarsfinder_tpu_torch.plotting.plot_msm_ck`.
    """
    if n_multiples < 1:
        raise ValueError("n_multiples must be >= 1")
    lag = int(_as_frame_lags(lag)[0])  # normalize once; k*lag stays exact
    model = msm(
        assignments, lag, n_states=n_states, weights=weights,
        segment_starts=segment_starts,
    )
    sets = model.metastable_assignments(n_sets)
    m = model.n_states
    chi = np.zeros((m, n_sets))
    for i in range(n_sets):
        chi[sets == i, i] = 1.0
    pi = model.stationary
    pi_set = chi.T @ pi
    if np.any(pi_set <= 0):
        raise ValueError(
            f"PCCA+ produced an empty metastable set (weights {pi_set}); "
            "reduce n_sets or refine the discretization"
        )

    def project(T, active=None):
        # restrict the projection weights to states active in THIS
        # estimate — states with pairs at tau but none at k*tau would
        # otherwise contribute msm()'s identity self-loop rows with
        # their full tau-weight, inflating the deviation
        pi_eff = pi if active is None else pi * active
        denom = chi.T @ pi_eff
        if np.any(denom <= 0):
            return np.full((n_sets, n_sets), np.nan)
        M = (chi.T * pi_eff) @ T @ chi
        return M / denom[:, None]

    est, pred = [], []
    Tk = np.eye(m)
    lags_out = lag * np.arange(1, n_multiples + 1)
    for k in range(1, n_multiples + 1):
        Tk = Tk @ model.transition_matrix
        pred.append(project(Tk))
        model_k = msm(
            assignments, lag * k, n_states=m, weights=weights,
            segment_starts=segment_starts,
        )
        est.append(project(model_k.transition_matrix, model_k.active))
    return MSMCKResult(lags_out, est, pred, sets)


# ---------------------------------------------------------------------------
# CV interpretability: input sensitivity / attribution
# ---------------------------------------------------------------------------


class SensitivityResult:
    """Outcome of :func:`cv_sensitivity`.

    Attributes:
        sensitivity: [k, d] per-CV, per-input sensitivity scores
            (weighted RMS gradient, optionally scaled by the input's
            ensemble std so scores compare across inputs with different
            natural scales).
        relative: [k, d] rows normalized to sum 1 — the fraction of CV i's
            response attributable to input d.
        labels: input labels (user-provided or ``x0``..``x{d-1}`` /
            ``atom0``.. when xyz-aggregated).
        aggregated: whether xyz triplets were aggregated to atoms.
    """

    def __init__(self, sensitivity, relative, labels, aggregated):
        self.sensitivity = sensitivity
        self.relative = relative
        self.labels = list(labels)
        self.aggregated = aggregated

    def top(self, cv_idx: int = 0, n: int = 5):
        """The n most influential inputs of CV ``cv_idx`` as
        (label, relative_importance) pairs, descending."""
        order = np.argsort(self.relative[cv_idx])[::-1][:n]
        return [(self.labels[i], float(self.relative[cv_idx, i])) for i in order]


def cv_sensitivity(
    cv_fn: Callable,
    samples,
    weights=None,
    normalize: str = "std",
    aggregate: str = "none",
    labels: Optional[Sequence[str]] = None,
    batch_size: int = 8192,
) -> SensitivityResult:
    r"""Which inputs drive each learned CV component (sensitivity
    analysis, the standard interpretability diagnostic of the
    CV-discovery literature — e.g. mlcolvar's `sensitivity_analysis`).

    For CV components :math:`g_i` and inputs :math:`x_d`,

    .. math::
        s_{id} = \sigma_d\,\sqrt{\mathbb{E}_w\!\left[
            \left(\partial g_i/\partial x_d\right)^2\right]}

    — the weighted RMS input gradient over the provided ensemble, scaled
    by the input's ensemble std :math:`\sigma_d` (``normalize='std'``;
    ``'none'`` for raw gradient RMS) so that "this feature moves the CV"
    accounts for how much the feature itself moves. Rows of ``relative``
    sum to 1.

    Per-sample gradients are taken as the Jacobian of the BATCHED
    function's component sums (k reverse passes, the same
    formulation as the generator loss path — samples are independent,
    so :math:`\partial \sum_n g_i(x_n)/\partial x_n` IS the per-sample
    gradient): one reverse pass of each component's sum on the CV's
    device. The path is chosen by type: a CV that returns numpy (a
    deployed numpy CV) takes central finite differences; a torch CV never
    does, and an error in it raises.

    Args:
        cv_fn: map from a batch of states ``[B, *state]`` to CV values
            ``[B, k]`` (a :class:`~colvarsfinder_tpu_torch.export.ColvarModel`,
            ``task.colvar_model()``, or any callable — including the
            numpy evaluator from
            :func:`~colvarsfinder_tpu_torch.deploy.load_numpy_cv`).
        samples: [n, *state] representative frames (e.g. the training
            trajectory or a subsample).
        weights: optional per-frame weights (mean-1 convention not
            required; normalized internally).
        normalize: ``'std'`` (default) or ``'none'``.
        aggregate: ``'none'`` or ``'xyz'`` — for coordinate states
            [N, 3], L2-combine each atom's x/y/z into one score per atom.
        labels: input labels (feature names, atom names). Defaults to
            ``x{d}`` / ``atom{a}``.
        batch_size: frames per gradient batch.

    Returns:
        :class:`SensitivityResult`.
    """
    samples = np.asarray(samples)
    n = samples.shape[0]
    state_shape = samples.shape[1:]
    d_flat = int(np.prod(state_shape))
    if weights is None:
        w = np.full(n, 1.0 / n)
    else:
        w = np.asarray(weights, dtype=np.float64).reshape(-1)
        if w.shape[0] != n:
            raise ValueError(f"{w.shape[0]} weights for {n} samples")
        w = w / w.sum()

    def _out2d(vals, B):
        # accept [B, k] and plain [B] CV outputs (e.g. committor_fn)
        vals = np.asarray(vals)
        return vals.reshape(B, -1)

    def _jac_numpy(xb):
        # central differences on the flattened input (deployment-artifact
        # path; d is small in feature space)
        B = xb.shape[0]
        x_flat = xb.reshape(B, -1).astype(np.float64)
        k = _out2d(cv_fn(xb), B).shape[1]
        J = np.empty((B, k, d_flat))
        for di in range(d_flat):
            eps = 1e-4 * max(1.0, np.abs(x_flat[:, di]).max())
            xp, xm = x_flat.copy(), x_flat.copy()
            xp[:, di] += eps
            xm[:, di] -= eps
            fp = _out2d(cv_fn(xp.reshape(xb.shape).astype(xb.dtype)), B)
            fm = _out2d(cv_fn(xm.reshape(xb.shape).astype(xb.dtype)), B)
            J[:, :, di] = (fp - fm) / (2 * eps)
        return J

    target = _torch_target(cv_fn, samples[:2])
    jac_fn = _jac_numpy if target is None else _jacobian_torch(
        cv_fn, target, d_flat)

    acc = None
    for lo in range(0, n, batch_size):
        xb = samples[lo: lo + batch_size]
        J = jac_fn(xb)  # [B, k, d]
        contrib = np.einsum("b,bkd->kd", w[lo: lo + batch_size], J**2)
        acc = contrib if acc is None else acc + contrib
    sens = np.sqrt(acc)  # [k, d]

    if normalize == "std":
        flat = samples.reshape(n, -1).astype(np.float64)
        mu = w @ flat
        sigma = np.sqrt(np.maximum(w @ (flat - mu) ** 2, 0.0))
        sens = sens * sigma[None, :]
    elif normalize != "none":
        raise ValueError("normalize must be 'std' or 'none'")

    if aggregate == "xyz":
        if len(state_shape) != 2 or state_shape[-1] != 3:
            raise ValueError(
                f"aggregate='xyz' needs [N, 3] states, got {state_shape}"
            )
        n_atoms = state_shape[0]
        sens = np.sqrt(
            (sens.reshape(sens.shape[0], n_atoms, 3) ** 2).sum(axis=-1)
        )
        default_labels = [f"atom{a}" for a in range(n_atoms)]
    elif aggregate == "none":
        default_labels = [f"x{di}" for di in range(d_flat)]
    else:
        raise ValueError("aggregate must be 'none' or 'xyz'")

    if labels is None:
        labels = default_labels
    elif len(labels) != sens.shape[1]:
        raise ValueError(
            f"{len(labels)} labels for {sens.shape[1]} inputs"
        )

    totals = sens.sum(axis=1, keepdims=True)
    relative = sens / np.where(totals > 0, totals, 1.0)
    return SensitivityResult(sens, relative, labels, aggregate == "xyz")


class CommittorCheck:
    """Outcome of :func:`committor_self_consistency`.

    Attributes:
        bin_centers: mean predicted committor per interior bin (the
            model's own labels), [m].
        msm_committor: the MSM-estimated committor of each bin, [m]
            (nan where the bin is unvisited / unreachable).
        counts: weighted interior population per bin (frame counts when
            no weights were given).
        max_deviation / rmse: |prediction - MSM estimate| over the
            populated bins, weighted by counts for the rmse.
    """

    def __init__(self, bin_centers, msm_committor, counts):
        self.bin_centers = bin_centers
        self.msm_committor = msm_committor
        self.counts = counts
        # gate and weight by the STATISTICAL population (counts carries
        # the weighted bin mass): bins populated only by ~zero-weight
        # frames (e.g. hot-replica spikes in a temperature-MBAR pool)
        # have no usable statistics and must not drive the score
        tiny = 1e-9 * max(float(np.sum(counts)), 1.0)
        ok = (
            np.isfinite(msm_committor)
            & np.isfinite(bin_centers)
            & (counts > tiny)
        )
        dev = np.abs(bin_centers[ok] - msm_committor[ok])
        self.max_deviation = float(dev.max()) if dev.size else float("nan")
        w = counts[ok]
        self.rmse = (
            float(np.sqrt(np.average(dev**2, weights=w)))
            if dev.size else float("nan")
        )

    def __repr__(self):
        return (
            f"CommittorCheck(max_deviation={self.max_deviation:.4f}, "
            f"rmse={self.rmse:.4f}, bins={len(self.bin_centers)})"
        )


def committor_self_consistency(
    q_values,
    in_a,
    in_b,
    lag: int,
    n_bins: int = 20,
    weights=None,
    segment_starts=None,
) -> CommittorCheck:
    r"""Validate a predicted committor against the trajectory's own
    dynamics (the self-consistency test of transition path theory).

    The committor is the unique function with :math:`q = 0` on A,
    :math:`q = 1` on B whose projected dynamics reproduce itself: if the
    prediction is right, the Markov-state-model committor of the
    "frames where the model predicts :math:`q \approx c`" bin is again
    :math:`c`. This estimates exactly that — discretize the interior
    frames by predicted q, fold all A / B frames into two boundary
    states, estimate an MSM at ``lag``, solve its discrete committor
    between the boundary states, and compare per bin. A systematically
    shifted or distorted reaction coordinate shows up as per-bin
    deviation even when it is monotone in the true committor.

    This complements :class:`~colvarsfinder_tpu_torch.core.CommittorTask`'s
    training loss (which can be low for a wrong q when the boundary
    sampling is thin) with a purely data-driven estimate — and works for
    ANY predicted committor (trained here, or imported).

    Args:
        q_values: [n] predicted committor per frame
            (``task.committor_values(traj.trajectory)``).
        in_a / in_b: [n] boolean masks of the A / B sets (the task's
            regions).
        lag: MSM estimation lag in frames — use the data's decorrelation
            scale (e.g. the training ``lag_idx`` of a companion
            eigenfunction task); too-small lags see non-Markovian memory.
        n_bins: interior committor bins on [0, 1].
        weights / segment_starts: as in :func:`msm` (boundaries keep
            lagged pairs within one contiguous source).

    Returns:
        :class:`CommittorCheck` — `max_deviation` well below ~0.1 over
        the populated bins indicates a self-consistent committor.
        Caveat: the check covers POPULATED interior bins only, so it
        cannot flag a committor collapsed near the global crossing
        probability (one populated bin, trivially consistent) — pair it
        with the boundary means ``E[q | A]`` / ``E[1-q | B]``, as
        :func:`~colvarsfinder_tpu_torch.parallel.sweep_committor_checks` does.
    """
    q = np.asarray(q_values, dtype=np.float64).reshape(-1)
    in_a = np.asarray(in_a, dtype=bool).reshape(-1)
    in_b = np.asarray(in_b, dtype=bool).reshape(-1)
    n = q.shape[0]
    if in_a.shape[0] != n or in_b.shape[0] != n:
        raise ValueError("q_values, in_a, in_b must have equal length")
    if (in_a & in_b).any():
        raise ValueError("in_a and in_b overlap")
    if not in_a.any() or not in_b.any():
        raise ValueError("both boundary sets must be non-empty")

    edges = np.linspace(0.0, 1.0, n_bins + 1)
    bin_idx = np.clip(np.digitize(q, edges) - 1, 0, n_bins - 1)
    a_state, b_state = n_bins, n_bins + 1
    assignments = np.where(in_a, a_state, np.where(in_b, b_state, bin_idx))

    model = msm(
        assignments, lag, n_states=n_bins + 2, weights=weights,
        segment_starts=segment_starts,
    )
    q_msm = model.committor([a_state], [b_state])[:n_bins]

    interior = ~(in_a | in_b)
    w = np.ones(n) if weights is None else np.asarray(weights, float)
    counts = np.bincount(
        bin_idx[interior], weights=w[interior], minlength=n_bins
    )
    sums = np.bincount(
        bin_idx[interior], weights=(q * w)[interior], minlength=n_bins
    )
    wsum = np.bincount(
        bin_idx[interior], weights=w[interior], minlength=n_bins
    )
    with np.errstate(invalid="ignore"):
        centers = np.where(wsum > 0, sums / np.maximum(wsum, 1e-300), np.nan)
    return CommittorCheck(centers, q_msm, counts)


def statistical_inefficiency(
    cv_values,
    segment_starts=None,
    *,
    mintime: int = 3,
    max_lag: Optional[int] = None,
) -> np.ndarray:
    """Statistical inefficiency ``g = 1 + 2*tau_int`` of each CV head.

    The integrated-autocorrelation-time estimator of Chodera et al.
    (J. Chem. Theory Comput. 3, 2007; the ``pymbar.timeseries``
    convention): with normalized autocorrelation ``C(t)`` of the series,

    .. math:: g = 1 + 2 \\sum_{t \\ge 1} \\frac{N_t}{N} C(t)

    summed until ``C(t)`` first drops below zero (but at least to
    ``mintime``), where ``N_t`` is the number of valid lagged pairs at
    lag ``t`` (``(1 - t/N)`` for one contiguous trajectory; pairs never
    straddle ``segment_starts`` boundaries for concatenated data). A
    correlated trajectory of ``N`` frames carries only ``N / g``
    independent samples — the number every downstream estimator (MBAR,
    bootstrap bands, committor bins) actually gets.

    Unlike :func:`autocorrelation` this is deliberately UNWEIGHTED:
    ``g`` characterizes the *sampling process* (how fast the chain
    decorrelates), while ``WeightedTrajectory.weights`` are ensemble
    reweighting factors — folding them in would mix the two questions.

    Args:
        cv_values: ``[n]`` or ``[n, k]`` time series IN FRAME ORDER.
        segment_starts: source offsets for concatenated trajectories
            (``WeightedTrajectory.segment_starts``); the correlation sum
            then uses within-segment pairs only.
        mintime: minimum lag to include before the negative-``C`` stop
            rule may trigger (guards against noise at tiny lags).
        max_lag: hard cap on the largest lag summed (default ``n // 2``
            — past half the series length the estimator is pure noise
            anyway). Keeps trended / non-stationary series, whose
            autocorrelation may never cross zero, from degrading to an
            O(n^2) scan (pymbar guards the same way with adaptive lag
            stepping; past lag 256 this implementation also switches to
            geometric lag stepping, each sampled ``C(t)`` standing in
            for the skipped lags).

    Returns:
        ``[k]`` array of ``g >= 1`` (scalar semantics: index ``[0]``
        for a 1-D series).
    """
    y = _as_series(cv_values)
    n, k = y.shape
    mu = y.mean(axis=0)
    var = y.var(axis=0)
    if np.any(var <= 0):
        raise ValueError("constant CV series has no correlation time")
    d = y - mu
    t_max = n if max_lag is None else min(n, int(max_lag) + 1)
    if max_lag is None:
        t_max = max(2, n // 2)
    dense_lags = 256  # dense sum below, geometric stepping above
    g = np.ones(k, dtype=np.float64)
    for h in range(k):
        acc = 0.0
        t, prev_t = 1, 0
        while t < t_max:
            starts = _pair_starts_or_none(n, t, segment_starts)
            if starts is None or starts.size == 0:
                break
            c = float(np.mean(d[starts, h] * d[starts + t, h])) / var[h]
            if c <= 0.0 and t > mintime:
                break
            # each sampled C(t) represents the (prev_t, t] lag gap
            acc += (t - prev_t) * (starts.size / n) * c
            prev_t = t
            t = t + 1 if t < dense_lags else int(np.ceil(t * 1.05))
        g[h] = max(1.0, 1.0 + 2.0 * acc)
    return g


def _pair_starts_or_none(n: int, lag: int, segment_starts):
    """:func:`_pair_starts` that returns ``None`` instead of raising
    when no segment is long enough (the correlation sum just stops)."""
    try:
        return _pair_starts(n, lag, segment_starts)
    except ValueError:
        return None


def decorrelated_indices(
    cv_values,
    segment_starts=None,
    *,
    g=None,
    offset: int = 0,
) -> np.ndarray:
    """Frame indices of an (approximately) independent subsample.

    Strides each trajectory segment by ``ceil(g)`` frames, where ``g``
    is the (maximum-over-heads, conservative) statistical inefficiency
    — the ``pymbar.timeseries.subsample_correlated_data`` workflow.
    Feed the result to MBAR or bootstrap estimators whose error bars
    assume independent samples:

    >>> idx = analysis.decorrelated_indices(cv_series)
    >>> mb = mbar_weights([cv[idx_k] for cv, idx_k in ...], ...)

    Args:
        cv_values: ``[n]`` or ``[n, k]`` series in frame order (used to
            estimate ``g`` when not given).
        segment_starts: concatenated-trajectory boundaries; the stride
            restarts at ``offset`` within each segment.
        g: override the estimated statistical inefficiency (e.g. the
            max over several observables).
        offset: first kept frame within each segment.

    Returns:
        int64 frame indices into the original series, strictly
        increasing.
    """
    y = _as_series(cv_values)
    n = y.shape[0]
    if g is None:
        g = float(np.max(statistical_inefficiency(y, segment_starts)))
    stride = max(1, int(np.ceil(float(g) - 1e-9)))
    if segment_starts is None:
        bounds = np.array([0, n], dtype=np.int64)
    else:
        bounds = np.append(np.asarray(segment_starts, dtype=np.int64), n)
    parts = [
        np.arange(bounds[s] + offset, bounds[s + 1], stride, dtype=np.int64)
        for s in range(bounds.size - 1)
        if bounds[s + 1] - bounds[s] > offset
    ]
    if not parts:
        raise ValueError("offset leaves no frames in any segment")
    return np.concatenate(parts)

"""Post-training analysis of learned collective variables: the part the
replica sweeps rank their replicas with (numpy only, copied from
``colvarsfinder_tpu/analysis.py``):

* :func:`vamp_score` (``analysis.py:582-655``) with ``_as_series``,
  ``_as_frame_lags``, ``_pair_starts`` and ``_inv_sqrt`` (``:364-410,
  566-579``);
* :func:`committor_self_consistency` (``:1801-1885``) with
  :class:`CommittorCheck` (``:1758-1798``), :func:`msm` (``:990-1055``) and
  the part of :class:`MSMResult` it reads (``:710-736, 765-818``: the
  transition matrix and the committor).

The rest of the JAX module is ROADMAP item 16.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = [
    "CommittorCheck",
    "MSMResult",
    "committor_self_consistency",
    "msm",
    "statistical_inefficiency",
    "vamp_score",
]


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

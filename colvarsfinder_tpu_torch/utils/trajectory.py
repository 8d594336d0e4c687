r"""Weighted trajectory container, Boltzmann reweighting and the periodic
and concatenation helpers.

Copied from ``colvarsfinder_tpu/utils/trajectory.py`` (``wrap_trajectory``
and ``unwrap_trajectory`` at :29 and :37, ``WeightedTrajectory`` at :62,
``concatenate_trajectories`` at :247, ``calc_weights`` at :331): host-side
numpy, and no pandas. Text files are parsed by the native reader
(``native_io.load_time_series``, built from ``native/fastio.cpp``) or, where
it cannot be built, by a numpy parser that rounds each number to the
nearest float64 as ``strtod`` does. ``calc_weights`` reads its CSV with the
``csv`` module and writes the weights as pandas' ``to_csv`` does.
"""

from __future__ import annotations

import csv
import math
import os
from typing import Optional

import numpy as np

__all__ = [
    "WeightedTrajectory",
    "calc_weights",
    "concatenate_trajectories",
    "wrap_trajectory",
    "unwrap_trajectory",
]


def wrap_trajectory(coords, box):
    """Wrap coordinates into the primary cell [0, L) per axis
    (orthogonal box lengths [3])."""
    coords = np.asarray(coords)
    box = np.asarray(box, dtype=coords.dtype)
    return np.mod(coords, box)


def unwrap_trajectory(coords, box):
    """Continuity-based unwrap of a wrapped trajectory [n, N, 3]:
    remove box jumps between consecutive frames per atom, so positions
    become continuous in time — the preprocessing alignment layers and
    ``position`` features need (pair-DISTANCE features can instead use
    ``FeatureLayer(box=...)`` directly on wrapped data).

    Assumes true per-frame displacements are below L/2 in every axis
    (the standard continuity condition; holds for any reasonable MD
    output cadence). The first frame is kept as stored.
    """
    coords = np.asarray(coords)
    if coords.ndim != 3:
        raise ValueError(f"expected [n_frames, N, 3], got {coords.shape}")
    box = np.asarray(box, dtype=np.float64).reshape(-1)
    if box.size != 3 or (box <= 0).any():
        raise ValueError(f"box must be 3 positive lengths, got {box}")
    d = np.diff(np.asarray(coords, dtype=np.float64), axis=0)
    shifts = -box * np.round(d / box)  # per-step image corrections
    corr = np.concatenate(
        [np.zeros((1,) + coords.shape[1:]), np.cumsum(shifts, axis=0)]
    )
    return (coords + corr).astype(coords.dtype)


class WeightedTrajectory:
    r"""Trajectory states and per-state importance weights.

    * MD branch: ``universe`` (an MDAnalysis Universe) gives frames
      [n, N, 3] restricted to ``input_ag``, with ``dt`` converted ps -> ns.
    * Text branch: a whitespace text file with rows ``time x_1 ... x_d``.
    * Array branch: ``trajectory`` (+ optional ``weights``, ``dt``).
    * Weights: normalized to mean one, frames outside (min_w, max_w)
      dropped, then normalized to mean one again (both normalizations kept,
      as in the reference).

    Attributes:
        trajectory: [n, N, 3] or [n, d]
        n_frames: number of retained states
        weights: 1-d weights with mean ~1
        dt: time between consecutive states
        segment_starts: frame offsets where each contiguous source
            trajectory begins, or None for one contiguous trajectory
    """

    def __init__(
        self,
        universe=None,
        input_ag=None,
        traj_filename: Optional[str] = None,
        weight_filename: Optional[str] = None,
        min_w: float = 0.0,
        max_w: float = float("inf"),
        verbose: bool = True,
        *,
        trajectory: Optional[np.ndarray] = None,
        weights: Optional[np.ndarray] = None,
        dt: Optional[float] = None,
        segment_starts=None,
    ):
        self.segment_starts = None
        if universe is not None:
            if verbose:
                print("\nloading trajectory to numpy array...", end="")
            if input_ag is None:
                input_atom_indices = universe.atoms.ix
            else:
                input_atom_indices = input_ag.ix
            self.trajectory = universe.trajectory.timeseries(order="fac")[
                :, input_atom_indices, :
            ]
            if verbose:
                print("done.")
            self.n_frames = universe.trajectory.n_frames
            self.dt = universe.trajectory.dt * 1e-3
            seg = getattr(universe.trajectory, "segment_starts", None)
            if seg is not None:
                self.segment_starts = np.asarray(seg, dtype=np.int64)
            if verbose:
                print(
                    "\nTrajectory Info:\n"
                    "  no. of frames in trajectory data: {}\n"
                    "  stepsize: {:.1f}ps\n"
                    "  shape of trajectory data array: {}\n".format(
                        self.n_frames,
                        universe.trajectory.dt,
                        self.trajectory.shape,
                    )
                )
        elif trajectory is not None:
            self.trajectory = np.asanyarray(trajectory)
            self.n_frames = self.trajectory.shape[0]
            self.dt = float(dt) if dt is not None else 1.0
        else:
            if traj_filename is None or not os.path.exists(traj_filename):
                raise FileNotFoundError("trajectory file not found")
            data_block = _load_time_series(traj_filename)
            self.n_frames = data_block.shape[0]
            self.trajectory = data_block[:, 1:]
            self.dt = data_block[1, 0] - data_block[0, 0]

        if segment_starts is not None:
            self.segment_starts = np.unique(
                np.asarray(segment_starts, dtype=np.int64)
            )

        if weights is not None:
            w = np.asarray(weights, dtype=np.float64)
            if self.n_frames != w.shape[0]:
                raise ValueError(
                    f"weights ({w.shape[0]}) and trajectory "
                    f"({self.n_frames} frames) have different lengths"
                )
            self._apply_weight_filter(w, min_w, max_w, verbose)
        elif weight_filename:
            w = _load_first_column(weight_filename)
            if self.n_frames != w.shape[0]:
                raise ValueError(
                    f"weight file has {w.shape[0]} rows but the trajectory "
                    f"has {self.n_frames} frames"
                )
            if verbose:
                print("\nloading weights from file: ", weight_filename)
            self._apply_weight_filter(w, min_w, max_w, verbose)
        else:
            self.weights = np.ones(self.n_frames)

    def _apply_weight_filter(self, w: np.ndarray, min_w, max_w, verbose: bool):
        w = w / w.mean()
        selected = (w > min_w) & (w < max_w)
        if not selected.all():
            self.trajectory = self.trajectory[selected, ...]
            w = w[selected]
            if self.segment_starts is not None:
                kept_before = np.concatenate([[0], np.cumsum(selected)])
                self.segment_starts = np.unique(
                    kept_before[np.asarray(self.segment_starts)]
                )
        w = w / w.mean()
        self.n_frames = self.trajectory.shape[0]
        self.weights = w
        if verbose:
            print(
                "\nAfter selecting states whose weights are in "
                "[{:.3e}, {:.3e}] and renormalization:\n"
                "\nShape of trajectory: {}".format(
                    min_w, max_w, self.trajectory.shape
                )
            )

    def lagged_pairs_count(self, lag_idx: int) -> int:
        return self.n_frames - lag_idx

    def valid_lagged_starts(self, lag_idx: int) -> np.ndarray:
        """Start frames ``i`` whose lagged pair ``(i, i + lag)`` lies within
        one contiguous source trajectory."""
        lag = int(lag_idx)
        if lag < 0:
            raise ValueError(f"lag_idx must be >= 0; got {lag}")
        n = self.n_frames
        if self.segment_starts is None:
            return np.arange(max(n - lag, 0), dtype=np.int64)
        bounds = np.append(np.asarray(self.segment_starts, dtype=np.int64), n)
        parts = [
            np.arange(bounds[s], bounds[s + 1] - lag, dtype=np.int64)
            for s in range(bounds.size - 1)
            if bounds[s + 1] - bounds[s] > lag
        ]
        if not parts:
            return np.empty(0, dtype=np.int64)
        return np.concatenate(parts)


def concatenate_trajectories(trajs, renormalize: bool = True):
    """Pool several :class:`WeightedTrajectory` objects into ONE dataset
    whose lagged pairs respect the source boundaries.

    The reference package trains on a single long trajectory
    (reference core.py:343-346 holds one tensor); in practice data often
    arrives as many short trajectories (independent launches, umbrella
    windows after :func:`~colvarsfinder_tpu_torch.utils.mbar_weights`,
    segments between metadynamics restarts). This returns a
    WeightedTrajectory with frames/weights concatenated and
    ``segment_starts`` recording the source offsets — the training
    tasks and the lag-based analysis estimators
    (``autocorrelation``/``vamp_score``/``tica``/``msm``) then draw
    time-lagged pairs only WITHIN a source trajectory.

    Args:
        trajs: WeightedTrajectory objects with identical state shapes
            and identical ``dt``. Inputs that are themselves
            concatenations keep their internal boundaries.
        renormalize: rescale the pooled weights to mean one (default).
            Each input's weights are mean-one individually (the class
            contract), so pooling weights frames of every source
            equally; pass per-frame cross-trajectory weights (e.g. from
            ``mbar_weights``) to the inputs first if sources should not
            count equally, and set ``renormalize=False`` to keep them
            untouched.

    Returns:
        A new :class:`WeightedTrajectory` (array branch) with
        ``segment_starts`` set.
    """
    trajs = list(trajs)
    if not trajs:
        raise ValueError("need at least one trajectory")
    shape0 = trajs[0].trajectory.shape[1:]
    dt0 = float(trajs[0].dt)
    for t in trajs[1:]:
        if t.trajectory.shape[1:] != shape0:
            raise ValueError(
                f"state shapes differ: {shape0} vs {t.trajectory.shape[1:]}"
            )
        if not np.isclose(float(t.dt), dt0, rtol=1e-6, atol=0.0):
            raise ValueError(
                f"dt differs across trajectories: {dt0} vs {float(t.dt)} "
                "(lagged pairs would mix timescales)"
            )
    starts = []
    offset = 0
    for t in trajs:
        own = (
            np.zeros(1, dtype=np.int64)
            if t.segment_starts is None
            else np.asarray(t.segment_starts, dtype=np.int64)
        )
        starts.append(own + offset)
        offset += t.n_frames
    out = WeightedTrajectory(
        trajectory=np.concatenate([t.trajectory for t in trajs], axis=0),
        dt=dt0,
        verbose=False,
    )
    w = np.concatenate([np.asarray(t.weights, dtype=np.float64) for t in trajs])
    out.weights = w / w.mean() if renormalize else w
    out.segment_starts = np.concatenate(starts)
    return out


def _load_time_series(filename: str) -> np.ndarray:
    """Read a whitespace-delimited trajectory text file into [n, 1+d];
    every number is parsed to the nearest float64, as ``strtod`` does."""
    from . import native_io

    data = native_io.load_time_series(filename)
    if data is not None:
        return data
    with open(filename) as f:
        rows = [ln.split() for ln in f if ln.strip()]
    if not rows:
        raise ValueError(f"{filename}: no rows to read")
    if any(len(r) != len(rows[0]) for r in rows):
        raise ValueError(f"{filename}: rows differ in their column counts")
    # Python's float() rounds to the nearest double, as strtod does
    return np.array([[float(v) for v in r] for r in rows], dtype=np.float64)


def _load_first_column(filename: str) -> np.ndarray:
    """The first column of a headerless text or CSV file, as float64."""
    from . import native_io

    data = native_io.load_time_series(filename)
    if data is not None:
        return data[:, 0].copy()
    with open(filename) as f:
        return np.array(
            [float(ln.replace(",", " ").split()[0])
             for ln in f if ln.strip()],
            dtype=np.float64,
        )


_POW10 = [float(f"1e{k}") for k in range(309)]


def _csv_float(text: str) -> float:
    """A number of the statistics CSV, rounded as pandas' default
    ``read_csv`` converter rounds it, so the weights are those of the JAX
    package bit for bit: up to 17 significant digits gathered into a double
    one digit at a time, then scaled by a power of ten. That is not always
    the nearest double (``float`` is)."""
    s = text.strip(" \t")
    n, i = len(s), 0
    neg = i < n and s[i] == "-"
    if i < n and s[i] in "+-":
        i += 1
    number, exponent, digits = 0.0, 0, 0
    while i < n and s[i].isdigit():
        if digits < 17:
            number = number * 10.0 + (ord(s[i]) - 48)
            digits += 1
        else:
            exponent += 1
        i += 1
    if i < n and s[i] == ".":
        i += 1
        while i < n and s[i].isdigit():
            if digits < 17:
                number = number * 10.0 + (ord(s[i]) - 48)
                digits += 1
                exponent -= 1
            i += 1
    if digits == 0:
        return float(s) if s else math.nan  # nan, inf, or an empty field
    if neg:
        number = -number
    if i < n and s[i] in "eE":
        i += 1
        e_neg = i < n and s[i] == "-"
        if i < n and s[i] in "+-":
            i += 1
        e, k = 0, 0
        while k < 17 and i < n and s[i].isdigit():
            e, k, i = e * 10 + ord(s[i]) - 48, k + 1, i + 1
        exponent += -e if e_neg else e
    if exponent > 308:
        return math.copysign(math.inf, number)
    if exponent >= 0:
        return number * _POW10[exponent]
    if exponent < -616:
        return 0.0 * number
    if exponent < -308:
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def calc_weights(
    csv_filename: str,
    sampling_beta: float,
    sys_beta: float,
    traj_weight_filename: str = "weights.txt",
    energy_col_idx: int = 1,
    verbose: bool = True,
):
    r"""Boltzmann reweighting factors from a statistics CSV:
    :math:`v_i = e^{-(\beta_{sys}-\beta_{sim})(V_i - \bar V)} / Z` with Z
    chosen so the mean weight is one; written headerless, one per line."""
    with open(csv_filename, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], [r for r in rows[1:] if r]
    energy_col_name = header[energy_col_idx]
    if verbose:
        print(f"Reading potential from: {csv_filename}")
        print(
            "Use {:d}th column to reweight, name: {}".format(
                energy_col_idx, energy_col_name
            )
        )

    energy = np.array([_csv_float(r[energy_col_idx]) for r in body],
                      dtype=np.float64)
    mean_energy = energy.mean()

    nonnormalized = np.exp(-(sys_beta - sampling_beta) * (energy - mean_energy))
    weights = nonnormalized / nonnormalized.mean()
    with open(traj_weight_filename, "w") as f:
        f.write(csv_rows(weights))  # headerless, one weight per line
    if verbose:
        print(f"weights saved to: {traj_weight_filename}")
    return weights



def csv_rows(*cols) -> str:
    """Rows of the columns ``cols`` (one value per row each, side by side)
    as pandas' ``to_csv(index=False)`` writes float columns, which the card
    machine cannot import: each value's shortest repr, NaN as an empty
    field."""
    table = np.column_stack([np.asarray(c, dtype=np.float64) for c in cols])
    if np.isnan(table).any():
        return "".join(",".join("" if v != v else repr(v) for v in row)
                       + "\n" for row in table.tolist())
    fmt = ",".join(["%r"] * table.shape[1]) + "\n"
    return (fmt * table.shape[0]) % tuple(table.ravel().tolist())

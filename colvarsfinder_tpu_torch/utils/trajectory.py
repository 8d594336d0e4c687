r"""Weighted trajectory container and Boltzmann reweighting.

Copied from ``colvarsfinder_tpu/utils/trajectory.py`` (``WeightedTrajectory``
at :62, ``calc_weights`` at :331): host-side numpy, with pandas imported only
where a CSV or text file is read. The text-file reader drops the JAX
package's native parser and uses pandas alone.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

__all__ = ["WeightedTrajectory", "calc_weights"]


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
            import pandas as pd

            weight_vec = pd.read_csv(weight_filename, usecols=[0], header=None)
            w = weight_vec[0].to_numpy(dtype=np.float64)
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


def _load_time_series(filename: str) -> np.ndarray:
    """Read a whitespace-delimited trajectory text file into [n, 1+d];
    every number is parsed to the nearest float64, as ``strtod`` does."""
    import pandas as pd

    return pd.read_csv(
        filename, sep=r"\s+", header=None, dtype=np.float64,
        float_precision="round_trip",
    ).to_numpy()


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
    import pandas as pd

    vec = pd.read_csv(csv_filename)
    vec.rename(columns={vec.columns[0]: "Time"}, inplace=True)

    energy_col_name = vec.columns[energy_col_idx]
    if verbose:
        print(f"Reading potential from: {csv_filename}")
        print(
            "Use {:d}th column to reweight, name: {}".format(
                energy_col_idx, energy_col_name
            )
        )

    energy = vec[energy_col_name].to_numpy(dtype=np.float64)
    mean_energy = energy.mean()

    nonnormalized = np.exp(-(sys_beta - sampling_beta) * (energy - mean_energy))
    weights = pd.DataFrame(
        nonnormalized / nonnormalized.mean(), columns=["weight"]
    )

    weights.to_csv(traj_weight_filename, header=False, index=False)
    if verbose:
        print(f"weights saved to: {traj_weight_filename}")
    return weights["weight"].to_numpy()

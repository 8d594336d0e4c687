"""PyTorch port, the copied data container: WeightedTrajectory and
calc_weights against the JAX package's on the same files and arrays, and
the loss dataframe helper."""

import numpy as np
import pytest

from colvarsfinder_tpu.utils import trajectory as jtr

from colvarsfinder_tpu_torch.logging_utils import (
    MetricsWriter,
    losses_to_dataframe,
)
from colvarsfinder_tpu_torch.utils import trajectory as ttr


def _same(a, b):
    np.testing.assert_array_equal(a.trajectory, b.trajectory)
    np.testing.assert_allclose(a.weights, b.weights, rtol=1e-15)
    assert a.n_frames == b.n_frames and a.dt == b.dt
    if a.segment_starts is None:
        assert b.segment_starts is None
    else:
        np.testing.assert_array_equal(a.segment_starts, b.segment_starts)


def test_array_branch_weight_filter_and_segments(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((60, 4, 3)).astype(np.float32)
    w = rng.uniform(0.0, 2.0, 60)
    args = dict(trajectory=x, weights=w, dt=0.5, min_w=0.3, max_w=1.8,
                verbose=False, segment_starts=[0, 25, 40])
    t, j = ttr.WeightedTrajectory(**args), jtr.WeightedTrajectory(**args)
    assert t.n_frames < 60  # the filter dropped frames
    _same(t, j)
    for lag in (0, 3, 20):
        np.testing.assert_array_equal(t.valid_lagged_starts(lag),
                                      j.valid_lagged_starts(lag))
    with pytest.raises(ValueError, match="different lengths"):
        ttr.WeightedTrajectory(trajectory=x, weights=w[:5], verbose=False)
    # a memory-mapped trajectory stays memory-mapped when nothing is dropped
    mm = np.lib.format.open_memmap(tmp_path / "x.npy", mode="w+",
                                   dtype=np.float32, shape=x.shape)
    mm[:] = x
    kept = ttr.WeightedTrajectory(trajectory=mm, weights=np.ones(60),
                                  verbose=False)
    assert isinstance(kept.trajectory, np.memmap)


def test_text_and_weight_files_and_calc_weights(tmp_path):
    rng = np.random.default_rng(1)
    n = 40
    data = np.column_stack([np.arange(n) * 0.25, rng.standard_normal((n, 3))])
    np.savetxt(tmp_path / "traj.txt", data)
    energy = rng.standard_normal(n)
    csv = tmp_path / "stats.csv"
    csv.write_text("time,energy\n" + "".join(
        f"{i},{float(e)!r}\n" for i, e in enumerate(energy)))
    w_t = ttr.calc_weights(str(csv), 1.0, 1.5, str(tmp_path / "wt.txt"),
                           verbose=False)
    w_j = jtr.calc_weights(str(csv), 1.0, 1.5, str(tmp_path / "wj.txt"),
                           verbose=False)
    np.testing.assert_allclose(w_t, w_j, rtol=1e-15)
    assert (tmp_path / "wt.txt").read_text() == (tmp_path / "wj.txt").read_text()
    args = dict(traj_filename=str(tmp_path / "traj.txt"),
                weight_filename=str(tmp_path / "wt.txt"), verbose=False,
                max_w=2.0)
    t, j = ttr.WeightedTrajectory(**args), jtr.WeightedTrajectory(**args)
    _same(t, j)
    assert t.dt == 0.25 and t.trajectory.shape[1] == 3
    with pytest.raises(FileNotFoundError):
        ttr.WeightedTrajectory(traj_filename=str(tmp_path / "missing.txt"))


def test_losses_dataframe_and_disabled_writer(tmp_path):
    rows = [np.arange(4.0), np.arange(4.0) + 1]
    df = losses_to_dataframe(rows, ["loss", "a", "b", "eig_1"])
    assert list(df.columns) == ["loss", "a", "b", "eig_1"]
    np.testing.assert_array_equal(df.to_numpy(), np.stack(rows))
    assert losses_to_dataframe([], ["loss"]).empty
    writer = MetricsWriter(str(tmp_path), enabled=False)
    writer.add_scalars_split(["loss"], [1.0], [2.0], 0)  # a no-op
    writer.close()
    assert not any(tmp_path.iterdir())

"""The CLN025 configuration at a small size on the CPU (12 atoms, 66
distances, heads [66, 16, 16, 16, 1]): its plain reference against a
direct computation, a sound run correct and a run with half of each batch
left out caught, the entry refusing a feature layer without a grouped pair
list, and its two metric readers on records made by hand; on the card, a
short run of the cell at its own size."""

import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from colvarsfinder_tpu_torch import FeatureLayer, logging_utils
from colvarsfinder_tpu_torch.core.eigenfunction import EigenFunctionTask
from portbench import harness
from portbench import trace as trace_mod
from portbench.entries import train_distances
from portbench.references import cln025_transfer as ref_mod

from cells import small

CELL = "cln025_transfer.distances"
ROOT = Path(__file__).resolve().parents[2]


def small_cell():
    wl, cfg = small(CELL)
    cfg.update(n_atoms=12, d_r=66, layer_dims=[66, 16, 16, 16, 1])
    return wl, cfg


def run():
    wl, cfg = small_cell()
    return harness.run(CELL, cfg, wl, 1, "cpu", 2**31 + 777, 0.1, False,
                       time.perf_counter())


def test_reference_features_are_every_pair_distance():
    x = torch.randn(5, 7, 3, dtype=torch.float64)
    want = torch.stack([(x[:, j] - x[:, i]).norm(dim=-1)
                        for i, j in itertools.combinations(range(7), 2)], 1)
    ref_mod.BLOCK, block = 2, ref_mod.BLOCK
    try:
        got = ref_mod.features(x)
    finally:
        ref_mod.BLOCK = block
    torch.testing.assert_close(got, want, rtol=1e-14, atol=0)
    assert ref_mod.pairs(7).tolist() == [
        list(p) for p in itertools.combinations(range(7), 2)]
    # the program's layer takes the same pairs in the same order
    layer = train_distances.feature_layer(7)
    torch.testing.assert_close(layer(x), want, rtol=1e-14, atol=0)


def test_sound_run_is_correct_and_half_batch_is_caught(monkeypatch):
    out = run()
    assert out["correct"], out["checks"]
    metrics = EigenFunctionTask._batch_metrics

    def halve(self, *b):
        return metrics(self, *[t[: t.shape[0] // 2] for t in b])

    monkeypatch.setattr(EigenFunctionTask, "_batch_metrics", halve)
    out = run()
    assert not out["correct"], out["checks"]


def test_half_batch_reference_fails_a_limit_on_the_cpu():
    from portbench import check, data

    wl, cfg = small_cell()
    plan = harness.entry(wl).plan(cfg, wl)
    inputs = data.Inputs(cfg, 2**31 + 99, "cpu")
    half = check.reference_readings(check.follow_reference(
        cfg, inputs, *plan, "cpu", dtype=torch.float32, half=True))
    nums = check.judge(cfg, wl, plan, inputs, half, "cpu")[0]
    limits = wl["checks"]["limits"]
    assert any(v > limits[k] for k, v in nums.items()), nums


def test_entry_refuses_a_layer_without_grouped_pairs(monkeypatch):
    plain = FeatureLayer.__init__

    def ungrouped(self, *a, **kw):
        plain(self, *a, **kw)
        self.pair_groups = ()

    monkeypatch.setattr(FeatureLayer, "__init__", ungrouped)
    with pytest.raises(SystemExit, match="grouped pair list"):
        run()


def event(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_metric_readers():
    from portbench.metrics import pair_distances_roofline, pair_grouped_share

    wl, cfg = harness.load_cell(CELL)
    events = [event("void (anonymous namespace)::pair_distances_kernel(x)",
                    float(10 * i), d) for i, d in enumerate((120, 150, 130))]
    tr = trace_mod.Trace(events, window_s=1e-3, steps=1)
    ctx = harness.Context(CELL, wl, cfg, 1.0, 2.0,
                          [{"wall_s": 2.0, "samples": 4, "steps": 1}], tr)
    nbytes = 4 * 20000 * (3 * 93 + 4278)
    assert pair_distances_roofline.k5_bytes(20000, 93, 4278) == nbytes
    want = 100 * (nbytes / 3.35e12) / 130e-6
    assert pair_distances_roofline.read(ctx) == pytest.approx(want)
    ctx.trace = trace_mod.Trace([], 1e-3, 1)
    assert pair_distances_roofline.read(ctx) is None
    logging_utils.reset_trace()
    assert pair_grouped_share.read(ctx) is None
    logging_utils.count("cvf.features.pairs_grouped", 300)
    logging_utils.count("cvf.features.pairs_single", 100)
    assert pair_grouped_share.read(ctx) == pytest.approx(75.0)
    logging_utils.reset_trace()


@pytest.mark.cuda
def test_short_run_of_the_cell_on_the_card():
    """A short run of the cell at its own size on the card: correct, with
    its end-to-end metrics, and with every distance grouped in its traced
    metrics (card only: skips without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        CELL, "--seed", "2147483700", "--seconds", "3",
                        "--trace", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["metrics"]["pair_grouped_share"]["value"] == 100.0
    assert out["metrics"]["pair_distances_roofline"]["value"] > 0

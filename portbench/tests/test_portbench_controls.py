"""The check's control and planted fault, on one seed (the readings behind
the limits came from ``portbench/calibrate.py`` on more): the TF32 control
(the program with its TF32 path on, or the reference with every product's
operands rounded to TF32 in the program's place) and the reference with
half of each batch left out each fail a number of every cell, on the card
at each cell's own size (card only: each skips without one); the
reference's TF32 control fails ``cv`` at a small size on the CPU too."""

import json
from pathlib import Path

import pytest
import torch

from portbench import calibrate, check, data, harness

from cells import small

SEED = 2147483777
CELLS = ["ala2_transfer.fused", "ala2_transfer.plain", "ala2_generator.gram",
         "ala2_transfer.sweep64"]


def cell_files(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    wl, cfg = harness.load_cell(cell)
    return wl, cfg, harness.entry(wl).plan(cfg, wl)


def fails(cfg, wl, plan, inputs, readings, dev="cuda"):
    limits = wl["checks"]["limits"]
    nums = check.judge(cfg, wl, plan, inputs, readings, dev)[0]
    return {k: v for k, v in nums.items() if v > limits[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_half_batch_fails_on_the_card(cell):
    wl, cfg, plan = cell_files(cell)
    inputs = data.Inputs(cfg, SEED, "cuda", int(wl.get("replicas", 1)))
    epochs = int(wl["epochs_per_call"]) if "replicas" in wl else None
    half = check.reference_readings(check.follow_reference(
        cfg, inputs, *plan, "cuda", dtype=torch.float32, half=True), epochs)
    assert fails(cfg, wl, plan, inputs, half)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_tf32_control_fails_on_the_card(cell):
    wl, cfg, plan = cell_files(cell)
    inputs, readings = calibrate.control_readings(cfg, wl, plan, SEED,
                                                  "cuda")
    assert fails(cfg, wl, plan, inputs, readings)


WORKLOADS = Path(__file__).resolve().parents[1] / "workloads"


@pytest.mark.parametrize("cell", [
    c for c in CELLS if json.loads((WORKLOADS / f"{c}.json").read_text())
    ["checks"]["control"] == "reference_tf32"])
def test_reference_tf32_control_fails_cv_on_the_cpu(cell):
    wl, cfg = small(cell)
    plan = harness.entry(wl).plan(cfg, wl)
    inputs, readings = calibrate.control_readings(cfg, wl, plan,
                                                  2147483999, "cpu")
    assert "cv" in fails(cfg, wl, plan, inputs, readings, "cpu")


def test_tf32_rounding():
    from portbench.references import eigen

    x = torch.tensor([1.0, 1 + 2**-11, 1 + 2**-10 + 2**-12, -3.14159])
    eigen.TF32 = True
    try:
        r = eigen._p(x)
    finally:
        eigen.TF32 = False
    assert r.tolist() == [1.0, 1 + 2**-10, 1 + 2**-10, -3.140625]
    assert eigen._p(x) is x

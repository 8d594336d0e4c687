"""Readings behind the limits of a cell's check, on the card at the cell's
own size: the program's numbers on each seed (sound runs: the lower
reading), the control's (the reference in the precision below the
configuration's, or the program with its own TF32 path switched on, as the
workload's ``checks.control`` says), a planted fault's (the reference put
in the program's place with half of each batch left out) and, in a sweep,
the float32 reference's (TF32 off: the witness of the chaos rule). A state left
unchanged reads 1 on ``change`` by the check's measure and needs no run.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 [--out readings.json]

It prints one line per reading and writes them all as JSON, a sweep's
with every replica's numbers.
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import check, data, harness  # noqa: E402


def program_readings(cfg, wl, seed, dev):
    with tempfile.TemporaryDirectory() as tmp:
        inputs, runner = harness.start(cfg, wl, seed, dev, tmp)
        return inputs, harness.finish(runner, dev)


def control_readings(cfg, wl, plan, seed, dev):
    """``(inputs, readings)`` of the control on ``seed``: the program with
    its TF32 path on, or the reference in TF32 in the program's place."""
    if wl["checks"]["control"] == "program_tf32":
        from colvarsfinder_tpu_torch import config

        config.set_matmul_precision("high")
        try:
            return program_readings(cfg, wl, seed, dev)
        finally:
            config.set_matmul_precision("highest")
    inputs = data.Inputs(cfg, seed, dev, int(wl.get("replicas", 1)))
    epochs = int(wl["epochs_per_call"]) if "replicas" in wl else None
    ref = check.follow_reference(cfg, inputs, *plan, dev,
                                 dtype=torch.float32, tf32=True)
    cv = check.reference_cv(cfg, inputs, ref[3], dev, dtype=torch.float32,
                            tf32=True)
    return inputs, check.reference_readings(ref, epochs, cv)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out")
    a = p.parse_args(argv)
    wl, cfg = harness.load_cell(a.workload)
    plan = harness.entry(wl).plan(cfg, wl)
    R = int(wl.get("replicas", 1))
    sweep_epochs = int(wl["epochs_per_call"]) if "replicas" in wl else None
    levels = wl["checks"].get("chaos")
    dev = harness.check_device(1)
    rows = []

    def record(kind, seed, inputs, readings, ref, n32):
        nums, leaves = check.numbers_of(cfg, inputs, readings, ref, dev)
        row = {"kind": kind, "seed": seed, "numbers": check.worst(nums),
               "leaves": {k: check.worst(g) for k, g in leaves.items()}}
        if R > 1:
            judged = ~check.chaotic(n32, levels) if levels else None
            row["judged"] = check.worst(nums, judged, levels)
            row["per_replica"] = {k: v.tolist() for k, v in nums.items()}
        rows.append(row)
        print(kind, seed, json.dumps(row["numbers"]),
              json.dumps(row.get("judged")), json.dumps(row["leaves"]),
              flush=True)

    def float32_witness(kind, seed, inputs, ref):
        if sweep_epochs is None:
            return None
        ref32 = check.follow_reference(cfg, inputs, *plan, dev,
                                       dtype=torch.float32)
        r32 = check.reference_readings(ref32, sweep_epochs)
        n32, _ = check.per_replica(r32, ref)
        record(kind, seed, inputs, r32, ref, n32)
        return n32

    t0 = time.perf_counter()
    for seed in [int(s) for s in a.seeds.split(",") if s]:
        inputs, readings = program_readings(cfg, wl, seed, dev)
        ref = check.follow_reference(cfg, inputs, *plan, dev)
        n32 = float32_witness("float32_reference", seed, inputs, ref)
        record("program", seed, inputs, readings, ref, n32)
    for seed in [int(s) for s in a.control_seeds.split(",") if s]:
        inputs, readings = control_readings(cfg, wl, plan, seed, dev)
        ref = check.follow_reference(cfg, inputs, *plan, dev)
        n32 = float32_witness("float32_reference", seed, inputs, ref)
        record("control", seed, inputs, readings, ref, n32)
        half = check.reference_readings(check.follow_reference(
            cfg, inputs, *plan, dev, dtype=torch.float32, half=True),
            sweep_epochs)
        record("half_batch", seed, inputs, half, ref, n32)
    print(f"{time.perf_counter() - t0:.1f} s", flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()

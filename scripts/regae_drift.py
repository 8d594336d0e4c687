#!/usr/bin/env python3
"""How far two correct float32 versions of one RegAutoEncoderTask run part
on one NVIDIA card, at chip_smoke.py's phase 7: its frames, widths and
all-six-terms settings, 30 epochs, the transfer regularizer and the
generator regularizer on the Gram path.

    python3 scripts/regae_drift.py

For model seeds 0, 1 and 2, each configuration trains through two plain
alignments (AlignmentLayer method='svd' and method='quaternion') and
through FusedAlignmentLayer (K2); the generator also on its vjp path
through K2. Per seed and pair the script prints the largest relative
difference over the 30 epochs of the loss and of each eigenvalue column:

* svd against quaternion: two plain versions, whose float32 features
  differ by rounding only;
* K2 against quaternion (transfer) and vjp against Gram through K2
  (generator): the pairs chip_smoke.py holds.

chip_smoke.py's ``DRIFT_RTOL`` is twice the largest plain-against-plain
reading, per configuration and column, and never below the training bar.
The last line is the readings as JSON.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import colvarsfinder_tpu_torch as cvf  # noqa: E402
from colvarsfinder_tpu_torch.config import set_matmul_precision  # noqa: E402
from colvarsfinder_tpu_torch.ops import _cuda  # noqa: E402

SEEDS = (0, 1, 2)
# (label, task kind, alignment, eager): the plain SVD runs the transfer
# step eagerly, since the batched SVD checks its status on the host, which
# a capture forbids; on the Gram path the step reads features only
RUNS = {
    "transfer": (("quaternion", "reg", "quaternion", False),
                 ("svd", "reg", "svd", True),
                 ("k2", "reg", "fused", False)),
    "generator": (("quaternion", "gen_gram", "quaternion", False),
                  ("svd", "gen_gram", "svd", False),
                  ("k2", "gen_gram", "fused", False),
                  ("k2 vjp", "gen_vjp", "fused", False)),
}
PAIRS = {
    "transfer": (("svd", "quaternion"), ("k2", "quaternion")),
    "generator": (("svd", "quaternion"), ("k2 vjp", "k2")),
}


def gaps(a, b):
    """The largest relative difference over the epochs, per column (the
    loss and the eigenvalues)."""
    cols = {"loss": 0, **{f"eig_{i}": 4 + i for i in range(cs.K)}}
    return {name: float(np.max(np.abs(a[:, c] - b[:, c]) / np.abs(b[:, c])))
            for name, c in cols.items()}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    set_matmul_precision("highest")  # as chip_smoke.py
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _cuda.build_all()
    ref, traj_np, w_np = cs.make_data(0)
    traj_obj = cvf.WeightedTrajectory(trajectory=traj_np, weights=w_np,
                                      dt=cs.DT, verbose=False)
    out = {"card": card, "epochs": cs.EPOCHS, "seeds": list(SEEDS)}
    with tempfile.TemporaryDirectory() as tmp:
        for config, runs in RUNS.items():
            for seed in SEEDS:
                curves = {}
                for label, kind, method, eager in runs:
                    task = cs.run_ae(cvf, card, kind, traj_obj, ref,
                                     f"{tmp}/{config} {seed} {label}",
                                     cs.EPOCHS, eager, method=method,
                                     seed=seed)[0]
                    curves[label] = task.train_loss
                    task.release_device_data()
                for a, b in PAIRS[config]:
                    got = gaps(curves[a], curves[b])
                    out[f"{config} seed {seed}: {a} vs {b}"] = got
                    print(f"{config}, model seed {seed}, {a} vs {b}: "
                          + ", ".join(f"{k} {v:.3e}" for k, v in got.items())
                          + f" over {cs.EPOCHS} epochs ({card})", flush=True)
            for a, b in PAIRS[config]:
                worst = {k: max(out[f"{config} seed {s}: {a} vs {b}"][k]
                                for s in SEEDS)
                         for k in out[f"{config} seed 0: {a} vs {b}"]}
                out[f"{config}: {a} vs {b}, largest"] = worst
                print(f"{config}, {a} vs {b}, largest over seeds {SEEDS}: "
                      + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()),
                      flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Time of the Gram precompute (``core/eigenfunction.py`` ``gram_batch``)
on one NVIDIA card, at the main path's batch: B = 20,000 frames of 10
atoms from chip_smoke.py's data, through FusedAlignmentLayer (K2) and
position features (d_r = 30), with chip_smoke's diffusion diagonal.

    python3 scripts/gram_precompute.py

``gram_batch`` takes the d_r rows of the per-frame Jacobians from copies
of the batch stacked along the frames, at most ``GRAM_PASS_FRAMES`` frames
per reverse pass. The script times it with one copy per pass (d_r passes
of B frames) and with its default (one pass of d_r * B frames), checks
that both give the same H and M, and prints wall time per batch (host
clock, after a synchronize), K2 launches per batch and the peak of
allocated device memory.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import colvarsfinder_tpu_torch as cvf  # noqa: E402
from colvarsfinder_tpu_torch.config import set_matmul_precision  # noqa: E402
from colvarsfinder_tpu_torch.core import eigenfunction  # noqa: E402
from colvarsfinder_tpu_torch.ops import _cuda  # noqa: E402


D_R = 3 * cs.N_ATOMS  # position features of every atom


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
    dev = torch.device("cuda")
    ref, traj, _ = cs.make_data()
    atoms = list(range(cs.N_ATOMS))
    pp = cvf.PreprocessingANN(
        cvf.FusedAlignmentLayer(ref, atoms),
        cvf.FeatureLayer([cvf.Feature("p", "position", atoms)])).to(dev)
    X = torch.from_numpy(traj[:cs.BATCH]).to(dev)
    dc = torch.from_numpy(cs.GEN_DIAG.astype(np.float32)).to(dev)
    default = eigenfunction.GRAM_PASS_FRAMES
    out, reps = {}, 5
    for label, frames in (("one copy per pass", cs.BATCH),
                          ("default", default)):
        eigenfunction.GRAM_PASS_FRAMES = frames
        eigenfunction.gram_batch(pp, X, dc, D_R)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launch_counts()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            H, M = eigenfunction.gram_batch(pp, X, dc, D_R)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        k2 = _cuda.launch_counts()["fused_align"] / reps
        peak = torch.cuda.max_memory_allocated() / 1e6
        out[label] = (H, M)
        print(f"{label} ({frames} frames per pass): median "
              f"{1e3 * float(np.median(times)):.2f} ms per batch (min "
              f"{1e3 * min(times):.2f}), {k2:g} K2 launches per batch, peak "
              f"allocated {peak:.1f} MB; M {M.numel() * M.element_size() / 1e6:.1f}"
              f" MB ({card})", flush=True)
    eigenfunction.GRAM_PASS_FRAMES = default
    (H1, M1), (H2, M2) = out.values()
    dh = float((H1 - H2).abs().max())
    dm = float(((M1 - M2).abs() / M1.abs().amax()).max())
    print(f"max |H diff| {dh:.3e}, max |M diff| / max |M| {dm:.3e}",
          flush=True)
    if dh > 1e-6 or dm > 1e-5:
        raise SystemExit("the two groupings disagree")


if __name__ == "__main__":
    main()

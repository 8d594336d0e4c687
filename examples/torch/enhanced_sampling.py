"""Enhanced sampling with a learned CV on the PyTorch port (the port of
``examples/enhanced_sampling.py``): the full deployment loop.

The workflow the reference enables via TorchScript + PLUMED
(reference: colvarsfinder/core.py:212-227, utils.py:220-223), run natively:

  1. sample unbiased dynamics on the triple-well circle potential — the
     chain stays trapped in one metastable well;
  2. train a transfer-operator eigenfunction CV on trapped-well data
     augmented with short excursions (what a first pass of CV discovery
     looks like in practice);
  3. run well-tempered metadynamics ALONG the learned CV — each
     deposition block one captured CUDA graph on the card — and verify it
     now visits all three wells;
  4. recover the free-energy profile along the CV from the deposited bias.

Run: python examples/torch/enhanced_sampling.py [--outdir /tmp/cvf_enhanced]
     [--device cpu]
A cut run (the CPU test): --n-steps 1000 --epochs 2; the three-well check
holds at the default size.
"""

import argparse
import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import torch

from colvarsfinder_tpu_torch.core import EigenFunctionTask
from colvarsfinder_tpu_torch.models import EigenFunctions
from colvarsfinder_tpu_torch.utils import (
    WeightedTrajectory,
    integrate_sde_metadynamics,
    integrate_sde_overdamped,
)


class TripleWellCircle:
    """Three wells along the unit circle, radial confinement."""

    dim = 2

    def __init__(self, beta=8.0):
        self.beta = beta

    def V(self, x):
        theta = torch.atan2(x[1], x[0])
        r = torch.sqrt(x[0] ** 2 + x[1] ** 2)
        # minima of 1 + cos(3θ) sit at θ = ±π/3 and π (where cos(3θ) = -1),
        # matching well_of() and the training clusters
        return 1.0 + torch.cos(3.0 * theta) + 8.0 * (r - 1.0) ** 2


def well_of(theta):
    if abs(theta - math.pi / 3) < 0.7:
        return "A"
    if abs(theta + math.pi / 3) < 0.7:
        return "B"
    if abs(abs(theta) - math.pi) < 0.7:
        return "C"
    return None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="/tmp/cvf_enhanced")
    ap.add_argument("--n-steps", type=int, default=200_000)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    dev = args.device
    pot = TripleWellCircle()

    # --- 1. unbiased run: trapped -------------------------------------
    t0 = time.time()
    frames, _ = integrate_sde_overdamped(
        pot, n_steps=args.n_steps,
        sampling_output_path=os.path.join(args.outdir, "unbiased"),
        X0=np.asarray([0.5, -0.866]), step_size=0.001, report_interval=20,
        seed=7, verbose=False, device=dev,
    )
    th = np.arctan2(frames[:, 1], frames[:, 0])
    wells_unbiased = {w for w in map(well_of, th) if w}
    print(f"unbiased ({time.time() - t0:.1f}s): visited wells "
          f"{sorted(wells_unbiased)} (trapped)")

    # --- 2. train a CV on locally-sampled data ------------------------
    rng = np.random.default_rng(0)
    theta = rng.choice(
        [math.pi / 3, math.pi, -math.pi / 3], size=6000
    ) + 0.25 * rng.standard_normal(6000)
    r = 1.0 + 0.06 * rng.standard_normal(6000)
    data = np.stack([r * np.cos(theta), r * np.sin(theta)], 1).astype(
        np.float32
    )
    traj = WeightedTrajectory(trajectory=data, dt=0.01, verbose=False)
    # k = 2: a single eigenfunction cannot separate three metastable
    # states (two wells alias to the same CV value and the bias cannot
    # push into the third) — the same reason the reference trains k >= 2
    task = EigenFunctionTask(
        traj, None, EigenFunctions([2, 20, 20, 1], 2, seed=0),
        os.path.join(args.outdir, "cv"), alpha=10.0,
        eig_weights=[1.0, 0.7], lag_tau=0.01, k=2, learning_rate=0.01,
        batch_size=1000, num_epochs=args.epochs, test_ratio=0.2,
        save_model_every_step=0, verbose=False, tensorboard=False, seed=0,
        device=dev,
    )
    t0 = time.time()
    task.train()
    cv = task.colvar_model()
    print(f"CV trained ({time.time() - t0:.1f}s): final loss "
          f"{task.train_loss[-1, 0]:.4f}")

    # --- 3. metadynamics along the learned CV -------------------------
    with torch.no_grad():
        cv_std = float(cv(torch.from_numpy(data).to(task.device)).std())
    t0 = time.time()
    res = integrate_sde_metadynamics(
        pot, cv, n_steps=args.n_steps,
        sampling_output_path=os.path.join(args.outdir, "metad"),
        X0=np.asarray([0.5, -0.866]), step_size=0.001,
        deposit_interval=100, hill_height=0.35, hill_width=0.35 * cv_std,
        bias_factor=10.0, seed=7, verbose=False, device=dev,
    )
    th = np.arctan2(res.frames[:, 1], res.frames[:, 0])
    wells_metad = {w for w in map(well_of, th) if w}
    print(f"metadynamics along learned CV ({time.time() - t0:.1f}s): "
          f"visited wells {sorted(wells_metad)}; "
          f"{len(res.hill_heights)} hills, final height "
          f"{res.hill_heights[-1]:.4f} (well-tempered decay from "
          f"{res.hill_heights[0]:.4f})")

    # --- 4. per-well free energy from the accumulated bias ------------
    # evaluate F at the CV values of the frames actually visited in each
    # well (the CV at never-visited barrier states is extrapolation and
    # not meaningful); the three wells have equal depth, so converged
    # estimates should agree to ~1 kT
    per_well = {}
    for w in ("A", "B", "C"):
        mask = np.asarray([well_of(t) == w for t in th])
        if mask.any():
            per_well[w] = float(
                res.free_energy(res.cv_values[mask]).mean()
            )
    lo = min(per_well.values())
    print("per-well free energy from deposited bias (kT, min-shifted; "
          "equal-depth wells should agree):")
    for w, fe in sorted(per_well.items()):
        print(f"  well {w}: F = {fe - lo:5.2f}")
    spread = max(per_well.values()) - lo
    print(f"  spread: {spread:.2f} kT")

    if args.n_steps >= 200_000 and args.epochs >= 60:
        assert wells_metad == {"A", "B", "C"}, (
            f"metadynamics along the learned CV should visit all three "
            f"wells, got {sorted(wells_metad)}"
        )
        print("OK: learned-CV metadynamics visited all three wells "
              f"(unbiased run saw {len(wells_unbiased)})")

    # --- 5. close the loop: reweight the biased frames and RETRAIN ----
    # (the reference ecosystem's PLUMED-reweight + calc_weights step);
    # the retrained CV now sees barrier-crossing data from all wells
    w = res.frame_weights(method="tiwary")
    traj2 = WeightedTrajectory(
        trajectory=res.frames.astype(np.float32), weights=w,
        dt=0.001 * 100, verbose=False,
    )
    task2 = EigenFunctionTask(
        traj2, None, EigenFunctions([2, 20, 20, 1], 2, seed=1),
        os.path.join(args.outdir, "cv2"), alpha=10.0,
        eig_weights=[1.0, 0.7], lag_tau=0.001 * 100, k=2,
        learning_rate=0.01, batch_size=min(500, len(w) // 2),
        num_epochs=max(2, args.epochs * 2 // 3), test_ratio=0.2,
        save_model_every_step=0, verbose=False, tensorboard=False, seed=1,
        device=dev,
    )
    t0 = time.time()
    task2.train()
    print(f"retrained CV on reweighted metadynamics frames "
          f"({time.time() - t0:.1f}s): {len(w)} frames, "
          f"effective sample size {w.sum() ** 2 / (w ** 2).sum():.0f}, "
          f"final loss {task2.train_loss[-1, 0]:.4f}")
    assert np.isfinite(task2.train_loss).all()


if __name__ == "__main__":
    main()

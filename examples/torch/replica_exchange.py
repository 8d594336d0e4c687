r"""Replica exchange on the PyTorch port (the port of
``examples/replica_exchange.py``): sampling a trapped system and training
on the ladder.

A 2D double well at beta = 8 (an 8 kT barrier along x1): a single chain
at the target temperature never leaves its starting well, so neither CV
training nor free-energy estimation can see the second basin. The
replica-exchange ladder (`integrate_sde_remd`) runs every temperature
slot as one chain batch, the Metropolis swaps on the device (each report
block one captured CUDA graph on the card); the cold
slot samples its exact Boltzmann distribution while inheriting barrier
crossings from the hot slots. Temperature-MBAR pools ALL slots into one
training-ready dataset (swap teleports become lag-safe segment
boundaries), on which we train a transfer-operator CV and a committor.

Run:  python examples/torch/replica_exchange.py [--outdir /tmp/cvf_remd]
      [--device cpu]
A cut run (the CPU test): --n-steps 4000 --epochs 2; the checks on the
trained CV and committor hold at the default sizes.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

from colvarsfinder_tpu_torch import CommittorTask, create_sequential_nn
from colvarsfinder_tpu_torch.core import EigenFunctionTask
from colvarsfinder_tpu_torch.models import EigenFunctions
from colvarsfinder_tpu_torch.utils import (
    integrate_sde_overdamped,
    integrate_sde_remd,
)

BETA = 8.0


class DoubleWell2D:
    """V = (x1^2 - 1)^2 + 4 x2^2 — barrier 1 at x1 = 0 (8 kT at beta 8)."""

    dim = 2
    beta = BETA

    def V(self, x):
        return (x[0] ** 2 - 1.0) ** 2 + 4.0 * x[1] ** 2


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="/tmp/cvf_remd")
    ap.add_argument("--n-steps", type=int, default=200_000)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    dev = args.device
    full = args.n_steps >= 200_000 and args.epochs >= 100
    os.makedirs(args.outdir, exist_ok=True)
    pot = DoubleWell2D()

    # --- the control: one chain at the target temperature is trapped ---
    single, _ = integrate_sde_overdamped(
        pot, args.n_steps, os.path.join(args.outdir, "single"),
        X0=np.array([-1.0, 0.0]), step_size=0.004, report_interval=20,
        seed=1, verbose=False, device=dev,
    )
    frac = (single[:, 0] > 0).mean()
    print(f"single chain at beta={BETA}: right-well fraction {frac:.3f} "
          f"(trapped)")

    # --- the ladder: one chain batch, swaps on the device ---
    betas = [8.0, 4.0, 2.0, 0.8]
    res = integrate_sde_remd(
        pot, betas, args.n_steps, os.path.join(args.outdir, "remd"),
        X0=np.array([-1.0, 0.0]), step_size=0.004, report_interval=20,
        exchange_interval=200, seed=1, verbose=False, device=dev,
    )
    print(f"REMD betas {betas}: pair acceptance "
          f"{np.round(res.pair_acceptance, 3)}")
    frac_cold = (res.frames[0, :, 0] > 0).mean()
    print(f"cold slot right-well fraction {frac_cold:.3f} "
          f"(crosses the 8 kT barrier)")
    if full:
        assert 0.1 < frac_cold < 0.9, "cold slot should visit both wells"

    # --- pool ALL slots: temperature MBAR + swap-safe boundaries ---
    traj = res.to_weighted_trajectory()  # target = coldest beta (8)
    x1, w = traj.trajectory[:, 0], traj.weights
    frac_w = float(np.average(x1 > 0, weights=w))
    print(f"pooled dataset: {traj.n_frames} frames "
          f"({len(traj.segment_starts)} segments incl. swap boundaries), "
          f"weighted right-well fraction {frac_w:.3f}")

    # --- transfer-operator CV on the pooled data ---
    task = EigenFunctionTask(
        traj, None, EigenFunctions([2, 20, 20, 1], 1, seed=0),
        os.path.join(args.outdir, "cv"),
        alpha=10.0, eig_weights=[1.0], lag_tau=traj.dt * 2, k=1,
        batch_size=min(5_000, traj.n_frames // 2), num_epochs=args.epochs,
        save_model_every_step=0, verbose=False, tensorboard=False, seed=0,
        device=dev,
    )
    task.train()
    cv = task.colvar_model()
    wells = np.array([[-1.0, 0.0], [1.0, 0.0]], dtype=np.float32)
    with torch.no_grad():
        cw = cv(torch.from_numpy(wells).to(task.device)).cpu().numpy().ravel()
    print(f"eigenfunction CV at the wells: {np.round(cw, 3)} "
          f"(separated: {abs(cw[1] - cw[0]) > 0.5})")
    if full:
        assert abs(cw[1] - cw[0]) > 0.5, "CV should separate the wells"

    # --- committor on the same data ---
    ctask = CommittorTask(
        traj, None, create_sequential_nn([2, 20, 20, 1], seed=0),
        os.path.join(args.outdir, "committor"),
        region_a=traj.trajectory[:, 0] < -0.8,
        region_b=traj.trajectory[:, 0] > 0.8,
        alpha=300.0, beta=BETA, batch_size=min(5_000, traj.n_frames // 2),
        num_epochs=4 * args.epochs, save_model_every_step=0,
        verbose=False, tensorboard=False, seed=0, device=dev,
    )
    ctask.train()
    probes = np.array([[-1.0, 0.0], [0.0, 0.0], [1.0, 0.0]], np.float32)
    q = ctask.committor_values(probes)
    print(f"committor q(-1, 0, 1) = {np.round(q, 3)}")
    assert np.isfinite(q).all() and np.isfinite(task.train_loss).all()
    if full:
        assert q[0] < 0.1 and q[2] > 0.9, "committor boundary conditions"


if __name__ == "__main__":
    main()

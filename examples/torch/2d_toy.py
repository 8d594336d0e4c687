r"""End-to-end 2D toy workflow on the PyTorch port (the port of
``examples/2d_toy.py``; counterpart of the reference's
examples/2d/2d.ipynb): triple-well potential along a circle, SDE sampling,
reweighting, then all four training tasks and the validation battery.

The potential is V(x) = V1(theta) + (r - 1)^2 / eps + 5 exp(-5 r^2), with
V1 a piecewise function of the angle, written once in torch; the sampler
takes its drift by autograd, each report block one captured CUDA graph on
the card.

Run:  python examples/torch/2d_toy.py [--epochs 50] [--outdir /tmp/2d]
      [--device cpu]
A cut run (the CPU test): --n-steps 3000 --step-size 0.01
--report-interval 10 --epochs 2 --batch-size 100; the committor's checks
hold at the default sizes.
"""

import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

from colvarsfinder_tpu_torch import CommittorTask, create_sequential_nn
from colvarsfinder_tpu_torch.analysis import (
    ck_test,
    committor_self_consistency,
    discretize,
    msm_ck_test,
    tica,
    timescales_vs_lag,
    vamp_score,
)
from colvarsfinder_tpu_torch.core import (
    AutoEncoderTask,
    EigenFunctionTask,
    RegAutoEncoderTask,
)
from colvarsfinder_tpu_torch.models import (
    AutoEncoder,
    EigenFunctions,
    RegAutoEncoder,
)
from colvarsfinder_tpu_torch.utils import (
    WeightedTrajectory,
    calc_weights,
    integrate_sde_overdamped,
)


class TripleWellPotAlongCircle:
    """Triple well along the unit circle, in torch; grad by autograd."""

    def __init__(self, beta: float = 1.0, eps: float = 0.5):
        self.beta = beta
        self.eps = eps
        self.dim = 2

    def V(self, x):
        theta = torch.atan2(x[1], x[0])
        r2 = x[0] ** 2 + x[1] ** 2
        r = torch.sqrt(r2)
        third = math.pi / 3
        v_hi = (1.0 - (theta * 3.0 / math.pi - 1.0) ** 2) ** 2
        v_lo = (1.0 - (theta * 3.0 / math.pi + 1.0) ** 2) ** 2
        v_mid = 3.0 / 5.0 - 2.0 / 5.0 * torch.cos(3.0 * theta)
        v1 = torch.where(theta > third, v_hi,
                         torch.where(theta < -third, v_lo, v_mid))
        return v1 + (r - 1.0) ** 2 / self.eps + 5.0 * torch.exp(-5.0 * r2)


def cv_values(cv, x, device):
    """A CV of numpy frames, on its device, as numpy."""
    with torch.no_grad():
        return cv(torch.as_tensor(x, dtype=torch.float32,
                                  device=device)).cpu().numpy()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="/tmp/cvf2d")
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--n-steps", type=int, default=500_000)
    ap.add_argument("--batch-size", type=int, default=1000)
    ap.add_argument("--report-interval", type=int, default=100)
    ap.add_argument("--step-size", type=float, default=0.001)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    dev = args.device
    full = (args.n_steps >= 500_000 and args.epochs >= 50
            and args.step_size <= 0.001)

    os.makedirs(args.outdir, exist_ok=True)
    pot = TripleWellPotAlongCircle(beta=1.0, eps=0.5)

    # --- 1. sample trajectory (each report block one captured graph) ---
    t0 = time.time()
    integrate_sde_overdamped(
        pot, n_steps=args.n_steps, sampling_output_path=args.outdir,
        X0=np.asarray([0.0, 1.0]), step_size=args.step_size,
        report_interval=args.report_interval,
        seed=30, verbose=True, device=dev,
    )
    print(f"sampling took {time.time() - t0:.2f}s")

    # --- 2. weights (same temperature -> all ones) ---
    calc_weights(
        os.path.join(args.outdir, "output.csv"), pot.beta, pot.beta,
        os.path.join(args.outdir, "weights.txt"), verbose=False,
    )
    traj = WeightedTrajectory(
        traj_filename=os.path.join(args.outdir, "traj.txt"),
        weight_filename=os.path.join(args.outdir, "weights.txt"),
        verbose=True,
    )

    common = dict(
        learning_rate=0.005, batch_size=args.batch_size,
        num_epochs=args.epochs, test_ratio=0.2,
        save_model_every_step=0, verbose=False, tensorboard=False, seed=30,
        device=dev,
    )
    k = 1

    def last(task, col):
        return float(task.train_loss[-1, task.loss_names.index(col)])

    # --- 3a. autoencoder ---
    model = AutoEncoder([2, 20, 20, 20, k], [k, 20, 20, 2], seed=30)
    task = AutoEncoderTask(
        traj, None, model, model_path=os.path.join(args.outdir, "ae"),
        **common,
    )
    t0 = time.time()
    task.train()
    print(f"[AE]       final train loss {last(task, 'loss'):.6f} "
          f"({time.time()-t0:.1f}s)")

    # --- 3b. eigenfunctions of the generator ---
    model = EigenFunctions([2, 20, 20, 20, 1], k, seed=30)
    task = EigenFunctionTask(
        traj, None, model, model_path=os.path.join(args.outdir, "eig_gen"),
        alpha=20.0, eig_weights=[1.0], diag_coeff=np.ones(2), beta=1.0,
        lag_tau=0.0, k=k, **common,
    )
    t0 = time.time()
    task.train()
    print(f"[EigenGen] final eig_1 {last(task, 'eig_1'):.6f} "
          f"({time.time()-t0:.1f}s)")

    # --- 3c. eigenfunctions of the transfer operator ---
    model = EigenFunctions([2, 20, 20, 20, 1], k, seed=30)
    task = EigenFunctionTask(
        traj, None, model, model_path=os.path.join(args.outdir, "eig_top"),
        alpha=20.0, eig_weights=[1.0], lag_tau=0.2, k=k, **common,
    )
    t0 = time.time()
    task.train()
    print(f"[EigenTOp] final eig_1 {last(task, 'eig_1'):.6f} "
          f"({time.time()-t0:.1f}s)")

    # --- 3c'. validate the transfer-op CV: is it Markovian at the lag? ---
    cv_top = task.colvar_model()
    y = cv_values(cv_top, traj.trajectory, dev)
    lag_frames = task.lag_idx
    ck = ck_test(y, lag=lag_frames, n_multiples=4, weights=traj.weights)
    ts = timescales_vs_lag(
        y, [lag_frames, 2 * lag_frames, 4 * lag_frames], dt=traj.dt,
        weights=traj.weights,
    )
    print(f"[EigenTOp] CK max deviation {ck.max_deviation:.4f} "
          f"(Markovian CVs sit well below ~0.05); implied timescale vs lag: "
          + np.array2string(ts[:, 0], precision=3))

    # set-level CK on the CV-bin MSM (the matrix-level complement)
    idx, _bin_centers = discretize(y[:, 0], n_bins=30)
    mck = msm_ck_test(idx, lag=lag_frames, n_sets=3, n_multiples=3,
                      weights=traj.weights)
    print(f"[EigenTOp] MSM set-level CK max deviation "
          f"{mck.max_deviation:.4f} over 3 PCCA+ sets")

    # --- 3c''. beat the linear baseline? TICA on the same input ---
    base = tica(traj.trajectory, lag=lag_frames, weights=traj.weights,
                n_components=k, dt=traj.dt)
    v_nn = vamp_score(y, lag_frames, weights=traj.weights)
    v_lin = vamp_score(base(traj.trajectory), lag_frames, weights=traj.weights)
    print(f"[EigenTOp] VAMP-2 trained {v_nn:.4f} vs TICA baseline {v_lin:.4f} "
          f"(TICA timescale {base.timescales[0]:.3f}; the slow mode here is "
          f"the circle angle — nonlinear — so the network should win)")

    # --- 3d. regularized autoencoder ---
    model = RegAutoEncoder([2, 20, 20, 20, 1], [1, 20, 20, 2],
                           [1, 20, 20, 1], K=1, seed=30)
    task = RegAutoEncoderTask(
        traj, None, model, model_path=os.path.join(args.outdir, "regae"),
        eig_weights=[1.0], gamma=[1.0, 20.0], eta=[0.0, 0.0, 0.0],
        lag_tau_ae=0.1, lag_tau_reg=0.1, **common,
    )
    t0 = time.time()
    task.train()
    print(f"[RegAE]    final train loss {last(task, 'loss'):.6f} "
          f"({time.time()-t0:.1f}s)")

    # --- 3e. committor between the two outer wells: wells sit at
    # theta = -2pi/3 (A) and +2pi/3 (B); by the symmetry of the middle
    # channel, q ~ 0.5 at the theta=0 well ---
    theta_traj = np.arctan2(traj.trajectory[:, 1], traj.trajectory[:, 0])
    ctask = CommittorTask(
        traj, None, create_sequential_nn([2, 20, 20, 1], seed=30),
        os.path.join(args.outdir, "committor"),
        region_a=np.abs(theta_traj + 2 * math.pi / 3) < 0.3,
        region_b=np.abs(theta_traj - 2 * math.pi / 3) < 0.3,
        alpha=300.0, beta=pot.beta,
        **{**common, "num_epochs": 8 * args.epochs},
    )
    t0 = time.time()
    ctask.train()
    wells = np.array(
        [[np.cos(a), np.sin(a)] for a in (-2 * math.pi / 3, 0.0, 2 * math.pi / 3)],
        dtype=np.float32,
    )
    qw = ctask.committor_values(wells)
    print(f"[Committor] q(A well)={qw[0]:.3f} q(mid)={qw[1]:.3f} "
          f"q(B well)={qw[2]:.3f} ({time.time()-t0:.1f}s; the symmetric "
          f"channel puts the mid well near 0.5, up to sampling asymmetry)")
    if full:  # the run at the script's default sizes
        assert qw[0] < 0.15 and qw[2] > 0.85, "committor boundary conditions"
        assert 0.25 < qw[1] < 0.75, "mid-well committor should be intermediate"

    # self-consistency (docs/validation.md section 8)
    chk = committor_self_consistency(
        ctask.committor_values(traj.trajectory),
        np.abs(theta_traj + 2 * math.pi / 3) < 0.3,
        np.abs(theta_traj - 2 * math.pi / 3) < 0.3,
        lag=2, n_bins=10, weights=traj.weights,
    )
    print(f"[Committor] self-consistency max deviation "
          f"{chk.max_deviation:.3f} (<= ~0.1 passes)")

    # --- 4. the CV model of the RegAE run on a grid ---
    cv = task.colvar_model()
    grid = np.stack(
        np.meshgrid(np.linspace(-2, 2, 20), np.linspace(-2, 2, 20)), -1
    ).reshape(-1, 2).astype(np.float32)
    vals = cv_values(cv, grid, dev)
    assert np.isfinite(vals).all()
    print("CV on grid: min %.4f max %.4f" % (vals.min(), vals.max()))


if __name__ == "__main__":
    main()

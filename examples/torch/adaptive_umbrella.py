"""Closed-loop CV discovery + free-energy estimation, start to finish, on
the PyTorch port (the port of ``examples/adaptive_umbrella.py``).

The workflow the reference ecosystem assembles by hand across
TorchScript/PLUMED round trips (reference: colvarsfinder/core.py:212-227
export, utils.py:220-223 bias, utils.py:354-417 reweight), run natively
end to end:

  1. ``workflow.adaptive_cv_discovery`` — unbiased bootstrap (trapped in
     one well of a 2D double-well), then rounds of well-tempered
     metadynamics ALONG the current CV + Tiwary reweighting + retraining
     on the pooled data;
  2. ``utils.integrate_sde_steered`` — a steered pull along the FINAL
     learned CV: Jarzynski free-energy first estimate + per-window
     equilibrium seeds;
  3. ``utils.integrate_sde_umbrella`` — umbrella windows along the CV,
     all windows as one chain batch (each report block one captured CUDA
     graph on the card), seeded by the pull;
  4. MBAR recombination -> unbiased weights -> reweighted free-energy
     profile along the CV, with moving-block bootstrap error bars,
     validated against the analytic double-well (plus the
     statistical-inefficiency subsample count);
  5. ``plotting`` — the standard figures (CV contour, FES with error
     band, steered work accounting) written as PNGs with ``--plot``
     (matplotlib).

Run: python examples/torch/adaptive_umbrella.py [--outdir /tmp/cvf_adaptive]
     [--device cpu] [--plot]
A cut run (the CPU test): --rounds 2 --unbiased-steps 2000
--metad-steps 2000 --umbrella-steps 600 --pre-steps 300 --epochs 2; the
exploration and correlation checks hold at the default sizes.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import torch

from colvarsfinder_tpu_torch import analysis, plotting
from colvarsfinder_tpu_torch.core import EigenFunctionTask
from colvarsfinder_tpu_torch.models import EigenFunctions
from colvarsfinder_tpu_torch.utils import (
    integrate_sde_steered,
    integrate_sde_umbrella,
)
from colvarsfinder_tpu_torch.workflow import adaptive_cv_discovery


class DoubleWell2D:
    """V = (x1^2 - 1)^2 + 8 x2^2: wells at x1 = +-1, ~1 kT x 6 barrier."""

    dim = 2
    beta = 6.0

    def V(self, x):
        return (x[0] ** 2 - 1.0) ** 2 + 8.0 * x[1] ** 2

    def gradV(self, x):
        return torch.stack([4.0 * x[0] * (x[0] ** 2 - 1.0), 16.0 * x[1]])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="/tmp/cvf_adaptive_umbrella")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--unbiased-steps", type=int, default=40_000)
    ap.add_argument("--metad-steps", type=int, default=40_000)
    ap.add_argument("--umbrella-steps", type=int, default=30_000)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--pre-steps", type=int, default=3_000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--plot", action="store_true",
                    help="write the figures (matplotlib)")
    args = ap.parse_args()
    dev = args.device
    full = (args.rounds >= 3 and args.unbiased_steps >= 40_000
            and args.metad_steps >= 40_000 and args.epochs >= 30)
    os.makedirs(args.outdir, exist_ok=True)
    pot = DoubleWell2D()

    # ------------------------------------------------------------------
    # 1. adaptive discovery: sample -> train -> bias -> reweight -> retrain
    # ------------------------------------------------------------------
    def make_task(traj, r):
        return EigenFunctionTask(
            traj, None, EigenFunctions([2, 20, 20, 1], 1, seed=r),
            os.path.join(args.outdir, f"cv{r}"), alpha=10.0,
            eig_weights=[1.0], lag_tau=traj.dt, k=1, learning_rate=0.01,
            batch_size=min(500, traj.n_frames // 2), num_epochs=args.epochs,
            save_model_every_step=0, verbose=False, tensorboard=False,
            seed=r, device=dev,
        )

    t0 = time.time()
    res = adaptive_cv_discovery(
        pot, make_task, n_rounds=args.rounds, X0=np.array([1.0, 0.0]),
        unbiased_steps=args.unbiased_steps, metad_steps=args.metad_steps,
        step_size=0.005, frame_interval=50, hill_height=0.6,
        bias_factor=8.0, output_path=os.path.join(args.outdir, "sampling"),
        seed=3, verbose=True, device=dev,
    )
    print(f"adaptive loop: {time.time() - t0:.1f}s")
    for r in res.rounds:
        x1 = r.segment.trajectory[:, 0]
        print(f"  round {r.index}: new-segment x1 range "
              f"[{x1.min():+.2f}, {x1.max():+.2f}]")
    spans = res.cv_range_per_round().ravel()
    print(f"  exploration signal (CV range per round): {np.round(spans, 2)}")
    if full:
        assert res.rounds[0].segment.trajectory[:, 0].min() > -0.5, (
            "bootstrap trapped")
        assert res.rounds[-1].segment.trajectory[:, 0].min() < -0.5, (
            "biased rounds should cross the barrier"
        )

    cv_model = res.cv_model
    with torch.no_grad():
        cv_pooled = cv_model(torch.from_numpy(res.pooled.trajectory).to(
            res.task.device)).cpu().numpy().reshape(-1)
    r_x1 = np.corrcoef(cv_pooled, res.pooled.trajectory[:, 0])[0, 1]
    print(f"final CV vs slow coordinate: R = {r_x1:+.3f}")
    if full:
        assert abs(r_x1) > 0.9

    # ------------------------------------------------------------------
    # 2. steered pull along the learned CV: a first nonequilibrium
    #    free-energy estimate (Jarzynski) + equilibrium-path seeds for
    #    the umbrella windows
    # ------------------------------------------------------------------
    # the chain batch [c, 2]: each row's first head
    cv1 = lambda x: cv_model(x).reshape(x.shape[0], -1)[:, :1]  # noqa: E731
    lo, hi = np.quantile(cv_pooled, [0.02, 0.98])
    centers = np.linspace(lo, hi, 16)
    # restraint fluctuation width sqrt(1/(beta*kappa)) = spacing / 2,
    # the standard overlap-without-slack choice
    spacing = centers[1] - centers[0]
    kappa = 4.0 / (pot.beta * spacing**2)
    t0 = time.time()
    pull = integrate_sde_steered(
        pot, cv1, cv_start=lo, cv_end=hi, kappa=float(10 * kappa),
        n_steps=args.umbrella_steps, n_realizations=16,
        X0=np.array([1.0, 0.0]), pre_steps=args.pre_steps, step_size=0.003,
        report_interval=50, seed=7, verbose=False, device=dev,
    )
    dF_pull = pot.beta * pull.jarzynski()
    print(f"steered pull ({time.time() - t0:.1f}s): Jarzynski barrier "
          f"~{(dF_pull.max() - dF_pull.min()):.2f} kT along the CV; "
          f"dissipation {pot.beta * pull.dissipated_work[-1]:.2f} kT")

    # ------------------------------------------------------------------
    # 3. umbrella windows along the learned CV (one chain batch),
    #    each window seeded inside its own basin by the steered path
    # ------------------------------------------------------------------
    t0 = time.time()
    umb = integrate_sde_umbrella(
        pot, cv1, centers=centers,
        kappa=float(kappa), n_steps=args.umbrella_steps,
        sampling_output_path=os.path.join(args.outdir, "umbrella"),
        X0=pull.window_starts(centers), pre_steps=args.pre_steps, step_size=0.003,
        report_interval=20, seed=11, verbose=False, device=dev,
    )
    means = umb.cv_values.mean(axis=1)[:, 0]
    print(f"umbrella: {umb.n_windows} windows as one chain batch "
          f"({time.time() - t0:.1f}s); mean |CV - center| = "
          f"{np.abs(means - centers).mean():.3f}")
    sub = umb.subsample()
    print(f"statistical inefficiency: keeping every "
          f"{int(round(sub.dt / umb.dt))}th frame leaves "
          f"{sub.frames.shape[1]} independent frames/window")

    # ------------------------------------------------------------------
    # 4. MBAR -> reweighted FES along the CV, vs the analytic profile
    # ------------------------------------------------------------------
    mb = umb.mbar()
    print(f"MBAR: converged={mb.converged} in {mb.n_iter} iterations")
    pooled_cv = umb.cv_values.reshape(-1)
    w = np.concatenate(mb.weights)
    # window-boundary segment_starts: bootstrap blocks never straddle
    # windows, and block_frames='auto' would measure within-window g only
    n_per_window = umb.cv_values.shape[1]
    seg = np.arange(0, pooled_cv.size, n_per_window)
    cen, F, err = analysis.free_energy_profile(
        pooled_cv, weights=w, beta=pot.beta, bins=40,
        value_range=(lo, hi), n_bootstrap=32,
        block_frames=min(100, n_per_window // 2),
        segment_starts=seg,
    )
    # analytic check: map CV bins back to x1 via the pooled frames and
    # compare the barrier height (~1 energy unit = beta kT at the top)
    F_kT = pot.beta * (F - np.nanmin(F[np.isfinite(F)]))
    mid = np.isfinite(F_kT)
    barrier = np.nanmax(F_kT[mid]) if mid.any() else float("nan")
    print(f"FES along CV: barrier {barrier:.2f} kT "
          f"(analytic x1 barrier: {pot.beta * 1.0:.1f} kT)")
    assert np.isfinite(w).all() and np.isfinite(res.task.train_loss).all()

    # ------------------------------------------------------------------
    # 5. figures
    # ------------------------------------------------------------------
    if not args.plot:
        print("OK (figures with --plot)")
        return
    import matplotlib

    matplotlib.use("Agg")
    ax = plotting.plot_cv_contour(
        cv_model, (-1.8, 1.8), (-0.8, 0.8),
        trajectory=res.pooled.trajectory[::10],
    )
    ax.figure.savefig(os.path.join(args.outdir, "cv_contour.png"), dpi=110)
    ax = plotting.plot_free_energy(cen, pot.beta * F, pot.beta * err, unit="$k_B T$")
    ax.figure.savefig(os.path.join(args.outdir, "fes.png"), dpi=110)
    ax = plotting.plot_loss_curves(res.task)
    ax.figure.savefig(os.path.join(args.outdir, "loss.png"), dpi=110)
    ax = plotting.plot_steered_work(pull)
    ax.figure.savefig(os.path.join(args.outdir, "steered_work.png"), dpi=110)
    print(f"figures -> {args.outdir}/{{cv_contour,fes,loss,steered_work}}.png")
    print("OK")


if __name__ == "__main__":
    main()

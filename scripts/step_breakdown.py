#!/usr/bin/env python3
"""Where the fused training step's device time goes, piece by piece, on one
NVIDIA card.

    python3 scripts/step_breakdown.py

The step of chip_smoke.py's fused run (FusedAlignmentLayer + fused_step=True
at the main path's shapes: batches of 20,000 lagged pairs of 10-atom frames,
dims [30,20,20,20,1], k = 2, capturable Adam) is taken apart, and each piece
is timed alone as the summed durations of its device activities under
torch.profiler (``chip_smoke.busy_ms``, mean of 10 calls), beside the whole
step timed the same way:

* alignment (K2 on X and X_l) and features (position ``index_select``);
* the flat parameter buffer of the kernels: ``params_t_of`` +
  ``flatten_params`` forward, and its backward (the flat gradient split back
  into per-layer gradients);
* K3 and K4 through their launch wrappers;
* the loss from the stats, forward and backward (``eigen_loss_from_stats``);
* the metric row of the batch;
* the optimizer step (Adam, foreach, ``capturable=True``).

The remainder (whole step less the pieces) is what the pieces leave out:
gradient accumulation into ``.grad`` and autograd's own copies. It prints
one line per piece, in µs per step, and the card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import colvarsfinder_tpu_torch as cvf  # noqa: E402
from colvarsfinder_tpu_torch import graphs  # noqa: E402
from colvarsfinder_tpu_torch.config import set_matmul_precision  # noqa: E402
from colvarsfinder_tpu_torch.ops import fused_eigen as fe  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("step_breakdown: needs an NVIDIA card")
    set_matmul_precision("highest")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    ref, traj_np, w_np = cs.make_data(0)
    traj_obj = cvf.WeightedTrajectory(trajectory=traj_np, weights=w_np,
                                      dt=cs.DT, verbose=False)
    with tempfile.TemporaryDirectory() as tmp:
        task = cs.make_task(cvf, traj_obj, ref, tmp, True, "fused", 1)
        with graphs.eager():
            task.train()  # Adam's state, the kernel libraries
        X, X_l, w, w_l = task._prepare_data()[0][0]
        model, pp, opt = task.model, task.preprocessing_layer, task.optimizer
        params = list(model.parameters())
        dims, k = tuple(model.layer_dims), task.k

        def step():
            loss, _ = task._batch_metrics(X, X_l, w, w_l)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()

        align = pp.alignment_layer
        A, A_l = align(X), align(X_l)
        F = pp.feature_layer(A).reshape(X.shape[0], -1).contiguous()
        F_l = pp.feature_layer(A_l).reshape(X.shape[0], -1).contiguous()
        flat = fe.flatten_params(fe.params_t_of(model))
        g_flat = torch.randn_like(flat)
        stats, Y = fe.stats_fwd_launch(flat.detach(), F, F_l, w, w_l, dims, k)

        def loss_from_stats():
            s = stats.detach().requires_grad_()
            loss, aux = fe.eigen_loss_from_stats(
                s, k=k, alpha=task._alpha, eig_w=task._eig_w_t,
                lag_idx=task.lag_idx, traj_dt=task.traj_dt,
                sort_eigvals=task._sort_eigvals_in_training)
            return loss, aux, torch.autograd.grad(loss, s)[0]

        loss, (eig_vals, non_pen, pen, cvec), d_stats = loss_from_stats()

        pieces = {
            "alignment (K2 on X and X_l)": lambda: (align(X), align(X_l)),
            "features (index_select, 2 batches)": lambda: (
                pp.feature_layer(A), pp.feature_layer(A_l)),
            "params_t_of + flatten_params, forward": lambda: (
                fe.flatten_params(fe.params_t_of(model))),
            "flat gradient split into the parameters (backward)":
                lambda: torch.autograd.grad(flat, params, g_flat,
                                            retain_graph=True),
            "K3 (stats forward)": lambda: fe.stats_fwd_launch(
                flat.detach(), F, F_l, w, w_l, dims, k),
            "loss from stats, forward + backward": loss_from_stats,
            "K4 (stats backward)": lambda: fe.stats_bwd_launch(
                flat.detach(), F, F_l, w, w_l, Y, d_stats, dims, k),
            "metric row": lambda: torch.cat([
                torch.stack([loss, non_pen, pen]).detach(), eig_vals,
                cvec.to(loss.dtype)]),
            "optimizer step (Adam, foreach, capturable)": opt.step,
        }
        whole = cs.busy_ms(step, calls=10) * 1e3
        print(f"whole fused step: {whole:9.2f} us of device time", flush=True)
        total = 0.0
        for name, fn in pieces.items():
            us = cs.busy_ms(fn, calls=10) * 1e3
            total += us
            print(f"  {us:9.2f} us  {name}", flush=True)
        print(f"  {whole - total:9.2f} us  the rest (gradient accumulation, "
              "autograd's copies)", flush=True)


if __name__ == "__main__":
    main()

r"""Multi-replica sweep with data-parallel training over the port's data
mesh (the port of ``examples/multireplica.py``; BASELINE config 5: sharded
trajectories, DP training across the mesh).

Workflow:
  1. integrate ``n_chains`` independent SDE replicas as one chain batch
     (each report block one captured CUDA graph on the card);
  2. concatenate the replica trajectories into one weighted dataset;
  3. train an eigenfunction task over a 1-axis ('data',) mesh of
     ``torch.distributed`` ranks (``parallel.make_data_mesh``), each rank
     on its share of every batch, the gradients summed once per step;
  4. train one task per replica as one replica program, then an lr x alpha
     sweep, and adopt the winner.

One process per card. Started plainly, the script makes a group of one
rank (NCCL on the card, gloo with ``--device cpu``); under torchrun it
joins the launcher's group:

    python examples/torch/multireplica.py [--device cpu]
    torchrun --nproc-per-node=4 examples/torch/multireplica.py

A cut run (the CPU test): --n-chains 2 --n-steps 2000 --epochs 2
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch
import torch.distributed as dist

from colvarsfinder_tpu_torch.core import EigenFunctionTask
from colvarsfinder_tpu_torch.models import EigenFunctions
from colvarsfinder_tpu_torch.parallel import (
    adopt_sweep_result,
    make_data_mesh,
    train_hyperparameter_sweep,
    train_replica_ensemble,
)
from colvarsfinder_tpu_torch.utils import (
    WeightedTrajectory,
    integrate_sde_overdamped,
)


class DoubleWell:
    """Double-well in x, harmonic in y, in torch."""

    dim = 2
    beta = 2.0

    def V(self, x):
        return (x[0] ** 2 - 1.0) ** 2 + 2.0 * x[1] ** 2


def init_group(device: str, outdir: str):
    """Join torchrun's process group, or make one of a single rank."""
    backend = "nccl" if device == "cuda" else "gloo"
    if "RANK" in os.environ:
        if device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
    else:
        store = os.path.join(outdir, f"mesh_store_{os.getpid()}")
        if os.path.exists(store):
            os.remove(store)
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=0, world_size=1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="/tmp/cvf_multireplica")
    ap.add_argument("--n-chains", type=int, default=8)
    ap.add_argument("--n-steps", type=int, default=100_000)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    os.makedirs(args.outdir, exist_ok=True)
    init_group(args.device, args.outdir)
    try:
        run(args)
    finally:
        dist.destroy_process_group()


def run(args):
    dev = (torch.device("cuda", torch.cuda.current_device())
           if args.device == "cuda" else torch.device("cpu"))
    mesh = make_data_mesh()
    ranks, rank = dist.get_world_size(), dist.get_rank()

    def say(*a):
        if rank == 0:
            print(*a, flush=True)

    say(f"{ranks} rank(s) on {dev.type} ({dist.get_backend()})")

    # 1. all replicas integrate as one chain batch (the same seed on every
    # rank: every rank holds the same data)
    frames, energies = integrate_sde_overdamped(
        DoubleWell(), n_steps=args.n_steps,
        sampling_output_path=os.path.join(args.outdir, f"rank{rank}"),
        step_size=0.005, report_interval=100, seed=7,
        n_chains=args.n_chains, verbose=False, device=dev,
    )
    say(f"replica trajectories: {frames.shape}")

    # 2. concatenate replicas into one weighted dataset
    flat = frames.reshape(-1, frames.shape[-1])
    traj = WeightedTrajectory(trajectory=flat, dt=0.5, verbose=False)

    # 3. data-parallel eigenfunction training over the mesh
    k = 2
    model = EigenFunctions([2, 20, 20, 1], k, seed=0)
    batch = 128 * ranks
    task = EigenFunctionTask(
        traj, None, model, model_path=os.path.join(args.outdir, "train"),
        alpha=10.0, eig_weights=[1.0, 0.5], lag_tau=0.5, k=k,
        learning_rate=0.005, batch_size=batch, num_epochs=args.epochs,
        test_ratio=0.2, save_model_every_step=0, verbose=False,
        tensorboard=False, seed=0, mesh=mesh, device=dev,
    )
    task.train()
    say(task.loss_names)
    say(np.array2string(task.train_loss[-3:], precision=4))

    # 4. alternative sweep formulation: train one task PER replica, all
    # advancing in lock-step as one replica program
    per_replica = [
        EigenFunctionTask(
            WeightedTrajectory(trajectory=frames[c], dt=0.5, verbose=False),
            None, EigenFunctions([2, 20, 20, 1], k, seed=c),
            os.path.join(args.outdir, f"replica{c}"),
            alpha=10.0, eig_weights=[1.0, 0.5], lag_tau=0.5, k=k,
            learning_rate=0.005, batch_size=128, num_epochs=args.epochs,
            test_ratio=0.2, save_model_every_step=0, verbose=False,
            tensorboard=False, seed=c, device=dev,
        )
        for c in range(min(4, args.n_chains))
    ]
    train_replica_ensemble(per_replica)
    say("per-replica final losses (one replica program):",
        [round(float(t.train_loss[-1, 0]), 3) for t in per_replica])
    say("mean epoch time: %.1f ms"
        % (1000 * np.mean(task.epoch_times[1:] or task.epoch_times)))

    # 5. hyperparameter sweep: an lr x alpha grid trained as one replica
    # program, the batch data shared on the device by every grid point
    lrs = [1e-3, 3e-3, 1e-2]
    alphas = [5.0, 10.0, 20.0]
    grid = {
        "learning_rate": [lr for lr in lrs for _ in alphas],
        "alpha": [a for _ in lrs for a in alphas],
    }
    # sweep over the first replica's (single-device) task: the replica
    # axis and the mesh axis are separate levers — combine deliberately
    results = train_hyperparameter_sweep(per_replica[0], grid)
    best = min(results, key=lambda r: float(r.train_loss[-1, 0]))
    say(f"sweep over {len(results)} (lr, alpha) points -> best "
        f"{best.hyperparams} with final loss "
        f"{float(best.train_loss[-1, 0]):.4f}")
    # load the winner back into the task; its normal surface (export,
    # checkpointing, continued training) now operates on that replica
    adopt_sweep_result(per_replica[0], best)
    # the slowest mode of the double well is the x-barrier crossing; the
    # leading eigenfunction should correlate with x
    cv = task.colvar_model()
    xs = np.linspace(-1.5, 1.5, 11, dtype=np.float32)
    pts = np.stack([xs, np.zeros_like(xs)], axis=1)
    with torch.no_grad():
        vals = cv(torch.from_numpy(pts).to(dev)).cpu().numpy()[:, 0]
    assert np.isfinite(vals).all() and np.isfinite(task.train_loss).all()
    say("leading CV along x:", np.round(vals, 3))


if __name__ == "__main__":
    main()

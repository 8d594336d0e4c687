"""Replica sweeps: whole ``parallel.train_hyperparameter_sweep`` calls of
``epochs_per_call`` epochs back to back, R replicas of the task, replica r
from the seeded heads of stack r, over the workload's grid (replica r takes
the (r mod side)-th learning rate and the (r div side)-th alpha).

Every call starts from the same heads and a fresh optimizer state, so each
call's results are the timed path's answer from the seed. Set-up makes one
call, which captures the sweep's epoch. The check follows every replica
through the last call's steps and compares each epoch's mean train loss
and each replica's parameter change, on every replica but those that the
chaos rule of ``portbench/check.py`` leaves out, and each replica's CV at
the parameters it ended with: a sweep returns those and not each step's
loss or its first gradient.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from colvarsfinder_tpu_torch.parallel import (
    ensemble,
    train_hyperparameter_sweep,
)

from portbench import check

from .train import build_task, cv_values, heads, train_batches


def grid(wl: dict, R: int) -> tuple:
    """``(learning rates, alphas)`` of the R replicas."""
    g = wl["grid"]
    lrs = np.geomspace(*g["learning_rate"])
    alphas = np.geomspace(*g["alpha"])
    side = len(lrs)
    return ([float(lrs[r % side]) for r in range(R)],
            [float(alphas[r // side]) for r in range(R)])


def plan(cfg: dict, wl: dict) -> tuple:
    """``(steps, learning rates, alphas)``: the reference follows a whole
    call of every replica."""
    R = int(wl["replicas"])
    steps = int(wl["epochs_per_call"]) * train_batches(cfg)
    return (steps, *grid(wl, R))


class Runner:
    def __init__(self, cfg: dict, wl: dict, inputs, device, model_path: str):
        self.cfg, self.wl = cfg, wl
        self.R = int(wl["replicas"])
        self.task = build_task(cfg, wl, inputs, device, model_path)
        self.task.num_epochs = int(wl["epochs_per_call"])
        self.models = [heads(cfg, inputs.replica_params(r)).to(device)
                       for r in range(self.R)]
        lrs, alphas = grid(wl, self.R)
        self.grid = {"learning_rate": lrs, "alpha": alphas}
        self.nb_train = train_batches(cfg)
        self.cv_x = torch.as_tensor(check.cv_frames(cfg, inputs),
                                    device=device)
        self.results = None

    def setup(self) -> None:
        self.call()

    def call(self, epochs: int | None = None) -> dict:
        """One whole sweep call, timed on the host; it ends in the sweep's
        one fetch of its results. ``program_s`` is the sweep's own timer of
        its replayed epochs and fetch."""
        task = self.task
        if epochs is not None:
            task.num_epochs = epochs
        t0 = time.perf_counter()
        self.results = train_hyperparameter_sweep(task, self.grid,
                                                  models=self.models)
        wall = time.perf_counter() - t0
        n = task.num_epochs
        task.num_epochs = int(self.wl["epochs_per_call"])
        return {"wall_s": wall, "steps": n * self.nb_train,
                "samples": self.R * n * self.nb_train * self.cfg["batch_size"],
                "program_s": ensemble.last_run_seconds}

    def readings(self) -> dict:
        """Each epoch's mean train loss [epochs, R], each replica's
        parameters {name: [R, ...]} and their change, and each replica's CV
        [R, k, B] at them, of the last call."""
        res = self.results
        names = list(res[0].model)
        start = {n: torch.stack([dict(m.named_parameters())[n].detach().cpu()
                                 for m in self.models]).double()
                 for n in names}
        final = {n: torch.stack([r.model[n] for r in res]).double()
                 for n in names}
        layers = len(self.cfg["layer_dims"]) - 1
        pp = self.task.preprocessing_layer
        cv = torch.stack([
            cv_values(pp, heads(self.cfg, [
                (r.model[f"weights.{i}"], r.model[f"biases.{i}"])
                for i in range(layers)]).to(self.cv_x.device), self.cv_x)
            for r in res])
        return {"epoch_losses": np.stack([r.train_loss[:, 0] for r in res],
                                         axis=1),
                "params": final, "cv": cv,
                "change": {n: final[n] - start[n] for n in names}}

    def release(self) -> None:
        ensemble.release_sweeps()
        self.task.release_device_data()
        del self.task, self.models

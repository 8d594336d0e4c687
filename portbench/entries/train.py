"""Solo training: whole ``EigenFunctionTask.train()`` calls of
``epochs_per_call`` epochs back to back, one model.

Set-up builds the task with the seeded inputs and drives it from the seed
through its first call of one epoch: on the card that epoch runs eagerly
and is then captured as the graph the window replays. An optimizer hook
(the optimizer's public one) copies the first gradient, as Adam's state
holds it after step 1. The task's parameters and Adam's state are then put
back to the seed in place, which keeps the captured graph, and a second
call of ``checks.epochs`` epochs replays it from the seed: its losses, the
parameters' change over it and the CV at the parameters it ends with are
the timed path's own. That same task is handed to the window.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

import colvarsfinder_tpu_torch as cvf
from portbench import check

BETA1 = 0.9


def heads(cfg: dict, params) -> "cvf.EigenFunctions":
    """The program's k heads with the seeded parameters ``params`` (per
    layer (weight [k, o, i], bias [k, o]))."""
    model = cvf.EigenFunctions(cfg["layer_dims"], cfg["k"],
                               activation=cfg["activation"])
    with torch.no_grad():
        for i, (W, b) in enumerate(params):
            model.weights[i].copy_(W)
            model.biases[i].copy_(b)
    return model


@torch.no_grad()
def cv_values(pp, model, x) -> torch.Tensor:
    """[k, B]: the program's CV, its preprocessing layer ``pp`` and heads
    ``model``, on the frames ``x``, on the host in float64."""
    return model(pp(x)).T.double().cpu()


def build_task(cfg: dict, wl: dict, inputs, device, model_path: str):
    """The program's EigenFunctionTask on the seeded inputs: the alignment
    the workload names over all atoms, position features, the heads of
    replica 0, the configuration's settings, the seeded split, one epoch a
    call and one fetch per epoch; the workload's ``task`` entries last."""
    atoms = list(range(cfg["n_atoms"]))
    if wl["align"] == "fused":
        align = cvf.FusedAlignmentLayer(inputs.ref_np, atoms)
    else:
        align = cvf.AlignmentLayer(inputs.ref_np, atoms, method=wl["align"])
    pp = cvf.PreprocessingANN(
        align, cvf.FeatureLayer([cvf.Feature("p", "position", atoms)]))
    traj = cvf.WeightedTrajectory(trajectory=inputs.frames,
                                  weights=inputs.weights, dt=cfg["dt_ns"],
                                  verbose=False)
    kw = dict(alpha=cfg["alpha"], eig_weights=cfg["eig_weights"],
              beta=cfg["beta"], lag_tau=cfg["lag"] * cfg["dt_ns"],
              learning_rate=cfg["learning_rate"], k=cfg["k"],
              batch_size=cfg["batch_size"], test_ratio=cfg["test_ratio"],
              optimizer_name=cfg["optimizer"], num_epochs=1,
              save_model_every_step=0, verbose=False, debug_mode=False,
              tensorboard=False, export_cv=False, device=device,
              split_indices=(inputs.train_idx, inputs.test_idx),
              progress_interval=1)
    if cfg.get("diag_coeff") is not None:
        kw["diag_coeff"] = np.asarray(cfg["diag_coeff"])
    kw.update(wl.get("task", {}))
    model = heads(cfg, inputs.replica_params(0))
    return cvf.EigenFunctionTask(traj, pp, model, model_path, **kw)


def train_batches(cfg: dict) -> int:
    n_pairs = int(cfg["data"]["n_frames"]) - int(cfg["lag"])
    n_train = n_pairs - math.ceil(cfg["test_ratio"] * n_pairs)
    return n_train // cfg["batch_size"]


def plan(cfg: dict, wl: dict) -> tuple:
    """``(steps, learning rates, alphas)``: the reference follows the
    replayed call from the seed, ``checks.epochs`` whole epochs."""
    steps = int(wl["checks"]["epochs"]) * train_batches(cfg)
    return steps, [cfg["learning_rate"]], [cfg["alpha"]]


class Runner:
    def __init__(self, cfg: dict, wl: dict, inputs, device, model_path: str):
        self.cfg, self.wl = cfg, wl
        self.task = build_task(cfg, wl, inputs, device, model_path)
        self.names = [n for n, _ in self.task.model.named_parameters()]
        self.initial = [p.detach().clone()
                        for p in self.task.model.parameters()]
        self.nb_train = train_batches(cfg)
        self.cv_x = torch.as_tensor(check.cv_frames(cfg, inputs),
                                    device=device)

    # ------------------------------------------------------------------
    def setup(self) -> None:
        task = self.task
        params = list(task.model.parameters())
        snaps = {}

        def hook(opt, args, kwargs):
            if "grad1" not in snaps:
                snaps["grad1"] = [opt.state[p]["exp_avg"].detach().clone()
                                  / (1.0 - BETA1) for p in params]

        handle = task.optimizer.register_step_post_hook(hook)
        try:
            task.num_epochs = 1
            task.train()
        finally:
            handle.remove()
        self.eager_losses = np.array(task.loss_list[0][0][:, 0])
        self.grad1 = snaps["grad1"]
        self.reset()
        task.num_epochs = int(self.wl["checks"]["epochs"])
        task.train()
        self.replay_losses = np.concatenate(
            [train[:, 0] for train, _ in task.loss_list])
        self.after = [p.detach().clone() for p in params]
        self.cv = cv_values(task.preprocessing_layer, task.model,
                            self.cv_x)[None]
        task.num_epochs = int(self.wl["epochs_per_call"])

    @torch.no_grad()
    def reset(self) -> None:
        """The parameters and Adam's state back to the seed, in place."""
        for p, p0 in zip(self.task.model.parameters(), self.initial):
            p.copy_(p0)
        for state in self.task.optimizer.state.values():
            for t in state.values():
                if torch.is_tensor(t):
                    t.zero_()

    # ------------------------------------------------------------------
    def call(self, epochs: int | None = None) -> dict:
        """One whole ``train()`` call, timed on the host; it ends in the
        program's fetch of its last epoch, which waits for the card."""
        task = self.task
        if epochs is not None:
            task.num_epochs = epochs
        t0 = time.perf_counter()
        task.train()
        wall = time.perf_counter() - t0
        n = task.num_epochs
        task.num_epochs = int(self.wl["epochs_per_call"])
        return {"wall_s": wall, "steps": n * self.nb_train,
                "samples": n * self.nb_train * self.cfg["batch_size"],
                "epoch_s": list(task.epoch_times)}

    def readings(self) -> dict:
        """What set-up saw the program produce, on the host in float64."""
        def host(ts):
            return {n: t.double().cpu()[None]
                    for n, t in zip(self.names, ts)}

        after = host(self.after)
        start = host(self.initial)
        return {"losses": [self.eager_losses, self.replay_losses],
                "grad1": host(self.grad1), "params": after, "cv": self.cv,
                "change": {n: after[n] - start[n] for n in after}}

    def release(self) -> None:
        self.task.release_device_data()
        del self.task

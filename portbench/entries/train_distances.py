"""Solo training from pair-distance features: whole
``EigenFunctionTask.train()`` calls as in :mod:`.train`, on a task built as
a user builds one for a protein's descriptor set: no alignment, one
``Feature(..., 'bond', (i, j))`` for every pair of the configuration's
``n_atoms`` atoms (i < j, row-major), ``PreprocessingANN(None,
FeatureLayer([...]))``, the default route.

A program whose ``FeatureLayer`` evaluates each distance on its own (no
grouped pair list) is refused at once: at thousands of distances its
captured epoch would hold over a million kernels.
"""

from __future__ import annotations

import itertools

import torch

import colvarsfinder_tpu_torch as cvf
from portbench import check
from portbench.entries import train

plan = train.plan


def feature_layer(n_atoms: int) -> "cvf.FeatureLayer":
    """Every heavy-atom pair distance of ``n_atoms`` atoms, one ``bond``
    feature each, in the order of :func:`portbench.references.
    cln025_transfer.pairs`."""
    return cvf.FeatureLayer([
        cvf.Feature(f"d_{i}_{j}", "bond", (i, j))
        for i, j in itertools.combinations(range(n_atoms), 2)])


def build_task(cfg: dict, wl: dict, inputs, device, model_path: str):
    """:func:`.train.build_task` with the pair-distance features in place
    of the alignment and the position features."""
    layer = feature_layer(cfg["n_atoms"])
    if layer.output_dimension != cfg["d_r"]:
        raise ValueError(f"{layer.output_dimension} distances for d_r "
                         f"{cfg['d_r']}")
    if not getattr(layer, "pair_groups", ()):
        raise SystemExit("the program's FeatureLayer evaluates each pair "
                         "distance on its own: this cell needs a grouped "
                         "pair list")
    pp = cvf.PreprocessingANN(None, layer)
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
    kw.update(wl.get("task", {}))
    model = train.heads(cfg, inputs.replica_params(0))
    return cvf.EigenFunctionTask(traj, pp, model, model_path, **kw)


class Runner(train.Runner):
    """:class:`.train.Runner` on the task of :func:`build_task`."""

    def __init__(self, cfg: dict, wl: dict, inputs, device, model_path: str):
        self.cfg, self.wl = cfg, wl
        self.task = build_task(cfg, wl, inputs, device, model_path)
        self.names = [n for n, _ in self.task.model.named_parameters()]
        self.initial = [p.detach().clone()
                        for p in self.task.model.parameters()]
        self.nb_train = train.train_batches(cfg)
        self.cv_x = torch.as_tensor(check.cv_frames(cfg, inputs),
                                    device=device)

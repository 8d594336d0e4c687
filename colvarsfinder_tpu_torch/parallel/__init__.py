"""Replica sweeps (``parallel/ensemble.py``) and the data mesh over
``torch.distributed`` (``parallel/mesh.py``, with the collectives of a
meshed train step in ``parallel/collectives.py``) of the PyTorch port."""

from . import ensemble
from .ensemble import (
    ExploreResult,
    Incompatible,
    SweepResult,
    adopt_sweep_result,
    explore_then_finetune,
    sweep_committor_checks,
    sweep_vamp_scores,
    train_architecture_ensemble,
    train_hyperparameter_sweep,
    train_replica_ensemble,
)
from .mesh import make_data_mesh, replicate, shard_batches, shard_frames

__all__ = [
    "ExploreResult",
    "Incompatible",
    "SweepResult",
    "adopt_sweep_result",
    "explore_then_finetune",
    "last_run_seconds",
    "make_data_mesh",
    "replicate",
    "shard_batches",
    "shard_frames",
    "sweep_committor_checks",
    "sweep_vamp_scores",
    "train_architecture_ensemble",
    "train_hyperparameter_sweep",
    "train_replica_ensemble",
]


def __getattr__(name):
    # the value of the last call, not the one at import
    if name == "last_run_seconds":
        return ensemble.last_run_seconds
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

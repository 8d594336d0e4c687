"""Replica sweeps of the PyTorch port (``parallel/ensemble.py``); the
device mesh (``parallel/mesh.py``) is not ported yet (ROADMAP item 15b)."""

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

__all__ = [
    "ExploreResult",
    "Incompatible",
    "SweepResult",
    "adopt_sweep_result",
    "explore_then_finetune",
    "last_run_seconds",
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

r"""Checkpoints of the port: PyTorch state dicts, per-CV text dumps and the
full training state (model, optimizer moments, epoch).

Counterpart of what ``TrainingTask.save_model`` needs from
``colvarsfinder_tpu/checkpoint.py`` and ``core/task.py:867-941``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = [
    "load_training_state",
    "save_cv_text",
    "save_state_dict",
    "save_training_state",
]


def save_state_dict(module: torch.nn.Module, filename: str) -> None:
    """``torch.save`` of the module's state dict."""
    torch.save(module.state_dict(), filename)


def save_cv_text(model, k: int, out_dir: str) -> None:
    """Per-CV plain-text parameter dumps ``<cv>_<layer>_<weight|bias>.txt``
    (the reference's format, ``colvarsfinder_tpu/core/task.py:889-896``)."""
    os.makedirs(out_dir, exist_ok=True)
    for idx in range(k):
        for name, param in model.get_params_of_cv(idx):
            fname = os.path.join(
                out_dir, f"{idx}_" + name.replace(".", "_") + ".txt"
            )
            arr = param.detach().cpu().numpy()
            np.savetxt(fname, np.atleast_1d(arr))


def save_training_state(filename: str, model, optimizer, epoch: int) -> None:
    """Model parameters, optimizer state and epoch in one file."""
    torch.save(
        {
            "model": model.state_dict(),
            "optimizer": optimizer.state_dict(),
            "epoch": int(epoch),
        },
        filename,
    )


def load_training_state(filename: str, model, optimizer) -> int:
    """Restore model and optimizer state in place; returns the epoch."""
    state = torch.load(filename, map_location="cpu", weights_only=True)
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    return int(state["epoch"])

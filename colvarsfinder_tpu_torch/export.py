r"""Collective-variable model composition (port of ``ColvarModel``,
``colvarsfinder_tpu/export.py:41``). The export and deployment artifacts of
the JAX package (StableHLO programs, TorchScript) are not ported yet
(ROADMAP.md queue 1, item 12)."""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["ColvarModel"]


class ColvarModel(nn.Module):
    """Composition of a preprocessing layer and a trained head:
    ``head(pp_layer(x))``."""

    def __init__(self, pp_layer: nn.Module, head: nn.Module):
        super().__init__()
        self.pp_layer = pp_layer
        self.head = head

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.pp_layer(x))

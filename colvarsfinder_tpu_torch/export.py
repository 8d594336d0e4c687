r"""Collective-variable model composition and deployment export (port of
``colvarsfinder_tpu/export.py``).

:class:`ColvarModel` is the composition :math:`\xi = g \circ r` of a
preprocessing layer and a trained head. :func:`export_colvar` writes the
artifact set that the JAX package's ``save_model`` writes with
``write_stablehlo=False``:

* ``cv_params.npz`` + ``cv_spec.json``: the CV model's state dict and a
  manifest of its architecture;
* ``cv_numpy_spec.json`` + ``cv_numpy.npz`` and ``cv_native.bin``: the
  dependency-free numpy and C++ artifacts (:mod:`.deploy`,
  :mod:`.deploy_native`), in the JAX package's format;
* ``scripted_cv_cpu.pt``: the reference's TorchScript artifact
  (:mod:`.deploy_torch`).

The last four need a spec for every stage of the CV; ``FusedAlignmentLayer``
and ``Lambda`` have none, and then only the first two are written, as in
the JAX package. The JAX package's StableHLO forward and gradient programs
(``write_stablehlo=True``) have no counterpart yet: ROADMAP.md queue 1,
item 12.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
from torch import nn

__all__ = ["ColvarModel", "export_colvar"]


class ColvarModel(nn.Module):
    """Composition of a preprocessing layer and a trained head:
    ``head(pp_layer(x))``."""

    def __init__(self, pp_layer: nn.Module, head: nn.Module):
        super().__init__()
        self.pp_layer = pp_layer
        self.head = head

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.pp_layer(x))


def export_colvar(cv_model: ColvarModel, example_input, out_dir: str, *,
                  write_stablehlo: bool = False) -> None:
    """Write the deployment artifact set for a CV model
    (``colvarsfinder_tpu/export.py:88-154``).

    Args:
        cv_model: the composed CV model, on any device.
        example_input: one example state, or a batch, defining the input
            rank and dimensions.
        out_dir: directory for the artifacts.
        write_stablehlo: the JAX package's compiled forward and gradient
            programs; not ported yet, True raises.
    """
    if write_stablehlo:
        raise NotImplementedError(
            "the compiled CV programs (cv_exported.bin, cv_grad_exported.bin)"
            " are not ported yet: ROADMAP.md queue 1, item 12"
        )
    from .deploy import UnsupportedLayerError, save_numpy_cv
    from .deploy_torch import export_torchscript_cv

    os.makedirs(out_dir, exist_ok=True)
    named = {name: t.detach().cpu().numpy()
             for name, t in cv_model.state_dict().items()}
    np.savez(os.path.join(out_dir, "cv_params.npz"), **named)

    x = np.asarray(example_input.detach().cpu()
                   if isinstance(example_input, torch.Tensor)
                   else example_input)
    if x.ndim == 0:
        raise ValueError("example_input must have at least 1 dimension")
    state_shape = tuple(x.shape[1:]) if x.ndim > 1 else (x.shape[0],)
    spec = {
        "format": "colvarsfinder-tpu-cv/1",
        "input_state_shape": list(state_shape),
        "pp_layer": type(cv_model.pp_layer).__name__,
        "head": type(cv_model.head).__name__,
        "param_order": list(named),
    }
    with open(os.path.join(out_dir, "cv_spec.json"), "w") as f:
        json.dump(spec, f, indent=2)

    # the numpy pair, the native program and the TorchScript module exist
    # only where every stage has a spec
    try:
        save_numpy_cv(cv_model, out_dir)
        export_torchscript_cv(cv_model, out_dir)
    except UnsupportedLayerError:
        pass

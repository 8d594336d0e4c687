r"""Eigenfunction ensemble model (port of
``colvarsfinder_tpu/models/eigen.py``): k scalar networks of one
architecture, kept as stacked parameters ``[k, d_out, d_in]`` /
``[k, d_out]`` and evaluated with one batched product per layer.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from .module import resolve_activation, stacked_mlp_apply, stacked_mlp_init

__all__ = ["EigenFunctions"]


class EigenFunctions(nn.Module):
    """k scalar eigenfunction networks with a shared architecture.

    Args:
        layer_dims: layer dimensions of each network; the last must be 1.
        k: number of eigenfunctions.
        activation: nonlinearity name (or registry function).
        seed / generator: the source of the initial weights (a
            ``torch.Generator`` wins over ``seed``).
        dtype / device: where the parameters live.

    The parameters are ``weights[l]`` ``[k, d_out, d_in]`` and ``biases[l]``
    ``[k, d_out]``; :attr:`params` gives them in the JAX package's
    ``({'weight', 'bias'}, ...)`` form.
    """

    def __init__(
        self,
        layer_dims: Sequence[int],
        k: int,
        activation="tanh",
        *,
        seed: int = 0,
        generator: torch.Generator | None = None,
        dtype=None,
        device=None,
    ):
        super().__init__()
        if layer_dims[-1] != 1:
            raise ValueError("each eigenfunction must be scalar-valued")
        self.activation = resolve_activation(activation)
        self.layer_dims = tuple(int(d) for d in layer_dims)
        self.k = int(k)
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        layers = stacked_mlp_init(
            self.layer_dims, self.k, generator=generator, dtype=dtype,
            device=device,
        )
        self.weights = nn.ParameterList(
            [nn.Parameter(layer["weight"]) for layer in layers]
        )
        self.biases = nn.ParameterList(
            [nn.Parameter(layer["bias"]) for layer in layers]
        )

    @classmethod
    def from_numpy(
        cls, params: Sequence[dict], activation="tanh", *, dtype=None,
        device=None,
    ) -> "EigenFunctions":
        """Module computing the same function as a JAX ``EigenFunctions``
        whose ``params`` (per layer ``{'weight': [k, o, i], 'bias': [k, o]}``)
        are given as numpy arrays."""
        w0 = np.asarray(params[0]["weight"])
        dims = [w0.shape[2]] + [np.asarray(p["weight"]).shape[1] for p in params]
        model = cls(dims, w0.shape[0], activation, dtype=dtype, device=device)
        with torch.no_grad():
            for li, p in enumerate(params):
                model.weights[li].copy_(torch.tensor(np.asarray(p["weight"])))
                model.biases[li].copy_(torch.tensor(np.asarray(p["bias"])))
        return model

    @property
    def params(self) -> tuple:
        """Per-layer ``{'weight', 'bias'}`` dicts (the JAX package's layout)."""
        return tuple(
            {"weight": W, "bias": b} for W, b in zip(self.weights, self.biases)
        )

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        """``[batch, d_r]`` -> ``[batch, k]``."""
        return stacked_mlp_apply(
            list(self.weights), list(self.biases), inp, self.activation
        )

    def get_params_of_cv(self, cv_idx: int):
        """Named parameters of eigenfunction ``cv_idx``
        (``colvarsfinder_tpu/models/eigen.py:90-97``)."""
        out = []
        for i, (W, b) in enumerate(zip(self.weights, self.biases)):
            out.append([f"{i + 1}.weight", W[cv_idx]])
            out.append([f"{i + 1}.bias", b[cv_idx]])
        return out

    def reordered(self, cvec) -> "EigenFunctions":
        """A new module with heads permuted by ``cvec``."""
        cvec_list = [int(c) for c in np.asarray(cvec).tolist()]
        if sorted(cvec_list) != list(range(self.k)):
            raise ValueError(
                f"cvec should be a permutation of 0,1,...,{self.k - 1}."
            )
        W0 = self.weights[0]
        new = EigenFunctions(
            self.layer_dims, self.k, self.activation, dtype=W0.dtype,
            device=W0.device,
        )
        order = torch.as_tensor(cvec_list, device=W0.device)
        with torch.no_grad():
            for li in range(len(self.weights)):
                new.weights[li].copy_(self.weights[li][order])
                new.biases[li].copy_(self.biases[li][order])
        return new


r"""Parameter init and stacked-MLP evaluation (port of
``colvarsfinder_tpu/models/module.py``).

Conventions are those of the JAX package, which in turn follows
``torch.nn.Linear``: a weight is ``[d_out, d_in]`` and ``y = x @ W.T + b``;
weight and bias start as U(-1/sqrt(d_in), 1/sqrt(d_in)). Stacked (ensemble)
parameters carry a leading head axis: weight ``[k, d_out, d_in]``, bias
``[k, d_out]``.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

from ..config import default_dtype

__all__ = [
    "ACTIVATIONS",
    "resolve_activation",
    "linear_init",
    "stacked_mlp_init",
    "stacked_mlp_apply",
]


def _tanh_precise(x: torch.Tensor) -> torch.Tensor:
    """tanh via the exp formula with the input clipped to [-20, 20]
    (``colvarsfinder_tpu/models/module.py:53-63``). The CUDA kernels of the
    fused step evaluate the same formula, so the plain path and the kernels
    share one activation; the clip keeps ``exp`` finite and zeroes the
    gradient where the true one is below float32 resolution."""
    xc = torch.clamp(x, -20.0, 20.0)
    return 1.0 - 2.0 / (torch.exp(2.0 * xc) + 1.0)


ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "tanh": _tanh_precise,
    "tanh_native": torch.tanh,
    "relu": torch.relu,
    "elu": torch.nn.functional.elu,
    # the tanh approximation, jax.nn.gelu's default
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "sigmoid": torch.sigmoid,
    "celu": torch.nn.functional.celu,
    "softplus": torch.nn.functional.softplus,
    "identity": lambda x: x,
}


def resolve_activation(activation) -> str:
    """Normalize an activation spec (name or registry function) to a name."""
    if isinstance(activation, str):
        name = activation.lower()
        if name not in ACTIVATIONS:
            raise ValueError(
                f"unknown activation '{activation}'; known: {sorted(ACTIVATIONS)}"
            )
        return name
    for name, fn in ACTIVATIONS.items():
        if activation is fn:
            return name
    raise ValueError(
        "activation must be a string name or a function from ACTIVATIONS; "
        f"got {activation!r}"
    )


def linear_init(
    d_in: int, d_out: int, *, generator: torch.Generator, dtype=None,
    device=None,
) -> dict:
    """One linear layer with the torch.nn.Linear default distribution:
    weight ``[d_out, d_in]`` and bias ``[d_out]`` ~ U(+-1/sqrt(d_in))."""
    dtype = default_dtype() if dtype is None else dtype
    bound = 1.0 / math.sqrt(d_in)
    weight = torch.empty(d_out, d_in, dtype=dtype).uniform_(
        -bound, bound, generator=generator
    )
    bias = torch.empty(d_out, dtype=dtype).uniform_(
        -bound, bound, generator=generator
    )
    return {"weight": weight.to(device), "bias": bias.to(device)}


def stacked_mlp_init(
    layer_dims: Sequence[int], k: int, *, generator: torch.Generator,
    dtype=None, device=None,
) -> tuple:
    """k independent MLPs stored stacked along a leading head axis:
    per layer ``{'weight': [k, d_out, d_in], 'bias': [k, d_out]}``."""
    if len(layer_dims) < 2:
        raise ValueError(
            "at least 2 layers are needed to define a neural network "
            f"(length={len(layer_dims)})"
        )
    per_net = [
        [
            linear_init(layer_dims[i], layer_dims[i + 1],
                        generator=generator, dtype=dtype, device=device)
            for i in range(len(layer_dims) - 1)
        ]
        for _ in range(k)
    ]
    return tuple(
        {
            "weight": torch.stack([p[li]["weight"] for p in per_net]),
            "bias": torch.stack([p[li]["bias"] for p in per_net]),
        }
        for li in range(len(layer_dims) - 1)
    )


def stacked_mlp_apply(
    weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
    x: torch.Tensor, activation: str,
) -> torch.Tensor:
    """Apply k stacked MLPs to a shared input batch.

    Args:
        weights / biases: per layer ``[k, d_out, d_in]`` / ``[k, d_out]``.
        x: input ``[batch, d_in]`` (or a single state ``[d_in]``).

    Returns:
        ``[batch, k * d_out_last]`` with per-head blocks contiguous, as
        ``colvarsfinder_tpu/models/module.py:207-270`` lays them out.
    """
    act = ACTIVATIONS[activation]
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    k = weights[0].shape[0]
    h = x.unsqueeze(0).expand(k, *x.shape)
    n = len(weights)
    for i, (W, b) in enumerate(zip(weights, biases)):
        # [k, b, i] x [k, i, o] -> [k, b, o]: one batched product per layer
        h = torch.baddbmm(b[:, None, :], h, W.transpose(1, 2))
        if i < n - 1:
            h = act(h)
    h = h.transpose(0, 1).reshape(x.shape[0], -1)
    return h[0] if squeeze else h

r"""Parameter init, plain and stacked MLPs, and the feedforward network
:class:`Sequential` (port of ``colvarsfinder_tpu/models/module.py``).

Conventions are those of the JAX package, which in turn follows
``torch.nn.Linear``: a weight is ``[d_out, d_in]`` and ``y = x @ W.T + b``;
weight and bias start as U(-1/sqrt(d_in), 1/sqrt(d_in)). Stacked (ensemble)
parameters carry a leading head axis: weight ``[k, d_out, d_in]``, bias
``[k, d_out]``.

Under ``config.set_compute_dtype('bfloat16')`` both appliers run in mixed
precision, as the JAX package's do (``colvarsfinder_tpu/models/module.py:
134-175, 207-260``): the parameters stay float32 and the activations are
stored in bfloat16, in the arithmetic style of ``config.set_bf16_style``.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn

from ..config import bf16_style, compute_dtype, default_dtype

__all__ = [
    "ACTIVATIONS",
    "Sequential",
    "create_sequential_nn",
    "linear_init",
    "mlp_apply",
    "mlp_init",
    "params_from_numpy",
    "resolve_activation",
    "stacked_mlp_apply",
    "stacked_mlp_init",
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


def mlp_init(
    layer_dims: Sequence[int], *, generator: torch.Generator, dtype=None,
    device=None,
) -> tuple:
    """Parameters of a feedforward net with the given layer dims, one
    ``{'weight', 'bias'}`` dict per linear layer
    (``colvarsfinder_tpu/models/module.py:119-134``)."""
    if len(layer_dims) < 2:
        raise ValueError(
            "at least 2 layers are needed to define a neural network "
            f"(length={len(layer_dims)})"
        )
    return tuple(
        linear_init(layer_dims[i], layer_dims[i + 1], generator=generator,
                    dtype=dtype, device=device)
        for i in range(len(layer_dims) - 1)
    )


def _mixed_style(x: torch.Tensor):
    """The bfloat16 style a float32 input runs in, or None for full
    precision (the float32 compute dtype, or another input dtype)."""
    if compute_dtype() == torch.bfloat16 and x.dtype == torch.float32:
        return bf16_style()
    return None


def _mixed_operands(h, W, b, style: str):
    """A layer's operands in bfloat16 style ``style``; ``h`` is the stored
    bfloat16 activation.

    - 'pure': bfloat16 operands, so the product has a bfloat16 result: on
      the card cuBLAS's bf16 GEMM (bf16 in and out, float32 accumulation
      inside the GEMM, one rounding of the result), the bias added in
      bfloat16.
    - 'acc32': the weights rounded to bfloat16 and both operands upcast
      exactly to float32; a product of two bfloat16 values is exact in
      float32, so the float32 GEMM computes the bf16 x bf16 -> f32 product
      with float32 accumulation and result (on the card cuBLAS's SGEMM, or
      its TF32 tensor-core path under matmul precision 'high', which holds
      bfloat16 operands exactly). PyTorch's ``out_dtype`` product, the
      direct bf16 x bf16 -> f32 call, has no autograd formula and no CPU
      kernel. Bias and activation stay float32.
    - 'w32': float32 weights, the activation upcast exactly; float32
      arithmetic at the configured matmul precision.
    """
    if style == "pure":
        return h, W.to(torch.bfloat16), b.to(torch.bfloat16)
    if style == "acc32":
        W = W.to(torch.bfloat16).to(W.dtype)
    return h.to(W.dtype), W, b


def mlp_apply(params: Sequence[dict], x: torch.Tensor,
              activation: str) -> torch.Tensor:
    """Apply an MLP: the activation between layers, none after the last.
    A float32 input under the bfloat16 compute dtype runs in mixed
    precision (``colvarsfinder_tpu/models/module.py:134-175``) and its
    output is cast back to float32."""
    act = ACTIVATIONS[activation]
    style = _mixed_style(x)
    h = x if style is None else x.to(torch.bfloat16)
    n = len(params)
    for i, layer in enumerate(params):
        W, b = layer["weight"], layer["bias"]
        if style is not None:
            h, W, b = _mixed_operands(h, W, b, style)
        h = torch.nn.functional.linear(h, W, b)
        if i < n - 1:
            h = act(h)
            if style not in (None, "pure"):
                h = h.to(torch.bfloat16)  # the stored activation
    return h if style is None else h.to(x.dtype)


def stacked_mlp_init(
    layer_dims: Sequence[int], k: int, *, generator: torch.Generator,
    dtype=None, device=None,
) -> tuple:
    """k independent MLPs stored stacked along a leading head axis:
    per layer ``{'weight': [k, d_out, d_in], 'bias': [k, d_out]}``."""
    per_net = [
        mlp_init(layer_dims, generator=generator, dtype=dtype, device=device)
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
    style = _mixed_style(x)
    k = weights[0].shape[0]
    h = x if style is None else x.to(torch.bfloat16)
    h = h.unsqueeze(0).expand(k, *x.shape)
    n = len(weights)
    for i, (W, b) in enumerate(zip(weights, biases)):
        if style is not None:
            h, W, b = _mixed_operands(h, W, b, style)
        # [k, b, i] x [k, i, o] -> [k, b, o]: one batched product per layer
        h = torch.baddbmm(b[:, None, :], h, W.transpose(1, 2))
        if i < n - 1:
            h = act(h)
            if style not in (None, "pure"):
                h = h.to(torch.bfloat16)  # the stored activation
    h = h.transpose(0, 1).reshape(x.shape[0], -1)
    if style is not None:
        h = h.to(x.dtype)
    return h[0] if squeeze else h


class _Linear(nn.Module):
    """One linear layer holding ``weight`` [d_out, d_in] and ``bias``."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias)


class Sequential(nn.Module):
    """A feedforward network: linear layers with ``activation`` between
    them and none after the last (``colvarsfinder_tpu/models/module.py:
    280-326``; the reference's ``create_sequential_nn``). The layers are
    submodules ``'1'``, ``'2'``, ..., so the parameters are named
    ``'1.weight'``, ``'1.bias'``, ... as in the reference."""

    def __init__(self, params: Sequence[dict], activation="tanh"):
        super().__init__()
        self.activation = resolve_activation(activation)
        for i, layer in enumerate(params):
            self.add_module(str(i + 1), _Linear(layer["weight"],
                                                layer["bias"]))
        self.layer_dims = (int(params[0]["weight"].shape[1]),) + tuple(
            int(layer["weight"].shape[0]) for layer in params)

    @property
    def params(self) -> tuple:
        """Per-layer ``{'weight', 'bias'}`` dicts (the JAX layout)."""
        return tuple({"weight": m.weight, "bias": m.bias}
                     for m in self.children())

    @property
    def num_layers(self) -> int:
        return len(self.layer_dims) - 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self.params, x, self.activation)

    def get_params_of_cv(self, cv_idx: int):
        """Named parameters of output ``cv_idx`` as one CV: every layer in
        full but the last, which is sliced to the CV's row
        (``colvarsfinder_tpu/models/ae.py:34-55``)."""
        encoded_dim = self.layer_dims[-1]
        if not 0 <= cv_idx < encoded_dim:
            raise ValueError(
                f"index {cv_idx} exceeded the range [0, {encoded_dim - 1}]!"
            )
        out = []
        for i, layer in enumerate(self.params):
            w, b = layer["weight"], layer["bias"]
            if i == self.num_layers - 1:
                w, b = w[cv_idx:cv_idx + 1], b[cv_idx:cv_idx + 1]
            out.append([f"{i + 1}.weight", w])
            out.append([f"{i + 1}.bias", b])
        return out


def create_sequential_nn(
    layer_dims: Sequence[int], activation="tanh", *, seed: int = 0,
    generator: torch.Generator | None = None, dtype=None,
) -> Sequential:
    """A feedforward network with freshly drawn weights
    (``colvarsfinder_tpu/models/module.py:329-346``); a ``torch.Generator``
    wins over ``seed``."""
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    params = mlp_init(layer_dims, generator=generator, dtype=dtype)
    return Sequential(params, activation)


def params_from_numpy(named: dict, layer_dims,
                      activation="tanh") -> Sequential:
    """A :class:`Sequential` from torch-style named parameters
    ``{'1.weight': [d_out, d_in], '1.bias': [d_out], ...}`` given as numpy
    arrays, e.g. those of a JAX ``Sequential``'s ``named_parameters()``
    (``colvarsfinder_tpu/models/module.py:349-366``)."""
    params = [
        {name: torch.tensor(np.asarray(named[f"{i + 1}.{name}"]),
                            dtype=default_dtype())
         for name in ("weight", "bias")}
        for i in range(len(layer_dims) - 1)
    ]
    return Sequential(params, activation)

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
from ..logging_utils import count

__all__ = [
    "ACTIVATIONS",
    "Sequential",
    "create_sequential_nn",
    "linear_init",
    "mlp_apply",
    "mlp_init",
    "params_from_numpy",
    "resolve_activation",
    "split_count",
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


#: fewest rows a chunk of a split layer product keeps
SPLIT_MIN_ROWS = 256
#: thread blocks per SM that a layer product's weight gradient aims for
SPLIT_BLOCKS_PER_SM = 4
#: side of the output tile, one thread block each, in which cuBLAS covers
#: the weight gradient of a small layer
SPLIT_TILE = 32


def split_count(device_type: str, records_grad: bool, rows: int,
                batch: int, result_dtype: torch.dtype, sm_count: int,
                d_out: int, d_in: int) -> int:
    """The number of chunks of the batch axis that a stacked layer product
    of :func:`stacked_mlp_apply` is split into; 1 keeps the whole product.

    A layer's weight gradient reduces over the ``rows`` of the batch, and
    its output is ``d_out x d_in``. cuBLAS covers that output in 32 x 32
    tiles, one thread block each, per batch entry, and does not split the
    reduction: a product over ``batch`` = k heads (R k in a sweep) runs as
    ``batch`` times the output's tiles blocks on the card, each looping
    over all the rows. A small layer (the dipeptide's, at most 30 x 20: one
    tile) leaves most SMs idle; a wide one (256 x 4,278: 1,072 tiles a
    head) fills the card whole. Split into S chunks, the product runs as S
    times as many blocks over ``rows / S`` rows each, and a sum over S;
    the weights are copied once per chunk.

    The split is taken on the card (``device_type`` 'cuda') where a weight
    gradient is recorded (``records_grad``) and the product's result is
    float32: bfloat16 partial products would be rounded before their sum,
    and float64 runs are references. S is the least that gives
    ``SPLIT_BLOCKS_PER_SM`` blocks on each of the ``sm_count`` SMs, 1 where
    the whole product already does, and keeps ``SPLIT_MIN_ROWS`` rows a
    chunk."""
    if (device_type != "cuda" or not records_grad
            or result_dtype != torch.float32):
        return 1
    tiles = batch * -(-d_out // SPLIT_TILE) * -(-d_in // SPLIT_TILE)
    want = -(-SPLIT_BLOCKS_PER_SM * sm_count // tiles)
    return max(1, min(want, rows // SPLIT_MIN_ROWS))


def _unwrapped(t: torch.Tensor) -> tuple:
    """``(n, plain)``: how many replicas ``torch.func.vmap`` maps ``t``
    over (1 outside any map), and the plain tensor under the transforms'
    wrappers, which says whether autograd records it."""
    functorch = torch._C._functorch
    n = 1
    while functorch.is_functorch_wrapped_tensor(t):
        inner = functorch.get_unwrapped(t)
        if functorch.is_batchedtensor(t):
            n *= inner.shape[functorch.maybe_get_bdim(t)]
        t = inner
    return n, t


def _heads_splits(x: torch.Tensor, weights, style) -> tuple:
    """:func:`split_count` of each layer product of the stacked heads, for
    an input ``x`` [B, d_in] of the layers ``weights`` ([k, d_out, d_in]
    each)."""
    n = len(weights)
    if not x.is_cuda:
        return (1,) * n
    replicas, plain = _unwrapped(weights[0])
    if style == "pure":
        result = torch.bfloat16
    else:
        result = x.dtype if style is None else weights[0].dtype
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    grad = torch.is_grad_enabled() and plain.requires_grad
    return tuple(split_count("cuda", grad, x.shape[0], replicas * W.shape[0],
                             result, sms, W.shape[1], W.shape[2])
                 for W in weights)


def _layer_product(h, W, b, splits: int) -> torch.Tensor:
    """``h @ W^T + b`` per head: ``[k, B, i] x [k, o, i] -> [k, B, o]``,
    one batched product; with ``splits`` > 1 (B a multiple of it) the
    product runs over ``k * splits`` chunks of ``B / splits`` rows, the
    weights and bias broadcast over the chunks, so autograd reduces every
    derivative over B chunk by chunk and then sums the chunks in a fixed
    order."""
    if splits == 1:
        return torch.baddbmm(b[:, None, :], h, W.transpose(1, 2))
    k, B, d_in = h.shape
    d_out = W.shape[1]
    Wt = W.transpose(1, 2)[:, None].expand(k, splits, d_in, d_out)
    bias = b[:, None, None, :].expand(k, splits, 1, d_out)
    out = torch.baddbmm(bias.reshape(k * splits, 1, d_out),
                        h.reshape(k * splits, B // splits, d_in),
                        Wt.reshape(k * splits, d_in, d_out))
    return out.view(k, B, d_out)


def stacked_mlp_apply(
    weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
    x: torch.Tensor, activation: str,
) -> torch.Tensor:
    """Apply k stacked MLPs to a shared input batch.

    Each layer is one batched product over the heads. On the card, where
    a weight gradient is recorded in float32, each product is split along
    the batch axis (:func:`split_count`): the weight gradients reduce over
    the whole batch, and cuBLAS would run each as a single 32 x 32 tile per
    head over all of the rows. A batch that is no multiple of the chunks
    is padded with zero rows, which add exact zeros to every gradient, and
    their outputs are dropped. Each layer takes its own number of chunks,
    so a wide first layer runs whole before its narrow successors split.
    The recorder counts the layer products in ``cvf.heads.split`` and
    ``cvf.heads.whole``.

    Args:
        weights / biases: per layer ``[k, d_out, d_in]`` / ``[k, d_out]``.
        x: input ``[batch, d_in]`` (or a single state ``[d_in]``).

    Returns:
        ``[batch, k * d_out_last]`` with per-head blocks contiguous, as
        ``colvarsfinder_tpu/models/module.py:207-270`` lays them out.
    """
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    style = _mixed_style(x)
    splits = _heads_splits(x, weights, style)
    n_split = sum(s > 1 for s in splits)
    if n_split:
        count("cvf.heads.split", n_split)
    if n_split < len(splits):
        count("cvf.heads.whole", len(splits) - n_split)
    h = _stacked_apply(weights, biases, x, activation, style, splits)
    return h[0] if squeeze else h


def _stacked_apply(weights, biases, x, activation: str, style,
                   splits: tuple) -> torch.Tensor:
    """:func:`stacked_mlp_apply` of ``x`` [B, d_in] with layer ``i``'s
    product split into ``splits[i]`` chunks of the batch axis. The rows are
    padded with zeros to a multiple of a layer's chunks where they are not
    one already (the input for the first layer, before it is broadcast over
    the heads)."""
    act = ACTIVATIONS[activation]
    rows = x.shape[0]
    k = weights[0].shape[0]
    n = len(weights)
    h = x if style is None else x.to(torch.bfloat16)
    pad = -rows % splits[0]
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
    h = h.unsqueeze(0).expand(k, *h.shape)
    for i, (W, b) in enumerate(zip(weights, biases)):
        if style is not None:
            h, W, b = _mixed_operands(h, W, b, style)
        pad = -h.shape[1] % splits[i]
        if pad:
            h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        h = _layer_product(h, W, b, splits[i])
        if i < n - 1:
            h = act(h)
            if style not in (None, "pure"):
                h = h.to(torch.bfloat16)  # the stored activation
    h = h[:, :rows].transpose(0, 1).reshape(rows, -1)
    if style is not None:
        h = h.to(x.dtype)
    return h


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

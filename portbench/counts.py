"""The yardstick's arithmetic: published peaks of the card, the bytes and
operations each hand-written kernel needs at given shapes, and the model
operations per training sample.

Bytes count each input read once and each output written once; operations
count 2 per multiply-add and leave out the activation. Nothing here reads
the program: the shapes come from the configuration.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "f32_flops_per_s": 67e12,  # float32 outside the tensor cores
}

F32 = 4


def head_macs(dims) -> int:
    """Multiply-adds of one head's forward pass for one sample."""
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def k1_bytes(batch: int) -> float:
    """K1 (batched Kabsch rotations): covariances [B, 3, 3] in, rotations
    [B, 3, 3] out."""
    return F32 * batch * (9 + 9)


def k2_bytes(batch: int, n_atoms: int) -> float:
    """K2 (fused alignment): frames [B, N, 3] in, aligned frames out (the
    reference and the indices are negligible)."""
    return F32 * batch * n_atoms * 3 * 2


def k3_flops(batch: int, k: int, dims) -> float:
    """K3 (statistics forward): every head's forward on X and X_l."""
    return 4.0 * batch * k * head_macs(dims)


def k4_flops(batch: int, k: int, dims) -> float:
    """K4 (statistics backward): on X and X_l, the heads' hidden layers
    again (K3 keeps only their outputs), every layer's weight gradient and
    the input gradient of every layer after the first."""
    inner = head_macs(dims) - dims[0] * dims[1]
    return 4.0 * batch * k * (2 * head_macs(dims) + inner)


def bound_seconds(nbytes: float = 0.0, flops: float = 0.0) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the float32 rate."""
    return max(nbytes / PEAKS["hbm_bytes_per_s"],
               flops / PEAKS["f32_flops_per_s"])


def model_flops_per_sample(cfg: dict) -> float:
    """Operations the training step needs per training sample, counted the
    same whatever implements them, with no recomputation.

    Transfer operator: each head's forward on X and on X_l, its weight
    gradients and the input gradients of every layer after the first (the
    features take no gradient); K4 computes the hidden layers again, which
    is not counted here.

    Generator on the Gram path: each head's forward on the features H, one
    reverse pass for its input gradient G (all layers), the quadratic form
    G M G^T (2 d^2 + 2 d), then the parameter gradient of that graph: twice
    the forward and the reverse pass (a product's gradient by both
    operands), and once the quadratic form (M is a constant)."""
    dims, k = cfg["layer_dims"], cfg["k"]
    macs = head_macs(dims)
    if cfg["loss"] == "transfer":
        inner = macs - dims[0] * dims[1]
        return 2 * k * (2.0 * macs + 2.0 * macs + 2.0 * inner)
    if cfg["loss"] == "generator":
        d = dims[0]
        quad = 2.0 * d * d + 2.0 * d
        graph = 2.0 * macs + 2.0 * macs
        return k * (graph + quad + 2.0 * graph + quad)
    raise ValueError(f"no operation count for loss {cfg['loss']!r}")

r"""Fused transfer-operator statistics (port of
``colvarsfinder_tpu/ops/fused_eigen.py``).

The transfer-operator loss depends on a batch only through a few weighted
statistics of the head outputs ``y = mlp(F)`` and ``y_l = mlp(F_l)``:

====================  ====================================================
``tw, twl``           sum w, sum w_l
``s1, s2``            sum w y, sum w y^2             (per head)
``s1l, s2l``          sum w_l y_l, sum w_l y_l^2     (per head)
``sd``                sum w (y_l - y)^2              (per head)
``sc``                sum w y_i y_j                  (per head pair i < j)
====================  ====================================================

so ``loss = g(stats(params, F, F_l, w, w_l))``. :func:`transfer_stats`
computes the stats with kernel K3 (``csrc/fused_eigen.cu``,
``cvf_stats_fwd``, replacing ``_fwd_kernel_factory``,
``fused_eigen.py:146-215``) and its backward with kernel K4
(``cvf_stats_bwd``, replacing ``_bwd_kernel_factory``, ``:230-321``),
both inside one ``torch.autograd.Function``. Gradients reach the
parameters only; the data inputs get none, as in the JAX ``custom_vjp``.

The plain version of both kernels is :func:`transfer_stats_reference` with
autograd; the wrapper takes it for CPU tensors and launches the kernels for
CUDA tensors.

Limits of the CUDA design: a block keeps all heads' weights (twice in the
backward, for the gradient accumulators) and a tile of per-sample
activations in shared memory, so the footprint of
:func:`stats_smem_bytes` at the smallest tile (32 samples) must fit the
H100's 227 KB per block; the last layer must have width 1 and there may be
at most 16 layers. The JAX limits ``k * hidden <= 256`` and ``k <= 9``
came from TPU VMEM and the 128-lane row and do not apply.
:func:`fused_tile` checks this.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import _cuda
from ..models.module import _tanh_precise as _act

__all__ = [
    "eigen_loss_from_stats",
    "fused_tile",
    "params_t_of",
    "stats_layout",
    "stats_smem_bytes",
    "transfer_stats",
    "transfer_stats_reference",
]

#: shared memory one block may use on an H100 (bytes)
SMEM_LIMIT = 232_448
#: sample tiles tried, largest first (one block per tile, one thread per
#: sample)
TILES = (128, 64, 32)
MAX_LAYERS = 16


def stats_layout(k: int):
    """Index layout of the stats vector; returns (n_stats, index dict)."""
    idx = {"tw": 0, "twl": 1}
    pos = 2
    for name in ("s1", "s2", "s1l", "s2l", "sd"):
        idx[name] = pos
        pos += k
    idx["sc"] = pos
    pos += k * (k - 1) // 2
    return pos, idx


def _pairs(k: int):
    return [(i, j) for i in range(k) for j in range(i + 1, k)]


def _n_params(dims: Sequence[int], k: int) -> int:
    return sum(k * a * b + k * b for a, b in zip(dims[:-1], dims[1:]))


def stats_smem_bytes(dims: Sequence[int], k: int, tile: int,
                     backward: bool) -> int:
    """Dynamic shared memory of one K3 (``backward=False``) or K4 block, in
    the layout of ``csrc/fused_eigen.cu``."""
    P = tile + 1
    n_params = _n_params(dims, k)
    n_stats, _ = stats_layout(k)
    hidden = list(dims[1:-1])
    common = 2 * k * tile + 2 * tile + dims[0] * P
    if backward:
        hid_rows = sum(hidden)
        floats = 2 * n_params + n_stats + common + (2 * hid_rows + 1) * P
    else:
        floats = n_params + common + 2 * max(hidden, default=0) * P
    return 4 * floats


def fused_tile(dims: Sequence[int], k: int) -> int:
    """Largest sample tile whose K3 and K4 blocks fit in shared memory;
    raises ValueError for models the CUDA kernels do not take."""
    dims = tuple(int(d) for d in dims)
    if dims[-1] != 1:
        raise ValueError(f"the fused step needs scalar heads, got dims {dims}")
    if not 1 <= len(dims) - 1 <= MAX_LAYERS:
        raise ValueError(
            f"the fused step takes 1 to {MAX_LAYERS} layers, got "
            f"{len(dims) - 1}"
        )
    for tile in TILES:
        if stats_smem_bytes(dims, k, tile, backward=True) <= SMEM_LIMIT:
            return tile
    need = stats_smem_bytes(dims, k, TILES[-1], backward=True)
    raise ValueError(
        f"the fused step's backward block needs {need} bytes of shared "
        f"memory for dims {dims} and k={k} (at a 32-sample tile), more "
        f"than the {SMEM_LIMIT} an H100 block has; use fused_step=False "
        "for this model"
    )


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _mlp_heads(params_t, x):
    """Per-head MLP forward on [B, d] -> [B, k] for transposed params
    ``((W_t [k, h_in, h_out], b [k, h_out]), ...)``."""
    k = params_t[0][0].shape[0]
    ys = []
    for kk in range(k):
        h = x
        for li, (w_t, b) in enumerate(params_t):
            h = h @ w_t[kk] + b[kk]
            if li < len(params_t) - 1:
                h = _act(h)
        ys.append(h[:, 0])
    return torch.stack(ys, dim=1)


def transfer_stats_reference(params_t, F, F_l, w, w_l):
    """Plain PyTorch stats vector (the oracle of kernels K3 and K4)."""
    k = params_t[0][0].shape[0]
    y = _mlp_heads(params_t, F)
    y_l = _mlp_heads(params_t, F_l)
    parts = [
        w.sum()[None],
        w_l.sum()[None],
        (y * w[:, None]).sum(dim=0),
        (y**2 * w[:, None]).sum(dim=0),
        (y_l * w_l[:, None]).sum(dim=0),
        (y_l**2 * w_l[:, None]).sum(dim=0),
        (((y_l - y) ** 2) * w[:, None]).sum(dim=0),
    ]
    sc = [(y[:, i] * y[:, j] * w).sum()[None] for (i, j) in _pairs(k)]
    return torch.cat(parts + sc)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _check_data(F, F_l, w, w_l):
    B, d = F.shape
    for name, t, shape in (("F", F, (B, d)), ("F_l", F_l, (B, d)),
                           ("w", w, (B,)), ("w_l", w_l, (B,))):
        if t.device.type != "cuda" or t.device != F.device:
            raise ValueError(f"{name} must be a CUDA tensor on {F.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if B == 0:
        raise ValueError("empty batch")


def _check_flat(flat, dims, k, device):
    n = _n_params(dims, k)
    if (flat.device != device or flat.dtype != torch.float32
            or tuple(flat.shape) != (n,) or not flat.is_contiguous()):
        raise ValueError(
            f"flat params must be a contiguous float32 [{n}] tensor on "
            f"{device}, got {flat.dtype} {tuple(flat.shape)} on {flat.device}"
        )


def _dims_arg(dims):
    import ctypes

    return (ctypes.c_int * len(dims))(*dims)


def stats_fwd_launch(flat, F, F_l, w, w_l, dims: Tuple[int, ...], k: int):
    """Launch K3: flat params + data -> stats [n_stats] (float32)."""
    _check_data(F, F_l, w, w_l)
    if F.shape[1] != dims[0]:
        raise ValueError(f"F has width {F.shape[1]}, dims[0] is {dims[0]}")
    _check_flat(flat, dims, k, F.device)
    tile = fused_tile(dims, k)
    B = F.shape[0]
    n_stats, _ = stats_layout(k)
    nblocks = -(-B // tile)
    partials = torch.empty(nblocks * n_stats, dtype=torch.float32,
                           device=F.device)
    stats = torch.empty(n_stats, dtype=torch.float32, device=F.device)
    lib = _cuda.library("fused_eigen")
    err = lib.cvf_stats_fwd(
        flat.data_ptr(), F.data_ptr(), F_l.data_ptr(), w.data_ptr(),
        w_l.data_ptr(), partials.data_ptr(), stats.data_ptr(),
        _dims_arg(dims), len(dims) - 1, k, B, tile,
        stats_smem_bytes(dims, k, tile, backward=False),
        _cuda.stream_handle(),
    )
    _cuda.check(err, "cvf_stats_fwd")
    _cuda.LAUNCHES["stats_fwd"] += 1
    return stats


def stats_bwd_launch(flat, F, F_l, w, w_l, d_stats,
                     dims: Tuple[int, ...], k: int):
    """Launch K4: dL/dstats -> dL/d(flat params) (float32)."""
    _check_data(F, F_l, w, w_l)
    _check_flat(flat, dims, k, F.device)
    n_stats, _ = stats_layout(k)
    if (d_stats.device != F.device or d_stats.dtype != torch.float32
            or tuple(d_stats.shape) != (n_stats,)
            or not d_stats.is_contiguous()):
        raise ValueError(f"d_stats must be a contiguous float32 [{n_stats}]")
    tile = fused_tile(dims, k)
    B = F.shape[0]
    nblocks = -(-B // tile)
    partials = torch.empty(nblocks * flat.shape[0], dtype=torch.float32,
                           device=F.device)
    grads = torch.empty_like(flat)
    lib = _cuda.library("fused_eigen")
    err = lib.cvf_stats_bwd(
        flat.data_ptr(), F.data_ptr(), F_l.data_ptr(), w.data_ptr(),
        w_l.data_ptr(), d_stats.data_ptr(), partials.data_ptr(),
        grads.data_ptr(), _dims_arg(dims), len(dims) - 1, k, B, tile,
        stats_smem_bytes(dims, k, tile, backward=True),
        _cuda.stream_handle(),
    )
    _cuda.check(err, "cvf_stats_bwd")
    _cuda.LAUNCHES["stats_bwd"] += 1
    return grads


class _TransferStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, flat, F, F_l, w, w_l, dims, k):
        ctx.save_for_backward(flat, F, F_l, w, w_l)
        ctx.dims, ctx.k = dims, k
        return stats_fwd_launch(flat, F, F_l, w, w_l, dims, k)

    @staticmethod
    def backward(ctx, d_stats):
        flat, F, F_l, w, w_l = ctx.saved_tensors
        g = stats_bwd_launch(flat, F, F_l, w, w_l, d_stats.contiguous(),
                             ctx.dims, ctx.k)
        return g, None, None, None, None, None, None


def _dims_of(params_t) -> Tuple[int, ...]:
    dims = [int(params_t[0][0].shape[1])]
    for (w_t, _) in params_t:
        dims.append(int(w_t.shape[2]))
    return tuple(dims)


def flatten_params(params_t) -> torch.Tensor:
    """The flat parameter buffer of the kernels: per layer W_t then b."""
    return torch.cat(
        [t.reshape(-1) for (w_t, b) in params_t for t in (w_t, b)]
    )


def transfer_stats(params_t, F, F_l, w, w_l):
    """Batch statistics of the transfer-operator loss.

    Args:
        params_t: per layer ``(W_t [k, h_in, h_out], b [k, h_out])`` — the
            transposed layout of :func:`params_t_of`.
        F / F_l: feature batches [B, d]; w / w_l: sample weights [B].

    Returns:
        stats [n_stats] in :func:`stats_layout` order. On CUDA tensors the
        forward is kernel K3 and the backward kernel K4 (gradients to the
        parameters only); on CPU tensors the plain version runs.
    """
    if F.device.type == "cpu":
        return transfer_stats_reference(params_t, F, F_l, w, w_l)
    dims = _dims_of(params_t)
    k = int(params_t[0][0].shape[0])
    return _TransferStats.apply(
        flatten_params(params_t), F.contiguous(), F_l.contiguous(),
        w.contiguous(), w_l.contiguous(), dims, k,
    )


def unflatten_grads(flat_grads: torch.Tensor, params_t):
    """Split a flat gradient (the kernels' layout) into per-layer
    ``(dW_t, db)`` shaped like ``params_t``."""
    out, pos = [], 0
    for (w_t, b) in params_t:
        nW, nb = w_t.numel(), b.numel()
        out.append((flat_grads[pos:pos + nW].view(w_t.shape),
                    flat_grads[pos + nW:pos + nW + nb].view(b.shape)))
        pos += nW + nb
    return tuple(out)


# ---------------------------------------------------------------------------
# loss on top of the stats
# ---------------------------------------------------------------------------


def eigen_loss_from_stats(
    stats, *, k: int, alpha: float, eig_w, lag_idx: int, traj_dt: float,
    sort_eigvals: bool,
):
    """Transfer-operator eigen loss from the stats vector
    (``colvarsfinder_tpu/ops/fused_eigen.py:568-615``), with the preserved
    quirks: unsorted numerator over sorted denominator, and the penalty
    over unsorted heads. Returns
    ``(loss, (eig_vals, non_penalty, penalty, cvec))``."""
    _, ix = stats_layout(k)
    tw, twl = stats[0], stats[1]
    s1 = stats[ix["s1"]:ix["s1"] + k]
    s2 = stats[ix["s2"]:ix["s2"] + k]
    s1l = stats[ix["s1l"]:ix["s1l"] + k]
    s2l = stats[ix["s2l"]:ix["s2l"] + k]
    sd = stats[ix["sd"]:ix["sd"] + k]
    sc = stats[ix["sc"]:]

    means = s1 / tw
    variances = s2 / tw - means**2
    means_l = s1l / twl
    variances_l = s2l / twl - means_l**2
    quot_unsorted_num = sd / tw
    quotients = (quot_unsorted_num / (variances + variances_l)) / (
        traj_dt * lag_idx
    )
    eig_vals = quotients.detach()
    if sort_eigvals:
        cvec = torch.argsort(eig_vals, stable=True)
        eig_vals = eig_vals[cvec]
    else:
        cvec = torch.arange(k, device=stats.device)

    eig_w_t = torch.as_tensor(eig_w, dtype=stats.dtype, device=stats.device)
    denom = variances[cvec] + variances_l[cvec]
    non_penalty = (eig_w_t * quot_unsorted_num / denom).sum() / (
        traj_dt * lag_idx
    )
    penalty = ((variances - 1.0) ** 2).sum()
    for pi, (i, j) in enumerate(_pairs(k)):
        cov = sc[pi] / tw - means[i] * means[j]
        penalty = penalty + cov**2
    loss = non_penalty + alpha * penalty
    return loss, (eig_vals, non_penalty, penalty, cvec)


def params_t_of(model) -> tuple:
    """Transposed-parameter view of an ``EigenFunctions`` module for
    :func:`transfer_stats` (same layout as the JAX ``params_t_of``)."""
    return tuple(
        (W.transpose(1, 2), b) for W, b in zip(model.weights, model.biases)
    )

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

Limits of the CUDA design. K3 runs one block per sample tile and keeps all
heads' weights and the tile's inputs and two hidden layers in shared
memory; K4 runs one block per (sample tile, head) and keeps that head's
weights twice (values and gradient accumulators) and the tile's activations
and cotangents. Both must fit the H100's 227 KB per block at their smallest
tile (32 samples): :func:`fwd_launch_shape` and :func:`bwd_launch_shape`
give each kernel's :class:`LaunchShape` (tile, threads, shared memory), and
each raises ValueError naming the limit. The last layer must have width 1 and
there may be at most 16 layers. The JAX limits ``k * hidden <= 256`` and
``k <= 9`` came from TPU VMEM and the 128-lane row and do not apply.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from . import _cuda
from ..models.module import _tanh_precise as _act

__all__ = [
    "LaunchShape",
    "bwd_launch_shape",
    "bwd_resident_blocks",
    "eigen_loss_from_stats",
    "fwd_launch_shape",
    "fwd_resident_blocks",
    "params_t_of",
    "stats_layout",
    "stats_smem_bytes",
    "transfer_stats",
    "transfer_stats_reference",
]

#: shared memory one block may use on an H100 (bytes)
SMEM_LIMIT = 232_448
#: sample tiles K3 and K4 try, largest first (the faster for both at the
#: main path's shapes); K3 runs one block per tile, K4 one per tile and head
TILES = (64, 32)
#: threads per sample of K3 and K4
THREADS_PER_SAMPLE = 4
MAX_LAYERS = 16
# one H100 SM: shared memory, what the runtime reserves of it per block,
# threads, blocks and registers; the kernels' __launch_bounds__ (6 blocks of
# 128 or 3 of 256 threads) cap a thread at 80 registers
SM_SMEM = 233_472
SM_SMEM_PER_BLOCK = 1024
SM_THREADS = 2048
SM_BLOCKS = 32
SM_REGISTERS = 65_536
MAX_REGISTERS = 80


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
    n_stats, _ = stats_layout(k)
    hidden = list(dims[1:-1])
    if backward:
        hid_rows = sum(hidden)
        n_head = _n_params(dims, 1)
        floats = 2 * n_head + tile + (dims[0] + 2 * hid_rows + 2) * P
    else:
        floats = (_n_params(dims, k) + 2 * k * tile + 2 * tile + dims[0] * P
                  + 2 * max(hidden, default=0) * P)
    return 4 * floats


def _check_dims(dims) -> Tuple[int, ...]:
    dims = tuple(int(d) for d in dims)
    if dims[-1] != 1:
        raise ValueError(f"the fused step needs scalar heads, got dims {dims}")
    if not 1 <= len(dims) - 1 <= MAX_LAYERS:
        raise ValueError(
            f"the fused step takes 1 to {MAX_LAYERS} layers, got "
            f"{len(dims) - 1}"
        )
    return dims


def _too_large(which: str, need: int, dims, k) -> ValueError:
    return ValueError(
        f"the fused step's {which} block needs {need} bytes of shared "
        f"memory for dims {dims} and k={k} (at a 32-sample tile), more "
        f"than the {SMEM_LIMIT} an H100 block has; use fused_step=False "
        "for this model"
    )


class LaunchShape(NamedTuple):
    """Launch shape of K3 or K4: one block of ``threads`` per ``tile``
    samples (K4: per tile and head), with ``smem_bytes`` of dynamic shared
    memory."""

    tile: int
    threads: int
    smem_bytes: int

    @property
    def blocks_per_sm(self) -> int:
        """Blocks an H100 SM holds at once, by its limits on threads,
        blocks, registers (at the kernels' cap, so the kernel may fit more)
        and shared memory."""
        return min(SM_THREADS // self.threads, SM_BLOCKS,
                   SM_REGISTERS // (self.threads * MAX_REGISTERS),
                   SM_SMEM // (self.smem_bytes + SM_SMEM_PER_BLOCK))

    @property
    def warps_per_sm(self) -> int:
        return self.blocks_per_sm * self.threads // 32


def _launch_shape(dims, k, backward) -> LaunchShape:
    dims = _check_dims(dims)
    for tile in TILES:
        smem = stats_smem_bytes(dims, k, tile, backward=backward)
        if smem <= SMEM_LIMIT:
            return LaunchShape(tile, THREADS_PER_SAMPLE * tile, smem)
    raise _too_large("backward" if backward else "forward", smem, dims, k)


def fwd_launch_shape(dims: Sequence[int], k: int) -> LaunchShape:
    """K3's launch shape: the largest tile of :data:`TILES` whose block
    fits in shared memory; raises ValueError for models K3 does not take."""
    return _launch_shape(dims, k, backward=False)


def bwd_launch_shape(dims: Sequence[int], k: int) -> LaunchShape:
    """K4's launch shape: the largest tile of :data:`TILES` whose block
    fits in shared memory; raises ValueError for models K4 does not take."""
    return _launch_shape(dims, k, backward=True)


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
    """Launch K3: flat params + data -> (stats [n_stats], Y [2, k, B]), the
    head outputs on F then F_l (float32)."""
    _check_data(F, F_l, w, w_l)
    if F.shape[1] != dims[0]:
        raise ValueError(f"F has width {F.shape[1]}, dims[0] is {dims[0]}")
    _check_flat(flat, dims, k, F.device)
    shape = fwd_launch_shape(dims, k)
    B = F.shape[0]
    n_stats, _ = stats_layout(k)
    nblocks = -(-B // shape.tile)
    partials = torch.empty(nblocks * n_stats, dtype=torch.float32,
                           device=F.device)
    stats = torch.empty(n_stats, dtype=torch.float32, device=F.device)
    Y = torch.empty((2, k, B), dtype=torch.float32, device=F.device)
    lib = _cuda.library("fused_eigen")
    err = lib.cvf_stats_fwd(
        flat.data_ptr(), F.data_ptr(), F_l.data_ptr(), w.data_ptr(),
        w_l.data_ptr(), partials.data_ptr(), stats.data_ptr(), Y.data_ptr(),
        _dims_arg(dims), len(dims) - 1, k, B, shape.tile, shape.smem_bytes,
        _cuda.stream_handle(),
    )
    _cuda.check(err, "cvf_stats_fwd")
    _cuda.LAUNCHES["stats_fwd"] += 1
    return stats, Y


def stats_bwd_launch(flat, F, F_l, w, w_l, Y, d_stats,
                     dims: Tuple[int, ...], k: int):
    """Launch K4: dL/dstats and K3's head outputs Y [2, k, B] ->
    dL/d(flat params) (float32)."""
    _check_data(F, F_l, w, w_l)
    _check_flat(flat, dims, k, F.device)
    n_stats, _ = stats_layout(k)
    B = F.shape[0]
    for name, t, shape in (("Y", Y, (2, k, B)), ("d_stats", d_stats,
                                                  (n_stats,))):
        if (t.device != F.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous float32 {list(shape)} tensor on "
                f"{F.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    shape = bwd_launch_shape(dims, k)
    nblocks = -(-B // shape.tile)
    partials = torch.empty(nblocks * flat.shape[0], dtype=torch.float32,
                           device=F.device)
    grads = torch.empty_like(flat)
    lib = _cuda.library("fused_eigen")
    err = lib.cvf_stats_bwd(
        flat.data_ptr(), F.data_ptr(), F_l.data_ptr(), w.data_ptr(),
        w_l.data_ptr(), Y.data_ptr(), d_stats.data_ptr(), partials.data_ptr(),
        grads.data_ptr(), _dims_arg(dims), len(dims) - 1, k, B, shape.tile,
        shape.smem_bytes, _cuda.stream_handle(),
    )
    _cuda.check(err, "cvf_stats_bwd")
    _cuda.LAUNCHES["stats_bwd"] += 1
    return grads


def _resident_blocks(entry: str, shape: LaunchShape) -> int:
    import ctypes

    out = ctypes.c_int(0)
    err = getattr(_cuda.library("fused_eigen"), entry)(
        shape.tile, shape.smem_bytes, ctypes.byref(out))
    _cuda.check(err, entry)
    return out.value


def fwd_resident_blocks(dims: Tuple[int, ...], k: int) -> int:
    """K3 blocks resident on one SM of the current card at the model's
    launch shape, as ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    reports it."""
    return _resident_blocks("cvf_stats_fwd_occupancy",
                            fwd_launch_shape(dims, k))


def bwd_resident_blocks(dims: Tuple[int, ...], k: int) -> int:
    """K4 blocks resident on one SM of the current card at the model's
    launch shape, as ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    reports it."""
    return _resident_blocks("cvf_stats_bwd_occupancy",
                            bwd_launch_shape(dims, k))


class _TransferStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, flat, F, F_l, w, w_l, dims, k):
        stats, Y = stats_fwd_launch(flat, F, F_l, w, w_l, dims, k)
        ctx.save_for_backward(flat, F, F_l, w, w_l, Y)
        ctx.dims, ctx.k = dims, k
        return stats

    @staticmethod
    def backward(ctx, d_stats):
        flat, F, F_l, w, w_l, Y = ctx.saved_tensors
        g = stats_bwd_launch(flat, F, F_l, w, w_l, Y, d_stats.contiguous(),
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

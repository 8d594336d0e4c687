r"""The two collectives a meshed train step makes (:mod:`.mesh`), and the
plain all-gather of the meshed samplers.

Every loss of the port is a nonlinear function of batch statistics
(weighted means, centred moments, quotients of them), so per-rank losses
with averaged gradients, as ``DistributedDataParallel`` trains, would
compute another loss. Here each rank evaluates the loss of the whole batch:

* :func:`gather_rows` concatenates every rank's per-sample tensors in rank
  order, so that the gathered batch is the unsharded batch, and every rank
  computes the same loss from it. Its backward returns this rank's rows of
  the cotangent and communicates nothing: the autograd collectives of
  ``torch.distributed.nn`` sum the cotangents over the ranks, which, with
  every rank holding the same loss, makes the gradient W times too large.
* :func:`all_reduce_grads` then sums the parameter gradients over the
  ranks, once per train step, in one flat buffer: each rank's gradient is
  its rows' share of the whole batch's.

Both run at any world size, W = 1 included, and at W = 1 they return the
very values they were given, so a meshed run of one rank is bit for bit the
unmeshed run. The gather is one sum all-reduce of a zero-filled buffer
into which each rank writes its rows (adding zeros is exact). On NCCL both
reduce with a pre-multiplied sum by 1.0, which is the sum, exactly: NCCL
skips an in-place sum of one rank without launching anything, and the
pre-multiplied sum runs its reduce kernel at every world size, so a graph
captured at W = 1 holds the collectives it holds at W > 1.

:func:`all_gather_rows` is one all-gather with no autograd, for the
samplers (:mod:`..utils.enhanced`), whose chains are independent: it
gathers the slots of a replica exchange inside its captured block, and a
call's recorded arrays at its end.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import mesh_coords

__all__ = ["all_gather_rows", "all_reduce_grads", "gather_rows"]


def _sum(tensor: torch.Tensor, group) -> None:
    """In-place sum of ``tensor`` over ``group``."""
    if dist.get_backend(group) == "nccl":
        op = dist._make_nccl_premul_sum(1.0)
    else:
        op = dist.ReduceOp.SUM
    dist.all_reduce(tensor, op=op, group=group)


def _like(values: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``values`` laid out in memory with ``t``'s order of dimensions: a
    reduction then runs over the gathered tensor in the order it runs over
    ``t`` (a model's [B, k] output may be a transposed view), so that at
    W = 1 its bits are the unmeshed ones."""
    order = sorted(range(t.dim()), key=lambda d: (-t.stride(d), d))
    out = torch.empty_permuted(values.shape, order, dtype=values.dtype,
                               device=values.device)
    return out.copy_(values)


class _GatherRows(torch.autograd.Function):
    """Forward: every rank's rows of each tensor, in rank order, through
    one all-reduce. Backward: this rank's rows of each cotangent."""

    @staticmethod
    def forward(ctx, rank, size, group, *tensors):
        b = tensors[0].shape[0]
        flat = [t.reshape(b, -1) for t in tensors]
        widths = [f.shape[1] for f in flat]
        buf = flat[0].new_zeros((size * b, sum(widths)))
        torch.cat(flat, dim=1, out=buf[rank * b:(rank + 1) * b])
        _sum(buf, group)
        outs = tuple(_like(part.reshape((size * b,) + tuple(t.shape[1:])), t)
                     for part, t in zip(torch.split(buf, widths, dim=1),
                                        tensors))
        ctx.rows = slice(rank * b, (rank + 1) * b)
        ctx.mark_non_differentiable(*(o for o, t in zip(outs, tensors)
                                      if not t.requires_grad))
        ctx.set_materialize_grads(False)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None) + tuple(
            None if g is None else g[ctx.rows] for g in grads)


def gather_rows(mesh, *tensors):
    """``tensors`` (each [b, ...], one dtype, the same b on every rank) of
    every rank of ``mesh``, concatenated along axis 0 in rank order: the
    per-sample tensors of the whole batch, [W·b, ...] each, as a tuple.
    Differentiable; the backward of an output is this rank's rows of its
    cotangent, with no communication."""
    rank, size, group = mesh_coords(mesh)
    return _GatherRows.apply(rank, size, group, *tensors)


def all_reduce_grads(params, mesh) -> None:
    """Sum the gradients of ``params`` (those that have one) over the ranks
    of ``mesh``, in place, through one flat buffer."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    _, _, group = mesh_coords(mesh)
    flat = torch.cat([g.reshape(-1) for g in grads])
    _sum(flat, group)
    torch._foreach_copy_(grads, [part.view_as(g) for part, g in zip(
        flat.split([g.numel() for g in grads]), grads)])


def all_gather_rows(mesh, tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` [b, ...] (the same shape on every rank) of every rank of
    ``mesh``, concatenated along axis 0 in rank order: [W·b, ...], through
    one all-gather into a new tensor. No autograd."""
    _, size, group = mesh_coords(mesh)
    # all_gather_into_tensor under its newer name where torch has it
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    out = tensor.new_empty((size * tensor.shape[0],) + tuple(tensor.shape[1:]))
    gather(out, tensor.contiguous(), group=group)
    return out

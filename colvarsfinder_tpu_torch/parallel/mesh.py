r"""The data mesh over ``torch.distributed`` (port of
``colvarsfinder_tpu/parallel/mesh.py``).

The JAX package's mesh is one program over every device: parameters and
optimizer state replicated, batches sharded along their batch axis, and
the losses' global weighted reductions turned into ``psum``\ s by XLA. The
port runs one process per card (``torchrun --nproc-per-node=N``, or any
launcher that calls ``torch.distributed.init_process_group``), and the
mesh is a 1-axis ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks of that group. Each rank keeps its contiguous share of every batch;
the losses gather their per-sample tensors in batch order and the train
step sums the parameter gradients once
(:mod:`.collectives`), so that a meshed run computes what one device does.

These are the JAX package's four helpers; the tasks take ``mesh=`` and use
them themselves.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "make_data_mesh",
    "replicate",
    "shard_batches",
    "shard_frames",
]


def make_data_mesh(device_type: Optional[str] = None,
                   axis_name: str = "data"):
    """A 1-axis ``DeviceMesh`` named ``axis_name`` over every rank of the
    initialised default process group, one device per rank. ``device_type``
    defaults to ``'cuda'`` for an NCCL group and ``'cpu'`` otherwise.

    Raises ``ValueError`` without a process group: call
    ``torch.distributed.init_process_group`` in every process first (as
    ``torchrun`` arranges); no group of one rank is made here."""
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            "make_data_mesh needs an initialised default process group: call "
            "torch.distributed.init_process_group(...) in every process "
            "first, e.g. under torchrun --nproc-per-node=N")
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(axis_name,))


def mesh_coords(mesh) -> tuple:
    """``(rank, size, group)``: this process's position on the 1-axis
    ``mesh``, the number of ranks and their process group."""
    return mesh.get_local_rank(), mesh.size(), mesh.get_group()


def shared_seed(seed: Optional[int], mesh, device) -> int:
    """``seed``, or where it is None one drawn with numpy: on a mesh, rank
    0's draw, broadcast, so that every rank takes the same."""
    if seed is not None:
        return seed
    drawn = [int(np.random.randint(0, 2**31 - 1))]
    if mesh is not None:
        _, _, group = mesh_coords(mesh)
        dist.broadcast_object_list(drawn, src=dist.get_global_rank(group, 0),
                                   group=group, device=device)
    return drawn[0]


def replicate(module_or_tensors: Any, mesh) -> Any:
    """Broadcast every parameter and buffer of a module (or every tensor
    of a sequence) from the mesh's rank 0, in place, so that every rank
    starts from rank 0's values; returns its argument. Without a mesh it
    returns it unchanged."""
    if mesh is None:
        return module_or_tensors
    _, _, group = mesh_coords(mesh)
    src = dist.get_global_rank(group, 0)
    if isinstance(module_or_tensors, torch.nn.Module):
        tensors = [*module_or_tensors.parameters(),
                   *module_or_tensors.buffers()]
    else:
        tensors = list(module_or_tensors)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=src, group=group)
    return module_or_tensors


def _rank_slice(n: int, mesh, what: str) -> slice:
    rank, size, _ = mesh_coords(mesh)
    if n % size:
        raise ValueError(f"{what} of {n} does not divide over the mesh's "
                         f"{size} ranks")
    share = n // size
    return slice(rank * share, (rank + 1) * share)


def shard_batches(t, mesh):
    """This rank's contiguous share of ``t`` [num_batches, batch, ...]
    along the batch axis (axis 1), as ``P(None, 'data')`` places it in the
    JAX package; a numpy array or a tensor, sliced, not copied. Raises
    ``ValueError`` when the batch does not divide over the ranks. Without a
    mesh ``t`` itself."""
    if mesh is None:
        return t
    return t[:, _rank_slice(t.shape[1], mesh, "a batch")]


def shard_frames(t, mesh, pad: bool = False):
    """This rank's contiguous share of ``t`` [n_frames, ...] along the
    frame axis (axis 0). A frame count that does not divide over the ranks
    raises ``ValueError``, or with ``pad=True`` is zero-padded up to the next
    multiple first (only for arrays addressed through index arrays, whose
    padding rows are never read, as in the JAX package). Without a mesh
    ``t`` itself."""
    if mesh is None:
        return t
    _, size, _ = mesh_coords(mesh)
    extra = (-t.shape[0]) % size
    if pad and extra:
        if torch.is_tensor(t):
            t = torch.cat([t, t.new_zeros((extra,) + tuple(t.shape[1:]))])
        else:
            t = np.concatenate([np.asarray(t), np.zeros(
                (extra,) + tuple(t.shape[1:]), dtype=np.asarray(t).dtype)])
    return t[_rank_slice(t.shape[0], mesh, "a frame count")]

r"""CUDA kernel K5, grouped pair distances (``csrc/pair_distances.cu``,
``cvf_pair_distances``): frames x [B, N, 3] float32 or float64 and an
int32 pair list [P, 2] in, the distances [B, P] in x's dtype out. A
:class:`.features.FeatureLayer` evaluates each run of consecutive ``bond``
features through it on a CUDA tensor without a box; with a box (the
minimum image, which the kernel does not take) or on the CPU the layer
takes the plain grouped version, :func:`.features.pair_distances`, which is
also this kernel's reference and, through autograd, its backward. A CUDA
tensor of another dtype, or a frame of more atoms than a block's shared
memory holds (:func:`max_atoms`), raises. The JAX package has no
counterpart kernel: there XLA fuses the per-feature distances.

At a protein's descriptor set (CLN025: N = 93 heavy atoms, P = 4,278
pairs) a frame's distances are 15 times its coordinates' bytes, so the
kernel is bound by its writes at the card's memory rate; the plain version
moves [B, P, 3] intermediates through several kernels instead. One block
stages one frame in shared memory and writes its distances in coalesced
lines.

The launch is the ``torch.library`` operator ``cvf_torch::pair_distances``
(the kernel on a CUDA tensor, a fake implementation for traces), as K1's
and K2's are. Its backward is the plain version's vjp, recorded where the
caller asks for ``create_graph=True`` (the generator loss, biasing forces
along a distance CV), as K2's is.
"""

from __future__ import annotations

import torch

from ..logging_utils import count
from . import _cuda
from .features import pair_distances
from .kabsch_cuda import _plain_vjp

__all__ = [
    "max_atoms",
    "pair_distances_cuda",
    "pair_distances_launch",
]

_DTYPES = (torch.float32, torch.float64)
_MAX_ATOMS: dict = {}


def max_atoms(device: torch.device, dtype: torch.dtype) -> int:
    """The most atoms a frame of ``dtype`` may have for K5 on ``device``:
    a block stages its frame in the shared memory a block may opt in to
    (227 KiB on an H100: 19,370 atoms in float32, 9,685 in float64)."""
    import ctypes

    key = (torch.device(device).index, dtype)
    if key not in _MAX_ATOMS:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = _cuda.library("pair_distances").cvf_pair_distances_max_atoms(
                int(dtype == torch.float64), ctypes.byref(out))
        _cuda.check(err, "cvf_pair_distances_max_atoms")
        _MAX_ATOMS[key] = out.value
    return _MAX_ATOMS[key]


def pair_distances_launch(x: torch.Tensor,
                          pairs: torch.Tensor) -> torch.Tensor:
    """Launch K5 on x [B, N, 3] float32 or float64 (N at most
    :func:`max_atoms`) and int32 ``pairs`` [P, 2] (both CUDA, contiguous,
    on one device; every index in [0, N)), one block a frame."""
    if x.device.type != "cuda" or pairs.device != x.device:
        raise ValueError(f"x and pairs must be on one CUDA device, got "
                         f"{x.device} and {pairs.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"K5 takes float32 or float64 frames, got {x.dtype}")
    if pairs.dtype != torch.int32:
        raise TypeError(f"pairs must be torch.int32, got {pairs.dtype}")
    if not (x.dim() == 3 and x.shape[2] == 3 and pairs.dim() == 2
            and pairs.shape[1] == 2):
        raise ValueError(f"x [B, N, 3] and pairs [P, 2] expected, got "
                         f"{tuple(x.shape)} and {tuple(pairs.shape)}")
    if not (x.is_contiguous() and pairs.is_contiguous()):
        raise ValueError("x and pairs must be contiguous")
    B, N = x.shape[0], x.shape[1]
    most = max_atoms(x.device, x.dtype)
    if N > most:
        raise ValueError(f"K5 takes frames of at most {most} atoms in "
                         f"{x.dtype} on this card, got {N}")
    out = torch.empty(B, pairs.shape[0], dtype=x.dtype, device=x.device)
    err = _cuda.library("pair_distances").cvf_pair_distances(
        x.data_ptr(), pairs.data_ptr(), out.data_ptr(), B, N,
        pairs.shape[0], int(x.dtype == torch.float64), _cuda.stream_handle())
    _cuda.check(err, "cvf_pair_distances")
    count(_cuda.COUNTER + "pair_distances")
    return out


@torch.library.custom_op("cvf_torch::pair_distances", mutates_args=(),
                         device_types="cuda")
def _pair_distances_op(x: torch.Tensor, pairs: torch.Tensor) -> torch.Tensor:
    """K5 on x [B, N, 3] and int32 pairs [P, 2]."""
    return pair_distances_launch(x, pairs)


@_pair_distances_op.register_fake
def _(x, pairs):
    return x.new_empty(x.shape[0], pairs.shape[0])


class _PairDistances(torch.autograd.Function):
    """K5 forward; the backward differentiates :func:`.features.
    pair_distances` at x, twice where asked (:func:`.kabsch_cuda.
    _plain_vjp`)."""

    @staticmethod
    def forward(ctx, x, pairs):
        ctx.save_for_backward(x, pairs)
        return torch.ops.cvf_torch.pair_distances(x.contiguous(), pairs)

    @staticmethod
    def backward(ctx, g):
        x, pairs = ctx.saved_tensors
        gx = _plain_vjp(lambda xd: pair_distances(xd, pairs), x, g)
        return gx, None


def pair_distances_cuda(x: torch.Tensor, pairs: torch.Tensor,
                        max_index: int) -> torch.Tensor:
    """Distances [B, P] of the CUDA frames ``x`` [B, N, 3] for the int32
    ``pairs`` [P, 2] through K5, equal to :func:`.features.pair_distances`
    without a box; differentiable w.r.t. ``x``. ``max_index`` is the
    largest index in ``pairs``, which the caller knows (a feature layer
    keeps it), so that a captured step reads nothing back from the card."""
    if max_index >= x.shape[1]:
        raise IndexError(f"pair index {max_index} out of range for "
                         f"{x.shape[1]} atoms")
    return _PairDistances.apply(x, pairs.contiguous())

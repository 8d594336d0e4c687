"""Global numerics configuration of the PyTorch port.

Counterpart of ``colvarsfinder_tpu/config.py:30-88``: a default floating
dtype for parameters and trajectories, and the precision of float32
matrix products. On an NVIDIA card "high" lets cuBLAS use TF32 tensor
cores (about three decimal digits); "highest" keeps every float32
product in full float32. The parity tests and ``chip_smoke.py`` pin
"highest", which is also PyTorch's own default for matmuls. Convolutions
are not used, but cuDNN's TF32 switch is set with the matmul switch so the
whole process has one precision.
"""

from __future__ import annotations

import torch

__all__ = [
    "set_matmul_precision",
    "matmul_precision",
    "set_default_dtype",
    "default_dtype",
    "resolve_device",
]

_NAMES = {
    "default": "medium",
    "bfloat16": "medium",
    "high": "high",
    "highest": "highest",
    "float32": "highest",
}


def set_matmul_precision(precision: str) -> None:
    """Set float32 contraction precision.

    Accepts 'default' | 'high' | 'highest' | 'bfloat16' | 'float32' (the
    names of the JAX package). 'highest'/'float32' is full float32 and
    turns TF32 off for both cuBLAS and cuDNN.
    """
    name = _NAMES[precision.lower()]
    torch.set_float32_matmul_precision(name)
    full = name == "highest"
    torch.backends.cuda.matmul.allow_tf32 = not full
    torch.backends.cudnn.allow_tf32 = not full


def matmul_precision() -> str:
    """Current float32 matmul precision as PyTorch names it."""
    return torch.get_float32_matmul_precision()


_DTYPE = torch.float32


def set_default_dtype(dtype) -> None:
    """Set the floating dtype of model parameters and trajectories:
    'float32' (default) or 'float64' (the parity mode). Must be set before
    models and tasks are constructed."""
    global _DTYPE
    if isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
    else:
        import numpy as np

        name = np.dtype(dtype).name
    if name not in ("float32", "float64"):
        raise ValueError(f"unsupported default dtype {name}")
    _DTYPE = torch.float64 if name == "float64" else torch.float32


def default_dtype() -> torch.dtype:
    """Current default floating dtype."""
    return _DTYPE


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card (``cuda``); the CPU is used only when the
    caller asks for it. A request for ``cuda`` on a machine without one
    raises instead of running somewhere else.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev

"""Global numerics configuration of the PyTorch port.

Counterpart of ``colvarsfinder_tpu/config.py:30-205``: a default floating
dtype for parameters and trajectories, the precision of float32 matrix
products, and the bfloat16 compute mode of the networks (its activation
dtype and arithmetic style). On an NVIDIA card "high" lets cuBLAS use TF32
tensor cores (about three decimal digits); "highest" keeps every float32
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
    "set_compute_dtype",
    "compute_dtype",
    "compute_dtype_name",
    "set_bf16_style",
    "bf16_style",
    "numerics_key",
]

_NAMES = {
    "default": "medium",
    "medium": "medium",
    "bfloat16": "medium",
    "high": "high",
    "highest": "highest",
    "float32": "highest",
}


def set_matmul_precision(precision: str) -> None:
    """Set float32 contraction precision.

    Accepts 'default' | 'high' | 'highest' | 'bfloat16' | 'float32' (the
    names of the JAX package), and 'medium' (what :func:`matmul_precision`
    returns for 'default'). 'highest'/'float32' is full float32 and turns
    TF32 off for both cuBLAS and cuDNN.

    cuBLAS follows ``torch.set_float32_matmul_precision`` alone: setting
    its legacy ``allow_tf32`` flag beside it makes torch's precision getter
    raise. cuDNN keeps its legacy flag, which ``torch.export`` reads (its
    per-operator ``fp32_precision`` flags make that getter raise).
    """
    name = _NAMES[precision.lower()]
    torch.set_float32_matmul_precision(name)
    torch.backends.cudnn.allow_tf32 = name != "highest"


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


_COMPUTE_DTYPE = "float32"


def set_compute_dtype(dtype) -> None:
    """Set the activation dtype of the networks' forward and backward
    passes (``colvarsfinder_tpu/config.py:91-133``).

    'float32' (default) keeps activations at full width. 'bfloat16' runs
    the layers of :func:`..models.module.mlp_apply` and
    :func:`..models.module.stacked_mlp_apply` in mixed precision: the
    parameters, their gradients and the optimizer state stay float32, the
    layers' inputs and activations are bfloat16 (the weights too, unless
    the style is 'w32', :func:`set_bf16_style`), and the network output is
    cast back to float32 before the loss. Refused under the float64
    default dtype. Captured epochs and sweeps key on
    :func:`numerics_key`, so a change re-captures instead of replaying a
    stale graph.
    """
    global _COMPUTE_DTYPE
    if dtype in ("float32", "bfloat16"):
        name = dtype
    elif isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
    else:
        import numpy as np

        name = np.dtype(dtype).name
    if name not in ("float32", "bfloat16"):
        raise ValueError(
            f"unsupported compute dtype {name!r}; "
            "expected 'float32' or 'bfloat16'"
        )
    if name == "bfloat16" and _DTYPE == torch.float64:
        raise ValueError(
            "bfloat16 compute mode is incompatible with the float64 "
            "default dtype (set_default_dtype('float32') first)"
        )
    _COMPUTE_DTYPE = name


def compute_dtype() -> torch.dtype:
    """Current activation dtype (``torch.float32`` or ``torch.bfloat16``)."""
    return torch.bfloat16 if _COMPUTE_DTYPE == "bfloat16" else torch.float32


def compute_dtype_name() -> str:
    """Current activation dtype as its name."""
    return _COMPUTE_DTYPE


_BF16_STYLES = ("pure", "acc32", "w32")
_BF16_STYLE = "pure"


def set_bf16_style(style: str) -> None:
    """Select the arithmetic of the bfloat16 compute mode
    (``colvarsfinder_tpu/config.py:140-193``); activations are stored in
    bfloat16 in every style:

    - 'pure' (default): weights and bias cast to bfloat16, products with a
      bfloat16 result, activation in bfloat16;
    - 'acc32': bfloat16 weights and inputs, products accumulated in float32
      with a float32 result, bias and activation in float32, then rounded
      to bfloat16 for the next layer;
    - 'w32': float32 weights, the bfloat16 activation upcast at the product
      (float32 arithmetic); only the stored activations are rounded.
    """
    global _BF16_STYLE
    if style not in _BF16_STYLES:
        raise ValueError(
            f"unknown bf16 style {style!r}; expected one of {_BF16_STYLES}"
        )
    _BF16_STYLE = style


def bf16_style() -> str:
    """Current bfloat16 arithmetic style ('pure' | 'acc32' | 'w32')."""
    return _BF16_STYLE


def numerics_key() -> tuple:
    """What the numerics of a captured epoch depend on: the float32 matmul
    precision, the default dtype, the activation dtype and the bfloat16
    style (``colvarsfinder_tpu/config.py:201-205``), and the QCP Newton
    solve's differentiation mode, which a captured graph records
    (:func:`..ops.alignment.newton_diff_mode`)."""
    from .ops import alignment  # imported here: ops imports this module

    return (matmul_precision(), _DTYPE, _COMPUTE_DTYPE, _BF16_STYLE,
            alignment.DEFAULT_NEWTON_DIFF_STEPS)


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

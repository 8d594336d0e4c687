"""Models of the PyTorch port."""

from .eigen import EigenFunctions
from .module import (
    ACTIVATIONS,
    linear_init,
    resolve_activation,
    stacked_mlp_apply,
    stacked_mlp_init,
)

__all__ = [
    "ACTIVATIONS",
    "EigenFunctions",
    "linear_init",
    "resolve_activation",
    "stacked_mlp_apply",
    "stacked_mlp_init",
]

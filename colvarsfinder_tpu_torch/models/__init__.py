"""Models of the PyTorch port."""

from .ae import AutoEncoder, RegAutoEncoder, RegModel
from .eigen import EigenFunctions
from .module import (
    ACTIVATIONS,
    Sequential,
    create_sequential_nn,
    linear_init,
    mlp_apply,
    mlp_init,
    params_from_numpy,
    resolve_activation,
    stacked_mlp_apply,
    stacked_mlp_init,
)

__all__ = [
    "ACTIVATIONS",
    "AutoEncoder",
    "EigenFunctions",
    "Sequential",
    "create_sequential_nn",
    "linear_init",
    "mlp_apply",
    "mlp_init",
    "params_from_numpy",
    "RegAutoEncoder",
    "RegModel",
    "resolve_activation",
    "stacked_mlp_apply",
    "stacked_mlp_init",
]

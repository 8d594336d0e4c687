r"""colvarsfinder-tpu, PyTorch/CUDA port.

A second package beside the JAX reference ``colvarsfinder_tpu``: the same
API for transfer-operator eigenfunction training, written in PyTorch, with
the JAX package's four Pallas TPU kernels rewritten as CUDA kernels for
Hopper (``csrc/``). It imports neither JAX nor the JAX package. Entry
points run on ``cuda`` unless the caller passes ``device='cpu'``; on CPU
tensors every kernel wrapper runs its plain PyTorch version.
"""

from . import config, core, models, ops, utils
from .core import EigenFunctionTask, TrainingTask
from .export import ColvarModel
from .models import EigenFunctions
from .ops import (
    AlignmentLayer,
    Feature,
    FeatureLayer,
    FusedAlignmentLayer,
    PreprocessingANN,
)
from .utils import WeightedTrajectory, calc_weights

__all__ = [
    "AlignmentLayer",
    "ColvarModel",
    "EigenFunctionTask",
    "EigenFunctions",
    "Feature",
    "FeatureLayer",
    "FusedAlignmentLayer",
    "PreprocessingANN",
    "TrainingTask",
    "WeightedTrajectory",
    "calc_weights",
    "config",
    "core",
    "models",
    "ops",
    "utils",
]

r"""colvarsfinder-tpu, PyTorch/CUDA port.

A second package beside the JAX reference ``colvarsfinder_tpu``: the same
API for eigenfunction training (generator and transfer operator),
committor training and (regularized) autoencoder training, written in
PyTorch, with the JAX package's four Pallas TPU kernels rewritten as CUDA
kernels for Hopper (``csrc/``). It imports neither JAX nor the JAX
package. Entry points run on ``cuda`` unless the caller passes
``device='cpu'``; on CPU tensors every kernel wrapper runs its plain
PyTorch version.
"""

from . import config, core, models, ops, utils
from .core import (
    AutoEncoderTask,
    CommittorTask,
    EigenFunctionTask,
    RegAutoEncoderTask,
    TrainingTask,
)
from .deploy import load_numpy_cv, save_numpy_cv
from .deploy_torch import export_torchscript_cv, torchscript_from_numpy_cv
from .export import ColvarModel, export_colvar
from .models import (
    AutoEncoder,
    EigenFunctions,
    RegAutoEncoder,
    RegModel,
    Sequential,
    create_sequential_nn,
)
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
    "AutoEncoder",
    "AutoEncoderTask",
    "ColvarModel",
    "CommittorTask",
    "EigenFunctionTask",
    "EigenFunctions",
    "Feature",
    "FeatureLayer",
    "FusedAlignmentLayer",
    "PreprocessingANN",
    "RegAutoEncoder",
    "RegAutoEncoderTask",
    "RegModel",
    "Sequential",
    "TrainingTask",
    "WeightedTrajectory",
    "calc_weights",
    "create_sequential_nn",
    "export_colvar",
    "export_torchscript_cv",
    "load_numpy_cv",
    "save_numpy_cv",
    "torchscript_from_numpy_cv",
    "config",
    "core",
    "models",
    "ops",
    "utils",
]

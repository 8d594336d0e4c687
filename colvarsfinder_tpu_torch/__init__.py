r"""colvarsfinder-tpu, PyTorch/CUDA port.

A second package beside the JAX reference ``colvarsfinder_tpu``: the same
API for eigenfunction training (generator and transfer operator),
committor training, (regularized) autoencoder training and replica
sweeps of them (``parallel``), the validation battery of a trained CV
(``analysis``), its figures (``plotting``, with matplotlib), the knob
autotuner (``tune``) and the adaptive sample/train/bias loop
(``workflow``), written in PyTorch, with the JAX package's four Pallas TPU kernels rewritten as CUDA
kernels for Hopper (``csrc/``). It imports neither JAX nor the JAX
package. Entry points run on ``cuda`` unless the caller passes
``device='cpu'``; on CPU tensors every kernel wrapper runs its plain
PyTorch version.
"""

from . import (
    analysis,
    config,
    core,
    models,
    ops,
    parallel,
    plotting,
    tune,
    utils,
    workflow,
)
from .core import (
    AutoEncoderTask,
    CommittorTask,
    EigenFunctionTask,
    RegAutoEncoderTask,
    TrainingTask,
)
from .checkpoint import load_torch_state_dict, save_torch_state_dict
from .deploy import load_numpy_cv, save_numpy_cv
from .deploy_native import load_native_cv, native_available
from .deploy_plumed import PlumedCV, write_plumed_cv, write_plumed_metad
from .deploy_torch import export_torchscript_cv, torchscript_from_numpy_cv
from .export import ColvarModel, export_colvar, load_colvar
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
from .utils import (
    WeightedTrajectory,
    calc_weights,
    integrate_md_langevin,
    integrate_sde_overdamped,
)

__version__ = "0.1.0"

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
    "PlumedCV",
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
    "integrate_md_langevin",
    "integrate_sde_overdamped",
    "load_colvar",
    "load_native_cv",
    "load_numpy_cv",
    "load_torch_state_dict",
    "native_available",
    "save_numpy_cv",
    "save_torch_state_dict",
    "torchscript_from_numpy_cv",
    "write_plumed_cv",
    "write_plumed_metad",
    "analysis",
    "config",
    "core",
    "models",
    "ops",
    "parallel",
    "plotting",
    "tune",
    "utils",
    "workflow",
    "__version__",
]

"""Training tasks of the PyTorch port."""

from .eigenfunction import EigenFunctionTask
from .losses import EigenAux, eigen_loss
from .task import TrainingTask, train_test_split

__all__ = [
    "EigenAux",
    "EigenFunctionTask",
    "TrainingTask",
    "eigen_loss",
    "train_test_split",
]

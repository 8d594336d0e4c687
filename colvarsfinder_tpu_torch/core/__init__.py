"""Training tasks of the PyTorch port."""

from .committor import CommittorTask
from .eigenfunction import EigenFunctionTask
from .losses import EigenAux, committor_loss, eigen_loss
from .task import TrainingTask, train_test_split

__all__ = [
    "CommittorTask",
    "EigenAux",
    "EigenFunctionTask",
    "TrainingTask",
    "committor_loss",
    "eigen_loss",
    "train_test_split",
]

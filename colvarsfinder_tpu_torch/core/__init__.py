"""Training tasks of the PyTorch port."""

from .autoencoder import AutoEncoderTask
from .committor import CommittorTask
from .eigenfunction import EigenFunctionTask
from .losses import (
    EigenAux,
    committor_loss,
    eigen_loss,
    enc_grad_loss,
    enc_norm_loss,
    enc_orthogonality_loss,
    reg_eigen_loss,
    weighted_mse_lagged_loss,
    weighted_mse_loss,
)
from .regautoencoder import RegAutoEncoderTask
from .task import TrainingTask, train_test_split

__all__ = [
    "AutoEncoderTask",
    "CommittorTask",
    "EigenAux",
    "EigenFunctionTask",
    "RegAutoEncoderTask",
    "TrainingTask",
    "committor_loss",
    "eigen_loss",
    "enc_grad_loss",
    "enc_norm_loss",
    "enc_orthogonality_loss",
    "reg_eigen_loss",
    "train_test_split",
    "weighted_mse_lagged_loss",
    "weighted_mse_loss",
]

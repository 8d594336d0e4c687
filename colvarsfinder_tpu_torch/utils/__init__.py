"""Data containers of the PyTorch port."""

from .trajectory import WeightedTrajectory, calc_weights

__all__ = ["WeightedTrajectory", "calc_weights"]

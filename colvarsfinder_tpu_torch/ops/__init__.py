"""Preprocessing layers, alignment and the fused-step statistics."""

from .alignment import (
    AlignmentLayer,
    align_frames,
    kabsch_rotations_quat,
    kabsch_rotations_svd,
)
from .features import (
    Feature,
    FeatureLayer,
    Identity,
    Lambda,
    PreprocessingANN,
    as_pp_layer,
)
from .fused_eigen import (
    eigen_loss_from_stats,
    params_t_of,
    stats_layout,
    transfer_stats,
    transfer_stats_reference,
)
from .kabsch_cuda import (
    FusedAlignmentLayer,
    align_frames_fused_cuda,
    kabsch_rotations_cuda,
)

__all__ = [
    "AlignmentLayer",
    "Feature",
    "FeatureLayer",
    "FusedAlignmentLayer",
    "Identity",
    "Lambda",
    "PreprocessingANN",
    "align_frames",
    "align_frames_fused_cuda",
    "as_pp_layer",
    "eigen_loss_from_stats",
    "kabsch_rotations_cuda",
    "kabsch_rotations_quat",
    "kabsch_rotations_svd",
    "params_t_of",
    "stats_layout",
    "transfer_stats",
    "transfer_stats_reference",
]

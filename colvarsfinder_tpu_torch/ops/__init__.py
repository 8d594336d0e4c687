"""Preprocessing layers, alignment, grouped pair distances and the
fused-step statistics."""

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
    bend_angle,
    bend_angle_cos,
    bond_length,
    coordination_pairs,
    dihedral_angle,
    dihedral_cos_sin,
    minimum_image,
    pair_distances,
    switching_rational,
)
from .builders import backbone_dihedrals, heavy_atom_contacts
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
from .pair_cuda import pair_distances_cuda

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
    "backbone_dihedrals",
    "bend_angle",
    "bend_angle_cos",
    "bond_length",
    "coordination_pairs",
    "dihedral_angle",
    "dihedral_cos_sin",
    "eigen_loss_from_stats",
    "kabsch_rotations_cuda",
    "kabsch_rotations_quat",
    "kabsch_rotations_svd",
    "heavy_atom_contacts",
    "minimum_image",
    "pair_distances",
    "pair_distances_cuda",
    "params_t_of",
    "stats_layout",
    "switching_rational",
    "transfer_stats",
    "transfer_stats_reference",
]

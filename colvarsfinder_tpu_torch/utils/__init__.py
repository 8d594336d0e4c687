"""Data containers and samplers of the PyTorch port."""

from .enhanced import (
    BiasedPotential,
    MBARResult,
    MetadynamicsResult,
    PlumedHills,
    REMDResult,
    SteeredResult,
    UmbrellaResult,
    harmonic_restraint,
    integrate_sde_metadynamics,
    integrate_sde_remd,
    integrate_sde_steered,
    integrate_sde_umbrella,
    mbar_weights,
    metad_frame_weights,
    read_plumed_colvar,
    read_plumed_hills,
)
from .sampling import (
    integrate_md_langevin,
    integrate_sde_langevin,
    integrate_sde_overdamped,
)
from .trajectory import WeightedTrajectory, calc_weights

__all__ = [
    "WeightedTrajectory",
    "calc_weights",
    "integrate_md_langevin",
    "integrate_sde_langevin",
    "integrate_sde_overdamped",
    "BiasedPotential",
    "MBARResult",
    "MetadynamicsResult",
    "harmonic_restraint",
    "integrate_sde_metadynamics",
    "integrate_sde_remd",
    "integrate_sde_steered",
    "integrate_sde_umbrella",
    "mbar_weights",
    "REMDResult",
    "SteeredResult",
    "UmbrellaResult",
    "PlumedHills",
    "read_plumed_hills",
    "read_plumed_colvar",
    "metad_frame_weights",
]

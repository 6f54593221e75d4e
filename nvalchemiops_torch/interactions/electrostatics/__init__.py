# SPDX-License-Identifier: Apache-2.0
"""Electrostatics of the PyTorch port: Coulomb over neighbor lists and
matrices, dense minimum-image Coulomb for small systems, Ewald summation,
PME (single, concatenated with ``batch_idx``, uniform batches, and over
the halo grid) and the parameter estimators (the real-space sum on the
halo grid is ``grid.grid_coulomb_energy_forces``).
"""

from nvalchemiops_torch.interactions.electrostatics.coulomb import (
    coulomb_energy,
    coulomb_energy_forces,
    coulomb_forces,
)
from nvalchemiops_torch.interactions.electrostatics.dense import (
    batch_dense_coulomb_energy_forces,
    dense_coulomb_energy_forces,
)
from nvalchemiops_torch.interactions.electrostatics.parameters import (
    EwaldParameters,
    PMEParameters,
    estimate_ewald_parameters,
    estimate_pme_mesh_dimensions,
    estimate_pme_parameters,
    mesh_spacing_to_dimensions,
)
from nvalchemiops_torch.interactions.electrostatics.k_vectors import (
    generate_k_vectors_ewald_summation,
    generate_k_vectors_pme,
)
from nvalchemiops_torch.interactions.electrostatics.ewald import (
    ewald_real_space,
    ewald_reciprocal_space,
    ewald_summation,
)
from nvalchemiops_torch.interactions.electrostatics.pme import (
    batch_pme_reciprocal,
    grid_particle_mesh_ewald,
    particle_mesh_ewald,
    pme_green_structure_factor,
    pme_reciprocal_space,
)

__all__ = [
    "batch_dense_coulomb_energy_forces",
    "dense_coulomb_energy_forces",
    "coulomb_energy",
    "coulomb_forces",
    "coulomb_energy_forces",
    "EwaldParameters",
    "PMEParameters",
    "estimate_ewald_parameters",
    "estimate_pme_mesh_dimensions",
    "estimate_pme_parameters",
    "mesh_spacing_to_dimensions",
    "generate_k_vectors_ewald_summation",
    "generate_k_vectors_pme",
    "ewald_real_space",
    "ewald_reciprocal_space",
    "ewald_summation",
    "particle_mesh_ewald",
    "grid_particle_mesh_ewald",
    "pme_reciprocal_space",
    "batch_pme_reciprocal",
    "pme_green_structure_factor",
]

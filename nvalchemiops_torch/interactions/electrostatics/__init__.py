# SPDX-License-Identifier: Apache-2.0
"""Electrostatics of the PyTorch port: PME reciprocal space (the real-space
erfc Coulomb sum lives on the grid, ``grid.grid_coulomb_energy_forces``)."""

from nvalchemiops_torch.interactions.electrostatics.k_vectors import (
    generate_k_vectors_pme,
)
from nvalchemiops_torch.interactions.electrostatics.pme import (
    pme_green_structure_factor,
    pme_reciprocal_space,
)

__all__ = ["generate_k_vectors_pme", "pme_green_structure_factor",
           "pme_reciprocal_space"]

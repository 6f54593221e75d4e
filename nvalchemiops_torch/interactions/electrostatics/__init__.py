# SPDX-License-Identifier: Apache-2.0
"""Electrostatics of the PyTorch port: PME reciprocal space, single and
batched (the real-space erfc Coulomb sum lives on the grid,
``grid.grid_coulomb_energy_forces``)."""

from nvalchemiops_torch.interactions.electrostatics.k_vectors import (
    generate_k_vectors_pme,
)
from nvalchemiops_torch.interactions.electrostatics.pme import (
    batch_pme_reciprocal,
    pme_green_structure_factor,
    pme_reciprocal_space,
)

__all__ = ["batch_pme_reciprocal", "generate_k_vectors_pme",
           "pme_green_structure_factor", "pme_reciprocal_space"]

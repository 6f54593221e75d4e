# SPDX-License-Identifier: Apache-2.0
"""DFT-D3(BJ) dispersion: the halo-grid engine, the dense engine for many
small systems, and the batched router."""

from nvalchemiops_torch.interactions.dispersion.dense_d3 import (
    BATCH_DENSE_MAX_ATOMS,
    batch_dense_dftd3,
    batch_dftd3,
    dense_dftd3,
)
from nvalchemiops_torch.interactions.dispersion.grid_d3 import (
    batch_grid_dftd3,
    compact_d3_elements,
    element_c6_mask,
    element_cn_ref,
    grid_dftd3,
)

__all__ = ["BATCH_DENSE_MAX_ATOMS", "batch_dense_dftd3", "batch_dftd3",
           "batch_grid_dftd3", "compact_d3_elements", "dense_dftd3",
           "element_c6_mask", "element_cn_ref", "grid_dftd3"]

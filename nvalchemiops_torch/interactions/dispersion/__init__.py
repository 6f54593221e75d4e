# SPDX-License-Identifier: Apache-2.0
"""DFT-D3(BJ) dispersion on the halo atom grid."""

from nvalchemiops_torch.interactions.dispersion.grid_d3 import (
    compact_d3_elements,
    element_c6_mask,
    element_cn_ref,
    grid_dftd3,
)

__all__ = ["compact_d3_elements", "element_c6_mask", "element_cn_ref",
           "grid_dftd3"]

# SPDX-License-Identifier: Apache-2.0
"""Neighbor-list helpers of the PyTorch port (only what the grid needs)."""

from nvalchemiops_torch.neighborlist.neighbor_utils import (
    pack_shifts,
    unpack_shifts,
)

__all__ = ["pack_shifts", "unpack_shifts"]

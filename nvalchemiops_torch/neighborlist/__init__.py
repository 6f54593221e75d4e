# SPDX-License-Identifier: Apache-2.0
"""Neighbor lists of the PyTorch port (counterpart of the JAX package's
``neighborlist``): naive and cell-list searches, single and batched, the
dual cutoff, the dispatcher, rebuild detection and the shift packing the
halo grid uses."""

from nvalchemiops_torch.neighborlist.neighborlist import neighbor_list
from nvalchemiops_torch.neighborlist.naive import naive_neighbor_list
from nvalchemiops_torch.neighborlist.batch_naive import (
    batch_naive_neighbor_list,
)
from nvalchemiops_torch.neighborlist.naive_dual_cutoff import (
    naive_neighbor_list_dual_cutoff,
)
from nvalchemiops_torch.neighborlist.batch_naive_dual_cutoff import (
    batch_naive_neighbor_list_dual_cutoff,
)
from nvalchemiops_torch.neighborlist.cell_list import (
    CellList,
    allocate_cell_list,
    build_cell_list,
    cell_list,
    estimate_cell_list_sizes,
    query_cell_list,
)
from nvalchemiops_torch.neighborlist.batch_cell_list import (
    BatchCellList,
    batch_build_cell_list,
    batch_cell_list,
    batch_query_cell_list,
    estimate_batch_cell_list_sizes,
)
from nvalchemiops_torch.neighborlist.rebuild_detection import (
    cell_list_needs_rebuild,
    check_cell_list_rebuild_needed,
    check_neighbor_list_rebuild_needed,
    neighbor_list_needs_rebuild,
)
from nvalchemiops_torch.neighborlist.neighbor_utils import (
    NeighborOverflowError,
    assert_max_neighbors,
    compute_naive_num_shifts,
    estimate_max_neighbors,
    get_neighbor_list_from_neighbor_matrix,
    pack_shifts,
    prepare_batch_idx_ptr,
    unpack_shifts,
)

__all__ = [
    "neighbor_list",
    "naive_neighbor_list",
    "batch_naive_neighbor_list",
    "naive_neighbor_list_dual_cutoff",
    "batch_naive_neighbor_list_dual_cutoff",
    "CellList",
    "BatchCellList",
    "allocate_cell_list",
    "build_cell_list",
    "query_cell_list",
    "cell_list",
    "estimate_cell_list_sizes",
    "batch_build_cell_list",
    "batch_query_cell_list",
    "batch_cell_list",
    "estimate_batch_cell_list_sizes",
    "cell_list_needs_rebuild",
    "neighbor_list_needs_rebuild",
    "check_cell_list_rebuild_needed",
    "check_neighbor_list_rebuild_needed",
    "NeighborOverflowError",
    "assert_max_neighbors",
    "estimate_max_neighbors",
    "compute_naive_num_shifts",
    "get_neighbor_list_from_neighbor_matrix",
    "prepare_batch_idx_ptr",
    "pack_shifts",
    "unpack_shifts",
]

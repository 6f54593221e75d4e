# SPDX-License-Identifier: Apache-2.0
"""Batched O(N) cell-list neighbor construction (counterpart of the JAX
package's ``neighborlist/batch_cell_list.py``).

Per-system cell grids are packed into one flat layout with a uniform
per-system stride (the largest system's cell count).  Build and query are
the single-system module's, with every per-system quantity (cells per
dimension, pbc flags, cell matrix) taken per atom through ``batch_idx``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nvalchemiops_torch.neighborlist.cell_list import (
    _as_pbc,
    _bin,
    _cells_per_dimension,
    _cells_per_dimension_host,
    _csr,
    _observed_capacity,
    candidate_row_block,
    query_rows,
)
from nvalchemiops_torch.neighborlist.naive import as_positions
from nvalchemiops_torch.neighborlist.neighbor_utils import (
    default_device,
    estimate_max_neighbors,
    get_neighbor_list_from_neighbor_matrix,
    host_array,
    prepare_batch_idx_ptr,
    shifts_to_aos,
)
from nvalchemiops_torch.types import INDEX_DTYPE

__all__ = [
    "BatchCellList",
    "estimate_batch_cell_list_sizes",
    "batch_build_cell_list",
    "batch_query_cell_list",
    "batch_cell_list",
]


class BatchCellList(NamedTuple):
    """Batched cell-list artifacts (per-system grids in one flat layout)."""

    cells_per_dimension: torch.Tensor       # [B, 3] int32
    neighbor_search_radius: torch.Tensor    # [B, 3] int32
    atom_periodic_shifts: torch.Tensor      # [N, 3] int32
    atom_to_cell_mapping: torch.Tensor      # [N, 3] int32
    atoms_per_cell_count: torch.Tensor      # [B * stride] int32
    cell_atom_start_indices: torch.Tensor   # [B * stride] int32
    cell_atom_list: torch.Tensor            # [N] int32


def estimate_batch_cell_list_sizes(cell, pbc, cutoff: float,
                                   max_nbins: int = 1000):
    """Host-side sizing: ``(cell_stride, max_total_cells,
    neighbor_search_radius [B, 3])`` with ``cell_stride`` the largest
    system's cell count and ``max_total_cells = B * cell_stride``."""
    cell_np = host_array(cell, np.float64).reshape(-1, 3, 3)
    pbc_np = host_array(pbc, bool).reshape(-1, 3)
    if pbc_np.shape[0] == 1 and cell_np.shape[0] > 1:
        pbc_np = np.broadcast_to(pbc_np, (cell_np.shape[0], 3))
    num_systems = cell_np.shape[0]
    radius = np.zeros((num_systems, 3), dtype=np.int64)
    totals = np.zeros(num_systems, dtype=np.int64)
    for b in range(num_systems):
        cpd, face = _cells_per_dimension_host(cell_np[b], cutoff, max_nbins)
        r = np.ceil(float(cutoff) * cpd / face).astype(np.int64)
        r = np.where((cpd == 1) & ~pbc_np[b], 0, r)
        radius[b] = r
        totals[b] = int(np.prod(cpd))
    stride = int(totals.max()) if num_systems else 1
    return stride, num_systems * stride, torch.as_tensor(
        radius, dtype=INDEX_DTYPE, device=default_device(cell))


def batch_build_cell_list(
    positions,
    cutoff,
    cell,
    pbc,
    batch_idx,
    cell_stride: int,
    max_nbins: int = 1000,
) -> BatchCellList:
    """Build per-system cell lists packed into one flat layout, on the
    positions' device."""
    positions = as_positions(positions)
    dtype, device = positions.dtype, positions.device
    cell_b = torch.as_tensor(cell, dtype=dtype, device=device).reshape(
        -1, 3, 3)
    num_systems = cell_b.shape[0]
    pbc_b = _as_pbc(pbc, device, (num_systems, 3))
    b_of = torch.as_tensor(batch_idx, device=device).long()

    inv = torch.linalg.inv(cell_b)
    cpd, radius = _cells_per_dimension(inv.transpose(-1, -2), cutoff, pbc_b,
                                       max_nbins)
    # per-atom binning with the atom's own system quantities
    frac = torch.einsum("nd,nde->ne", positions, inv[b_of])
    cpd_a = cpd[b_of]
    cell_coords, aps = _bin(frac, cpd_a, pbc_b[b_of])
    lin_local = cell_coords[:, 0] + cpd_a[:, 0] * (
        cell_coords[:, 1] + cpd_a[:, 1] * cell_coords[:, 2])
    lin = b_of.to(INDEX_DTYPE) * cell_stride + lin_local
    order, starts, counts = _csr(lin, num_systems * cell_stride)
    return BatchCellList(
        cells_per_dimension=cpd,
        neighbor_search_radius=radius,
        atom_periodic_shifts=aps,
        atom_to_cell_mapping=cell_coords,
        atoms_per_cell_count=counts,
        cell_atom_start_indices=starts,
        cell_atom_list=order,
    )


def batch_query_cell_list(
    positions,
    cutoff,
    cell,
    pbc,
    batch_idx,
    cell_list_data: BatchCellList,
    cell_stride: int,
    search_radius,
    cell_capacity: int,
    max_neighbors: int,
    half_fill: bool = False,
    fill_value: int = -1,
    row_block: int = 1024,
    shift_format: str = "aos",
):
    """Query the batched cell list into a padded neighbor matrix; shifts as
    ``[N, K, 3]`` (``"aos"``) or packed int32 ``[N, K]`` (``"packed"``).
    ``search_radius`` is one int triple for the whole batch."""
    positions = as_positions(positions)
    dtype, device = positions.dtype, positions.device
    cell_b = torch.as_tensor(cell, dtype=dtype, device=device).reshape(
        -1, 3, 3)
    pbc_b = _as_pbc(pbc, device, (cell_b.shape[0], 3))
    sys_idx = torch.as_tensor(batch_idx, device=device).long()
    nm, num, sh = query_rows(
        positions, cutoff, cell_b, pbc_b, sys_idx, cell_list_data,
        int(cell_stride), search_radius, cell_capacity, max_neighbors,
        half_fill, fill_value, int(row_block))
    if shift_format == "packed":
        return nm, num, sh
    return nm, num, shifts_to_aos(sh)


def batch_cell_list(
    positions,
    cutoff: float,
    cell,
    pbc,
    batch_idx=None,
    batch_ptr=None,
    max_neighbors: int | None = None,
    half_fill: bool = False,
    fill_value: int | None = None,
    return_neighbor_list: bool = False,
    neighbor_matrix=None,
    max_nbins: int = 1000,
    cell_capacity: int | None = None,
    shift_format: str = "aos",
    **_ignored,
):
    """Build + query batched cell lists in one call; return patterns of
    :func:`~nvalchemiops_torch.neighborlist.cell_list.cell_list`."""
    positions = as_positions(positions, _ignored.get("device"))
    total_atoms = positions.shape[0]
    if fill_value is None:
        fill_value = total_atoms
    batch_idx, batch_ptr = prepare_batch_idx_ptr(
        batch_idx, batch_ptr, total_atoms, device=positions.device)
    if max_neighbors is None:
        if neighbor_matrix is not None:
            max_neighbors = int(neighbor_matrix.shape[1])
        else:
            max_neighbors = estimate_max_neighbors(cutoff)

    stride, max_total_cells, radius = estimate_batch_cell_list_sizes(
        cell, pbc, cutoff, max_nbins)
    radius_t = tuple(int(v) for v in host_array(radius).max(axis=0))
    cl = batch_build_cell_list(positions, cutoff, cell, pbc, batch_idx,
                               stride, max_nbins)
    cap = _observed_capacity(cl, cell_capacity)
    nm, num, sh = batch_query_cell_list(
        positions, cutoff, cell, pbc, batch_idx, cl, stride, radius_t, cap,
        int(max_neighbors), half_fill=half_fill, fill_value=int(fill_value),
        row_block=candidate_row_block(radius_t, half_fill, cap),
        shift_format=shift_format)
    if return_neighbor_list:
        return get_neighbor_list_from_neighbor_matrix(
            nm, num, sh, fill_value=int(fill_value))
    return nm, num, sh

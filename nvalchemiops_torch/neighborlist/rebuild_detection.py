# SPDX-License-Identifier: Apache-2.0
"""Rebuild-skip checks for cached neighbor structures in an MD loop
(counterpart of the JAX package's ``neighborlist/rebuild_detection.py``):
small reductions on the device returning a shape-(1,) bool tensor, plus
host-``bool`` conveniences."""

from __future__ import annotations

import torch

from nvalchemiops_torch.mathops.math import apply_mat3
from nvalchemiops_torch.neighborlist.cell_list import _as_pbc, _bin
from nvalchemiops_torch.types import INDEX_DTYPE

__all__ = [
    "cell_list_needs_rebuild",
    "neighbor_list_needs_rebuild",
    "check_cell_list_rebuild_needed",
    "check_neighbor_list_rebuild_needed",
]


def cell_list_needs_rebuild(
    current_positions,
    atom_to_cell_mapping,
    cells_per_dimension,
    cell,
    pbc,
):
    """True if any atom now maps to another cell: each atom's wrapped (or
    clamped) cell coordinates on the stored grid against
    ``atom_to_cell_mapping``."""
    dtype, device = current_positions.dtype, current_positions.device
    cell = torch.as_tensor(cell, dtype=dtype, device=device).reshape(3, 3)
    pbc_arr = _as_pbc(pbc, device, (1, 3))[0]
    cpd = torch.as_tensor(cells_per_dimension, device=device).to(
        INDEX_DTYPE).reshape(3)
    frac = apply_mat3(current_positions, torch.linalg.inv(cell))
    new_coords, _ = _bin(frac, cpd, pbc_arr)
    return (new_coords != atom_to_cell_mapping).any().reshape(1)


def neighbor_list_needs_rebuild(
    reference_positions,
    current_positions,
    skin_distance_threshold,
):
    """True if any atom moved farther than the skin distance."""
    delta = current_positions - reference_positions
    disp_sq = (delta * delta).sum(-1)
    thresh = torch.as_tensor(skin_distance_threshold, dtype=disp_sq.dtype,
                             device=disp_sq.device)
    return (disp_sq > thresh * thresh).any().reshape(1)


def check_cell_list_rebuild_needed(
    cells_per_dimension,
    neighbor_search_radius,
    atom_periodic_shifts,
    atom_to_cell_mapping,
    atoms_per_cell_count,
    cell_atom_start_indices,
    cell_atom_list,
    current_positions,
    current_cell,
    current_pbc,
    cutoff: float,
) -> bool:
    """Host-bool form of :func:`cell_list_needs_rebuild` (the other cell
    list fields are accepted and unused, as in the JAX package)."""
    del (neighbor_search_radius, atom_periodic_shifts, atoms_per_cell_count,
         cell_atom_start_indices, cell_atom_list, cutoff)
    return bool(cell_list_needs_rebuild(
        current_positions, atom_to_cell_mapping, cells_per_dimension,
        current_cell, current_pbc)[0])


def check_neighbor_list_rebuild_needed(
    reference_positions,
    current_positions,
    skin_distance_threshold: float,
) -> bool:
    """Host-bool form of :func:`neighbor_list_needs_rebuild`."""
    return bool(neighbor_list_needs_rebuild(
        reference_positions, current_positions, skin_distance_threshold)[0])

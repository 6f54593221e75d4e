# SPDX-License-Identifier: Apache-2.0
"""Brute-force O(N^2) neighbor list for batched (concatenated) systems
(counterpart of the JAX package's ``neighborlist/batch_naive.py``).

Systems are concatenated along the atom axis with ``batch_idx``; the
streaming search masks cross-system pairs and takes each pair's own cell
for its shift.  The shift table is the union (max per dimension) of the
per-system shift ranges: shifts beyond a system's own range cannot pass
its distance test.
"""

from __future__ import annotations

import torch

from nvalchemiops_torch.neighborlist._streaming import streaming_pair_search
from nvalchemiops_torch.neighborlist.naive import (
    _resolve_max_neighbors, as_positions, squared, is_periodic,
)
from nvalchemiops_torch.neighborlist.neighbor_utils import (
    compute_naive_num_shifts,
    expand_full_shifts,
    expand_naive_shifts,
    get_neighbor_list_from_neighbor_matrix,
    prepare_batch_idx_ptr,
)
from nvalchemiops_torch.types import INDEX_DTYPE

__all__ = ["batch_naive_neighbor_list"]


def batch_shift_table(positions, cell, pbc, cutoff, half_fill, batch_ptr):
    """``(cell_b [B, 3, 3], shifts [S, 3], periodic)`` of a batch: the
    union of the systems' shift ranges, or the zero shift alone with
    identity cells when nothing is periodic."""
    dtype, device = positions.dtype, positions.device
    periodic = is_periodic(pbc, cell)
    if periodic:
        cell_b = torch.as_tensor(cell, dtype=dtype,
                                 device=device).reshape(-1, 3, 3)
        shift_range, _, _ = compute_naive_num_shifts(cell_b, cutoff, pbc)
        union = shift_range.max(axis=0)
        shifts = torch.as_tensor(
            expand_naive_shifts(union) if half_fill
            else expand_full_shifts(union), device=device)
    else:
        num_systems = int(batch_ptr.shape[0]) - 1
        cell_b = torch.eye(3, dtype=dtype, device=device).expand(
            max(num_systems, 1), 3, 3)
        shifts = torch.zeros((1, 3), dtype=INDEX_DTYPE, device=device)
    return cell_b, shifts, periodic


def batch_naive_neighbor_list(
    positions,
    cutoff: float,
    pbc=None,
    cell=None,
    batch_idx=None,
    batch_ptr=None,
    half_fill: bool = False,
    fill_value: int | None = None,
    return_neighbor_list: bool = False,
    max_neighbors: int | None = None,
    neighbor_matrix=None,
    max_atoms_per_system: int | None = None,
    **_ignored,
):
    """Batched brute-force neighbor matrix over concatenated systems.

    ``cell [B, 3, 3]`` and ``pbc [B, 3]`` (or ``[3]``, broadcast).  Returns
    the patterns of :func:`~nvalchemiops_torch.neighborlist.naive.
    naive_neighbor_list`.
    """
    positions = as_positions(positions, _ignored.get("device"))
    total_atoms = positions.shape[0]
    if fill_value is None:
        fill_value = total_atoms
    batch_idx, batch_ptr = prepare_batch_idx_ptr(
        batch_idx, batch_ptr, total_atoms, device=positions.device)
    cell_b, shifts, periodic = batch_shift_table(
        positions, cell, pbc, cutoff, half_fill, batch_ptr)
    k = _resolve_max_neighbors(max_neighbors, neighbor_matrix, cutoff,
                               total_atoms * int(shifts.shape[0]))
    nm, num, sh = streaming_pair_search(
        positions, cell_b, shifts, squared(cutoff, positions), k,
        batch_idx=batch_idx, half_fill=half_fill,
        fill_value=int(fill_value), batched=True)
    if return_neighbor_list:
        return get_neighbor_list_from_neighbor_matrix(
            nm, num, sh if periodic else None, fill_value=int(fill_value))
    if periodic:
        return nm, num, sh
    return nm, num

# SPDX-License-Identifier: Apache-2.0
"""Dual-cutoff brute-force neighbor lists for batched systems
(counterpart of the JAX package's
``neighborlist/batch_naive_dual_cutoff.py``)."""

from __future__ import annotations

from nvalchemiops_torch.neighborlist._streaming import streaming_pair_search
from nvalchemiops_torch.neighborlist.batch_naive import batch_shift_table
from nvalchemiops_torch.neighborlist.naive import (
    _resolve_max_neighbors, as_positions, squared,
)
from nvalchemiops_torch.neighborlist.naive_dual_cutoff import dual_outputs
from nvalchemiops_torch.neighborlist.neighbor_utils import (
    prepare_batch_idx_ptr,
)

__all__ = ["batch_naive_neighbor_list_dual_cutoff"]


def batch_naive_neighbor_list_dual_cutoff(
    positions,
    cutoff: float,
    cutoff2: float,
    pbc=None,
    cell=None,
    batch_idx=None,
    batch_ptr=None,
    half_fill: bool = False,
    fill_value: int | None = None,
    return_neighbor_list: bool = False,
    max_neighbors: int | None = None,
    max_neighbors2: int | None = None,
    neighbor_matrix=None,
    neighbor_matrix2=None,
    **_ignored,
):
    """Batched single-pass dual-cutoff neighbor matrices; return patterns
    of :func:`~nvalchemiops_torch.neighborlist.naive_dual_cutoff.
    naive_neighbor_list_dual_cutoff`."""
    positions = as_positions(positions, _ignored.get("device"))
    total_atoms = positions.shape[0]
    if fill_value is None:
        fill_value = total_atoms
    batch_idx, batch_ptr = prepare_batch_idx_ptr(
        batch_idx, batch_ptr, total_atoms, device=positions.device)
    cell_b, shifts, periodic = batch_shift_table(
        positions, cell, pbc, max(float(cutoff), float(cutoff2)), half_fill,
        batch_ptr)
    cand = total_atoms * int(shifts.shape[0])
    k1 = _resolve_max_neighbors(max_neighbors, neighbor_matrix, cutoff, cand)
    k2 = _resolve_max_neighbors(max_neighbors2, neighbor_matrix2, cutoff2,
                                cand)
    out = streaming_pair_search(
        positions, cell_b, shifts, squared(cutoff, positions), k1,
        cutoff_sq2=squared(cutoff2, positions), max_neighbors2=k2,
        batch_idx=batch_idx, half_fill=half_fill,
        fill_value=int(fill_value), batched=True)
    return dual_outputs(out, periodic, int(fill_value), return_neighbor_list)

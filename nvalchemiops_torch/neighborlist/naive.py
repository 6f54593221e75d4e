# SPDX-License-Identifier: Apache-2.0
"""Brute-force O(N^2) neighbor list, single system (counterpart of the
JAX package's ``neighborlist/naive.py``).

Output contract: padded ``neighbor_matrix`` / ``num_neighbors`` (+ the
integer ``neighbor_matrix_shifts`` under PBC), or their COO/CSR
conversion, from the streaming pair search in ``_streaming.py``.
"""

from __future__ import annotations

import torch

from nvalchemiops_torch.neighborlist._streaming import streaming_pair_search
from nvalchemiops_torch.neighborlist.neighbor_utils import (
    compute_naive_num_shifts,
    default_device,
    estimate_max_neighbors,
    expand_full_shifts,
    expand_naive_shifts,
    get_neighbor_list_from_neighbor_matrix,
    host_array,
)
from nvalchemiops_torch.types import INDEX_DTYPE

__all__ = ["naive_neighbor_list"]


def _resolve_max_neighbors(max_neighbors, neighbor_matrix, cutoff,
                           total_candidates):
    """Capacity K: explicit > buffer capacity > density heuristic, the
    heuristic bounded by the candidate space (atoms x periodic images)."""
    if max_neighbors is not None:
        return int(max_neighbors)
    if neighbor_matrix is not None:
        return int(neighbor_matrix.shape[1])
    est = estimate_max_neighbors(cutoff)
    if total_candidates > 0:
        est = max(16, min(est, ((total_candidates + 15) // 16) * 16))
    return est


def _shift_table(cell, cutoff, pbc, half_fill):
    """Host-side shift enumeration (static count) for a single system."""
    shift_range, _, _ = compute_naive_num_shifts(cell, cutoff, pbc)
    if half_fill:
        return expand_naive_shifts(shift_range[0])
    return expand_full_shifts(shift_range[0])


def is_periodic(pbc, cell) -> bool:
    """True when a cell is given and any axis is periodic."""
    return pbc is not None and cell is not None and bool(
        host_array(pbc, bool).any())


def as_positions(positions, device=None):
    """Positions as a tensor on their device (numpy: on ``device``, the
    card by default)."""
    return torch.as_tensor(positions,
                           device=default_device(positions, device))


def squared(cutoff, positions):
    """The squared cutoff, rounded in the positions' dtype as the JAX
    package rounds it (``cutoff`` cast first, then squared)."""
    return torch.as_tensor(float(cutoff), dtype=positions.dtype,
                           device=positions.device) ** 2


def naive_neighbor_list(
    positions,
    cutoff: float,
    pbc=None,
    cell=None,
    half_fill: bool = False,
    fill_value: int | None = None,
    return_neighbor_list: bool = False,
    max_neighbors: int | None = None,
    neighbor_matrix=None,
    neighbor_matrix_shifts=None,
    num_neighbors=None,
    shift_range_per_dimension=None,
    shift_offset=None,
    total_shifts=None,
    **_ignored,
):
    """Neighbor matrix by the brute-force O(N^2) search.

    Pre-allocated output buffers are consulted only for their capacity, as
    in the JAX package; ``device`` (keyword) places numpy positions.

    Returns, without PBC, ``(neighbor_matrix, num_neighbors)``; with PBC
    ``(neighbor_matrix, num_neighbors, neighbor_matrix_shifts)``; with
    ``return_neighbor_list=True`` the COO/CSR conversion of the same data.
    """
    positions = as_positions(positions, _ignored.get("device"))
    dtype, device = positions.dtype, positions.device
    total_atoms = positions.shape[0]
    if fill_value is None:
        fill_value = total_atoms
    periodic = is_periodic(pbc, cell)

    if periodic:
        cell_b = torch.as_tensor(cell, dtype=dtype,
                                 device=device).reshape(1, 3, 3)
        shifts = torch.as_tensor(_shift_table(cell_b, cutoff, pbc, half_fill),
                                 device=device)
    else:
        cell_b = torch.eye(3, dtype=dtype, device=device).reshape(1, 3, 3)
        shifts = torch.zeros((1, 3), dtype=INDEX_DTYPE, device=device)

    k = _resolve_max_neighbors(max_neighbors, neighbor_matrix, cutoff,
                               total_atoms * int(shifts.shape[0]))
    nm, num, sh = streaming_pair_search(
        positions, cell_b, shifts, squared(cutoff, positions), k,
        half_fill=half_fill, fill_value=int(fill_value))

    if return_neighbor_list:
        return get_neighbor_list_from_neighbor_matrix(
            nm, num, sh if periodic else None, fill_value=int(fill_value))
    if periodic:
        return nm, num, sh
    return nm, num

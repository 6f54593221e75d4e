# SPDX-License-Identifier: Apache-2.0
"""Dual-cutoff brute-force neighbor lists, single system (counterpart of
the JAX package's ``neighborlist/naive_dual_cutoff.py``): one distance
pass fills two neighbor matrices for two cutoff radii."""

from __future__ import annotations

import torch

from nvalchemiops_torch.neighborlist._streaming import streaming_pair_search
from nvalchemiops_torch.neighborlist.naive import (
    _resolve_max_neighbors, _shift_table, as_positions, is_periodic,
    squared,
)
from nvalchemiops_torch.neighborlist.neighbor_utils import (
    get_neighbor_list_from_neighbor_matrix,
)
from nvalchemiops_torch.types import INDEX_DTYPE

__all__ = ["naive_neighbor_list_dual_cutoff"]


def dual_outputs(out, periodic, fill_value, return_neighbor_list):
    """The dual-cutoff return patterns from the two search triples:
    ``(nm1, num1, nm2, num2)`` without PBC, ``(nm1, num1, shifts1, nm2,
    num2, shifts2)`` with it, or the two COO/CSR conversions."""
    nm1, num1, sh1, nm2, num2, sh2 = out
    if return_neighbor_list:
        return (get_neighbor_list_from_neighbor_matrix(
                    nm1, num1, sh1 if periodic else None,
                    fill_value=fill_value)
                + get_neighbor_list_from_neighbor_matrix(
                    nm2, num2, sh2 if periodic else None,
                    fill_value=fill_value))
    if periodic:
        return nm1, num1, sh1, nm2, num2, sh2
    return nm1, num1, nm2, num2


def naive_neighbor_list_dual_cutoff(
    positions,
    cutoff: float,
    cutoff2: float,
    pbc=None,
    cell=None,
    half_fill: bool = False,
    fill_value: int | None = None,
    return_neighbor_list: bool = False,
    max_neighbors: int | None = None,
    max_neighbors2: int | None = None,
    neighbor_matrix=None,
    neighbor_matrix2=None,
    **_ignored,
):
    """Single-pass dual-cutoff neighbor matrices; return patterns as in
    :func:`dual_outputs`."""
    positions = as_positions(positions, _ignored.get("device"))
    dtype, device = positions.dtype, positions.device
    total_atoms = positions.shape[0]
    if fill_value is None:
        fill_value = total_atoms
    periodic = is_periodic(pbc, cell)

    shift_cutoff = max(float(cutoff), float(cutoff2))
    if periodic:
        cell_b = torch.as_tensor(cell, dtype=dtype,
                                 device=device).reshape(1, 3, 3)
        shifts = torch.as_tensor(
            _shift_table(cell_b, shift_cutoff, pbc, half_fill), device=device)
    else:
        cell_b = torch.eye(3, dtype=dtype, device=device).reshape(1, 3, 3)
        shifts = torch.zeros((1, 3), dtype=INDEX_DTYPE, device=device)

    cand = total_atoms * int(shifts.shape[0])
    k1 = _resolve_max_neighbors(max_neighbors, neighbor_matrix, cutoff, cand)
    k2 = _resolve_max_neighbors(max_neighbors2, neighbor_matrix2, cutoff2,
                                cand)
    out = streaming_pair_search(
        positions, cell_b, shifts, squared(cutoff, positions), k1,
        cutoff_sq2=squared(cutoff2, positions), max_neighbors2=k2,
        half_fill=half_fill, fill_value=int(fill_value))
    return dual_outputs(out, periodic, int(fill_value), return_neighbor_list)

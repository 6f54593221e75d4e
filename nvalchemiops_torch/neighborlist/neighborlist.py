# SPDX-License-Identifier: Apache-2.0
"""Unified neighbor-list dispatcher (counterpart of the JAX package's
``neighborlist/neighborlist.py``): one entry point that picks the
algorithm (N >= 5000 -> cell list, ``cutoff2`` -> dual cutoff, batch
arguments -> batched variants) and forwards uniform keyword arguments."""

from __future__ import annotations

import numpy as np
import torch

from nvalchemiops_torch.neighborlist.batch_cell_list import batch_cell_list
from nvalchemiops_torch.neighborlist.batch_naive import (
    batch_naive_neighbor_list,
)
from nvalchemiops_torch.neighborlist.batch_naive_dual_cutoff import (
    batch_naive_neighbor_list_dual_cutoff,
)
from nvalchemiops_torch.neighborlist.cell_list import cell_list
from nvalchemiops_torch.neighborlist.naive import (
    as_positions, naive_neighbor_list,
)
from nvalchemiops_torch.neighborlist.naive_dual_cutoff import (
    naive_neighbor_list_dual_cutoff,
)
from nvalchemiops_torch.neighborlist.neighbor_utils import (
    prepare_batch_idx_ptr,
)

__all__ = ["neighbor_list"]

_CELL_LIST_THRESHOLD = 5000


def neighbor_list(
    positions,
    cutoff: float,
    cell=None,
    pbc=None,
    batch_idx=None,
    batch_ptr=None,
    cutoff2: float | None = None,
    half_fill: bool = False,
    fill_value: int | None = None,
    return_neighbor_list: bool = False,
    method: str | None = None,
    **kwargs,
):
    """Neighbor list by the method that fits the inputs.

    - single cutoff, no PBC: ``(neighbor_matrix, num_neighbors)``
    - single cutoff, PBC (and every cell list): ``(neighbor_matrix,
      num_neighbors, shifts)``
    - dual cutoff: the pattern repeated for both cutoffs
    - ``return_neighbor_list=True``: COO/CSR (+ per-pair unit shifts).

    ``method``: one of ``naive, cell_list, batch_naive, batch_cell_list,
    naive_dual_cutoff, batch_naive_dual_cutoff``, or None to choose as the
    JAX package does.  Other keywords (``max_neighbors``, ``device`` for
    numpy positions, ...) go to the method.
    """
    positions = as_positions(positions, kwargs.get("device"))
    total_atoms = positions.shape[0]

    if method is None:
        if cutoff2 is not None:
            method = "naive_dual_cutoff"
        elif total_atoms >= _CELL_LIST_THRESHOLD:
            method = "cell_list"
            if cell is None or pbc is None:
                cell = torch.eye(3, dtype=positions.dtype,
                                 device=positions.device).reshape(1, 3, 3)
                pbc = np.zeros(3, dtype=bool)
        else:
            method = "naive"
        if batch_idx is not None or batch_ptr is not None:
            method = "batch_" + method
            batch_idx, batch_ptr = prepare_batch_idx_ptr(
                batch_idx, batch_ptr, total_atoms, device=positions.device)

    common = dict(half_fill=half_fill, fill_value=fill_value,
                  return_neighbor_list=return_neighbor_list, **kwargs)
    if method == "naive":
        return naive_neighbor_list(positions, cutoff, pbc=pbc, cell=cell,
                                   **common)
    if method == "cell_list":
        return cell_list(positions, cutoff, cell, pbc, **common)
    if method == "batch_naive":
        return batch_naive_neighbor_list(
            positions, cutoff, pbc=pbc, cell=cell, batch_idx=batch_idx,
            batch_ptr=batch_ptr, **common)
    if method == "batch_cell_list":
        return batch_cell_list(positions, cutoff, cell, pbc,
                               batch_idx=batch_idx, batch_ptr=batch_ptr,
                               **common)
    if method == "naive_dual_cutoff":
        return naive_neighbor_list_dual_cutoff(
            positions, cutoff, cutoff2, pbc=pbc, cell=cell, **common)
    if method == "batch_naive_dual_cutoff":
        return batch_naive_neighbor_list_dual_cutoff(
            positions, cutoff, cutoff2, pbc=pbc, cell=cell,
            batch_idx=batch_idx, batch_ptr=batch_ptr, **common)
    raise ValueError(f"Invalid method: {method}")

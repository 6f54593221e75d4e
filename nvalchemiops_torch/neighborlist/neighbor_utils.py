# SPDX-License-Identifier: Apache-2.0
"""Shared neighbor-list utilities (counterpart of the JAX package's
``neighborlist/neighbor_utils.py``).

- Row compaction: the JAX package packs each row's hits with a running
  ``top_k`` over priority keys (its ``pack_block`` / ``merge_topk`` /
  ``decode_keys``).  The port keeps the contract, rows in candidate order
  and exact counts even on overflow, with a prefix sum over the in-range
  mask (:func:`select_hits`): each hit's slot is the number of hits
  before it in its row, and hits past the capacity are counted but not
  stored.
- Capacity heuristics, overflow checks, host-side periodic shift tables
  (numpy, as in the JAX package: their sizes are static shapes), the
  matrix -> COO/CSR conversion and the ``batch_idx`` / ``batch_ptr``
  bookkeeping.
- Packed periodic-shift codes, one int32 per shift, components bit-packed
  10 bits each (range +-511)::

      packed = (sx + 512) << 20 | (sy + 512) << 10 | (sz + 512)

  The halo grid stores one code per extended cell.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nvalchemiops_torch.types import INDEX_DTYPE, default_device

SHIFT_PACK_BIAS = 512
SHIFT_PACK_MASK = 1023

__all__ = [
    "NeighborOverflowError",
    "assert_max_neighbors",
    "estimate_max_neighbors",
    "compute_naive_num_shifts",
    "expand_naive_shifts",
    "expand_full_shifts",
    "get_neighbor_list_from_neighbor_matrix",
    "prepare_batch_idx_ptr",
    "pack_shifts",
    "unpack_shifts",
    "shifts_to_aos",
    "shifts_from_aos",
]


def host_array(x, dtype=None):
    """A small (cell-sized) tensor or array as numpy, for host-side static
    sizes; never called on atom-sized data."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


# ---------------------------------------------------------------------------
# Row compaction
# ---------------------------------------------------------------------------


def select_hits(mask, k: int, counts=None):
    """Columns of the hits a block adds to its rows' first ``k`` entries.

    ``mask [R, C]`` marks a block's hits in candidate order; ``counts
    [R]`` (default 0) the hits each row had before the block, so slot ``s``
    of row ``r`` takes its ``(s - counts_r + 1)``-th hit here.  A prefix
    sum ranks the hits and a row-wise binary search finds each slot's
    column, so only ``R x k`` entries are read back: no scatter, nothing
    written twice, no host sync.  Returns ``(col [R, k]`` int64, ``fill
    [R, k]`` bool where this block fills the slot, ``counts [R]`` int32
    with this block's hits added).
    """
    rows, cols = mask.shape
    ranks = torch.cumsum(mask, dim=1, dtype=torch.int32)
    total = (ranks[:, -1] if cols else
             torch.zeros(rows, dtype=torch.int32, device=mask.device))
    want = torch.arange(1, k + 1, dtype=torch.int32, device=mask.device)
    want = want.expand(rows, k)
    if counts is not None:
        want = want - counts[:, None]
    col = torch.searchsorted(ranks, want.contiguous()) if cols else \
        torch.zeros((rows, k), dtype=torch.long, device=mask.device)
    fill = (want >= 1) & (want <= total[:, None])
    new_counts = total if counts is None else total + counts
    return torch.clamp(col, max=max(cols - 1, 0)), fill, \
        new_counts.to(INDEX_DTYPE)


# ---------------------------------------------------------------------------
# Size estimation / overflow
# ---------------------------------------------------------------------------


def estimate_max_neighbors(
    cutoff: float,
    atomic_density: float = 0.35,
    safety_factor: float = 5.0,
) -> int:
    """Density-heuristic upper bound on neighbors per atom:
    ``safety_factor * density * (4/3) pi cutoff^3`` rounded up to a
    multiple of 16; 0 for non-positive cutoffs."""
    if cutoff <= 0:
        return 0
    cutoff_sphere_volume = atomic_density * (4.0 / 3.0) * math.pi * (cutoff**3)
    expected = max(1.0, safety_factor * cutoff_sphere_volume)
    return int(math.ceil(expected / 16)) * 16


class NeighborOverflowError(Exception):
    """Raised when an atom has more neighbors than the matrix capacity."""

    def __init__(self, max_neighbors: int, num_neighbors: int):
        super().__init__(
            "The number of neighbors is larger than the maximum allowed: "
            f"{num_neighbors} > {max_neighbors}."
        )


def assert_max_neighbors(neighbor_matrix, num_neighbors) -> None:
    """Raise :class:`NeighborOverflowError` on capacity overflow (one
    scalar read from the device)."""
    if num_neighbors.numel() == 0:
        return
    observed = int(num_neighbors.max())
    if observed > neighbor_matrix.shape[1]:
        raise NeighborOverflowError(neighbor_matrix.shape[1], observed)


# ---------------------------------------------------------------------------
# Periodic shift enumeration (host numpy: static sizes)
# ---------------------------------------------------------------------------


def _shift_range_for_cell(cell: np.ndarray, cutoff: float,
                          pbc: np.ndarray) -> np.ndarray:
    """Per-dimension shift range ``ceil(|column_d of cell^-1| * cutoff)``."""
    cell = np.asarray(cell, dtype=np.float64).reshape(3, 3)
    inv_t = np.linalg.inv(cell).T
    d_inv = np.linalg.norm(inv_t, axis=1)
    d_inv = np.where(np.asarray(pbc, dtype=bool), d_inv, 0.0)
    return np.ceil(d_inv * float(cutoff)).astype(np.int64)


def compute_naive_num_shifts(cell, cutoff: float, pbc):
    """Host-side shift counts per system (reads the cell, a small tensor).

    Returns ``(shift_range [B, 3], shift_offset [B + 1]`` cumulative
    half-space counts, ``total_shifts)``, as numpy and an int.
    """
    cell = host_array(cell, np.float64)
    if cell.ndim == 2:
        cell = cell[None]
    pbc = host_array(pbc, bool)
    if pbc.ndim == 1:
        pbc = pbc[None]
    if pbc.shape[0] == 1 and cell.shape[0] > 1:
        pbc = np.broadcast_to(pbc, (cell.shape[0], 3))

    num_systems = cell.shape[0]
    shift_range = np.zeros((num_systems, 3), dtype=np.int64)
    counts = np.zeros(num_systems, dtype=np.int64)
    for b in range(num_systems):
        s = _shift_range_for_cell(cell[b], cutoff, pbc[b])
        shift_range[b] = s
        k1, k2 = 2 * s[1] + 1, 2 * s[2] + 1
        counts[b] = s[0] * k1 * k2 + s[1] * k2 + s[2] + 1
    shift_offset = np.concatenate([[0], np.cumsum(counts)])
    return shift_range, shift_offset, int(shift_offset[-1])


def expand_naive_shifts(shift_range: np.ndarray) -> np.ndarray:
    """Half-space shift vectors for one system (zero shift included):
    ``k0 > 0 or (k0 == 0 and k1 > 0) or (k0 == 0 and k1 == 0 and k2 >= 0)``
    with ``k0`` in ``[0, s0]`` and ``k1``/``k2`` in ``[-s, s]``."""
    s0, s1, s2 = (int(v) for v in np.asarray(shift_range).reshape(3))
    out = []
    for k0 in range(0, s0 + 1):
        for k1 in range(-s1, s1 + 1):
            for k2 in range(-s2, s2 + 1):
                if (k0 > 0 or (k0 == 0 and k1 > 0)
                        or (k0 == 0 and k1 == 0 and k2 >= 0)):
                    out.append((k0, k1, k2))
    return np.asarray(out, dtype=np.int32).reshape(-1, 3)


def expand_full_shifts(shift_range: np.ndarray) -> np.ndarray:
    """Full-space shift vectors (both signs), zero shift first, then in
    lexicographic order: the row-owner enumeration, where row ``a`` holds
    ``(b, S)`` for every image ``r_b + S @ cell`` within the cutoff."""
    s0, s1, s2 = (int(v) for v in np.asarray(shift_range).reshape(3))
    grid = np.stack(
        np.meshgrid(
            np.arange(-s0, s0 + 1),
            np.arange(-s1, s1 + 1),
            np.arange(-s2, s2 + 1),
            indexing="ij",
        ),
        axis=-1,
    ).reshape(-1, 3)
    order = np.lexsort((grid[:, 2], grid[:, 1], grid[:, 0],
                        (grid != 0).any(axis=1)))
    return grid[order].astype(np.int32)


# ---------------------------------------------------------------------------
# Format conversion
# ---------------------------------------------------------------------------


def get_neighbor_list_from_neighbor_matrix(
    neighbor_matrix,
    num_neighbors,
    neighbor_shift_matrix=None,
    fill_value: int = -1,
):
    """Convert a padded neighbor matrix to COO + CSR form, on its device.

    Returns int32 ``neighbor_list [2, num_pairs]`` (rows ascending, each
    row in slot order), ``neighbor_ptr [total_atoms + 1]`` and, when
    shifts are given, ``unit_shifts [num_pairs, 3]``.  The pair count is
    data dependent: one ``nonzero`` reads it from the device.
    """
    device = neighbor_matrix.device
    if num_neighbors.shape[0] == 0:
        neighbor_list = torch.zeros((2, 0), dtype=INDEX_DTYPE, device=device)
        neighbor_ptr = torch.zeros((1,), dtype=INDEX_DTYPE, device=device)
        if neighbor_shift_matrix is not None:
            return neighbor_list, neighbor_ptr, torch.zeros(
                (0, 3), dtype=INDEX_DTYPE, device=device)
        return neighbor_list, neighbor_ptr

    assert_max_neighbors(neighbor_matrix, num_neighbors)

    mask = neighbor_matrix != fill_value
    i_idx, slot_idx = torch.nonzero(mask, as_tuple=True)
    neighbor_list = torch.stack(
        [i_idx.to(INDEX_DTYPE),
         neighbor_matrix[i_idx, slot_idx].to(INDEX_DTYPE)], dim=0)
    ptr = torch.zeros(num_neighbors.shape[0] + 1, dtype=INDEX_DTYPE,
                      device=device)
    ptr[1:] = torch.cumsum(num_neighbors.to(INDEX_DTYPE), 0)
    if neighbor_shift_matrix is not None:
        shifts = neighbor_shift_matrix[i_idx, slot_idx].to(INDEX_DTYPE)
        return neighbor_list, ptr, shifts
    return neighbor_list, ptr


# ---------------------------------------------------------------------------
# Batch bookkeeping
# ---------------------------------------------------------------------------


def prepare_batch_idx_ptr(batch_idx, batch_ptr, num_atoms: int,
                          device=None):
    """Derive whichever of ``batch_idx`` / ``batch_ptr`` is missing, as
    int32 tensors on the device of the one given (``device`` for numpy
    input, the card by default).  Deriving ``batch_ptr`` reads the system
    count from the device."""
    if batch_idx is None and batch_ptr is None:
        raise ValueError("Either batch_idx or batch_ptr must be provided.")

    if batch_idx is None:
        dev = default_device(batch_ptr, device)
        ptr = torch.as_tensor(batch_ptr, device=dev).to(torch.int64)
        counts = ptr[1:] - ptr[:-1]
        idx = torch.repeat_interleave(
            torch.arange(ptr.shape[0] - 1, device=dev), counts,
            output_size=int(num_atoms))
        return idx.to(INDEX_DTYPE), ptr.to(INDEX_DTYPE)

    dev = default_device(batch_idx, device)
    idx = torch.as_tensor(batch_idx, device=dev).to(torch.int64)
    if batch_ptr is None:
        num_systems = int(idx.max()) + 1 if idx.numel() else 1
        counts = torch.bincount(idx, minlength=num_systems)
        ptr = torch.zeros(num_systems + 1, dtype=torch.int64, device=dev)
        ptr[1:] = torch.cumsum(counts, 0)
        return idx.to(INDEX_DTYPE), ptr.to(INDEX_DTYPE)
    return (idx.to(INDEX_DTYPE),
            torch.as_tensor(batch_ptr, device=dev).to(INDEX_DTYPE))


# ---------------------------------------------------------------------------
# Packed shift encoding
# ---------------------------------------------------------------------------


def pack_shifts(sx, sy, sz):
    """Pack three int shift components (|s| <= 511) into one int32."""
    sx = sx.to(INDEX_DTYPE)
    sy = sy.to(INDEX_DTYPE)
    sz = sz.to(INDEX_DTYPE)
    return (
        ((sx + SHIFT_PACK_BIAS) << 20)
        | ((sy + SHIFT_PACK_BIAS) << 10)
        | (sz + SHIFT_PACK_BIAS)
    )


def unpack_shifts(packed):
    """Unpack an int32 shift code into (sx, sy, sz) int32 tensors."""
    packed = packed.to(INDEX_DTYPE)
    sx = ((packed >> 20) & SHIFT_PACK_MASK) - SHIFT_PACK_BIAS
    sy = ((packed >> 10) & SHIFT_PACK_MASK) - SHIFT_PACK_BIAS
    sz = (packed & SHIFT_PACK_MASK) - SHIFT_PACK_BIAS
    return sx, sy, sz


def shifts_to_aos(packed):
    """Packed ``[.., K]`` -> AoS ``[.., K, 3]``."""
    sx, sy, sz = unpack_shifts(packed)
    return torch.stack([sx, sy, sz], dim=-1)


def shifts_from_aos(aos):
    """AoS ``[.., K, 3]`` -> packed ``[.., K]``."""
    return pack_shifts(aos[..., 0], aos[..., 1], aos[..., 2])

# SPDX-License-Identifier: Apache-2.0
"""Streaming O(N^2) pair search shared by the naive neighbor lists
(counterpart of the JAX package's ``neighborlist/_streaming.py``).

The candidate space is ``shifts x atoms``, enumerated column-major
(column = shift_idx * N + j), and processed in column chunks so memory
stays O(N * (K + chunk)).  Per chunk the squared distances are [N, C]
broadcasts; hits are compacted into the rows in column order by a prefix
sum (``neighbor_utils.select_hits``), which is the order the JAX
package's running top-k keeps, so rows come out identical.  The dual
cutoff shares the distances between both cutoffs.
"""

from __future__ import annotations

import torch

from nvalchemiops_torch.neighborlist.neighbor_utils import (
    pack_shifts,
    select_hits,
    shifts_to_aos,
)
from nvalchemiops_torch.types import INDEX_DTYPE

#: elements of one [N, chunk] candidate block
BLOCK_ELEMENTS = 1 << 25


def _choose_chunk(n: int, total_cols: int) -> int:
    """Column-chunk size: a [n, chunk] block of at most ``BLOCK_ELEMENTS``
    elements, at least 128 columns."""
    return max(128, min(total_cols, BLOCK_ELEMENTS // max(n, 1)))


def streaming_pair_search(
    positions,
    cell,
    shifts_int,
    cutoff_sq,
    max_neighbors: int,
    *,
    cutoff_sq2=None,
    max_neighbors2: int | None = None,
    batch_idx=None,
    half_fill: bool = False,
    fill_value: int = -1,
    batched: bool = False,
):
    """Run the streaming pair search.

    ``positions [N, 3]``, ``cell [B, 3, 3]`` (identity for the
    non-periodic path, whose ``shifts_int`` is the zero shift alone),
    ``shifts_int [S, 3]`` int32 (full space for ``half_fill=False``, half
    space for ``half_fill=True``), ``cutoff_sq`` the squared cutoff.  With
    ``batched``, pairs must share a system (``batch_idx [N]``) and shifts
    take the pair's own cell.  ``half_fill`` stores each pair once: for
    the zero shift only ``j > i``.

    Returns ``(neighbor_matrix [N, K] int32, num_neighbors [N] int32,
    shift_matrix [N, K, 3] int32)``, and a second triple for ``cutoff_sq2``
    in dual mode.
    """
    n = positions.shape[0]
    s = shifts_int.shape[0]
    dtype, device = positions.dtype, positions.device
    dual = cutoff_sq2 is not None
    ks = (max_neighbors, max_neighbors2) if dual else (max_neighbors,)
    cutoffs = ((cutoff_sq, cutoff_sq2) if dual else (cutoff_sq,))
    cutoffs = [torch.as_tensor(c, dtype=dtype, device=device)
               for c in cutoffs]
    total_cols = s * n

    nms = [torch.full((n, k), fill_value, dtype=INDEX_DTYPE, device=device)
           for k in ks]
    zero_code = int(pack_shifts(*(torch.zeros((), dtype=INDEX_DTYPE),) * 3))
    shs = [torch.full((n, k), zero_code, dtype=INDEX_DTYPE, device=device)
           for k in ks]
    counts = [torch.zeros(n, dtype=INDEX_DTYPE, device=device) for _ in ks]

    if n and total_cols:
        shifts_int = shifts_int.to(device=device, dtype=INDEX_DTYPE)
        # Cartesian shifts per (shift, system): [S, B, 3]
        shift_cart = torch.einsum("sd,bde->sbe", shifts_int.to(dtype),
                                  cell.to(dtype))
        is_zero_shift = (shifts_int == 0).all(dim=1)
        codes = pack_shifts(shifts_int[:, 0], shifts_int[:, 1],
                            shifts_int[:, 2])
        sys_i = batch_idx.to(device=device).long() if batched else None
        px, py, pz = positions[:, 0], positions[:, 1], positions[:, 2]
        row_ids = torch.arange(n, device=device)[:, None]
        chunk = _choose_chunk(n, total_cols)
        for start in range(0, total_cols, chunk):
            cols = torch.arange(start, min(start + chunk, total_cols),
                                device=device)
            s_idx = torch.div(cols, n, rounding_mode="floor")
            j = cols - s_idx * n
            is_zero = is_zero_shift[s_idx]
            sc = shift_cart[s_idx, sys_i[j] if batched else 0]
            # image of atom j for this column
            qx = px[j] + sc[:, 0]
            qy = py[j] + sc[:, 1]
            qz = pz[j] + sc[:, 2]
            dx = qx[None, :] - px[:, None]
            dy = qy[None, :] - py[:, None]
            dz = qz[None, :] - pz[:, None]
            d2 = dx * dx + dy * dy + dz * dz
            j_row = j[None, :]
            excl = is_zero[None, :] & ((j_row <= row_ids) if half_fill
                                       else (j_row == row_ids))
            if batched:
                excl = excl | (sys_i[j][None, :] != sys_i[:, None])
            j32 = j.to(INDEX_DTYPE)
            code = codes[s_idx]
            for t, (k, cut) in enumerate(zip(ks, cutoffs)):
                col, fill, counts[t] = select_hits((d2 < cut) & ~excl, k,
                                                   counts[t])
                nms[t] = torch.where(fill, j32[col], nms[t])
                shs[t] = torch.where(fill, code[col], shs[t])

    out = ()
    for nm, num, sh in zip(nms, counts, shs):
        out += (nm, num, shifts_to_aos(sh))
    return out

# SPDX-License-Identifier: Apache-2.0
"""O(N) cell-list neighbor construction, single system (counterpart of the
JAX package's ``neighborlist/cell_list.py``).

Build (sort based, deterministic): fractional coordinates -> cell
coordinates (+ periodic wrap bookkeeping) -> linear cell ids -> one stable
``argsort`` -> CSR layout by ``searchsorted``.  ``cell_atom_list``,
``cell_atom_start_indices`` and ``atoms_per_cell_count`` equal the JAX
package's, atoms ascending within a cell.

Query (gather + compaction, row owner): each atom gathers the
fixed-capacity occupant lists of the surrounding cells (the full
``(2R+1)^3`` offsets, or the half space for ``half_fill``), computes all
candidate distances as dense tensor arithmetic, and compacts its hits in
candidate order (``neighbor_utils.select_hits``), in blocks of atoms so
the candidate block stays bounded.

Shift algebra: for a pair (i, j) found through cell offset ``d``,
``S = wrap(c_i + d) + aps_i - aps_j`` on periodic axes (0 elsewhere), and
``r_pair = r_j + S @ cell - r_i``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from nvalchemiops_torch.mathops.math import apply_mat3
from nvalchemiops_torch.neighborlist.naive import as_positions
from nvalchemiops_torch.neighborlist.neighbor_utils import (
    default_device,
    estimate_max_neighbors,
    get_neighbor_list_from_neighbor_matrix,
    host_array,
    pack_shifts,
    select_hits,
    shifts_to_aos,
)
from nvalchemiops_torch.types import INDEX_DTYPE

__all__ = [
    "CellList",
    "estimate_cell_list_sizes",
    "allocate_cell_list",
    "build_cell_list",
    "query_cell_list",
    "cell_list",
]

#: candidates (atoms x offsets x cell capacity) of one query block of
#: atoms, the row block the one-shot entry points pick
CANDIDATE_BLOCK = 1 << 25


class CellList(NamedTuple):
    """Cell-list artifacts (the JAX package's fields)."""

    cells_per_dimension: torch.Tensor       # [3] int32
    neighbor_search_radius: torch.Tensor    # [3] int32
    atom_periodic_shifts: torch.Tensor      # [N, 3] int32
    atom_to_cell_mapping: torch.Tensor      # [N, 3] int32
    atoms_per_cell_count: torch.Tensor      # [max_total_cells] int32
    cell_atom_start_indices: torch.Tensor   # [max_total_cells] int32
    cell_atom_list: torch.Tensor            # [N] int32


# ---------------------------------------------------------------------------
# Host-side sizing
# ---------------------------------------------------------------------------


def _cells_per_dimension_host(cell: np.ndarray, cutoff: float,
                              max_nbins: int):
    """Cell counts per dimension (halved until at most ``max_nbins``) and
    face distances."""
    cell = np.asarray(cell, dtype=np.float64).reshape(3, 3)
    inv_t = np.linalg.inv(cell).T
    face_distance = 1.0 / np.linalg.norm(inv_t, axis=1)
    cpd = np.maximum((face_distance / float(cutoff)).astype(np.int64), 1)
    while int(np.prod(cpd)) > max_nbins:
        cpd = np.maximum(cpd // 2, 1)
    return cpd, face_distance


def estimate_cell_list_sizes(cell, pbc, cutoff: float, max_nbins: int = 1000):
    """Host-side allocation estimate (reads the cell, a small tensor).

    Returns ``(max_total_cells, neighbor_search_radius [3] int32)``: the
    cell grid after the halve-until-under-``max_nbins`` loop, and the
    per-dimension search radius ``ceil(cutoff / bin_width)`` (0 for
    single-cell non-periodic dimensions).
    """
    device = default_device(cell)
    cell_np = host_array(cell, np.float64).reshape(-1, 3, 3)[0]
    pbc_np = host_array(pbc, bool).reshape(-1)[:3]
    if cutoff <= 0:
        return 1, torch.zeros((3,), dtype=INDEX_DTYPE, device=device)
    cpd, face_distance = _cells_per_dimension_host(cell_np, cutoff, max_nbins)
    radius = np.ceil(float(cutoff) * cpd / face_distance).astype(np.int64)
    radius = np.where((cpd == 1) & ~pbc_np, 0, radius)
    return int(np.prod(cpd)), torch.as_tensor(radius, dtype=INDEX_DTYPE,
                                              device=device)


def _observed_capacity(cl, cell_capacity):
    """Capacity of the query: ``cell_capacity`` when given, else the
    observed maximum occupancy rounded up to a multiple of 8 (one read of
    the cell-sized count table).  The JAX package takes at least twice the
    mean occupancy; slots past the
    largest cell only pad the candidate blocks, and rows do not depend on
    the capacity."""
    if cell_capacity is not None:
        return int(cell_capacity)
    counts = cl.atoms_per_cell_count
    observed = int(counts.max()) if counts.numel() else 0
    return max(8, int(np.ceil(observed / 8)) * 8)


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------


def _cells_per_dimension(inv_t, cutoff, pbc, max_nbins: int):
    """Cells per dimension and search radius on the device, the host
    estimate's formula (``[.., 3]`` for cells ``[.., 3, 3]``)."""
    dtype = inv_t.dtype
    face = 1.0 / torch.linalg.norm(inv_t, dim=-1)
    cutoff_t = torch.as_tensor(float(cutoff), dtype=dtype,
                               device=inv_t.device)
    cpd = torch.clamp((face / cutoff_t).to(INDEX_DTYPE), min=1)
    for _ in range(32):
        too_many = (cpd.prod(dim=-1, keepdim=True) > max_nbins)
        cpd = torch.where(too_many, torch.clamp(cpd // 2, min=1), cpd)
    radius = torch.ceil(cutoff_t * cpd.to(dtype) / face).to(INDEX_DTYPE)
    radius = torch.where((cpd == 1) & ~pbc, torch.zeros_like(radius), radius)
    return cpd, radius


def _bin(frac, cpd, pbc):
    """Cell coordinates and periodic shifts of fractional coordinates."""
    coords = torch.floor(frac * cpd.to(frac.dtype)).to(INDEX_DTYPE)
    wrap = torch.div(coords, cpd, rounding_mode="floor")
    wrapped = coords - wrap * cpd
    clamped = torch.minimum(torch.clamp(coords, min=0), cpd - 1)
    aps = torch.where(pbc, wrap, torch.zeros_like(wrap)).to(INDEX_DTYPE)
    cell_coords = torch.where(pbc, wrapped, clamped).to(INDEX_DTYPE)
    return cell_coords, aps


def _csr(linear, total_cells: int):
    """Stable sort of the linear cell ids and the CSR tables."""
    order = torch.argsort(linear, stable=True)
    sorted_ids = linear[order].contiguous()
    cell_range = torch.arange(total_cells, dtype=sorted_ids.dtype,
                              device=linear.device)
    starts = torch.searchsorted(sorted_ids, cell_range, side="left")
    ends = torch.searchsorted(sorted_ids, cell_range, side="right")
    return (order.to(INDEX_DTYPE), starts.to(INDEX_DTYPE),
            (ends - starts).to(INDEX_DTYPE))


def _as_pbc(pbc, device, shape):
    return torch.as_tensor(np.array(host_array(pbc, bool)),
                           device=device).reshape(-1, 3).expand(shape)


def allocate_cell_list(total_atoms: int, max_total_cells: int,
                       neighbor_search_radius=None, device="cuda") -> CellList:
    """Zero-filled :class:`CellList` with the given capacities (the build
    returns fresh tensors; this gives a CellList of the right shapes)."""
    radius = (torch.zeros((3,), dtype=INDEX_DTYPE, device=device)
              if neighbor_search_radius is None
              else torch.as_tensor(neighbor_search_radius, device=device).to(
                  INDEX_DTYPE))

    def z(*shape):
        return torch.zeros(shape, dtype=INDEX_DTYPE, device=device)

    return CellList(
        cells_per_dimension=z(3),
        neighbor_search_radius=radius,
        atom_periodic_shifts=z(total_atoms, 3),
        atom_to_cell_mapping=z(total_atoms, 3),
        atoms_per_cell_count=z(max_total_cells),
        cell_atom_start_indices=z(max_total_cells),
        cell_atom_list=z(total_atoms),
    )


def build_cell_list(
    positions,
    cutoff,
    cell,
    pbc,
    max_total_cells: int,
    max_nbins: int = 1000,
) -> CellList:
    """Build the spatial cell list on the positions' device.

    ``max_total_cells`` comes from :func:`estimate_cell_list_sizes` (host
    side); the cells per dimension are recomputed here on the device with
    the same formula, so the build needs no host read.
    """
    positions = as_positions(positions)
    dtype, device = positions.dtype, positions.device
    cell = torch.as_tensor(cell, dtype=dtype, device=device).reshape(3, 3)
    pbc_arr = _as_pbc(pbc, device, (1, 3))[0]
    inv = torch.linalg.inv(cell)
    cpd, radius = _cells_per_dimension(inv.T, cutoff, pbc_arr, max_nbins)
    cell_coords, aps = _bin(apply_mat3(positions, inv), cpd, pbc_arr)
    linear = cell_coords[:, 0] + cpd[0] * (
        cell_coords[:, 1] + cpd[1] * cell_coords[:, 2])
    order, starts, counts = _csr(linear, max_total_cells)
    return CellList(
        cells_per_dimension=cpd,
        neighbor_search_radius=radius,
        atom_periodic_shifts=aps,
        atom_to_cell_mapping=cell_coords,
        atoms_per_cell_count=counts,
        cell_atom_start_indices=starts,
        cell_atom_list=order,
    )


# ---------------------------------------------------------------------------
# Query
# ---------------------------------------------------------------------------


def _offset_table(search_radius, half_fill: bool) -> np.ndarray:
    """Cell-offset sweep table: full space for ``half_fill=False``, the
    half space (``dx > 0``, or ``dx == 0`` and ``dy > 0``, or ``dx == dy ==
    0`` and ``dz >= 0``) for ``half_fill=True``; the home cell first."""
    rx, ry, rz = (int(r) for r in search_radius)
    offs = []
    for dx in range(-rx, rx + 1):
        for dy in range(-ry, ry + 1):
            for dz in range(-rz, rz + 1):
                if half_fill and not (
                    dx > 0 or (dx == 0 and dy > 0)
                    or (dx == 0 and dy == 0 and dz >= 0)
                ):
                    continue
                offs.append((dx, dy, dz))
    offs = np.asarray(offs, dtype=np.int32).reshape(-1, 3)
    order = np.lexsort((offs[:, 2], offs[:, 1], offs[:, 0],
                        (offs != 0).any(axis=1)))
    return offs[order]


def query_rows(positions, cutoff, cell_b, pbc_b, sys_idx, cl,
               cell_stride: int, search_radius, cell_capacity: int,
               max_neighbors: int, half_fill: bool, fill_value: int,
               row_block: int):
    """Query core shared by the single and batched cell lists.

    ``cell_b [B, 3, 3]``, ``pbc_b [B, 3]`` bool, ``sys_idx [N]`` each
    atom's system, ``cl.cells_per_dimension [B, 3]`` and flat cell ids
    ``system * cell_stride + local``.  Candidates are enumerated offset by
    offset, slot by slot, and each row keeps its hits in that order
    (``select_hits``).

    The pair shift ``S = W + A_i - A_j`` (``W`` the offset's wrap, ``A``
    the atoms' periodic shifts) splits into a per-(row, offset) part and a
    per-atom part, so per candidate the image is one gather of
    ``q_j = r_j - A_j @ cell`` plus the row's ``(W + A_i) @ cell - r_i``,
    and the packed shift code is formed for the kept entries only.  Empty
    slots point at a sentinel atom at infinity, which no cutoff takes.
    Returns ``(neighbor_matrix [N, K], num_neighbors [N], packed shifts
    [N, K])``.
    """
    n = positions.shape[0]
    dtype, device = positions.dtype, positions.device
    k = int(max_neighbors)
    cap = int(cell_capacity)
    zero_code = int(pack_shifts(*(torch.zeros((), dtype=INDEX_DTYPE),) * 3))
    nm = torch.full((n, k), int(fill_value), dtype=INDEX_DTYPE, device=device)
    sh = torch.full((n, k), zero_code, dtype=INDEX_DTYPE, device=device)
    num = torch.zeros(n, dtype=INDEX_DTYPE, device=device)
    if n == 0:
        return nm, num, sh

    offsets = torch.as_tensor(_offset_table(search_radius, half_fill),
                              device=device)
    num_offsets = offsets.shape[0]
    num_cand = num_offsets * cap
    # the home cell is the table's first offset
    home_first = bool((offsets[0] == 0).all())
    cutoff_sq = torch.as_tensor(float(cutoff), dtype=dtype,
                                device=device) ** 2

    # fixed-capacity per-cell occupant view of the CSR layout; n = empty
    slot = torch.arange(cap, dtype=INDEX_DTYPE, device=device)
    flat_idx = cl.cell_atom_start_indices[:, None] + slot[None, :]
    in_cell = slot[None, :] < cl.atoms_per_cell_count[:, None]
    padded_cells = torch.where(
        in_cell,
        cl.cell_atom_list[torch.clamp(flat_idx, 0, max(n - 1, 0)).long()],
        torch.full((), n, dtype=INDEX_DTYPE, device=device))
    n_cells = padded_cells.shape[0]

    cpd_b = cl.cells_per_dimension.reshape(-1, 3)
    aps = cl.atom_periodic_shifts
    cells_a = cell_b[sys_idx]                                   # [N, 3, 3]
    aps_cart = (aps.to(dtype)[:, :, None] * cells_a).sum(1)     # A_j @ cell
    inf = torch.full((1,), math.inf, dtype=dtype, device=device)
    q = [torch.cat([positions[:, d] - aps_cart[:, d], inf]) for d in range(3)]
    lin_a = ((aps[:, 0] << 20) + (aps[:, 1] << 10) + aps[:, 2]).to(
        INDEX_DTYPE)

    for start in range(0, n, row_block):
        rows = torch.arange(start, min(start + row_block, n), device=device)
        r = rows.shape[0]
        s_i = sys_idx[rows]
        cpd_i = cpd_b[s_i][:, None, :]                          # [R, 1, 3]
        pbc_i = pbc_b[s_i][:, None, :]
        target = cl.atom_to_cell_mapping[rows][:, None, :] + offsets[None]
        wrap = torch.div(target, cpd_i, rounding_mode="floor")
        in_range = (target >= 0) & (target < cpd_i)
        off_valid = (pbc_i | in_range).all(dim=-1)              # [R, O]
        m = torch.where(pbc_i, target - wrap * cpd_i,
                        torch.minimum(torch.clamp(target, min=0), cpd_i - 1))
        lin = (s_i[:, None] * cell_stride + m[..., 0]
               + cpd_i[..., 0] * (m[..., 1] + cpd_i[..., 1] * m[..., 2]))
        lin = torch.clamp(lin, 0, n_cells - 1)
        cand = padded_cells[lin.long()]                         # [R, O, cap]

        # per (row, offset): S_i = (W + A_i) on periodic axes
        s_row = (wrap + aps[rows][:, None, :]) * pbc_i.to(INDEX_DTYPE)
        base = (s_row.to(dtype)[..., None] * cells_a[rows][:, None]).sum(2)
        base = base - positions[rows][:, None, :]               # [R, O, 3]
        d2 = None
        for d in range(3):
            dd = q[d][cand] + base[..., d, None]
            d2 = dd * dd if d2 is None else d2 + dd * dd
        mask = (d2 < cutoff_sq) & off_valid[..., None]
        mask = mask.reshape(r, num_cand)
        if home_first:
            home = cand[:, 0]
            row_col = rows[:, None].to(INDEX_DTYPE)
            mask[:, :cap] &= ~((home <= row_col) if half_fill
                               else (home == row_col))
        col, fill, num[rows] = select_hits(mask, k)
        j = torch.gather(cand.reshape(r, num_cand), 1, col)
        o = torch.div(col, cap, rounding_mode="floor")
        s_lin = ((s_row[..., 0] << 20) + (s_row[..., 1] << 10)
                 + s_row[..., 2])                              # [R, O]
        code = (zero_code + torch.gather(s_lin, 1, o)
                - lin_a[torch.clamp(j, max=n - 1).long()])
        nm[rows] = torch.where(fill, j, nm[rows])
        sh[rows] = torch.where(fill, code.to(INDEX_DTYPE), sh[rows])
    return nm, num, sh


def query_cell_list(
    positions,
    cutoff,
    cell,
    pbc,
    cell_list_data: CellList,
    search_radius,
    cell_capacity: int,
    max_neighbors: int,
    half_fill: bool = False,
    fill_value: int = -1,
    row_block: int = 1024,
    shift_format: str = "aos",
):
    """Query the cell list into a padded neighbor matrix.

    ``search_radius`` (int triple), ``cell_capacity`` and
    ``max_neighbors`` are host-side capacities; atoms are queried
    ``row_block`` at a time.  ``shift_format="aos"`` gives the
    ``[N, K, 3]`` shift matrix, ``"packed"`` one int32 code per pair
    (``neighbor_utils.pack_shifts``).  Returns ``(neighbor_matrix [N, K],
    num_neighbors [N], shifts)``.
    """
    positions = as_positions(positions)
    dtype, device = positions.dtype, positions.device
    cell_b = torch.as_tensor(cell, dtype=dtype, device=device).reshape(
        1, 3, 3)
    pbc_b = _as_pbc(pbc, device, (1, 3))
    cl = cell_list_data
    sys_idx = torch.zeros(positions.shape[0], dtype=torch.long,
                          device=device)
    nm, num, sh = query_rows(
        positions, cutoff, cell_b, pbc_b, sys_idx, cl,
        cl.atoms_per_cell_count.shape[0], search_radius, cell_capacity,
        max_neighbors, half_fill, fill_value, int(row_block))
    if shift_format == "packed":
        return nm, num, sh
    return nm, num, shifts_to_aos(sh)


def candidate_row_block(search_radius, half_fill: bool, cap: int) -> int:
    """Atoms per query block: ``CANDIDATE_BLOCK`` candidates at most."""
    num_offsets = _offset_table(search_radius, half_fill).shape[0]
    return max(1, CANDIDATE_BLOCK // max(num_offsets * cap, 1))


def cell_list(
    positions,
    cutoff: float,
    cell,
    pbc,
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
    """Build + query in one call, with capacity estimation.

    The cell capacity is the observed occupancy (a read of the cell-sized
    count table); ``max_neighbors`` defaults to
    :func:`estimate_max_neighbors` (size it from the system's density at
    scale: the default assumes 0.35 atoms per cubic Angstrom and a safety
    factor of 5).  ``device`` (keyword) places numpy positions.  Returns
    ``(neighbor_matrix, num_neighbors, shifts)`` or, with
    ``return_neighbor_list``, the COO/CSR conversion.
    """
    positions = as_positions(positions, _ignored.get("device"))
    total_atoms = positions.shape[0]
    if fill_value is None:
        fill_value = total_atoms
    if max_neighbors is None:
        if neighbor_matrix is not None:
            max_neighbors = int(neighbor_matrix.shape[1])
        else:
            max_neighbors = estimate_max_neighbors(cutoff)

    max_total_cells, radius = estimate_cell_list_sizes(cell, pbc, cutoff,
                                                       max_nbins)
    radius_t = tuple(int(v) for v in host_array(radius))
    cl = build_cell_list(positions, cutoff, cell, pbc, max_total_cells,
                         max_nbins)
    cap = _observed_capacity(cl, cell_capacity)
    nm, num, sh = query_cell_list(
        positions, cutoff, cell, pbc, cl, radius_t, cap, int(max_neighbors),
        half_fill=half_fill, fill_value=int(fill_value),
        row_block=candidate_row_block(radius_t, half_fill, cap),
        shift_format=shift_format)
    if return_neighbor_list:
        return get_neighbor_list_from_neighbor_matrix(
            nm, num, sh, fill_value=int(fill_value))
    return nm, num, sh

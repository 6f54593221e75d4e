# SPDX-License-Identifier: Apache-2.0
"""Halo-padded atom grid (counterpart of ``nvalchemiops_tpu.grid``).

Atoms are binned into a fixed-capacity spatial grid stored as dense
per-property planes ``[Cz, Cy, Cx, cap]``, padded by the search radius with
periodic ghost cells whose positions carry their image shift.  Pairing
"every atom of cell c with every atom of cell c + d" is then a read of a
contiguous candidate window, which the pair-sweep kernels
(kernels/window_sweep.py, kernels/row_sweep.py, kernels/chunk_sweep.py) walk
in the half-space, pair-once order.  The JAX package's XLA-engine sweeps
that its ``__all__`` exports, :func:`grid_pair_reduce` (the full
``(2R+1)^3`` offset sweep) and :func:`grid_row_reduce_sym` (the half-space
row sweep with x-merged candidate windows), are plain PyTorch here: a
Python loop over offsets with static slices of the extended planes.  Of the
package, only :func:`grid_neighbor_count` and
:func:`grid_coordination_numbers` run on them; every engine name, ``"xla"``
included, runs a kernel's sweep.

Port contracts kept from the JAX package:

- the host-side geometry choice (``estimate_grid_geometry``,
  ``choose_grid_origin``, ``choose_grid_geometry``) is the same code, so
  both packages pick the same grid; its cost constants are still the ones
  fit on the TPU;
- empty slots are parked at ``x = DISPLACE + slot * DISPLACE_SPACING``, so
  the distance test alone excludes them from every pair body;
- atoms past a cell's capacity land in the trash slot ``ncells * cap``;
- atom ids are int32 here (the JAX build carries them in the position
  dtype).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from nvalchemiops_torch.kernels.chunk_sweep import (
    chunk_sweep, super_chunk_cells,
)
from nvalchemiops_torch.kernels.window_sweep import SweepParams, window_sweep
from nvalchemiops_torch.mathops.math import (
    apply_mat3_batched, divmod_floor,
)
from nvalchemiops_torch.neighborlist.neighbor_utils import pack_shifts
from nvalchemiops_torch.types import INDEX_DTYPE

DISPLACE = 3.0e7
DISPLACE_SPACING = 1.0e5

__all__ = [
    "AtomGrid",
    "estimate_grid_geometry",
    "build_atom_grid",
    "batch_build_atom_grid",
    "system_grid",
    "choose_grid_origin",
    "choose_grid_geometry",
    "build_atom_grid_auto",
    "scatter_to_grid",
    "gather_from_grid",
    "gather_rows_from_grid",
    "scatter_rows_to_grid",
    "fold_halo",
    "grid_pair_reduce",
    "grid_row_reduce_sym",
    "row_home_mask",
    "grid_neighbor_count",
    "grid_coordination_numbers",
    "grid_coulomb_energy_forces",
]


@dataclass
class AtomGrid:
    """Dense atom grid with halo (all planes ``[Ez, Ey, Ex, cap]``).

    ``flat_slot [N]`` maps atom -> interior slot (``ncells * cap`` = trash
    for overflow); ``counts_max`` is the largest observed occupancy (a
    0-d int32 tensor); ``dims``/``radius`` are (z, y, x) ordered.
    """

    ext_px: torch.Tensor
    ext_py: torch.Tensor
    ext_pz: torch.Tensor
    ext_valid: torch.Tensor
    ext_aid: torch.Tensor
    ext_shift_code: torch.Tensor
    flat_slot: torch.Tensor
    counts_max: torch.Tensor
    dims: tuple
    radius: tuple
    cap: int

    def __post_init__(self):
        self.dims = tuple(int(d) for d in self.dims)
        self.radius = tuple(int(r) for r in self.radius)
        self.cap = int(self.cap)


def _pbc_list(pbc):
    if isinstance(pbc, torch.Tensor):
        pbc = pbc.cpu().numpy()
    return [bool(b) for b in np.asarray(pbc, dtype=bool).reshape(-1)[:3]]


def _cell_np(cell):
    if isinstance(cell, torch.Tensor):
        cell = cell.detach().cpu().numpy()
    return np.asarray(cell, dtype=np.float64).reshape(3, 3)


def estimate_grid_geometry(cell, pbc, cutoff: float, total_atoms: int,
                           target_occupancy: float = 0.66,
                           bins_per_cutoff: int = 1):
    """Host-side static geometry ``(dims, radius, cap)`` (z, y, x order)."""
    cell_np = _cell_np(cell)
    inv_t = np.linalg.inv(cell_np).T
    face = 1.0 / np.linalg.norm(inv_t, axis=1)  # distances between cell faces
    bin_target = cutoff / max(bins_per_cutoff, 1)
    cpd = np.maximum((face / bin_target).astype(np.int64), 1)
    radius = np.ceil(cutoff * cpd / face).astype(np.int64)
    pbc_np = np.asarray(_pbc_list(pbc))
    if (radius[pbc_np] > cpd[pbc_np]).any():
        raise ValueError(
            "grid path requires search radius <= cells per dimension "
            f"(got radius {radius}, dims {cpd}); use the naive/streaming path"
        )
    mean_occ = total_atoms / max(np.prod(cpd), 1)
    cap_est = max(mean_occ / target_occupancy,
                  mean_occ + 5.0 * np.sqrt(mean_occ + 1.0))
    cap = int(np.ceil(max(cap_est, 8.0) / 8)) * 8
    return (
        (int(cpd[2]), int(cpd[1]), int(cpd[0])),
        (int(radius[2]), int(radius[1]), int(radius[0])),
        cap,
    )


def _bin_coords(positions, cell, pbc, dims, origin):
    """Per-atom (x, y, z) periodic wrap count and linear cell index, by the
    build's binning rule (wrap on periodic axes, clamp elsewhere), over any
    leading system axes: ``positions [.., n, 3]``, ``cell [.., 3, 3]``."""
    dtype = positions.dtype
    cz, cy, cx = dims
    pbc_t = torch.tensor(_pbc_list(pbc), device=positions.device)
    cpd_xyz = torch.tensor([cx, cy, cz], dtype=INDEX_DTYPE,
                           device=positions.device)
    frac = apply_mat3_batched(positions, torch.linalg.inv(cell))
    bin_pos = frac * cpd_xyz.to(dtype)
    if origin is not None:
        bin_pos = bin_pos - torch.as_tensor(
            origin, dtype=dtype, device=positions.device).reshape(3)
    coords = torch.floor(bin_pos).to(INDEX_DTYPE)
    wrap, wrapped = divmod_floor(coords, cpd_xyz)
    clamped = torch.minimum(torch.clamp(coords, min=0), cpd_xyz - 1)
    ccoords = torch.where(pbc_t, wrapped, clamped)
    aps = torch.where(pbc_t, wrap, torch.zeros_like(wrap))
    lin = ccoords[..., 0] + cx * (ccoords[..., 1] + cy * ccoords[..., 2])
    return aps, lin


def _extend(plane, radius, pbc, fill, first_axis: int = 0):
    """Halo-pad the three cell axes from ``first_axis`` on: wrap on
    periodic axes, ``fill`` elsewhere (axis order z, y, x; pbc is x, y,
    z)."""
    out = plane
    for ax, (r, periodic) in enumerate(zip(radius, (pbc[2], pbc[1], pbc[0])),
                                       start=first_axis):
        if r == 0:
            continue
        n = out.shape[ax]
        if periodic:
            lo = out.narrow(ax, n - r, r)
            hi = out.narrow(ax, 0, r)
        else:
            shape = list(out.shape)
            shape[ax] = r
            lo = hi = torch.full(shape, fill, dtype=out.dtype,
                                 device=out.device)
        out = torch.cat([lo, out, hi], dim=ax)
    return out


def build_atom_grid(positions, cell, pbc, dims, radius, cap,
                    origin=None) -> AtomGrid:
    """Bin, sort, fill the slot planes, and halo-extend: the batched build
    (:func:`batch_build_atom_grid`) on a batch of one, with a 0-d
    ``counts_max``.

    ``origin`` (optional [3], xyz order, in bin units) shifts the periodic
    bin partition (see :func:`choose_grid_origin`).
    """
    cell = torch.as_tensor(cell, dtype=positions.dtype,
                           device=positions.device).reshape(3, 3)
    return system_grid(batch_build_atom_grid(
        positions[None], cell, pbc, dims, radius, cap, origin=origin), 0)


def batch_build_atom_grid(positions, cells, pbc, dims, radius, cap,
                          origin=None) -> AtomGrid:
    """Whole-batch grid build: ``positions [B, npa, 3]`` -> an AtomGrid
    whose array fields carry a leading system axis (``counts_max [B]``).

    One stable sort over the compound keys ``system * ncells + cell`` (so
    per-system ranks equal the single-system build's), one flat histogram
    and exclusive cumsum over ``B * ncells`` cells; slots, atom ids (local
    to each system, int32), shift codes and ``counts_max`` equal the JAX
    package's ``batch_build_atom_grid`` exactly.  Geometry is shared by the
    batch; ``cells`` may be ``[3, 3]`` or ``[B, 3, 3]``.
    """
    b, npa, _ = positions.shape
    dtype, device = positions.dtype, positions.device
    cells = torch.as_tensor(cells, dtype=dtype, device=device)
    if cells.dim() == 2:
        cells = cells.reshape(1, 3, 3).expand(b, 3, 3)
    pbc_l = _pbc_list(pbc)
    cz, cy, cx = (int(d) for d in dims)
    rz, ry, rx = (int(r) for r in radius)
    cap = int(cap)
    ncells = cx * cy * cz

    aps, lin = _bin_coords(positions, cells, pbc_l, (cz, cy, cx), origin)
    # wrapped positions (images moved into the box) so ghost shifts are exact
    wp = (positions - apply_mat3_batched(aps.to(dtype), cells)).reshape(-1,
                                                                         3)
    sys_id = torch.arange(b, dtype=INDEX_DTYPE, device=device)
    lin_g = (lin + sys_id[:, None] * ncells).reshape(-1)   # compound key

    n_tot = b * npa
    iota = torch.arange(n_tot, dtype=torch.int64, device=device)
    sorted_lin, order = torch.sort(lin_g, stable=True)
    boundary = torch.ones(n_tot, dtype=torch.bool, device=device)
    if n_tot > 1:
        boundary[1:] = sorted_lin[1:] != sorted_lin[:-1]
    run_start = torch.cummax(torch.where(boundary, iota, 0), dim=0).values
    rank_sorted = (iota - run_start).to(INDEX_DTYPE)
    sys_sorted = torch.div(sorted_lin, ncells, rounding_mode="floor")
    counts_max = torch.zeros(b, dtype=INDEX_DTYPE, device=device).scatter_reduce(
        0, sys_sorted.long(), rank_sorted + 1, reduce="amax")
    local_lin = sorted_lin - sys_sorted * ncells
    flat = torch.zeros(n_tot, dtype=INDEX_DTYPE, device=device)
    flat[order] = torch.where(rank_sorted >= cap,
                              torch.full_like(rank_sorted, ncells * cap),
                              local_lin * cap + rank_sorted)

    counts = torch.bincount(lin_g.long(), minlength=b * ncells)
    starts = torch.cumsum(counts, 0) - counts
    ends = starts + counts
    valid = torch.arange(cap, device=device)[None, :] < counts[:, None]
    srcc = torch.minimum(starts[:, None] + torch.arange(cap, device=device),
                         ends[:, None]).reshape(-1)
    svals = torch.cat([wp[order], wp.new_zeros((cap, 3))])
    planes = torch.where(valid.reshape(-1, 1), svals[srcc],
                         torch.zeros((), dtype=dtype, device=device))
    planes = planes.reshape(b, cz, cy, cx, cap, 3)
    order_local = (order - torch.div(order, npa, rounding_mode="floor") * npa
                   ).to(INDEX_DTYPE)
    aid_src = torch.cat([order_local, torch.full((cap,), npa,
                                                 dtype=INDEX_DTYPE,
                                                 device=device)])
    g_aid = torch.where(valid.reshape(-1), aid_src[srcc],
                        torch.full((), npa, dtype=INDEX_DTYPE, device=device)
                        ).reshape(b, cz, cy, cx, cap)
    g_valid = valid.reshape(b, cz, cy, cx, cap)

    # per-system park iota: systems never interact
    slot_iota = torch.arange(ncells * cap, dtype=dtype,
                             device=device).reshape(1, cz, cy, cx, cap)
    park = torch.where(g_valid, torch.zeros((), dtype=dtype, device=device),
                       DISPLACE + slot_iota * DISPLACE_SPACING)
    radius_t = (rz, ry, rx)

    def ext(plane, fill):
        return _extend(plane, radius_t, pbc_l, fill, first_axis=1)

    ext_px = ext(planes[..., 0] + park, DISPLACE)
    ext_py = ext(planes[..., 1], 0.0)
    ext_pz = ext(planes[..., 2], 0.0)
    ext_valid = ext(g_valid, False)
    ext_aid = ext(g_aid, npa)

    ez, ey, ex = cz + 2 * rz, cy + 2 * ry, cx + 2 * rx

    def shift(e, r, c):
        return divmod_floor(torch.arange(e, dtype=INDEX_DTYPE, device=device)
                            - r, c)[0]

    sz = shift(ez, rz, cz)[:, None, None].expand(ez, ey, ex)
    sy = shift(ey, ry, cy)[None, :, None].expand(ez, ey, ex)
    sx = shift(ex, rx, cx)[None, None, :].expand(ez, ey, ex)
    sxf, syf, szf = sx.to(dtype), sy.to(dtype), sz.to(dtype)
    c = cells.reshape(b, 1, 1, 1, 3, 3)
    shx = sxf * c[..., 0, 0] + syf * c[..., 1, 0] + szf * c[..., 2, 0]
    shy = sxf * c[..., 0, 1] + syf * c[..., 1, 1] + szf * c[..., 2, 1]
    shz = sxf * c[..., 0, 2] + syf * c[..., 1, 2] + szf * c[..., 2, 2]
    return AtomGrid(
        ext_px=ext_px + shx[..., None],
        ext_py=ext_py + shy[..., None],
        ext_pz=ext_pz + shz[..., None],
        ext_valid=ext_valid,
        ext_aid=ext_aid,
        ext_shift_code=pack_shifts(sx, sy, sz).expand((b, ez, ey, ex)),
        flat_slot=flat.reshape(b, npa),
        counts_max=counts_max,
        dims=(cz, cy, cx),
        radius=(rz, ry, rx),
        cap=cap,
    )


def system_grid(grid: AtomGrid, b: int) -> AtomGrid:
    """System ``b`` of a batched AtomGrid, as a single-system AtomGrid."""
    return AtomGrid(
        **{f: getattr(grid, f)[b] for f in (
            "ext_px", "ext_py", "ext_pz", "ext_valid", "ext_aid",
            "ext_shift_code", "flat_slot", "counts_max")},
        dims=grid.dims, radius=grid.radius, cap=grid.cap)


def _window(grid: AtomGrid, z0: int, y0: int, x0: int):
    """Index of the interior-sized block of an extended plane that starts at
    extended cell ``(z0, y0, x0)``."""
    cz, cy, cx = grid.dims
    return (slice(z0, z0 + cz), slice(y0, y0 + cy), slice(x0, x0 + cx))


def scatter_to_grid(grid: AtomGrid, values, fill=0.0):
    """Scatter a per-atom array into interior layout ``[Cz, Cy, Cx, cap]``."""
    cz, cy, cx = grid.dims
    buf = torch.full((cz * cy * cx * grid.cap + 1,), fill, dtype=values.dtype,
                     device=values.device)
    buf[grid.flat_slot.long()] = values
    return buf[:-1].reshape(cz, cy, cx, grid.cap)


def gather_from_grid(grid: AtomGrid, plane):
    """Read per-atom values back out of an interior grid plane."""
    flat = plane.reshape(-1)
    return flat[torch.clamp(grid.flat_slot.long(), max=flat.numel() - 1)]


def gather_rows_from_grid(grid: AtomGrid, planes):
    """One ``[slots, k]`` row gather for k interior planes -> k per-atom
    arrays (overflow atoms read the last slot, as in the JAX package)."""
    stacked = torch.stack([p.reshape(-1) for p in planes], dim=-1)
    rows = stacked[torch.clamp(grid.flat_slot.long(),
                               max=stacked.shape[0] - 1)]
    return tuple(rows[:, i] for i in range(len(planes)))


def _interior(grid: AtomGrid, ext_plane):
    rz, ry, rx = grid.radius
    cz, cy, cx = grid.dims
    return ext_plane[rz:rz + cz, ry:ry + cy, rx:rx + cx]


def scatter_rows_to_grid(grid: AtomGrid, values_list, fill=0.0):
    """k per-atom arrays -> k interior planes, as one slot -> atom row
    gather through the grid's atom-id plane (empty slots read ``fill``).

    Values are cast to the first array's dtype.
    """
    cz, cy, cx = grid.dims
    dtype = values_list[0].dtype
    k = len(values_list)
    vals = torch.stack([torch.as_tensor(v).to(dtype) for v in values_list],
                       dim=-1)
    padded = torch.cat([vals, torch.full((1, k), fill, dtype=dtype,
                                         device=vals.device)])
    aid = _interior(grid, grid.ext_aid).reshape(-1).long()
    planes = padded[aid].reshape(cz, cy, cx, grid.cap, k)
    return tuple(planes[..., i] for i in range(k))


def _extend_like(grid: AtomGrid, plane, fill):
    """Halo-extend an interior per-slot property plane: periodic copies,
    masked to ``fill`` where the extended slot is not a valid atom.
    Feature planes ``[.., cap, F]`` extend the same way."""
    out = _extend(plane, grid.radius, [True] * 3, fill)
    valid = grid.ext_valid
    if plane.dim() == 5:
        valid = valid[..., None]
    return torch.where(valid, out,
                       torch.full((), fill, dtype=out.dtype, device=out.device))


def fold_halo(grid: AtomGrid, ext_acc):
    """Fold an extended accumulator's halo back onto the interior (wrap)."""
    rz, ry, rx = grid.radius
    cz, cy, cx = grid.dims
    a = ext_acc
    for ax, (r, c) in enumerate(((rz, cz), (ry, cy), (rx, cx))):
        core = a.narrow(ax, r, c).clone()
        if r:
            core.narrow(ax, 0, r).add_(a.narrow(ax, r + c, r))
            core.narrow(ax, c - r, r).add_(a.narrow(ax, 0, r))
        a = core
    return a


# ---------------------------------------------------------------------------
# The offset sweeps of the JAX package's XLA engine, in plain PyTorch
# ---------------------------------------------------------------------------


def _sweep_planes(grid: AtomGrid, extra_ext_planes, extra_own_planes):
    """The ``own`` (interior) and ``ext`` (extended) plane dicts of a sweep:
    px, py, pz, valid, aid, then the extra planes (which may replace
    them)."""
    ext = {"px": grid.ext_px, "py": grid.ext_py, "pz": grid.ext_pz,
           "valid": grid.ext_valid, "aid": grid.ext_aid}
    own = {name: _interior(grid, plane) for name, plane in ext.items()}
    own.update(extra_own_planes)
    ext.update(extra_ext_planes)
    return own, ext


def grid_pair_reduce(grid: AtomGrid, kernel, init, extra_ext_planes=(),
                     extra_own_planes=()):
    """The full ``(2R+1)^3`` offset sweep, reducing per-own-slot quantities.

    ``kernel(carry, own, cand, offset_index)`` receives ``own``: px, py, pz,
    valid, aid and the extra own planes, interior ``[Cz, Cy, Cx, cap]``;
    ``cand``: the same names and the extra extended planes, sliced at the
    offset, plus ``code [Cz, Cy, Cx, 1]`` (the packed ghost shift); it
    returns the new carry.  A pair block (own slot a, candidate slot b) is
    ``own[..., :, None]`` against ``cand[..., None, :]``.
    """
    rz, ry, rx = grid.radius
    own, ext = _sweep_planes(grid, extra_ext_planes, extra_own_planes)
    offsets = [(dz, dy, dx) for dz in range(-rz, rz + 1)
               for dy in range(-ry, ry + 1) for dx in range(-rx, rx + 1)]
    carry = init
    for oi, (dz, dy, dx) in enumerate(offsets):
        at = _window(grid, rz + dz, ry + dy, rx + dx)
        cand = {name: plane[at] for name, plane in ext.items()}
        cand["code"] = grid.ext_shift_code[at][..., None]
        carry = kernel(carry, own, cand, oi)
    return carry


def row_home_mask(cap: int, rx: int, device="cuda"):
    """Pair-once mask of the home row window ``[1, 1, 1, cap, (rx+1)*cap]``:
    the window holds x chunks 0..rx; chunk 0 is the cell with itself (keep
    slot pairs i < j), the others are distinct cells seen only from the
    left (keep all).  ``device``: where the mask is made."""
    slot_i = torch.arange(cap, device=device)[:, None]
    slot_j = torch.arange((rx + 1) * cap, device=device)[None, :]
    keep = (slot_j >= cap) | (slot_i < slot_j)
    return keep.reshape(1, 1, 1, cap, (rx + 1) * cap)


def grid_row_reduce_sym(grid: AtomGrid, kernel, init, num_ext_acc: int,
                        extra_ext_planes=(), extra_own_planes=()):
    """Half-space ``(dz, dy)`` sweep with x-merged candidate windows.

    ``kernel(carry, own, cand, home)`` sees candidate planes of trailing
    width ``W = (2*Rx+1)*cap`` (home row: ``(Rx+1)*cap``; apply
    :func:`row_home_mask` when ``home``) and returns ``(carry, deltas)``:
    ``num_ext_acc`` j-side delta planes ``[Cz, Cy, Cx, W]``.  Each window's
    deltas are added back chunk by chunk onto extended accumulators by
    in-place slice adds (no atomics: equal bits run to run), which
    :func:`fold_halo` folds onto the interior.  Returns ``(carry,
    folded)``.
    """
    rz, ry, rx = grid.radius
    cap = grid.cap
    own, ext = _sweep_planes(grid, extra_ext_planes, extra_own_planes)
    ext_acc = [torch.zeros_like(grid.ext_px) for _ in range(num_ext_acc)]

    def run_offset(carry, z0, y0, chunks, home):
        # windows concatenate along the slot axis, so a plane may carry a
        # trailing feature axis [.., cap, F]
        cand = {name: torch.cat([plane[_window(grid, z0, y0, c)]
                                 for c in chunks], dim=3)
                for name, plane in ext.items()}
        code = torch.stack([grid.ext_shift_code[_window(grid, z0, y0, c)]
                            for c in chunks], dim=-1)
        cand["code"] = code.repeat_interleave(cap, dim=-1)
        carry, deltas = kernel(carry, own, cand, home)
        for acc, delta in zip(ext_acc, deltas):
            d = delta.reshape(delta.shape[:-1] + (len(chunks), cap))
            for ci, c in enumerate(chunks):
                acc[_window(grid, z0, y0, c)] += d[..., ci, :]
        return carry

    # home row: dz = dy = 0, x chunks 0..rx to the right
    carry = run_offset(init, rz, ry, list(range(rx, 2 * rx + 1)), True)
    full = list(range(2 * rx + 1))
    for dz in range(-rz, rz + 1):
        for dy in range(-ry, ry + 1):
            if dz > 0 or (dz == 0 and dy > 0):
                carry = run_offset(carry, dz + rz, dy + ry, full, False)
    return carry, tuple(fold_halo(grid, acc) for acc in ext_acc)


def _distances(own, cand):
    dx = cand["px"][..., None, :] - own["px"][..., :, None]
    dy = cand["py"][..., None, :] - own["py"][..., :, None]
    dz = cand["pz"][..., None, :] - own["pz"][..., :, None]
    return dx * dx + dy * dy + dz * dz


def grid_neighbor_count(grid: AtomGrid, cutoff, num_atoms: int):
    """Per-atom neighbour counts within ``cutoff`` straight from the grid
    (the full sweep; a validation helper).  Counts are ``INDEX_DTYPE``."""
    dtype, device = grid.ext_px.dtype, grid.ext_px.device
    cutoff_sq = torch.tensor(float(cutoff), dtype=dtype, device=device) ** 2
    zero = torch.zeros((), dtype=INDEX_DTYPE, device=device)
    zero_code = pack_shifts(zero, zero, zero)

    def kern(counts, own, cand, oi):
        d2 = _distances(own, cand)
        # parked empty slots fail the distance test on their own
        ok = (d2 < cutoff_sq) & (d2 > 1e-24)
        self_pair = own["aid"][..., :, None] == cand["aid"][..., None, :]
        ok &= ~(self_pair & (cand["code"][..., None] == zero_code))
        return counts + ok.sum(-1).to(INDEX_DTYPE)

    init = torch.zeros(grid.dims + (grid.cap,), dtype=INDEX_DTYPE,
                       device=device)
    return gather_from_grid(grid, grid_pair_reduce(grid, kern, init))


def grid_coordination_numbers(grid: AtomGrid, rcov_per_atom, cutoff,
                              k1=16.0):
    """DFT-D3 coordination numbers on the grid (the full sweep)."""
    dtype, device = grid.ext_px.dtype, grid.ext_px.device
    cutoff_sq = torch.tensor(float(cutoff), dtype=dtype, device=device) ** 2
    k1 = torch.tensor(float(k1), dtype=dtype, device=device)
    rcov_plane = scatter_to_grid(grid, torch.as_tensor(rcov_per_atom).to(
        device=device, dtype=dtype))
    rcov_ext = _extend_like(grid, rcov_plane, 0.0)

    def kern(cn, own, cand, oi):
        d2 = _distances(own, cand)
        ok = (d2 < cutoff_sq) & (d2 > 1e-24)
        inv_r = torch.rsqrt(torch.where(ok, d2, torch.ones_like(d2)))
        rc = own["rcov"][..., :, None] + cand["rcov"][..., None, :]
        f = 1.0 / (1.0 + torch.exp(-k1 * (rc * inv_r - 1.0)))
        return cn + torch.where(ok, f, torch.zeros_like(f)).sum(-1)

    cn = grid_pair_reduce(grid, kern, torch.zeros_like(rcov_plane),
                          extra_ext_planes=(("rcov", rcov_ext),),
                          extra_own_planes=(("rcov", rcov_plane),))
    return gather_from_grid(grid, cn)


def _coulomb_window_impl(grid: AtomGrid, q_plane, q_ext, cutoff: float,
                         alpha: float):
    """Coulomb pair sweep -> interior planes ``(e, fx, fy, fz)``."""
    own = torch.stack([_interior(grid, grid.ext_px),
                       _interior(grid, grid.ext_py),
                       _interior(grid, grid.ext_pz), q_plane])
    cand = torch.stack([grid.ext_px, grid.ext_py, grid.ext_pz, q_ext])
    acc, jacc = window_sweep("coulomb", grid.radius, own, cand,
                             SweepParams(cutoff=float(cutoff),
                                         alpha=float(alpha)))
    return tuple(acc[k] + fold_halo(grid, jacc[k]) for k in range(4))


def _coulomb_block_impl(grid: AtomGrid, q_plane, q_ext, cutoff: float,
                        alpha: float):
    """Coulomb sweep on the super-chunk kernel (kernels/chunk_sweep.py) ->
    interior planes ``(e, fx, fy, fz)``."""
    own = torch.stack([_interior(grid, grid.ext_px),
                       _interior(grid, grid.ext_py),
                       _interior(grid, grid.ext_pz), q_plane])
    cand = torch.stack([grid.ext_px, grid.ext_py, grid.ext_pz, q_ext])
    g_cells = super_chunk_cells("coulomb", grid.dims[2], grid.cap,
                                grid.radius[2])
    acc, jacc = chunk_sweep("coulomb", grid.radius, own, cand,
                            SweepParams(cutoff=float(cutoff),
                                        alpha=float(alpha)), g_cells)
    return tuple(acc[k] + fold_halo(grid, jacc[k]) for k in range(4))


def grid_coulomb_energy_forces(grid: AtomGrid, charges, cutoff, alpha=0.0,
                               engine: str | None = None):
    """(erfc-damped) Coulomb per-atom energies and forces via the pair sweep.

    ``alpha = 0`` is the bare Coulomb sum within ``cutoff``; self-image
    pairs (r -> 0) are excluded by the r^2 > 0 guard.  Returns
    ``(energies [N], forces [N, 3])``.  ``engine``: ``None`` or
    ``"window"`` (the per-cell pair sweep, kernels/window_sweep.py) or
    ``"block"`` (the super-chunk sweep, kernels/chunk_sweep.py); ``"xla"``,
    the JAX package's XLA engine (its default off the TPU), runs the window
    engine, which gives its results to rounding.
    """
    if engine not in (None, "window", "block", "xla"):
        raise ValueError(f"grid_coulomb_energy_forces: unknown engine "
                         f"{engine!r}")
    q_plane = scatter_to_grid(grid, charges)
    q_ext = _extend_like(grid, q_plane, 0.0)
    impl = _coulomb_block_impl if engine == "block" else _coulomb_window_impl
    planes = impl(grid, q_plane, q_ext, cutoff, alpha)
    energies, f1, f2, f3 = gather_rows_from_grid(grid, planes)
    return energies, torch.stack([f1, f2, f3], dim=-1)


def choose_grid_origin(positions, cell, pbc, dims):
    """Bin-partition origin (xyz, bin units) minimizing the max occupancy.

    Tries the zero origin and half-bin shifts (4 combinations); returns
    ``(origin [3] np.ndarray, max_occupancy int)``.  Uses the build's exact
    binning rule, so the occupancy it reports is what the build sees.
    """
    dtype = positions.dtype
    cell_t = torch.as_tensor(cell, dtype=dtype,
                             device=positions.device).reshape(3, 3)
    cz, cy, cx = dims
    pbc_l = _pbc_list(pbc)
    best = None
    for o in ([0.0, 0.0, 0.0], [0.5, 0.5, 0.5], [0.5, 0.0, 0.0],
              [0.0, 0.5, 0.5]):
        _, lin = _bin_coords(positions, cell_t, pbc_l, dims, o)
        occ = int(torch.bincount(lin.long(), minlength=cx * cy * cz).max())
        if best is None or occ < best[1]:
            best = (np.asarray(o), occ)
        if occ == best[1] and best[1] * len(positions) == 0:
            break
    return best


# The window-engine cost model below was fit on the TPU (per-block setup
# cost, 128-lane window rounding, <=2048-lane blocks).  It is kept verbatim
# so both packages pick the same geometry; refitting it on the H100 is
# ROADMAP.md, queue 1 item 10.
_WINDOW_BLOCK_COST = 16384
_MAX_BLOCK_LANES = 2048


def _window_lane_width(cap: int, rx: int) -> int:
    return -(-((2 * rx + 1) * cap) // 128) * 128


def _window_x_block(cx: int, lane_w: int) -> int:
    best = 1
    for bx in range(1, cx + 1):
        if cx % bx == 0 and bx * lane_w <= _MAX_BLOCK_LANES:
            best = bx
    return best


def _capacity_of(observed: int) -> int:
    """Capacity for an observed occupancy: one slot of headroom, rounded
    up to a multiple of 8, at least +2%."""
    return max(int(np.ceil((observed + 1) / 8)) * 8,
               int(np.ceil(observed * 1.02 / 8)) * 8)


def choose_grid_geometry(positions, cell, pbc, cutoff: float,
                         dims_candidates=None):
    """Score dims x origin x capacity by predicted sweep cost; pick the best.

    Same search as the JAX package: per-axis bin counts {floor, floor-1} at
    (z, y) 1-2x and x 1-4x bins per cutoff (plus ``dims_candidates``),
    pre-scored with a mean-occupancy cap, the best 8 re-scored with the
    observed occupancy of their best origin.  Returns ``(dims, radius,
    cap, origin)`` with ``origin`` None for the zero origin.
    """
    cell_np = _cell_np(cell)
    inv_t = np.linalg.inv(cell_np).T
    face = 1.0 / np.linalg.norm(inv_t, axis=1)          # xyz order
    pbc_np = np.asarray(_pbc_list(pbc))
    cpd_max = np.maximum((face / cutoff).astype(np.int64), 1)
    n_atoms = int(positions.shape[0])

    cands = []
    for bzy in (1, 2):
        for bx_f in (1, 2, 3, 4):
            for delta in (0, -1):
                bpc = np.array([bx_f, bzy, bzy])
                cpd = np.maximum(bpc * cpd_max + delta, 1)
                cands.append((int(cpd[2]), int(cpd[1]), int(cpd[0])))
    if dims_candidates:
        cands.extend(tuple(int(v) for v in d) for d in dims_candidates)
    seen, uniq = set(), []
    for d in cands:
        if d not in seen:
            seen.add(d)
            uniq.append(d)

    def geom_score(dims, cap):
        cpd_xyz = np.array([dims[2], dims[1], dims[0]], dtype=np.int64)
        radius = np.ceil(cutoff * cpd_xyz / face).astype(np.int64)
        if (radius[pbc_np] > cpd_xyz[pbc_np]).any():
            return None, None
        rz, ry, rx = int(radius[2]), int(radius[1]), int(radius[0])
        n_half = ((2 * rz + 1) * (2 * ry + 1) - 1) // 2
        ncells = dims[0] * dims[1] * dims[2]
        lane_w = _window_lane_width(cap, rx)
        bx = _window_x_block(dims[2], lane_w)
        capable = bx * lane_w <= _MAX_BLOCK_LANES
        if capable:
            n_blocks = dims[0] * dims[1] * (dims[2] // bx)
            score = (ncells * (n_half + 1) * cap * lane_w
                     + _WINDOW_BLOCK_COST * n_blocks)
        else:
            score = ncells * cap * cap * ((rx + 1) + n_half * (2 * rx + 1))
        return (not capable, score), (rz, ry, rx)

    pre = []
    for dims in uniq:
        ncells = dims[0] * dims[1] * dims[2]
        mean_occ = n_atoms / max(ncells, 1)
        cap_est = max(mean_occ / 0.7, mean_occ + 5.0 * np.sqrt(mean_occ + 1.0))
        cap_est = int(np.ceil(max(cap_est, 8.0) / 8)) * 8
        key, _ = geom_score(dims, cap_est)
        if key is not None:
            pre.append((key, dims))
    pre.sort(key=lambda kv: kv[0])

    best = None
    for _, dims in pre[:8]:
        origin_np, occ = choose_grid_origin(positions, cell, pbc, dims)
        cap = _capacity_of(occ)
        key, radius = geom_score(dims, cap)
        if key is None:
            continue
        if best is None or key < best[0]:
            origin = origin_np if np.any(origin_np != 0.0) else None
            best = (key, dims, radius, cap, origin)
    if best is None:
        raise ValueError(
            "no valid grid geometry for this cell/cutoff (radius > cells "
            "per dimension on a periodic axis); use the naive path"
        )
    return best[1], best[2], best[3], best[4]


def build_atom_grid_auto(positions, cell, pbc, cutoff: float,
                         target_occupancy: float = 0.66,
                         bins_per_cutoff: int = 1,
                         optimize_origin: bool = True,
                         optimize_geometry: bool = True) -> AtomGrid:
    """Pick the geometry, origin and a tight capacity, then build.

    ``optimize_geometry`` searches bin counts with
    :func:`choose_grid_geometry` (its cost constants are the JAX package's,
    fit on the TPU); ``optimize_geometry=False`` keeps the single
    :func:`estimate_grid_geometry` partition (where ``target_occupancy``
    and ``bins_per_cutoff`` apply), with the origin of
    :func:`choose_grid_origin` when ``optimize_origin``.  The capacity
    comes from the observed occupancy; the build's own occupancy is read
    back and a short capacity rebuilt, so no atom is ever dropped.  Host
    work and a few scalar reads, as in the JAX package.
    """
    n = positions.shape[0]
    if optimize_geometry:
        dims, radius, cap, origin = choose_grid_geometry(positions, cell,
                                                         pbc, cutoff)
    else:
        dims, radius, cap = estimate_grid_geometry(
            cell, pbc, cutoff, n, target_occupancy=target_occupancy,
            bins_per_cutoff=bins_per_cutoff)
        origin = None
        if optimize_origin:
            origin_np, observed = choose_grid_origin(positions, cell, pbc,
                                                     dims)
            if np.any(origin_np != 0.0):
                origin = origin_np
        else:
            g = build_atom_grid(positions, cell, pbc, dims, radius, cap)
            observed = int(g.counts_max)
        cap = _capacity_of(observed)
    g = build_atom_grid(positions, cell, pbc, dims, radius, cap,
                        origin=origin)
    # estimate, then check: rebuild with the true capacity rather than
    # drop the atoms of a cell the estimate undercounted
    true_occ = int(g.counts_max)
    if true_occ > cap:
        cap = int(np.ceil((true_occ + 1) / 8)) * 8
        g = build_atom_grid(positions, cell, pbc, dims, radius, cap,
                            origin=origin)
    return g

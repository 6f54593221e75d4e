# SPDX-License-Identifier: Apache-2.0
"""Tile-windowed B-spline spread/gather (counterpart of
``nvalchemiops_tpu.spline_windowed``).

1. **Tile binning**: atoms are bucketed by the mesh tile (``T^3`` points,
   T = 8) holding their stencil base index, into fixed-capacity slots
   ``[ntiles, cap]``.
2. **Local axis matrices**: each atom's order-point stencil per axis lands
   in a window of ``W = T + 4`` points anchored at ``tile*T - 1``, so the
   weights (and derivatives) are banded ``[cap, W]`` rows, packed side by
   side in ``smat [ntiles, cap, k*W]``.
3. **Per-tile contraction** (kernels/windowed_gather.py): the spread
   window ``[W, W*W]`` per tile, and the gather of value and fractional
   gradient per slot.
4. **Parity fold**: windows (stride T, width W <= 2T) overlap their
   neighbours; even and odd tiles fold onto the mesh with pure
   reshape/adds, ordered z -> y -> x.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from nvalchemiops_torch.kernels.windowed_gather import (
    gather_grad_planes,
    spread_windows,
)
from nvalchemiops_torch.mathops.math import apply_mat3
from nvalchemiops_torch.spline import bspline_derivative, bspline_weight
from nvalchemiops_torch.types import INDEX_DTYPE

__all__ = [
    "windowed_applicable",
    "mesh_tile_capacity",
    "observed_tile_capacity",
    "MeshTiles",
    "build_mesh_tiles",
    "windowed_spread",
    "windowed_gather",
]

_HALO_LEFT = 1   # stencil offsets reach base - 1 for orders 3-4
_HALO_RIGHT = 3  # and base + 2; window width = T + 4


def windowed_applicable(mesh_dims, spline_order: int, tile: int = 8) -> bool:
    """True when the windowed path supports this configuration."""
    return (
        1 <= spline_order <= 4
        and all(int(d) % tile == 0 for d in mesh_dims)
        and all(int(d) >= tile for d in mesh_dims)
    )


def mesh_tile_capacity(num_atoms: int, mesh_dims, tile: int = 8) -> int:
    """Static per-tile slot capacity (Poisson-safe, multiple of 8)."""
    ntiles = int(np.prod([int(d) // tile for d in mesh_dims]))
    occ = num_atoms / max(ntiles, 1)
    cap = occ + 6.0 * np.sqrt(occ + 4.0)
    return max(int(np.ceil(cap / 8.0)) * 8, 16)


def _mesh_coords(positions, inv, mesh_dims):
    """Wrapped mesh coordinates ``mc [N, 3]`` in ``[0, dims)``."""
    dims_f = torch.tensor([int(d) for d in mesh_dims], dtype=positions.dtype,
                          device=positions.device)
    mc = apply_mat3(positions, inv) * dims_f
    mc = mc - torch.floor(mc / dims_f) * dims_f     # wrap into [0, dims)
    mc = torch.where(mc >= dims_f, torch.zeros_like(mc), mc)  # rounding seam
    return mc, dims_f


def _tile_lin(base, mesh_dims, tile):
    nx, ny, nz = (int(d) for d in mesh_dims)
    t = torch.div(base, tile, rounding_mode="floor")
    nty, ntz = ny // tile, nz // tile
    return t, (t[:, 0] * nty + t[:, 1]) * ntz + t[:, 2]


def observed_tile_capacity(positions, cell, mesh_dims, tile: int = 8,
                           spline_order: int = 4) -> int:
    """Tile capacity from the observed max occupancy (one host sync):
    two slots of headroom, at least +5%, rounded up to a multiple of 8."""
    inv = torch.linalg.inv(torch.as_tensor(
        cell, dtype=positions.dtype, device=positions.device).reshape(3, 3))
    mc, _ = _mesh_coords(positions, inv, mesh_dims)
    _, lin = _tile_lin(torch.floor(mc).to(INDEX_DTYPE), mesh_dims, tile)
    ntiles = int(np.prod([int(d) // tile for d in mesh_dims]))
    observed = int(torch.bincount(lin.long(), minlength=ntiles).max())
    return max(int(np.ceil((observed + 2) / 8)) * 8,
               int(np.ceil(observed * 1.05 / 8)) * 8, 8)


@dataclass
class MeshTiles:
    """Tile-binned separable stencil.

    ``smat [ntiles, cap, k*W]`` holds the per-slot axis matrices (Sx, Sy,
    Sz[, dSx, dSy, dSz]); ``flat_slot [N]`` maps atom -> slot (overflow ->
    ``ntiles*cap``), ``aid [ntiles*cap]`` slot -> atom (empty -> N);
    ``counts_max`` is the observed max occupancy (0-d int32 tensor) and
    ``inv`` the inverse cell.
    """

    smat: torch.Tensor
    flat_slot: torch.Tensor
    aid: torch.Tensor
    counts_max: torch.Tensor
    inv: torch.Tensor
    mesh_dims: tuple
    tile: int
    cap: int
    order: int
    has_grad: bool

    def __post_init__(self):
        self.mesh_dims = tuple(int(d) for d in self.mesh_dims)

    @property
    def w_win(self) -> int:
        """Window width per axis, ``tile + 4``."""
        return self.tile + _HALO_LEFT + _HALO_RIGHT

    def axis_mat(self, idx: int):
        """Block ``idx`` of ``smat`` (0-2: Sx, Sy, Sz; 3-5: derivatives)."""
        w = self.w_win
        return self.smat[..., idx * w:(idx + 1) * w]


def _stencil_rows(positions, inv, mesh_dims, order: int, tile: int,
                  need_grad: bool):
    """Per-atom packed banded axis-matrix rows ``[N, k*W]`` + tile ids.

    Each axis block holds the ``order`` weights at window-local columns
    ``local0 .. local0 + order - 1``, written by direct indexing (the JAX
    package routes them with one-hot matmuls for the TPU's matrix unit; the
    rows are identical).
    """
    dtype = positions.dtype
    n = positions.shape[0]
    w_win = tile + _HALO_LEFT + _HALO_RIGHT
    mc, dims_f = _mesh_coords(positions, inv, mesh_dims)
    base_f = torch.floor(mc)
    theta = mc - base_f
    base = base_f.to(INDEX_DTYPE)

    i = torch.arange(order, dtype=INDEX_DTYPE, device=positions.device)
    offset_start = torch.floor(theta - (order - 2) * 0.5).to(INDEX_DTYPE)
    u = (order * 0.5 + theta[..., None]
         - (i[None, None, :] + offset_start[..., None]).to(dtype))
    w = bspline_weight(u, order)                              # [N, 3, order]
    tile_idx, lin = _tile_lin(base, mesh_dims, tile)
    # window-local index of stencil point 0 (window origin tile*T - 1)
    local0 = base + offset_start - (tile_idx * tile - _HALO_LEFT)  # [N, 3]

    k_blocks = 6 if need_grad else 3
    rows = torch.zeros((n, k_blocks * w_win), dtype=dtype,
                       device=positions.device)
    atom = torch.arange(n, device=positions.device)[:, None]
    cols = local0.long()[:, :, None] + i.long()[None, None, :]   # [N, 3, order]
    blocks = [(w, 0)]
    if need_grad:
        blocks.append((bspline_derivative(u, order) * dims_f[None, :, None], 3))
    for vals, first in blocks:
        for d in range(3):
            rows[atom, (first + d) * w_win + cols[:, d]] = vals[:, d]
    return rows, lin


def _slot_maps(lin, ntiles: int, cap: int):
    """``(flat_slot [N], aid [ntiles*cap], counts_max)`` from one stable
    bucket sort: atom -> slot (overflow -> ``ntiles*cap``) and slot -> atom
    (empty -> N)."""
    n = lin.shape[0]
    device = lin.device
    iota = torch.arange(n, dtype=torch.int64, device=device)
    sorted_lin, order = torch.sort(lin.to(INDEX_DTYPE), stable=True)
    boundary = torch.ones(n, dtype=torch.bool, device=device)
    if n > 1:
        boundary[1:] = sorted_lin[1:] != sorted_lin[:-1]
    run_start = torch.cummax(torch.where(boundary, iota, 0), dim=0).values
    rank_sorted = (iota - run_start).to(INDEX_DTYPE)
    if n:
        counts_max = (rank_sorted.max() + 1).to(INDEX_DTYPE)
    else:
        counts_max = torch.zeros((), dtype=INDEX_DTYPE, device=device)
    flat_slot = torch.zeros(n, dtype=INDEX_DTYPE, device=device)
    flat_slot[order] = torch.where(rank_sorted >= cap,
                                   torch.full_like(rank_sorted, ntiles * cap),
                                   sorted_lin * cap + rank_sorted)
    counts = torch.bincount(lin.long(), minlength=ntiles)
    starts = torch.cumsum(counts, 0) - counts
    src = starts[:, None] + torch.arange(cap, device=device)[None, :]
    src = torch.where(src < (starts + counts)[:, None], src, n)
    order_padded = torch.cat([order.to(INDEX_DTYPE),
                              torch.full((1,), n, dtype=INDEX_DTYPE,
                                         device=device)])
    return flat_slot, order_padded[src.reshape(-1)], counts_max


def build_mesh_tiles(positions, cell, mesh_dims, order: int, cap: int,
                     tile: int = 8, need_grad: bool = True) -> MeshTiles:
    """Bin atoms by stencil-base mesh tile and build the local axis
    matrices.  ``counts_max`` reports the observed maximum occupancy, for
    the caller's overflow check."""
    dtype = positions.dtype
    nx, ny, nz = (int(d) for d in mesh_dims)
    inv = torch.linalg.inv(torch.as_tensor(
        cell, dtype=dtype, device=positions.device).reshape(3, 3))
    rows, lin = _stencil_rows(positions, inv, (nx, ny, nz), order, tile,
                              need_grad)
    ntiles = (nx // tile) * (ny // tile) * (nz // tile)
    flat_slot, aid, counts_max = _slot_maps(lin, ntiles, cap)
    # slot -> atom row gather (empty slots read the zero row)
    rows_padded = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])
    smat = rows_padded[aid.long()].reshape(ntiles, cap, rows.shape[1])
    return MeshTiles(smat, flat_slot, aid, counts_max, inv, (nx, ny, nz),
                     tile, cap, order, need_grad)


def _fold_axis(arr, nt_axis: int, n: int, tile: int):
    """Fold overlapping (tile, window) pairs along one axis.

    ``arr``: [..., nt, W, ...trailing] with the tile axis at ``nt_axis`` and
    its window axis right after.  Windows start at ``t*tile - 1`` with width
    W <= 2*tile, so even and odd tiles write disjoint stride-2*tile blocks.
    Returns the folded, periodically wrapped axis of length ``n``.
    """
    arr = torch.movedim(torch.movedim(arr, nt_axis, 0), nt_axis + 1, 1)
    nt, w_win = arr.shape[0], arr.shape[1]
    rest = tuple(arr.shape[2:])
    nt_even = nt + (nt % 2)
    if nt_even != nt:
        arr = torch.cat([arr, arr.new_zeros((1,) + tuple(arr.shape[1:]))])
    ext_len = n + (nt_even - nt) * tile + tile + _HALO_RIGHT + _HALO_LEFT
    ext = arr.new_zeros((ext_len,) + rest)
    for a in (0, 1):
        sub = arr[a::2]                                    # [nt_even/2, W, ...]
        sub = torch.cat([sub, sub.new_zeros(
            (sub.shape[0], 2 * tile - w_win) + rest)], dim=1)
        span = sub.shape[0] * 2 * tile
        ext[tile * a: tile * a + span] += sub.reshape((span,) + rest)
    # ext index e holds global g = e - 1; wrap the halo back onto [0, n)
    core = ext[_HALO_LEFT:_HALO_LEFT + n].clone()
    right = ext[_HALO_LEFT + n:]
    while right.shape[0] > 0:  # the halo can exceed n when nt is tiny
        t = min(right.shape[0], n)
        core[:t] += right[:t]
        right = right[t:]
    core[n - _HALO_LEFT:] += ext[:_HALO_LEFT]
    return torch.movedim(core, 0, nt_axis)


def windowed_spread(tiles: MeshTiles, values):
    """``mesh[x, y, z] = sum_n values[n] Sx Sy Sz`` via per-tile windows
    (CUDA kernel on a CUDA device) and the parity fold."""
    nx, ny, nz = tiles.mesh_dims
    tile, cap, w_win = tiles.tile, tiles.cap, tiles.w_win
    ntx, nty, ntz = nx // tile, ny // tile, nz // tile
    padded = torch.cat([values, values.new_zeros((1,))])
    q_t = padded[tiles.aid.long()].reshape(ntx * nty * ntz, cap)
    windows = spread_windows(tiles.smat, q_t, w_win)
    a = windows.reshape(ntx, nty, ntz, w_win, w_win * w_win)
    a = _fold_axis(a, 2, nz, tile)                       # [tx, ty, nz, W*W]
    a = torch.transpose(a, 2, 3)                         # [tx, ty, W*W, nz]
    a = a.reshape(ntx, nty, w_win, w_win, nz)            # [tx, ty, wy, wx, nz]
    a = _fold_axis(a, 1, ny, tile)                       # [tx, ny, wx, nz]
    a = torch.transpose(a, 1, 2)                         # [tx, wx, ny, nz]
    return _fold_axis(a, 0, nx, tile)                    # [nx, ny, nz]


def _extract_windows(mesh, tile: int):
    """Overlapping per-tile windows ``[ntiles, W, W*W]`` (z, then (y, x))."""
    nx, ny, nz = mesh.shape
    w_win = tile + _HALO_LEFT + _HALO_RIGHT
    ntx, nty, ntz = nx // tile, ny // tile, nz // tile

    def win_idx(nt, n):
        idx = (np.arange(nt)[:, None] * tile - _HALO_LEFT
               + np.arange(w_win)[None, :]) % n
        return torch.as_tensor(idx.reshape(-1), device=mesh.device)

    a = torch.index_select(mesh, 0, win_idx(ntx, nx))    # [(tx,wx), ny, nz]
    a = a.reshape(ntx, w_win, ny, nz)
    a = torch.transpose(a, 1, 2)                         # [tx, ny, wx, nz]
    a = torch.index_select(a, 1, win_idx(nty, ny))       # [tx, (ty,wy), wx, nz]
    a = a.reshape(ntx, nty, w_win * w_win, nz)           # [tx, ty, (wy,wx), nz]
    a = torch.transpose(a, 2, 3)                         # [tx, ty, nz, W*W]
    a = torch.index_select(a, 2, win_idx(ntz, nz))       # [tx, ty, (tz,wz), W*W]
    return a.reshape(ntx * nty * ntz, w_win, w_win * w_win)


def windowed_gather(tiles: MeshTiles, mesh, with_gradient: bool = False):
    """Per-atom interpolation ``values [N]``, or ``(values, grad_frac
    [N, 3])`` with the gradient along fractional axes scaled by the mesh
    dims (rotate with ``tiles.inv`` for Cartesian).

    With the gradient the per-tile contraction is the CUDA kernel on a
    CUDA device; the value-only gather is plain torch, as it was plain XLA
    in the JAX package.
    """
    win = _extract_windows(mesh, tiles.tile).contiguous()
    w = tiles.w_win

    def per_atom(planes):
        stacked = torch.stack(planes, dim=-1).reshape(-1, len(planes))
        return stacked[torch.clamp(tiles.flat_slot.long(),
                                   max=stacked.shape[0] - 1)]

    if with_gradient:
        if not tiles.has_grad:
            raise ValueError("tiles built with need_grad=False")
        rows = per_atom(list(gather_grad_planes(tiles.smat, win, w)))
        return rows[:, 0], rows[:, 1:]
    tyx = (tiles.axis_mat(1)[..., :, None]
           * tiles.axis_mat(0)[..., None, :]).flatten(-2)
    q = torch.einsum("tcm,tzm->tcz", tyx, win)
    return per_atom([(tiles.axis_mat(2) * q).sum(-1)])[:, 0]

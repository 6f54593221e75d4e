# SPDX-License-Identifier: Apache-2.0
"""Commensurate voxel-stencil pair sweep (counterpart of
``nvalchemiops_tpu.stencil``).

For systems that admit an occupancy-1 fine binning (one atom per voxel at
most: any near-crystalline solid, checked at build time) the capacity axis
of the halo grid (grid.py) goes away:

- every field lives on one flat plane ``[Ez, Ey*Ex + 2*pad]``: the (y, x)
  axes flattened with the halo inline and padded by ``pad = Ry*Ex + Rx``
  columns, so a cell offset (dy, dx) is a single column shift;
- empty voxels are parked far away at build time (grid.DISPLACE), so the
  ``d^2 < cutoff^2`` test alone excludes them; the own side's halo columns
  are parked at ``-DISPLACE`` so ghost copies never act as own atoms.

Engines of the three sweeps (:func:`stencil_coulomb_energy_forces`,
:func:`stencil_coordination_numbers`, :func:`stencil_cn_chain_forces`):

- ``"pallas"`` (the default on a CUDA tensor), ``"stack"`` and ``"fuse"``
  (the JAX package's XLA formulations of the same full-space function):
  the full-space own-side sweep of kernel 9 (kernels/stencil_sweep.py),
  each own voxel against all ``(2R+1)^3 - 1`` offsets, no scatter; on a
  CPU tensor the kernel's wrapper runs its plain version;
- ``"xla"`` (the default on the CPU, as the JAX package picks it off the
  TPU): the half-space sweep :func:`stencil_reduce_sym`, each pair once,
  with the j side folded back through the halo.  CPU tensors only: on a
  CUDA tensor it raises ``NotImplementedError`` (ROADMAP.md).

Geometry search and build keep the JAX package's rules, so both packages
bin the same atoms into the same voxels.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from nvalchemiops_torch.grid import (
    DISPLACE, DISPLACE_SPACING, _cell_np, _extend, _pbc_list,
)
from nvalchemiops_torch.kernels.stencil_sweep import stencil_sweep
from nvalchemiops_torch.kernels.window_sweep import (
    BODY_FNS, SweepParams, halfspace_zy,
)
from nvalchemiops_torch.mathops.math import apply_mat3, divmod_floor
from nvalchemiops_torch.types import INDEX_DTYPE

__all__ = [
    "StencilGrid", "extend_stencil", "scatter_to_stencil",
    "gather_from_stencil", "gather_rows_from_stencil", "build_stencil_grid",
    "choose_stencil_geometry", "build_stencil_auto", "stencil_reduce_sym",
    "fold_stencil", "own_interior", "own_flat_from_interior",
    "stencil_coulomb_energy_forces", "stencil_coordination_numbers",
    "stencil_cn_chain_forces",
]


@dataclass
class StencilGrid:
    """Flat halo-inline voxel planes (position fields ``[Ez, Ey*Ex +
    2*pad]``); ``flat_idx [N]`` is each atom's interior voxel (z-major),
    ``counts_max`` the largest voxel occupancy (must be 1); ``dims`` and
    ``radius`` are (z, y, x) ordered, ``pbc`` (x, y, z)."""

    ext_px: torch.Tensor
    ext_py: torch.Tensor
    ext_pz: torch.Tensor
    flat_idx: torch.Tensor
    counts_max: torch.Tensor
    dims: tuple
    radius: tuple
    pbc: tuple

    def __post_init__(self):
        self.dims = tuple(int(d) for d in self.dims)
        self.radius = tuple(int(r) for r in self.radius)
        self.pbc = tuple(bool(b) for b in self.pbc)

    @property
    def ext_dims(self):
        cz, cy, cx = self.dims
        rz, ry, rx = self.radius
        return cz + 2 * rz, cy + 2 * ry, cx + 2 * rx

    @property
    def col_pad(self):
        _, ry, rx = self.radius
        return ry * self.ext_dims[2] + rx

    @property
    def flat_width(self):
        _, ey, ex = self.ext_dims
        return ey * ex + 2 * self.col_pad


def _flatten_cols(ext3, col_pad, fill):
    """[Ez, Ey, Ex] -> [Ez, Ey*Ex + 2*pad] with constant column padding."""
    flat = ext3.reshape(ext3.shape[0], -1)
    return torch.nn.functional.pad(flat, (col_pad, col_pad), value=fill)


def extend_stencil(sg: StencilGrid, plane, fill):
    """Interior [Cz, Cy, Cx] plane -> sweep-ready flat [Ez, F] plane."""
    return _flatten_cols(_extend(plane, sg.radius, sg.pbc, fill),
                         sg.col_pad, fill)


def scatter_to_stencil(sg: StencilGrid, values, fill=0.0):
    """Per-atom values -> interior [Cz, Cy, Cx] plane (occupancy-1 slots)."""
    cz, cy, cx = sg.dims
    values = torch.as_tensor(values, device=sg.flat_idx.device)
    buf = torch.full((cz * cy * cx,), fill, dtype=values.dtype,
                     device=values.device)
    buf[sg.flat_idx.long()] = values
    return buf.reshape(cz, cy, cx)


def gather_from_stencil(sg: StencilGrid, plane):
    """Interior [Cz, Cy, Cx] plane -> per-atom values."""
    return plane.reshape(-1)[sg.flat_idx.long()]


def gather_rows_from_stencil(sg: StencilGrid, planes):
    """One [voxels, k] row gather for k interior planes."""
    stacked = torch.stack([p.reshape(-1) for p in planes], dim=-1)
    rows = stacked[sg.flat_idx.long()]
    return tuple(rows[..., i] for i in range(len(planes)))


def _voxel_coords(positions, cell, pbc_t, dims, origin):
    """Per-atom (x, y, z) wrap counts and linear voxel index, by the
    build's rule (wrap on periodic axes, clamp elsewhere)."""
    dtype = positions.dtype
    cz, cy, cx = dims
    cpd_xyz = torch.tensor([cx, cy, cz], dtype=INDEX_DTYPE,
                           device=positions.device)
    pbc_arr = torch.tensor(pbc_t, device=positions.device)
    frac = apply_mat3(positions, torch.linalg.inv(cell))
    bin_pos = frac * cpd_xyz.to(dtype)
    if origin is not None:
        bin_pos = bin_pos - torch.as_tensor(
            origin, dtype=dtype, device=positions.device).reshape(1, 3)
    coords = torch.floor(bin_pos).to(INDEX_DTYPE)
    wrap, wrapped = divmod_floor(coords, cpd_xyz)
    clamped = torch.minimum(torch.clamp(coords, min=0), cpd_xyz - 1)
    ccoords = torch.where(pbc_arr, wrapped, clamped)
    aps = torch.where(pbc_arr, wrap, torch.zeros_like(wrap))
    lin = ccoords[:, 0] + cx * (ccoords[:, 1] + cy * ccoords[:, 2])
    return aps, lin


def build_stencil_grid(positions, cell, pbc, dims, radius,
                       origin=None) -> StencilGrid:
    """Bin atoms into occupancy-1 voxels and build the flat halo planes.

    The occupancy-1 precondition is not enforced here; check
    ``counts_max`` (or use :func:`build_stencil_auto`, which does).  A
    voxel holding two atoms keeps one of them, so results are then wrong,
    as with a row-grid capacity overflow.
    """
    dtype, device = positions.dtype, positions.device
    cell = torch.as_tensor(cell, dtype=dtype, device=device).reshape(3, 3)
    pbc_t = tuple(_pbc_list(pbc))
    cz, cy, cx = (int(d) for d in dims)
    rz, ry, rx = (int(r) for r in radius)
    ncells = cx * cy * cz
    aps, lin = _voxel_coords(positions, cell, pbc_t, (cz, cy, cx), origin)
    shift_cart = apply_mat3(aps.to(dtype), cell)
    wp = positions - shift_cart
    counts = torch.bincount(lin.long(), minlength=ncells)
    lin_l = lin.long()

    def scat(vals, fill):
        buf = torch.full((ncells,), fill, dtype=vals.dtype, device=device)
        buf[lin_l] = vals
        return buf.reshape(cz, cy, cx)

    g_px, g_py, g_pz = (scat(wp[:, k], 0.0) for k in range(3))
    occupied = scat(torch.ones(lin.shape[0], dtype=torch.bool,
                               device=device), False)
    # park empty voxels at unique far-away x (displacement validity)
    vox_iota = torch.arange(ncells, dtype=dtype, device=device).reshape(
        cz, cy, cx)
    g_px = g_px + torch.where(occupied, torch.zeros((), dtype=dtype,
                                                    device=device),
                              DISPLACE + vox_iota * DISPLACE_SPACING)
    radius_t = (rz, ry, rx)
    ext_px3 = _extend(g_px, radius_t, pbc_t, DISPLACE)
    ext_py3 = _extend(g_py, radius_t, pbc_t, 0.0)
    ext_pz3 = _extend(g_pz, radius_t, pbc_t, 0.0)

    # ghost images carry their box shift pre-applied (as the grid build)
    ez, ey, ex = cz + 2 * rz, cy + 2 * ry, cx + 2 * rx

    def shift(e, r, c):
        return divmod_floor(torch.arange(e, dtype=INDEX_DTYPE, device=device)
                            - r, c)[0].to(dtype)

    szf = shift(ez, rz, cz)[:, None, None]
    syf = shift(ey, ry, cy)[None, :, None]
    sxf = shift(ex, rx, cx)[None, None, :]
    shx = sxf * cell[0, 0] + syf * cell[1, 0] + szf * cell[2, 0]
    shy = sxf * cell[0, 1] + syf * cell[1, 1] + szf * cell[2, 1]
    shz = sxf * cell[0, 2] + syf * cell[1, 2] + szf * cell[2, 2]
    col_pad = ry * ex + rx
    return StencilGrid(
        ext_px=_flatten_cols(ext_px3 + shx, col_pad, DISPLACE),
        ext_py=_flatten_cols(ext_py3 + shy, col_pad, 0.0),
        ext_pz=_flatten_cols(ext_pz3 + shz, col_pad, 0.0),
        flat_idx=lin,
        counts_max=counts.max().to(INDEX_DTYPE),
        dims=(cz, cy, cx), radius=radius_t, pbc=pbc_t)


def choose_stencil_geometry(positions, cell, pbc, cutoff: float,
                            bins_per_cutoff=(3, 4, 2, 5)):
    """Search for a commensurate occupancy-1 binning.

    Tries ``k`` bins per cutoff for each candidate ``k``, with the
    half-bin origin shifts of ``grid.choose_grid_origin``; returns
    ``(dims, radius, origin, max_occupancy)`` of the cheapest valid
    geometry (half-space offsets x voxels), or ``None`` if none reaches
    occupancy 1 (the caller falls back to the row grid).
    """
    cell_np = _cell_np(cell)
    pbc_t = tuple(_pbc_list(pbc))
    pbc_np = np.asarray(pbc_t)
    face = 1.0 / np.linalg.norm(np.linalg.inv(cell_np).T, axis=1)
    dtype = positions.dtype
    cell_t = torch.as_tensor(cell, dtype=dtype,
                             device=positions.device).reshape(3, 3)

    best = None
    for k in bins_per_cutoff:
        cpd = np.maximum(np.round(face * k / float(cutoff)).astype(np.int64),
                         1)
        radius = np.ceil(cutoff * cpd / face - 1e-9).astype(np.int64)
        if (radius[pbc_np] > cpd[pbc_np]).any():
            continue
        dims = (int(cpd[2]), int(cpd[1]), int(cpd[0]))
        rad = (int(radius[2]), int(radius[1]), int(radius[0]))
        n_off = ((2 * rad[0] + 1) * (2 * rad[1] + 1) * (2 * rad[2] + 1)
                 - 1) // 2
        cost = n_off * int(np.prod(cpd))
        for o in ([0.0, 0.0, 0.0], [0.5, 0.5, 0.5], [0.5, 0.0, 0.0],
                  [0.0, 0.5, 0.5]):
            _, lin = _voxel_coords(positions, cell_t, pbc_t, dims, o)
            occ = int(torch.bincount(lin.long(),
                                     minlength=int(np.prod(cpd))).max())
            if occ <= 1 and (best is None or cost < best[4]):
                best = (dims, rad, np.asarray(o), occ, cost)
                break
    if best is None:
        return None
    return best[0], best[1], best[2], best[3]


def build_stencil_auto(positions, cell, pbc, cutoff: float):
    """Geometry search + validated build; ``None`` if no occupancy-1
    binning exists (fall back to the row grid)."""
    geo = choose_stencil_geometry(positions, cell, pbc, cutoff)
    if geo is None:
        return None
    dims, radius, origin, _ = geo
    sg = build_stencil_grid(positions, cell, pbc, dims, radius,
                            origin=None if not origin.any() else origin)
    if int(sg.counts_max) > 1:
        return None
    return sg


def fold_stencil(sg: StencilGrid, acc):
    """Fold a flat [Ez, F] accumulator's halo back onto the interior."""
    rz, ry, rx = sg.radius
    cz, cy, cx = sg.dims
    ez, ey, ex = sg.ext_dims
    pad = sg.col_pad
    a = acc[:, pad:pad + ey * ex].reshape(ez, ey, ex)
    for ax, (r, c) in enumerate(((rz, cz), (ry, cy), (rx, cx))):
        core = a.narrow(ax, r, c).clone()
        if r:
            core.narrow(ax, 0, r).add_(a.narrow(ax, r + c, r))
            core.narrow(ax, c - r, r).add_(a.narrow(ax, 0, r))
        a = core
    return a


def own_interior(sg: StencilGrid, acc):
    """Own-side [Cz, W0] accumulator -> interior [Cz, Cy, Cx]."""
    _, ry, rx = sg.radius
    cz, cy, cx = sg.dims
    _, ey, ex = sg.ext_dims
    return acc.reshape(cz, ey, ex)[:, ry:ry + cy, rx:rx + cx]


def own_flat_from_interior(sg: StencilGrid, plane, fill=0.0):
    """Interior [Cz, Cy, Cx] plane -> own-side flat [Cz, Ey*Ex] plane, the
    y/x halo band constant-filled (``fill=-DISPLACE`` parks the position
    plane, so ghost copies never pair as own atoms)."""
    _, ry, rx = sg.radius
    padded = torch.nn.functional.pad(plane, (rx, rx, ry, ry), value=fill)
    return padded.reshape(plane.shape[0], -1)


def _interior_of_ext(sg: StencilGrid, ext_plane):
    rz, ry, rx = sg.radius
    cz, cy, cx = sg.dims
    _, ey, ex = sg.ext_dims
    pad = sg.col_pad
    flat = ext_plane[rz:rz + cz, pad:pad + ey * ex]
    return flat.reshape(cz, ey, ex)[:, ry:ry + cy, rx:rx + cx]


def _planes(sg, ext_named, own_named):
    """Stacked candidate ``[n, Ez, F]`` and own ``[n, Cz, W0]`` planes:
    positions first (the own x plane parked on its halo band), then the
    named extra planes."""
    ext = torch.stack([sg.ext_px, sg.ext_py, sg.ext_pz, *ext_named])
    own = torch.stack([
        own_flat_from_interior(sg, _interior_of_ext(sg, sg.ext_px),
                               -DISPLACE),
        own_flat_from_interior(sg, _interior_of_ext(sg, sg.ext_py)),
        own_flat_from_interior(sg, _interior_of_ext(sg, sg.ext_pz)),
        *own_named])
    return ext.contiguous(), own.contiguous()


def stencil_reduce_sym(sg: StencilGrid, body, params: SweepParams,
                       extra_ext_planes=(), extra_own_planes=()):
    """Half-space voxel sweep with symmetric accumulation (plain PyTorch).

    ``body`` names a pass body of kernels/window_sweep.py (``cn``,
    ``chain``, ``coulomb``), fed flat ``[Cz, W0]`` own planes and shifted
    candidate slices (positions first, then the extra planes).  Every pair
    is visited once: the home row's dx > 0 and every half-space (dz, dy)
    over dx = -Rx..Rx.  Returns ``(own_accs, folded_j_accs)``: own-side
    ``[Cz, W0]`` planes (finish with :func:`own_interior`) and j-side
    ``[Cz, Cy, Cx]`` planes.
    """
    rz, ry, rx = sg.radius
    cz = sg.dims[0]
    _, _, ex = sg.ext_dims
    pad = sg.col_pad
    ext, own = _planes(sg, extra_ext_planes, extra_own_planes)
    w0 = own.shape[2]
    fn = BODY_FNS[body]
    own_acc = None
    ext_acc = None
    for dz, dy in [(0, 0)] + halfspace_zy(rz, ry):
        dxs = range(1, rx + 1) if (dz, dy) == (0, 0) else range(-rx, rx + 1)
        for dx in dxs:
            c0 = pad + dy * ex + dx
            cand = ext[:, rz + dz:rz + dz + cz, c0:c0 + w0]
            own_t, j_t = fn(own, cand, params, None, None, None)
            if own_acc is None:
                own_acc = [torch.zeros_like(t) for t in own_t]
                ext_acc = torch.zeros((len(j_t),) + tuple(ext.shape[1:]),
                                      dtype=own.dtype, device=own.device)
            own_acc = [a + t for a, t in zip(own_acc, own_t)]
            ext_acc[:, rz + dz:rz + dz + cz, c0:c0 + w0] += torch.stack(j_t)
    return tuple(own_acc), tuple(fold_stencil(sg, a) for a in ext_acc)


def _resolve_engine(engine, device):
    if engine is None:
        return "pallas" if device.type == "cuda" else "xla"
    if engine not in ("pallas", "xla", "stack", "fuse"):
        raise ValueError(f"unknown stencil engine {engine!r}")
    return engine


def _sweep(sg, body, params, engine, ext_named, own_named):
    """Own-side planes of one body on the engine's sweep, interior
    [Cz, Cy, Cx] each."""
    device = sg.ext_px.device
    if _resolve_engine(engine, device) == "xla":
        if device.type != "cpu":
            raise NotImplementedError(
                "stencil engine 'xla' runs on the CPU only; on the card the "
                "half-space sweep is not ported (ROADMAP.md, 'Engines off "
                "the default path')")
        own_acc, folded = stencil_reduce_sym(sg, body, params, ext_named,
                                             own_named)
        return tuple(own_interior(sg, a) + f for a, f in zip(own_acc, folded))
    ext, own = _planes(sg, ext_named, own_named)
    out = stencil_sweep(body, sg.dims, sg.radius, ext, own, params)
    return tuple(own_interior(sg, a) for a in out)


def stencil_coulomb_energy_forces(sg: StencilGrid, charges, cutoff,
                                  alpha=0.0, engine: str | None = None):
    """(Damped-)Coulomb per-atom energies and forces on the voxel stencil:
    the same pair math as ``grid.grid_coulomb_energy_forces``, another
    traversal.  Returns ``(energies [N], forces [N, 3])``."""
    dtype = sg.ext_px.dtype
    q_int = scatter_to_stencil(sg, torch.as_tensor(charges).to(
        device=sg.ext_px.device, dtype=dtype))
    q_ext = extend_stencil(sg, q_int, 0.0)
    e, fx, fy, fz = _sweep(
        sg, "coulomb", SweepParams(cutoff=float(cutoff), alpha=float(alpha)),
        engine, (q_ext,), (own_flat_from_interior(sg, q_int),))
    energies, f1, f2, f3 = gather_rows_from_stencil(sg, (e, fx, fy, fz))
    return energies, torch.stack([f1, f2, f3], dim=-1)


def _rcov_planes(sg, rcov_per_atom, rcov_planes):
    if rcov_planes is not None:
        return rcov_planes
    rcov_int = scatter_to_stencil(sg, torch.as_tensor(rcov_per_atom).to(
        device=sg.ext_px.device, dtype=sg.ext_px.dtype))
    return rcov_int, extend_stencil(sg, rcov_int, 0.0)


def stencil_coordination_numbers(sg: StencilGrid, rcov_per_atom, cutoff,
                                 k1=16.0, engine: str | None = None,
                                 rcov_planes=None):
    """DFT-D3 coordination numbers on the voxel stencil (pass 1's math).

    ``rcov_planes`` optionally supplies prebuilt ``(interior, extended)``
    rcov planes, so a caller running several stencil passes (the hybrid D3
    engine) scatters them once.
    """
    rcov_int, rcov_ext = _rcov_planes(sg, rcov_per_atom, rcov_planes)
    (cn,) = _sweep(sg, "cn", SweepParams(cutoff=float(cutoff), k1=float(k1)),
                   engine, (rcov_ext,), (own_flat_from_interior(sg,
                                                                rcov_int),))
    return gather_from_stencil(sg, cn)


def stencil_cn_chain_forces(sg: StencilGrid, rcov_per_atom, decn_per_atom,
                            cutoff, k1=16.0, engine: str | None = None,
                            rcov_planes=None):
    """D3 CN chain-rule forces on the voxel stencil: ``F_i += sum_j (dE/dCN_i
    + dE/dCN_j) dCN_ij/dr_ij r_hat`` (pass 3's math).  Returns forces
    [N, 3]."""
    rcov_int, rcov_ext = _rcov_planes(sg, rcov_per_atom, rcov_planes)
    decn_int = scatter_to_stencil(sg, torch.as_tensor(decn_per_atom).to(
        device=sg.ext_px.device, dtype=sg.ext_px.dtype))
    decn_ext = extend_stencil(sg, decn_int, 0.0)
    planes = _sweep(
        sg, "chain", SweepParams(cutoff=float(cutoff), k1=float(k1)), engine,
        (rcov_ext, decn_ext), (own_flat_from_interior(sg, rcov_int),
                               own_flat_from_interior(sg, decn_int)))
    return torch.stack(gather_rows_from_stencil(sg, planes), dim=-1)

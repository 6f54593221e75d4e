# SPDX-License-Identifier: Apache-2.0
"""Spatial domain decomposition of the halo-grid sweeps over ranks
(counterpart of ``nvalchemiops_tpu.parallel.domain``).

The grid's z axis is split into slabs, one per rank of the mesh's ``"z"``
axis.  Every rank is handed the same replicated grid (built once, as the
JAX package builds it) and sweeps its own slab on kernel 1
(kernels/window_sweep.py) with the pass bodies the single-process
``grid_dftd3`` / ``grid_coulomb_energy_forces`` give it:

1. the slab's interior rows ``[r*lz, (r+1)*lz)`` of every plane a pass
   reads are stacked feature-major, and ``rz`` rows go up and ``rz`` down
   the z ring (``_dist.halo_exchange``); the edges that wrapped carry the
   lattice shift on the position features, or hold parked values on an
   open z axis;
2. the y/x halos are local wrap pads with their lattice shifts;
3. the slab ``[F, lz, cy, cx, cap]`` with its halos
   ``[F, lz + 2rz, cy + 2ry, cx + 2rx, cap]`` is a valid input of kernel 1
   unchanged; its j-side output is folded in y/x locally, then in z over
   the ring (``_dist.fold_z_ring``);
4. every rank all-gathers the slab outputs and returns the whole result.

The D3 features between passes are built replicated from the gathered CN
plane, as the JAX package builds them.  ``domain_pme_reciprocal`` splits
the mesh tiles instead: each rank spreads and gathers a contiguous run of
tiles on kernels 3 and 2, and the partial meshes and per-atom rows are
summed over the ranks.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with a ``"z"``
axis (:func:`make_z_mesh`); the caller initialises the process group (NCCL
with one rank per card, or gloo).  Tensors stay on the device they are
given; with gloo and CUDA tensors the exchanged rows are staged through
host memory (``_dist.transport``).  ``pbc`` is (x, y, z), as the JAX code
converts it.  The slabs need ``cz % D == 0`` and ``cz // D >= rz``.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from nvalchemiops_torch import spline_windowed as sw
from nvalchemiops_torch.grid import (
    DISPLACE,
    DISPLACE_SPACING,
    AtomGrid,
    _interior,
    _pbc_list,
    gather_from_grid,
    gather_rows_from_grid,
    scatter_to_grid,
)
from nvalchemiops_torch.interactions.dispersion.grid_d3 import (
    _d3_inputs,
    _d3_plane_features,
)
from nvalchemiops_torch.interactions.electrostatics.pme import (
    _finish,
    _potential,
)
from nvalchemiops_torch.kernels.window_sweep import SweepParams, window_sweep
from nvalchemiops_torch.kernels.windowed_gather import (
    gather_grad_planes,
    spread_windows,
)
from nvalchemiops_torch.parallel._dist import (
    all_gather_cat,
    all_reduce_sum,
    axis_group,
    fold_yx,
    fold_z_ring,
    halo_exchange,
    slab_rows,
    wrap_pad_yx,
)

__all__ = [
    "make_z_mesh",
    "domain_coulomb_energy_forces",
    "domain_dftd3_cn",
    "domain_dftd3",
    "domain_dftd3_coulomb",
    "domain_pme_reciprocal",
]

_SQRT3 = 1.7320508075688772


def _mesh_device_type() -> str:
    """The ``DeviceMesh`` device type of the default process group:
    ``"cuda"`` under NCCL, else ``"cpu"`` (gloo, whose tensors may still
    lie on a card)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_z_mesh(devices=None) -> DeviceMesh:
    """1-D ``("z",)`` mesh over ``devices`` (global ranks, in slab order;
    default: every rank of the initialised process group).  Every rank of
    the group calls it."""
    ranks = list(range(dist.get_world_size()) if devices is None
                 else devices)
    return DeviceMesh(_mesh_device_type(), torch.tensor(ranks),
                      mesh_dim_names=("z",))


class _Ring:
    """A slab decomposition of ``grid`` over the mesh's ``"z"`` axis: the
    group, this rank's interior rows, the cell and the periodicity."""

    def __init__(self, mesh, grid: AtomGrid, cell, pbc):
        self.group, self.size, self.rank = axis_group(mesh, "z")
        cz, rz = grid.dims[0], grid.radius[0]
        if cz % self.size or cz // self.size < rz:
            raise ValueError(f"cz={cz} must split into >={rz}-thick slabs "
                             f"across {self.size} devices")
        self.grid = grid
        self.rows = slab_rows(self.rank, self.size, cz)
        self.cell = torch.as_tensor(cell, dtype=grid.ext_px.dtype,
                                    device=grid.ext_px.device).reshape(3, 3)
        pbc_x, pbc_y, pbc_z = _pbc_list(pbc)
        self.pbc_zyx = (pbc_z, pbc_y, pbc_x)

    def slab(self, planes):
        """The slab's rows of a feature-major stack ``[F, cz, ..]``."""
        return planes[:, self.rows]

    def sweep(self, body, own, cand, params, lf=None):
        """One pass body of kernel 1 on the slab: ``own [n_own, lz, ..]``,
        ``cand [n_cand, lz, ..]`` (px, py, pz first) -> ``(own_out, j)``,
        both ``[.., lz, cy, cx, cap]``, ``j`` folded over the halos."""
        g = self.grid
        cy, cx = g.dims[1], g.dims[2]
        rz, ry, rx = g.radius
        pbc_z, pbc_y, pbc_x = self.pbc_zyx
        f = cand.shape[0]
        zero = torch.zeros(f - 3, dtype=cand.dtype, device=cand.device)
        z_shift, y_shift, x_shift = (torch.cat([self.cell[k], zero])
                                     for k in (2, 1, 0))
        park = torch.cat([torch.full((3,), DISPLACE, dtype=cand.dtype,
                                     device=cand.device), zero])
        ext = halo_exchange(cand.contiguous(), rz, self.group, z_shift,
                            pbc_z, park)
        ext = wrap_pad_yx(ext, ry, rx, pbc_y, pbc_x, park, y_shift, x_shift)
        own_out, j_out = window_sweep(body, g.radius, own.contiguous(),
                                      ext.contiguous(), params, lf=lf)
        return own_out, fold_z_ring(fold_yx(j_out, ry, rx, cy, cx), rz,
                                    self.group)

    def gather(self, slab_planes):
        """Every rank's slab planes ``[k, lz, ..]`` -> the full interior
        planes ``[k, cz, ..]``."""
        return all_gather_cat(slab_planes.contiguous(), self.group, dim=1)


def _positions(grid: AtomGrid):
    return [_interior(grid, p) for p in (grid.ext_px, grid.ext_py,
                                         grid.ext_pz)]


def domain_dftd3_cn(mesh, grid: AtomGrid, rcov_per_atom, cell, cutoff,
                    k1=16.0, pbc=(True, True, True)):
    """DFT-D3 coordination numbers with the grid's z axis split over the
    mesh (kernel 1's ``cn`` body on each slab)."""
    ring = _Ring(mesh, grid, cell, pbc)
    rcov = torch.as_tensor(rcov_per_atom, dtype=grid.ext_px.dtype,
                           device=grid.ext_px.device)
    cand = ring.slab(torch.stack(_positions(grid)
                                 + [scatter_to_grid(grid, rcov)]))
    own_out, j = ring.sweep("cn", cand, cand, SweepParams(
        cutoff=float(cutoff), k1=float(k1)))
    cn = ring.gather(own_out + j)[0]
    return gather_from_grid(grid, cn)


def domain_coulomb_energy_forces(mesh, grid: AtomGrid, charges, cell, cutoff,
                                 alpha=0.0, pbc=(True, True, True)):
    """(Damped) Coulomb per-atom energies and forces with the grid's z axis
    split over the mesh: the contract of ``grid.grid_coulomb_energy_forces``
    (kernel 1's ``coulomb`` body on each slab).  ``pbc`` is (x, y, z)."""
    ring = _Ring(mesh, grid, cell, pbc)
    q = torch.as_tensor(charges, dtype=grid.ext_px.dtype,
                        device=grid.ext_px.device)
    cand = ring.slab(torch.stack(_positions(grid)
                                 + [scatter_to_grid(grid, q)]))
    own_out, j = ring.sweep("coulomb", cand, cand, SweepParams(
        cutoff=float(cutoff), alpha=float(alpha)))
    energies, f1, f2, f3 = gather_rows_from_grid(
        grid, tuple(ring.gather(own_out + j)))
    return energies, torch.stack([f1, f2, f3], dim=-1)


def _domain_d3(ring: _Ring, numbers, rcov, r4r2, c6ab, cn_ref_elem,
               params: SweepParams, charges=None):
    """D3 passes 1-3 on the slabs; returns the full interior planes
    ``[5 (+4), cz, cy, cx, cap]``: e, fx, fy, fz, cn (then ec, fcx, fcy,
    fcz with ``charges``: the Coulomb pair on pass 2's sweep)."""
    grid = ring.grid
    _, _, planes, extra = _d3_inputs(
        grid, numbers, rcov, r4r2, c6ab, cn_ref_elem,
        extra=() if charges is None else (charges,))
    z_plane, _, rcov_plane, _, r4r2_plane, _, cna, mask, c6p = planes
    dtype, device = grid.ext_px.dtype, grid.ext_px.device
    # padding atoms (numbers == 0) parked on the global interior, before
    # any exchange, so their parked positions travel with the halos
    cz, cy, cx = grid.dims
    iota = torch.arange(cz * cy * cx * grid.cap, dtype=dtype,
                        device=device).reshape(z_plane.shape)
    px, py, pz = _positions(grid)
    px = px + torch.where(z_plane == 0, DISPLACE + iota * DISPLACE_SPACING,
                          torch.zeros((), dtype=dtype, device=device))
    pos = [px, py, pz]

    # pass 1: coordination numbers, gathered whole
    cand1 = ring.slab(torch.stack(pos + [rcov_plane]))
    own1, j1 = ring.sweep("cn", cand1, cand1, params)
    cn_plane = ring.gather(own1 + j1)[0]

    # per-atom features, replicated
    lf, e_pl, edc_pl, w_plane = _d3_plane_features(
        z_plane, cn_plane, cna, mask, c6p, params.k3)
    si_plane = torch.sqrt(r4r2_plane * _SQRT3)

    # pass 2: energy, direct forces, dE/dCN (and the Coulomb pair)
    head = pos + [si_plane, w_plane]
    body, own_idx = "d3_direct", list(range(5))
    cols = head + [z_plane.to(dtype)]
    if charges is not None:
        body, own_idx = "d3_direct_coulomb", list(range(5)) + [6]
        cols.append(extra[0])
    cand2 = ring.slab(torch.cat([torch.stack(cols),
                                 torch.movedim(e_pl, -1, 0),
                                 torch.movedim(edc_pl, -1, 0)]))
    own2, j2 = ring.sweep(body, cand2[own_idx], cand2, params,
                          lf=lf[ring.rows].contiguous())
    # e: pairs counted once, own side only; output k >= 1 takes j output k-1
    out2 = torch.cat([own2[:1], own2[1:] + j2])
    decn = out2[4]

    # pass 3: CN chain-rule forces
    cand3 = torch.cat([ring.slab(torch.stack(pos + [rcov_plane])),
                       decn[None]])
    own3, j3 = ring.sweep("chain", cand3, cand3, params)
    f = out2[1:4] + own3 + j3
    slab_out = torch.cat([out2[:1], f, own1 + j1, out2[5:]])
    return ring.gather(slab_out)


def _d3_params(cutoff, a1, a2, s8, s6, k1, k3, **coulomb):
    return SweepParams(cutoff=float(cutoff), a1=float(a1), a2=float(a2),
                       s6=float(s6), s8=float(s8), k1=float(k1),
                       k3=float(k3), **coulomb)


def domain_dftd3(mesh, grid: AtomGrid, numbers, rcov, r4r2, c6ab,
                 cn_ref_elem, cutoff, a1, a2, s8, cell,
                 s6=1.0, k1=16.0, k3=-4.0, pbc=(True, True, True)):
    """DFT-D3(BJ) energy, forces and CNs with the grid's z axis split over
    the mesh: the contract of ``grid_d3.grid_dftd3`` on one device, plus
    the explicit ``cell`` for the halo image shifts.  Passes 1-3 run kernel
    1's ``cn``, ``d3_direct`` and ``chain`` bodies on each slab."""
    ring = _Ring(mesh, grid, cell, pbc)
    e, f1, f2, f3, cn = _domain_d3(
        ring, numbers, rcov, r4r2, c6ab, cn_ref_elem,
        _d3_params(cutoff, a1, a2, s8, s6, k1, k3))
    f1, f2, f3, coord_num = gather_rows_from_grid(grid, (f1, f2, f3, cn))
    return e.sum(), torch.stack([f1, f2, f3], dim=-1), coord_num


def domain_dftd3_coulomb(mesh, grid: AtomGrid, numbers, charges,
                         rcov, r4r2, c6ab, cn_ref_elem, cutoff,
                         a1, a2, s8, cell, coulomb_cutoff=None, alpha=0.0,
                         s6=1.0, k1=16.0, k3=-4.0,
                         pbc=(True, True, True)):
    """Fused domain-decomposed D3 + real-space Coulomb: the Coulomb pair
    rides pass 2 (kernel 1's ``d3_direct_coulomb`` body), so the whole
    real-space force field pays one set of halo exchanges and one pass-2
    traversal.  Returns ``(e_d3_total, f_d3 [N, 3], coord_num [N],
    e_coulomb [N], f_coulomb [N, 3])``."""
    ring = _Ring(mesh, grid, cell, pbc)
    if coulomb_cutoff is None:
        coulomb_cutoff = cutoff
    e, f1, f2, f3, cn, ec, fc1, fc2, fc3 = _domain_d3(
        ring, numbers, rcov, r4r2, c6ab, cn_ref_elem,
        _d3_params(cutoff, a1, a2, s8, s6, k1, k3, alpha=float(alpha),
                   ccutoff=float(coulomb_cutoff)), charges=charges)
    f1, f2, f3, coord_num, e_c, fc1, fc2, fc3 = gather_rows_from_grid(
        grid, (f1, f2, f3, cn, ec, fc1, fc2, fc3))
    return (e.sum(), torch.stack([f1, f2, f3], dim=-1), coord_num, e_c,
            torch.stack([fc1, fc2, fc3], dim=-1))


def domain_pme_reciprocal(mesh, positions, charges, cell, alpha,
                          mesh_dims, order: int = 4,
                          tile_capacity: int | None = None,
                          compute_forces: bool = False):
    """PME reciprocal space with the mesh tiles split over the ranks.

    The contract of the single-device windowed ``pme_reciprocal_space``
    (per-atom energies with the self and background terms; forces from the
    spline derivatives, net force removed).  The tiles are built
    replicated; rank ``r`` of ``D`` spreads tiles ``[r T/D, (r+1) T/D)``
    with kernel 3 and folds them into a partial mesh, the partial meshes
    are summed, every rank convolves, and each gathers its tiles (kernel 2
    with forces) into per-atom rows that are summed (each atom lies in one
    tile).  ``ValueError`` when the windows reject the mesh, when the tile
    count does not divide by the ranks, or when a tile overflows its
    capacity.
    """
    mesh_dims = tuple(int(d) for d in mesh_dims)
    if not sw.windowed_applicable(mesh_dims, order):
        raise ValueError("domain PME requires the windowed configuration "
                         f"(mesh dims {mesh_dims} divisible by 8)")
    group, size, rank = axis_group(mesh, "z")
    ntiles = math.prod(d // 8 for d in mesh_dims)
    if ntiles % size:
        raise ValueError(f"{ntiles} mesh tiles do not split over {size} "
                         "ranks")
    dtype, device = positions.dtype, positions.device
    charges = torch.as_tensor(charges, dtype=dtype, device=device)
    cell = torch.as_tensor(cell, dtype=dtype, device=device).reshape(3, 3)
    cap = tile_capacity or sw.mesh_tile_capacity(positions.shape[0],
                                                 mesh_dims)
    tiles = sw.build_mesh_tiles(positions, cell, mesh_dims, order, cap,
                                need_grad=compute_forces)
    if int(tiles.counts_max) > cap:
        raise ValueError(f"PME mesh tile overflow: {int(tiles.counts_max)} "
                         f"atoms in one tile, capacity {cap}; pass a larger "
                         "tile_capacity")
    own = slab_rows(rank, size, ntiles)
    w = tiles.w_win
    smat = tiles.smat[own].contiguous()
    windows = torch.zeros((ntiles, w, w * w), dtype=dtype, device=device)
    windows[own] = spread_windows(
        smat, sw._slot_values(tiles, charges)[own].contiguous(), w)
    charge_mesh = all_reduce_sum(sw._fold_windows(tiles, windows), group)
    potential = _potential(charge_mesh, cell, alpha, mesh_dims, order)
    win = sw._extract_windows(potential, tiles.tile)[own].contiguous()
    if compute_forces:
        planes = gather_grad_planes(smat, win, w)
    else:
        tyx = (tiles.axis_mat(1)[own][..., :, None]
               * tiles.axis_mat(0)[own][..., None, :]).flatten(-2)
        q = torch.einsum("tcm,tzm->tcz", tyx, win)
        planes = ((tiles.axis_mat(2)[own] * q).sum(-1),)
    rows = torch.zeros((ntiles, cap, len(planes)), dtype=dtype,
                       device=device)
    rows[own] = torch.stack(planes, dim=-1)
    rows = rows.reshape(ntiles * cap, len(planes))
    per_atom = all_reduce_sum(rows[tiles.flat_slot.long()], group)
    grad_frac = per_atom[:, 1:] if compute_forces else None
    energies, forces, _ = _finish(charges, per_atom[:, 0], grad_frac,
                                  tiles.inv, alpha, cell, compute_forces,
                                  False)
    return (energies, forces) if compute_forces else energies

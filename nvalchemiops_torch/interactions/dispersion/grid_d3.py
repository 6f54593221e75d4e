# SPDX-License-Identifier: Apache-2.0
"""DFT-D3(BJ) on the halo atom grid (counterpart of
``nvalchemiops_tpu.interactions.dispersion.grid_d3``, window engine).

Three pair sweeps (kernels/window_sweep.py) over the grid:

1. coordination numbers (logistic counting function);
2. the C6 interpolation, BJ-damped energy, direct forces and dE/dCN;
3. the CN chain-rule forces.

Between passes 1 and 2 the interpolation features are computed per slot in
plane space.  The Gaussian 5x5 interpolation factorizes over the reference
grid (``exp(k3 (di^2 + dj^2)) = e_i e_j``), so per pair the kernel only
needs the own left features ``l0 = C6(z_i, .) e_i`` and ``l1c``, and the
candidate's ``e_j``, ``edc_j`` and element ``z_j``: three mesh-term dots.
The derivative weights are compensated in factored form, ``edc = e (d -
a_cn)`` with ``a_cn = wd / w``, which keeps the dE/dCN signal free of the
ulp noise of a post-contraction difference (the JAX package measured the
f32 force error drop from 4.7e-3 to 1.6e-5 with it).

The tables must be element-structured (:func:`element_cn_ref`) with a
separable C6 availability mask (:func:`element_c6_mask`).  D3 parameters
are runtime floats.
"""

from __future__ import annotations

import numpy as np
import torch

from nvalchemiops_torch.grid import (
    DISPLACE,
    DISPLACE_SPACING,
    AtomGrid,
    _extend_like,
    _interior,
    batch_build_atom_grid,
    estimate_grid_geometry,
    fold_halo,
    gather_rows_from_grid,
    scatter_rows_to_grid,
    system_grid,
)
from nvalchemiops_torch.kernels.window_sweep import SweepParams, window_sweep
from nvalchemiops_torch.types import INDEX_DTYPE

__all__ = ["compact_d3_elements", "element_cn_ref", "element_c6_mask",
           "grid_dftd3", "batch_grid_dftd3"]

_SQRT3 = 1.7320508075688772


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def element_cn_ref(cn_ref, atol=0.0):
    """Element-structured CN reference table ``[Zmax+1, mesh]`` (numpy).

    Real D3 data satisfies ``cn_ref[zi, zj, p, q] == cnA[zi, p]`` for all
    partners ``zj >= 1`` (the ``zj == 0`` padding column holds the -1 fill
    and is not checked); raises if the table is not of that form.
    """
    cn_ref = _np(cn_ref)
    zmax1, _, mesh, _ = cn_ref.shape
    cand = cn_ref[:, 0, :, 0] if zmax1 == 1 else cn_ref[:, min(1, zmax1 - 1), :, 0]
    full = np.broadcast_to(cand[:, None, :, None], cn_ref.shape)
    chk = slice(min(1, zmax1 - 1), None)
    if not np.allclose(full[:, chk], cn_ref[:, chk], atol=atol, rtol=0.0):
        raise ValueError(
            "cn_ref is not element-structured (cn_ref[zi, zj, p, q] must "
            "depend only on (zi, p) for zj >= 1)"
        )
    return cand


def element_c6_mask(c6ab):
    """Per-element reference availability mask ``m [Zmax+1, mesh]`` (numpy).

    Validates that ``(c6ab != 0)[zi, zj, p, q] == m[zi, p] & m[zj, q]``
    (element 0 is padding and not checked); raises otherwise.
    """
    c6 = _np(c6ab)
    nz = c6 != 0.0
    m = nz.any(axis=(1, 3))
    sep = m[:, None, :, None] & m[None, :, None, :]
    sep[0] = False
    sep[:, 0] = False
    chk = nz.copy()
    chk[0] = False
    chk[:, 0] = False
    if not (chk == sep).all():
        raise ValueError("c6ab zero pattern is not separable per element")
    return m.astype(c6.dtype)


def compact_d3_elements(numbers, rcov, r4r2, c6ab, cn_ref):
    """Relabel ``numbers`` onto the dense set of elements present (numpy).

    Shrinks the interpolation width ``zm = (Zmax+1) * mesh`` to
    ``(n_present+1) * mesh``; padding 0 stays 0.  Accepts the full
    ``cn_ref [Z+1, Z+1, m, m]`` or the element-structured ``[Z+1, m]``
    form.  Returns ``(numbers_local, rcov_c, r4r2_c, c6ab_c, cn_ref_c)``.
    """
    numbers_np, rcov_np, r4r2_np, c6_np, cn_np = (
        _np(a) for a in (numbers, rcov, r4r2, c6ab, cn_ref))
    present = np.unique(numbers_np)
    present = present[present > 0].astype(np.int64)
    if present.size and present.max() >= rcov_np.shape[0]:
        raise ValueError(
            f"atomic number {present.max()} exceeds table size "
            f"{rcov_np.shape[0]}"
        )
    lut = np.zeros(rcov_np.shape[0], np.int32)
    lut[present] = np.arange(1, present.size + 1, dtype=np.int32)
    sel = np.r_[np.zeros(1, np.int64), present]
    cn_c = cn_np[np.ix_(sel, sel)] if cn_np.ndim == 4 else cn_np[sel]
    return (lut[numbers_np], rcov_np[sel], r4r2_np[sel],
            c6_np[np.ix_(sel, sel)], cn_c)


def _d3_pass1_cn(grid, px_d, rcov_plane, rcov_ext, params):
    """Pass 1: coordination-number plane [cz, cy, cx, cap]."""
    own = torch.stack([_interior(grid, px_d), _interior(grid, grid.ext_py),
                       _interior(grid, grid.ext_pz), rcov_plane])
    cand = torch.stack([px_d, grid.ext_py, grid.ext_pz, rcov_ext])
    acc, jacc = window_sweep("cn", grid.radius, own, cand, params)
    return acc[0] + fold_halo(grid, jacc[0])


def _d3_plane_features(z_plane, cn_plane, cna_elem, mask_elem, c6p_elem, k3):
    """Interpolation features per slot, in plane space.

    Returns ``(lf [.., cap, 2 zm] = [l0 | l1c], e [.., cap, mesh],
    edc [.., cap, mesh], w [.., cap])``.  ``e`` is max-scaled over the
    available reference points (an exact LSE stabilization: the scales
    cancel in every ratio) and zero where a reference is unavailable.
    """
    zl = z_plane.long()
    cna_pl = cna_elem[zl]                               # [.., cap, mesh]
    mask_pl = mask_elem[zl]
    d_pl = cn_plane[..., None] - cna_pl
    arg = k3 * d_pl * d_pl
    avail = mask_pl > 0
    arg_m = torch.where(avail, arg, torch.full((), -torch.inf,
                                               dtype=arg.dtype,
                                               device=arg.device))
    arg_max = torch.clamp(arg_m.max(dim=-1, keepdim=True).values, min=-1e30)
    zero = torch.zeros((), dtype=arg.dtype, device=arg.device)
    e_pl = torch.where(avail, torch.exp(arg - arg_max), zero)
    ed_pl = e_pl * d_pl
    w_plane = e_pl.sum(-1)
    wd_plane = ed_pl.sum(-1)
    pos = w_plane > 0.0
    a_cn = torch.where(pos, wd_plane / torch.where(pos, w_plane,
                                                   torch.ones_like(w_plane)),
                       zero)
    # factored compensation e (d - a): never ed - a e or l1 - a l0
    edc_pl = e_pl * (d_pl - a_cn[..., None])
    # l0[(z, q)] = sum_p C6[z_i, p, (z, q)] e_i[p] (and l1c with edc):
    # elementwise products summed over the mesh axis, full f32 on any
    # device (no TF32 matmul path)
    mesh = e_pl.shape[-1]
    l0 = torch.zeros(e_pl.shape[:-1] + (c6p_elem.shape[-1],),
                     dtype=e_pl.dtype, device=e_pl.device)
    l1c = torch.zeros_like(l0)
    for p in range(mesh):
        rows = c6p_elem[:, p, :][zl]                    # [.., cap, zm]
        l0 = l0 + e_pl[..., p:p + 1] * rows
        l1c = l1c + edc_pl[..., p:p + 1] * rows
    return torch.cat([l0, l1c], dim=-1).contiguous(), e_pl, edc_pl, w_plane


def _d3_pass2_direct(grid, px_d, z_ext, si_plane, si_ext, w_plane, e_pl,
                     edc_pl, lf, params):
    """Pass 2: per-slot energy, direct forces and dE/dCN planes."""
    w_ext = _extend_like(grid, w_plane, 0.0)
    e_ext = _extend_like(grid, e_pl, 0.0)
    edc_ext = _extend_like(grid, edc_pl, 0.0)
    own = torch.stack([_interior(grid, px_d), _interior(grid, grid.ext_py),
                       _interior(grid, grid.ext_pz), si_plane, w_plane])
    cand = torch.cat([
        torch.stack([px_d, grid.ext_py, grid.ext_pz, si_ext, w_ext,
                     z_ext.to(px_d.dtype)]),
        torch.movedim(e_ext, -1, 0), torch.movedim(edc_ext, -1, 0),
    ]).contiguous()
    acc, jacc = window_sweep("d3_direct", grid.radius, own, cand, params,
                             lf=lf)
    e_pl = acc[0]                     # pairs counted once, own side only
    fx = acc[1] + fold_halo(grid, jacc[0])
    fy = acc[2] + fold_halo(grid, jacc[1])
    fz = acc[3] + fold_halo(grid, jacc[2])
    decn = acc[4] + fold_halo(grid, jacc[3])
    return e_pl, fx, fy, fz, decn


def _d3_pass3_chain(grid, px_d, rcov_plane, rcov_ext, decn_pl, params):
    """Pass 3: CN chain-rule force planes (fx, fy, fz)."""
    decn_ext = _extend_like(grid, decn_pl, 0.0)
    own = torch.stack([_interior(grid, px_d), _interior(grid, grid.ext_py),
                       _interior(grid, grid.ext_pz), rcov_plane, decn_pl])
    cand = torch.stack([px_d, grid.ext_py, grid.ext_pz, rcov_ext, decn_ext])
    acc, jacc = window_sweep("chain", grid.radius, own, cand, params)
    return tuple(acc[k] + fold_halo(grid, jacc[k]) for k in range(3))


def _parked_px(grid, z_ext):
    """``ext_px`` with padding atoms (numbers == 0) parked like empty slots,
    so no pass body compares element ids for validity."""
    ez, ey, ex, cap = grid.ext_px.shape
    dtype = grid.ext_px.dtype
    ext_iota = torch.arange(ez * ey * ex * cap, dtype=dtype,
                            device=grid.ext_px.device).reshape(ez, ey, ex, cap)
    return grid.ext_px + torch.where(
        z_ext == 0, DISPLACE + ext_iota * DISPLACE_SPACING,
        torch.zeros((), dtype=dtype, device=grid.ext_px.device))


def _grid_d3_window_impl(grid: AtomGrid, z_plane, z_ext, rcov_plane,
                         rcov_ext, r4r2_plane, r4r2_ext, cna_elem, mask_elem,
                         c6p_elem, params: SweepParams):
    """D3 passes 1-3 on the pair sweep; returns the planes
    ``(e, fx, fy, fz, cn)``."""
    px_d = _parked_px(grid, z_ext)
    cn_plane = _d3_pass1_cn(grid, px_d, rcov_plane, rcov_ext, params)
    lf, e_pl, edc_pl, w_plane = _d3_plane_features(
        z_plane, cn_plane, cna_elem, mask_elem, c6p_elem, params.k3)
    si_plane = torch.sqrt(r4r2_plane * _SQRT3)
    si_ext = torch.sqrt(r4r2_ext * _SQRT3)
    e_pl, fx, fy, fz, decn = _d3_pass2_direct(
        grid, px_d, z_ext, si_plane, si_ext, w_plane, e_pl, edc_pl, lf,
        params)
    fx3, fy3, fz3 = _d3_pass3_chain(grid, px_d, rcov_plane, rcov_ext, decn,
                                    params)
    return e_pl, fx + fx3, fy + fy3, fz + fz3, cn_plane


def grid_dftd3(
    grid: AtomGrid,
    numbers,
    rcov,
    r4r2,
    c6ab,
    cn_ref_elem,
    cutoff: float,
    a1, a2, s8,
    s6=1.0, k1=16.0, k3=-4.0,
    engine: str | None = None,
):
    """DFT-D3(BJ) energy, forces and CNs on the atom grid.

    ``cn_ref_elem`` is the ``[Zmax+1, mesh]`` element-structured CN table
    (:func:`element_cn_ref`); the C6 availability mask must be separable
    (:func:`element_c6_mask`).  Tables may be numpy arrays or tensors.
    Returns ``(energy_total, forces [N, 3], coord_num [N])`` in the grid's
    dtype on the grid's device.  ``engine`` accepts only ``None`` or
    ``"window"``; the JAX package's other engines are listed in
    ROADMAP.md.
    """
    if engine not in (None, "window"):
        raise NotImplementedError(
            f"grid_dftd3 engine={engine!r} is not ported (ROADMAP.md, "
            "'Engines off the default path')")
    dtype = grid.ext_px.dtype
    device = grid.ext_px.device

    def table(a):
        return torch.as_tensor(_np(a)).to(device=device, dtype=dtype)

    numbers = torch.as_tensor(_np(numbers)).to(device=device,
                                               dtype=INDEX_DTYPE)
    rcov_t, r4r2_t, c6_t, cna_t = (table(a) for a in
                                   (rcov, r4r2, c6ab, cn_ref_elem))
    mask_t = table(element_c6_mask(c6ab))
    zmax1 = rcov_t.shape[0]
    mesh = cna_t.shape[1]
    # p-major C6 rows: c6p[z_i, p, (z, q)] = c6ab[z_i, z, p, q]
    c6p = c6_t.permute(0, 2, 1, 3).reshape(zmax1, mesh, zmax1 * mesh)

    nl = numbers.long()
    zf_plane, rcov_plane, r4r2_plane = scatter_rows_to_grid(
        grid, (numbers.to(dtype), rcov_t[nl], r4r2_t[nl]))
    z_plane = zf_plane.to(INDEX_DTYPE)
    z_ext = _extend_like(grid, z_plane, 0)
    rcov_ext = _extend_like(grid, rcov_plane, 0.0)
    r4r2_ext = _extend_like(grid, r4r2_plane, 0.0)
    params = SweepParams(cutoff=float(cutoff), a1=float(a1), a2=float(a2),
                         s6=float(s6), s8=float(s8), k1=float(k1),
                         k3=float(k3))
    e_pl, fx_pl, fy_pl, fz_pl, cn_pl = _grid_d3_window_impl(
        grid, z_plane, z_ext, rcov_plane, rcov_ext, r4r2_plane, r4r2_ext,
        cna_t, mask_t, c6p, params)
    energy = e_pl.sum()
    f1, f2, f3, coord_num = gather_rows_from_grid(
        grid, (fx_pl, fy_pl, fz_pl, cn_pl))
    return energy, torch.stack([f1, f2, f3], dim=-1), coord_num


def batch_grid_dftd3(positions, numbers, cells, pbc, cutoff: float, rcov,
                     r4r2, c6ab, cn_ref_elem, a1, a2, s8, s6=1.0, k1=16.0,
                     k3=-4.0, cap: int | None = None,
                     engine: str | None = None):
    """Batched DFT-D3(BJ) on one whole-batch halo grid.

    The systems share the grid geometry estimated from ``cells[0]``; the
    grid is built once for the batch (:func:`grid.batch_build_atom_grid`)
    and each system runs :func:`grid_dftd3` on its part, in a loop over
    systems.  ``positions [B, n, 3]``, ``numbers [B, n]`` (0 = padding
    atom), ``cells`` ``[3, 3]`` or ``[B, 3, 3]``; ``cap`` overrides the
    estimated slot capacity (target occupancy 0.66, as in the JAX
    package).  Returns ``(energy [B], forces [B, n, 3], cn [B, n])``.
    ``engine`` accepts only ``None`` or ``"window"`` (the JAX package
    defaults to its xla engine here, which agrees with the window engine
    to f64 rounding).
    """
    if engine not in (None, "window"):
        raise NotImplementedError(
            f"batch_grid_dftd3 engine={engine!r} is not ported (ROADMAP.md, "
            "'Engines off the default path')")
    b, n = positions.shape[0], positions.shape[1]
    cells_np = np.asarray(_np(cells), dtype=np.float64)
    dims, radius, cap_est = estimate_grid_geometry(
        cells_np if cells_np.ndim == 2 else cells_np[0], pbc, cutoff, n,
        target_occupancy=0.66)
    g = batch_build_atom_grid(positions, cells, pbc, dims, radius,
                              cap or cap_est)
    numbers_np = _np(numbers)
    outs = [grid_dftd3(system_grid(g, i), numbers_np[i], rcov, r4r2, c6ab,
                       cn_ref_elem, cutoff, a1, a2, s8, s6=s6, k1=k1, k3=k3)
            for i in range(b)]
    return tuple(torch.stack(o) for o in zip(*outs))

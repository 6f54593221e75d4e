# SPDX-License-Identifier: Apache-2.0
"""DFT-D3(BJ) on the halo atom grid (counterpart of
``nvalchemiops_tpu.interactions.dispersion.grid_d3``: the window, block,
pallas and hybrid engines, and the fused D3 + Coulomb sweep; the JAX
package's ``"xla"`` engine runs the window engine, which gives its results
to rounding).

Three pair sweeps over the grid, on the engine's kernel (window: kernel 1,
kernels/window_sweep.py; block: kernel 8, kernels/chunk_sweep.py; pallas:
kernel 7, kernels/row_sweep.py):

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
f32 force error drop from 4.7e-3 to 1.6e-5 with it).  The block and pallas
engines take the JAX engines' zm-wide inputs, ``rf[(z, q)] = [z_j == z]
e_j[q]`` and ``rfdc`` likewise, expanded from the same factored e / edc
(the JAX engines form ``rfdc = rfd - a_cn rf`` as a difference instead; in
exact arithmetic the two are one function), so each pair contracts dots of
length ``zm = zmax1 * mesh``.  The hybrid engine runs passes 1 and 3 on
the voxel stencil (stencil.py, kernel 9).

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
    _system_axes,
    batch_build_atom_grid,
    estimate_grid_geometry,
    fold_halo,
    gather_from_grid,
    gather_rows_from_grid,
    scatter_rows_to_grid,
    scatter_to_grid,
)
from nvalchemiops_torch.kernels.chunk_sweep import (
    chunk_sweep, super_chunk_cells,
)
from nvalchemiops_torch.kernels.row_sweep import row_sweep
from nvalchemiops_torch.kernels.window_sweep import SweepParams, window_sweep
from nvalchemiops_torch.neighborlist.neighbor_utils import unpack_shifts
from nvalchemiops_torch.stencil import (
    extend_stencil, scatter_to_stencil, stencil_cn_chain_forces,
    stencil_coordination_numbers,
)
from nvalchemiops_torch.trace import host_read, span, spanned, upload
from nvalchemiops_torch.types import INDEX_DTYPE

__all__ = ["compact_d3_elements", "element_cn_ref", "element_c6_mask",
           "grid_dftd3", "grid_dftd3_coulomb", "batch_grid_dftd3"]

_SQRT3 = 1.7320508075688772


def _np(a, site: str = "d3_to_numpy"):
    """``a`` as a numpy array (a device tensor read back: a host read at
    ``site``)."""
    if isinstance(a, torch.Tensor):
        with host_read(site, a.device):
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


# the precision strings of jax.lax.Precision and its member names
_PRECISION_NAMES = {"default", "high", "highest", "bfloat16", "bfloat16_3x",
                    "tensorfloat32", "float32", "fastest"}


def _check_precision(precision):
    """Raise ``ValueError`` unless ``precision`` is a value the JAX package
    takes: ``None``, a ``jax.lax.Precision`` member or its string, or a
    pair of either."""
    if precision is None:
        return
    pair = isinstance(precision, (list, tuple))
    names = [getattr(p, "name", p) for p in (precision if pair
                                             else [precision])]
    if (pair and len(names) != 2) or not all(
            isinstance(n, str) and n.lower() in _PRECISION_NAMES
            for n in names):
        raise ValueError(f"precision must be None, a jax.lax.Precision or "
                         f"one of {sorted(_PRECISION_NAMES)}, got "
                         f"{precision!r}")


def _feature_dtype(feature_dtype):
    """``feature_dtype`` as a torch floating dtype (``None`` stays): a torch
    dtype, or a numpy/JAX dtype or its name; ``ValueError`` otherwise."""
    if feature_dtype is None or isinstance(feature_dtype, torch.dtype):
        dt = feature_dtype
    else:
        name = getattr(feature_dtype, "__name__", None) or getattr(
            feature_dtype, "name", None) or str(feature_dtype)
        dt = getattr(torch, str(name).rsplit(".", 1)[-1], None)
    if feature_dtype is not None and not (isinstance(dt, torch.dtype)
                                          and dt.is_floating_point):
        raise ValueError(f"feature_dtype must be a floating dtype, got "
                         f"{feature_dtype!r}")
    return dt


def _check_engine(name, engine, engines):
    """``ValueError`` for an engine name neither package has."""
    if engine not in engines:
        raise ValueError(f"{name}: unknown engine {engine!r}; one of "
                         f"{[e for e in engines if e]}")


def _stack(grid, planes):
    """Feature planes stacked feature-major: ``[F, ..]``, or ``[B, F, ..]``
    on a batched grid."""
    return torch.stack(planes, dim=_system_axes(grid))


def _sweep(grid, engine, block_g, body, own, cand, params, lf=None,
           cf=None):
    """One pass on the engine's kernel: ``"window"`` (kernel 1, factored
    mesh features), ``"pallas"`` (kernel 7) or ``"block"`` (kernel 8; G =
    ``block_g`` or the card's pick), the last two with zm-wide features.
    On a batched grid the kernel sweeps every system in one launch and the
    outputs come back as ``[F, B, ..]`` views."""
    if engine == "window":
        out = window_sweep(body, grid.radius, own, cand, params, lf=lf)
    elif engine == "pallas":
        out = row_sweep(body, grid.radius, own, cand, params, lf=lf, cf=cf)
    else:
        g_cells = block_g or super_chunk_cells(
            body, grid.dims[2], grid.cap, grid.radius[2],
            0 if lf is None else lf.shape[-1])
        out = chunk_sweep(body, grid.radius, own, cand, params, g_cells,
                          lf=lf, cf=cf)
    if _system_axes(grid):
        return tuple(t.transpose(0, 1) for t in out)
    return out


def _d3_pass1_cn(grid, px_d, rcov_plane, rcov_ext, params, engine="window",
                 block_g=None):
    """Pass 1: coordination-number plane [cz, cy, cx, cap]."""
    own = _stack(grid, [_interior(grid, px_d), _interior(grid, grid.ext_py),
                        _interior(grid, grid.ext_pz), rcov_plane])
    cand = _stack(grid, [px_d, grid.ext_py, grid.ext_pz, rcov_ext])
    acc, jacc = _sweep(grid, engine, block_g, "cn", own, cand, params)
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


def _wide_rows(e_ext, edc_ext, z_ext, zm):
    """The JAX block/pallas engines' candidate rows ``[rf | rfdc]`` (zm
    wide) from the factored e / edc planes: ``rf[(z, q)] = [z_j == z]
    e_j[q]``, ``rfdc`` likewise from edc."""
    mesh = e_ext.shape[-1]
    zrow = torch.arange(zm, device=z_ext.device) // mesh
    zmask = z_ext[..., None].long() == zrow
    reps = (1,) * (e_ext.dim() - 1) + (zm // mesh,)
    zero = torch.zeros((), dtype=e_ext.dtype, device=e_ext.device)
    return torch.cat([torch.where(zmask, e_ext.repeat(reps), zero),
                      torch.where(zmask, edc_ext.repeat(reps), zero)],
                     dim=-1).contiguous()


def _d3_pass2_direct(grid, px_d, z_ext, si_plane, si_ext, w_plane, e_pl,
                     edc_pl, lf, params, q=None, engine="window",
                     block_g=None, raw_j=None):
    """Pass 2: per-slot energy, direct forces and dE/dCN planes ``(e, fx,
    fy, fz, decn)``.  With ``q = (q_plane, q_ext)`` the Coulomb pair rides
    the same sweep (body ``d3_direct_coulomb``) and the Coulomb planes
    follow: ``(ec, fcx, fcy, fcz)``, or only ``ec`` with
    ``params.combine_forces`` (the force planes then carry both).  A list
    ``raw_j`` receives the j-side force accumulators before the fold."""
    w_ext = _extend_like(grid, w_plane, 0.0)
    e_ext = _extend_like(grid, e_pl, 0.0)
    edc_ext = _extend_like(grid, edc_pl, 0.0)
    own_cols = [_interior(grid, px_d), _interior(grid, grid.ext_py),
                _interior(grid, grid.ext_pz), si_plane, w_plane]
    cand_cols = [px_d, grid.ext_py, grid.ext_pz, si_ext, w_ext]
    body = "d3_direct"
    if q is not None:
        body = "d3_direct_coulomb"
        own_cols.append(q[0])
    cf = None
    if engine == "window":
        cand_cols.append(z_ext.to(px_d.dtype))
        if q is not None:
            cand_cols.append(q[1])
        nb = _system_axes(grid)
        cand = torch.cat([_stack(grid, cand_cols), torch.movedim(e_ext, -1, nb),
                          torch.movedim(edc_ext, -1, nb)], dim=nb).contiguous()
    else:
        if q is not None:
            cand_cols.append(q[1])
        cand = _stack(grid, cand_cols)
        cf = _wide_rows(e_ext, edc_ext, z_ext, lf.shape[-1] // 2)
    acc, jacc = _sweep(grid, engine, block_g, body, _stack(grid, own_cols),
                       cand, params, lf=lf, cf=cf)
    if raw_j is not None:
        raw_j.append(jacc[:3])
    # e: pairs counted once, own side only
    return (acc[0],) + tuple(acc[k] + fold_halo(grid, jacc[k - 1])
                             for k in range(1, acc.shape[0]))


def _d3_pass3_chain(grid, px_d, rcov_plane, rcov_ext, decn_pl, params,
                    engine="window", block_g=None, raw_j=None):
    """Pass 3: CN chain-rule force planes (fx, fy, fz); a list ``raw_j``
    receives the j-side accumulators before the fold."""
    decn_ext = _extend_like(grid, decn_pl, 0.0)
    own = _stack(grid, [_interior(grid, px_d), _interior(grid, grid.ext_py),
                        _interior(grid, grid.ext_pz), rcov_plane, decn_pl])
    cand = _stack(grid, [px_d, grid.ext_py, grid.ext_pz, rcov_ext, decn_ext])
    acc, jacc = _sweep(grid, engine, block_g, "chain", own, cand, params)
    if raw_j is not None:
        raw_j.append(jacc)
    return tuple(acc[k] + fold_halo(grid, jacc[k]) for k in range(3))


def _parked_px(grid, z_ext):
    """``ext_px`` with padding atoms (numbers == 0) parked like empty slots,
    so no pass body compares element ids for validity."""
    ez, ey, ex, cap = grid.ext_px.shape[-4:]
    dtype = grid.ext_px.dtype
    ext_iota = torch.arange(ez * ey * ex * cap, dtype=dtype,
                            device=grid.ext_px.device).reshape(ez, ey, ex, cap)
    return grid.ext_px + torch.where(
        z_ext == 0, DISPLACE + ext_iota * DISPLACE_SPACING,
        torch.zeros((), dtype=dtype, device=grid.ext_px.device))


def _grid_d3_impl(grid: AtomGrid, z_plane, z_ext, rcov_plane, rcov_ext,
                  r4r2_plane, r4r2_ext, cna_elem, mask_elem, c6p_elem,
                  params: SweepParams, engine: str = "window", block_g=None,
                  q=None, cn_plane=None, skip_chain: bool = False,
                  feature_dtype=None, compute_virial: bool = False,
                  cell=None):
    """D3 passes 1-3 on one engine's pair sweep (``"window"``, ``"pallas"``
    or ``"block"``: the JAX ``_grid_d3_window_impl``,
    ``_grid_d3_pallas_impl`` and ``_grid_d3_block_impl``); returns the
    planes ``(e, fx, fy, fz, cn)``.

    ``q = (q_plane, q_ext)`` adds the Coulomb pair to pass 2 (see
    :func:`_d3_pass2_direct`); its planes follow the five.  ``cn_plane``
    replaces pass 1; ``skip_chain`` stops after pass 2 and appends the
    dE/dCN plane instead of adding the chain forces (the hybrid engine's
    hooks, as ``cn_a_override`` / ``skip_chain`` of the JAX row sweep).
    ``feature_dtype`` rounds the pass-2 feature planes to that dtype (the
    JAX window engine's storage cast).  ``compute_virial`` (window engine,
    D3 only) appends the ``[3, 3]`` virial (:func:`_window_virial`).
    """
    px_d = _parked_px(grid, z_ext)
    if cn_plane is None:
        with span("d3.cn"):
            cn_plane = _d3_pass1_cn(grid, px_d, rcov_plane, rcov_ext, params,
                                    engine, block_g)
    with span("d3.features"):
        lf, e_pl, edc_pl, w_plane = _d3_plane_features(
            z_plane, cn_plane, cna_elem, mask_elem, c6p_elem, params.k3)
        if feature_dtype is not None:
            lf, e_pl, edc_pl = (a.to(feature_dtype).to(a.dtype)
                                for a in (lf, e_pl, edc_pl))
        si_plane = torch.sqrt(r4r2_plane * _SQRT3)
        si_ext = torch.sqrt(r4r2_ext * _SQRT3)
    raw_j = [] if compute_virial else None
    with span("d3.direct"):
        e_pl, fx, fy, fz, decn, *coul = _d3_pass2_direct(
            grid, px_d, z_ext, si_plane, si_ext, w_plane, e_pl, edc_pl, lf,
            params, q=q, engine=engine, block_g=block_g, raw_j=raw_j)
    if skip_chain:
        return (e_pl, fx, fy, fz, cn_plane, decn, *coul)
    with span("d3.chain"):
        fx3, fy3, fz3 = _d3_pass3_chain(grid, px_d, rcov_plane, rcov_ext,
                                        decn, params, engine, block_g,
                                        raw_j=raw_j)
        out = (e_pl, fx + fx3, fy + fy3, fz + fz3, cn_plane, *coul)
    if compute_virial:
        out += (_window_virial(grid, out[1:4], raw_j[0] + raw_j[1], cell),)
    return out


def _window_virial(grid, forces, j_forces, cell):
    """The ``[3, 3]`` virial from the engine's planes (the JAX window
    engine's plane identity, grid_d3.py:1644-1666):

        ``V[a, b] = sum_int F_a r_b + sum_ext jF_a S_b``

    ``forces`` are the folded per-slot force planes, ``r`` the interior
    positions, ``j_forces [3, ez, ey, ex, cap]`` the raw j-side force
    accumulators of passes 2 and 3 before the fold, and ``S`` each extended
    cell's Cartesian ghost shift from ``grid.ext_shift_code`` and ``cell``;
    with no ``cell``, each extended slot's ghost position less its home
    copy's (what the JAX XLA engine's pair displacements carry).  Each
    pair's displacement is ``(r_j + S) - r_i``, so the sum over the halo's
    raw accumulators books every pair's shift once."""
    dtype, device = forces[0].dtype, forces[0].device
    ez, ey, ex = j_forces.shape[1:4]
    ext_p = (grid.ext_px, grid.ext_py, grid.ext_pz)
    r_int = [_interior(grid, p) for p in ext_p]
    if cell is None:
        shift = [_ghost_shift(grid, p) for p in ext_p]
    else:
        codes = grid.ext_shift_code.reshape(ez, ey, ex)
        cellm = torch.as_tensor(cell, device=device).to(dtype).reshape(3, 3)
        s = [c.to(dtype) for c in unpack_shifts(codes)]
        shift = [(s[0] * cellm[0, b] + s[1] * cellm[1, b]
                  + s[2] * cellm[2, b])[..., None] for b in range(3)]
    return torch.stack([
        torch.stack([(forces[a] * r_int[b]).sum()
                     + (j_forces[a] * shift[b]).sum()
                     for b in range(3)])
        for a in range(3)])


def _ghost_shift(grid, ext_p):
    """One Cartesian component of every extended slot's ghost shift, its
    position less its home copy's (0 where the slot holds no atom)."""
    home = _extend_like(grid, _interior(grid, ext_p), 0.0)
    return torch.where(grid.ext_valid, ext_p - home, torch.zeros_like(home))


def _snap_block_g(block_g, cx):
    """The JAX rule: a ``block_G`` hint snaps to the nearest divisor of cx."""
    if block_g is None:
        return None
    return min((g for g in range(1, cx + 1) if cx % g == 0),
               key=lambda g: abs(g - block_g))


@spanned("d3.inputs")
def _d3_inputs(grid, numbers, rcov, r4r2, c6ab, cn_ref_elem, extra=()):
    """Tables on the grid's device and dtype, and the per-slot planes:
    ``(numbers, tables, planes)`` with ``planes = (z_plane, z_ext,
    rcov_plane, rcov_ext, r4r2_plane, r4r2_ext, cna, mask, c6p)`` and the
    interior planes of ``extra`` per-atom arrays after them."""
    dtype = grid.ext_px.dtype
    device = grid.ext_px.device

    def table(a):
        return upload(_np(a), device, dtype, "d3_tables")

    numbers = upload(_np(numbers), device, INDEX_DTYPE, "d3_numbers")
    rcov_t, r4r2_t, c6_t, cna_t = (table(a) for a in
                                   (rcov, r4r2, c6ab, cn_ref_elem))
    mask_t = table(element_c6_mask(c6ab))
    zmax1 = rcov_t.shape[0]
    mesh = cna_t.shape[1]
    # p-major C6 rows: c6p[z_i, p, (z, q)] = c6ab[z_i, z, p, q]
    c6p = c6_t.permute(0, 2, 1, 3).reshape(zmax1, mesh, zmax1 * mesh)
    nl = numbers.long()
    zf_plane, rcov_plane, r4r2_plane, *more = scatter_rows_to_grid(
        grid, (numbers.to(dtype), rcov_t[nl], r4r2_t[nl],
               *(table(a) for a in extra)))
    z_plane = zf_plane.to(INDEX_DTYPE)
    planes = (z_plane, _extend_like(grid, z_plane, 0), rcov_plane,
              _extend_like(grid, rcov_plane, 0.0), r4r2_plane,
              _extend_like(grid, r4r2_plane, 0.0), cna_t, mask_t, c6p)
    return numbers, rcov_t, planes, more


@spanned("d3")
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
    precision=None,
    engine: str | None = None,
    block_G: int | None = None,
    compute_virial: bool = False,
    stencil=None,
    bilinear: str = "stack",
    feature_dtype=None,
    hybrid_cn: str = "stencil",
    cell=None,
):
    """DFT-D3(BJ) energy, forces and CNs on the atom grid.

    ``cn_ref_elem`` is the ``[Zmax+1, mesh]`` element-structured CN table
    (:func:`element_cn_ref`); the C6 availability mask must be separable
    (:func:`element_c6_mask`).  Tables may be numpy arrays or tensors.
    Returns ``(energy_total, forces [N, 3], coord_num [N])`` in the grid's
    dtype on the grid's device.  The parameters are the JAX package's, in
    its order.

    ``engine``:

    - ``None`` / ``"window"``: the per-cell sweep (kernel 1) with the
      factored mesh-term features;
    - ``"block"``: the super-chunk sweep (kernel 8) with zm-wide features;
      ``block_G`` hints G and snaps to a divisor of cx, as in the JAX
      package; by default G is picked for the card's shared memory;
    - ``"pallas"``: the per-row sweep (kernel 7) with zm-wide features;
    - ``"hybrid"``, implied by ``stencil=`` (a :class:`stencil.StencilGrid`
      with occupancy 1, built for at least this cutoff): the chain pass,
      and with ``hybrid_cn="stencil"`` the CN pass, run on the voxel
      stencil (kernel 9); ``hybrid_cn="row"`` keeps pass 1 on the grid.
      Pass 2 runs on kernel 1's D3 direct body with the CNs as given: the
      same pass as the JAX hybrid's, which runs it on its XLA row sweep.
      The stencil's chain forces are added per atom;
    - ``"xla"``: the JAX package's XLA engine (its default off the TPU);
      the port runs the window engine for it, which gives its results to
      rounding (both packages' tests hold the two to each other at f64).

    ``compute_virial=True`` appends the ``[3, 3]`` virial (the JAX
    contract: the matrix path's per-system virial, one system).  The window
    engine forms it from its force planes and the raw halo j-side
    accumulators of passes 2 and 3 (kernel 1 unchanged), with the ghost
    shifts from ``cell``, the grid's cell (``cell`` feeds only the
    virial), or with no ``cell`` from the ghost positions.  Where the JAX
    package takes its XLA engine's virial (no ``cell``, another engine, a
    stencil), the port takes the window engine's, with no stencil.
    ``precision`` (the TPU matrix unit's passes) and ``bilinear`` (the XLA
    engine's einsum grouping) are checked and change nothing: every port
    engine computes its C6 dots in full f32.  ``feature_dtype`` rounds the
    pass-2 feature planes (``lf``, ``e``, ``edc``) to that dtype on the
    window and hybrid engines, where the JAX package stores them in it;
    the block and pallas engines ignore it, as the JAX ones do.
    """
    _check_precision(precision)
    if bilinear not in ("stack", "split", "quad"):
        raise ValueError(f"bilinear must be 'stack', 'split' or 'quad', got "
                         f"{bilinear!r}")
    feature_dtype = _feature_dtype(feature_dtype)
    if compute_virial and (cell is None or engine not in (None, "window")
                           or stencil is not None):
        # where the JAX package falls back to its XLA engine's virial
        engine, stencil = "xla", None
    if engine is None and stencil is not None:
        engine = "hybrid"
    if engine == "hybrid" and stencil is None:
        raise ValueError("engine='hybrid' requires a StencilGrid (stencil=...)")
    _check_engine("grid_dftd3", engine,
                  (None, "window", "block", "pallas", "hybrid", "xla"))
    if hybrid_cn not in ("stencil", "row"):
        raise ValueError(f"hybrid_cn must be 'stencil' or 'row', got "
                         f"{hybrid_cn!r}")
    numbers, rcov_t, planes, _ = _d3_inputs(grid, numbers, rcov, r4r2, c6ab,
                                            cn_ref_elem)
    params = SweepParams(cutoff=float(cutoff), a1=float(a1), a2=float(a2),
                         s6=float(s6), s8=float(s8), k1=float(k1),
                         k3=float(k3))
    block_g = _snap_block_g(block_G, grid.dims[2])
    if engine == "hybrid":
        rcov_a = rcov_t[numbers.long()]
        rcov_int = scatter_to_stencil(stencil, rcov_a)
        rcov_planes = (rcov_int, extend_stencil(stencil, rcov_int, 0.0))
        cn_a = cn_plane = None
        if hybrid_cn == "stencil":
            cn_a = stencil_coordination_numbers(
                stencil, rcov_a, float(cutoff), float(k1),
                rcov_planes=rcov_planes)
            cn_plane = scatter_to_grid(grid, cn_a)
        e_pl, fx_pl, fy_pl, fz_pl, cn_pl, decn_pl = _grid_d3_impl(
            grid, *planes, params, "window", cn_plane=cn_plane,
            skip_chain=True, feature_dtype=feature_dtype)
        chain_a = stencil_cn_chain_forces(
            stencil, rcov_a, gather_from_grid(grid, decn_pl), float(cutoff),
            float(k1), rcov_planes=rcov_planes)
        f1, f2, f3, cn_g = gather_rows_from_grid(grid, (fx_pl, fy_pl, fz_pl,
                                                        cn_pl))
        forces = torch.stack([f1, f2, f3], dim=-1) + chain_a
        return e_pl.sum(), forces, cn_g if cn_a is None else cn_a
    engine = "window" if engine in (None, "xla") else engine
    e_pl, fx_pl, fy_pl, fz_pl, cn_pl, *virial = _grid_d3_impl(
        grid, *planes, params, engine, block_g=block_g,
        feature_dtype=feature_dtype if engine == "window" else None,
        compute_virial=compute_virial, cell=cell)
    with span("d3.gather"):
        energy = e_pl.sum()
        f1, f2, f3, coord_num = gather_rows_from_grid(
            grid, (fx_pl, fy_pl, fz_pl, cn_pl))
        forces = torch.stack([f1, f2, f3], dim=-1)
    return (energy, forces, coord_num, *virial)


@spanned("d3")
def grid_dftd3_coulomb(
    grid: AtomGrid,
    numbers,
    charges,
    rcov,
    r4r2,
    c6ab,
    cn_ref_elem,
    cutoff: float,
    a1, a2, s8,
    coulomb_cutoff: float | None = None,
    alpha: float = 0.0,
    s6=1.0, k1=16.0, k3=-4.0,
    engine: str = "block",
    combine_forces: bool = False,
):
    """Fused DFT-D3(BJ) + real-space (erfc-damped) Coulomb on one sweep.

    The Coulomb pair terms ride the D3 direct pass's geometry: on the
    super-chunk sweep (``engine="block"``, kernel 8) or the per-cell sweep
    (``engine="window"``, kernel 1; the JAX package's ``"xla"`` engine runs
    it too), with the Coulomb pair's own cutoff
    (default: ``cutoff``) and ``alpha``.  Both cutoffs must be <= the
    cutoff the grid was built for.  ``combine_forces=True`` is the MD-step
    configuration: the window engine folds the Coulomb forces into the D3
    force channels inside the kernel (6 own + 5 j outputs instead of 9 +
    8); the block engine, like the JAX one, sums them afterwards.

    Returns ``(e_d3_total, f_d3 [N, 3], coord_num [N], e_coulomb [N],
    f_coulomb [N, 3])``; with ``combine_forces`` the force entry carries
    D3 + Coulomb and the trailing entry is ``None``.
    """
    _check_engine("grid_dftd3_coulomb", engine, ("block", "window", "xla"))
    engine = "window" if engine == "xla" else engine
    if coulomb_cutoff is None:
        coulomb_cutoff = cutoff
    _, _, planes, (q_plane,) = _d3_inputs(grid, numbers, rcov, r4r2, c6ab,
                                          cn_ref_elem, extra=(charges,))
    q = (q_plane, _extend_like(grid, q_plane, 0.0))
    in_kernel = combine_forces and engine == "window"
    params = SweepParams(cutoff=float(cutoff), a1=float(a1), a2=float(a2),
                         s6=float(s6), s8=float(s8), k1=float(k1),
                         k3=float(k3), alpha=float(alpha),
                         ccutoff=float(coulomb_cutoff),
                         combine_forces=in_kernel)
    e_pl, *f_planes = _grid_d3_impl(grid, *planes, params, engine, q=q)
    energy = e_pl.sum()
    if in_kernel:
        f1, f2, f3, coord_num, e_c = gather_rows_from_grid(grid, f_planes)
        return energy, torch.stack([f1, f2, f3], dim=-1), coord_num, e_c, None
    f1, f2, f3, coord_num, e_c, fc1, fc2, fc3 = gather_rows_from_grid(
        grid, f_planes)
    forces = torch.stack([f1, f2, f3], dim=-1)
    f_c = torch.stack([fc1, fc2, fc3], dim=-1)
    if combine_forces:
        return energy, forces + f_c, coord_num, e_c, None
    return energy, forces, coord_num, e_c, f_c


@spanned("d3")
def batch_grid_dftd3(positions, numbers, cells, pbc, cutoff: float, rcov,
                     r4r2, c6ab, cn_ref_elem, a1, a2, s8, s6=1.0, k1=16.0,
                     k3=-4.0, target_occupancy: float = 0.66,
                     cap: int | None = None, engine: str = "window"):
    """Batched DFT-D3(BJ) on one whole-batch halo grid.

    The systems share the grid geometry estimated from ``cells[0]``; the
    grid is built once for the batch (:func:`grid.batch_build_atom_grid`).
    On the window (the default, and ``engine="xla"``), block and pallas
    engines each D3 pass is one launch of the engine's kernel (1, 8 or 7)
    over every system (three launches a call for any B), and the folds,
    feature planes and per-system sums carry the system axis.
    ``engine="hybrid"`` raises, as the JAX function does: it needs a
    ``StencilGrid``, which this function does not take.
    ``positions [B, n, 3]``, ``numbers [B, n]`` (0 = padding atom),
    ``cells`` ``[3, 3]`` or ``[B, 3, 3]``; ``target_occupancy`` sizes the
    estimated slot capacity, and ``cap`` overrides it, as in the JAX
    package.  Returns ``(energy [B], forces [B, n, 3], cn [B, n])``.  The
    default engine is the window engine (the JAX package defaults to its
    xla engine here, which agrees with the window engine to f64 rounding).
    """
    _check_engine("batch_grid_dftd3", engine,
                  (None, "window", "xla", "block", "pallas", "hybrid"))
    if engine == "hybrid":
        raise ValueError("engine='hybrid' requires a StencilGrid (stencil=...)")
    n = positions.shape[1]
    cells_np = np.asarray(_np(cells), dtype=np.float64)
    dims, radius, cap_est = estimate_grid_geometry(
        cells_np if cells_np.ndim == 2 else cells_np[0], pbc, cutoff, n,
        target_occupancy=target_occupancy)
    g = batch_build_atom_grid(positions, cells, pbc, dims, radius,
                              cap_est if cap is None else cap)
    _, _, planes, _ = _d3_inputs(g, _np(numbers), rcov, r4r2, c6ab,
                                 cn_ref_elem)
    params = SweepParams(cutoff=float(cutoff), a1=float(a1), a2=float(a2),
                         s6=float(s6), s8=float(s8), k1=float(k1),
                         k3=float(k3))
    engine = "window" if engine in (None, "xla") else engine
    e_pl, fx_pl, fy_pl, fz_pl, cn_pl = _grid_d3_impl(g, *planes, params,
                                                     engine)
    with span("d3.gather"):
        f1, f2, f3, coord_num = gather_rows_from_grid(
            g, (fx_pl, fy_pl, fz_pl, cn_pl))
        return (e_pl.sum(dim=(1, 2, 3, 4)),
                torch.stack([f1, f2, f3], dim=-1), coord_num)

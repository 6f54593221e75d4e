# SPDX-License-Identifier: Apache-2.0
"""Cardinal B-splines, mesh spread/gather and deconvolution (counterpart
of ``nvalchemiops_tpu.spline``).

Orders 1-4 on ``[0, order)``; mesh parameter ``u = order/2 + theta -
offset`` as in the JAX package, so the order weights per axis sum to 1.
Fractional coordinates are ``s = r @ cell^-1`` (lattice vectors are cell
rows), mesh indices wrap periodically.

The dense path (``dense_spread_single``, ``dense_gather_single``,
``dense_gather_gradient_single``) takes an optional leading system axis in
place of the JAX package's ``vmap``: positions ``[B, N, 3]`` with cells
``[B, 3, 3]``.  Spread and gathers go through the separable-spline kernels
(kernels/separable_spline.py), which take the compact per-atom stencil.

The public spreads and gathers (scalar, multi-channel, vector field and
gradient) take the JAX package's routes: one system through the
tile-windowed path (kernel 3 for each spread; the value gathers in plain
torch, the gradient on kernel 2), or through the dense path (kernels 5 and
6, one call per channel or component) where a tile overflows or the mesh
does not suit the windows; concatenated systems (``batch_idx``) through
the scatter path: one ``index_add_`` over the ``order^3`` outer product
per atom and channel for the spread, indexing for the gathers, as the JAX
package runs them as XLA scatter and gather.

Every stencil takes its weights in the local forms of
:func:`_local_weights`; the expanded forms in ``u`` stay only in the
public :func:`bspline_weight` / :func:`bspline_derivative` and the
helpers built on them, which keep the JAX formulas.
"""

from __future__ import annotations

import math

import torch

from nvalchemiops_torch.kernels.separable_spline import (
    separable_gather,
    separable_spread,
)
from nvalchemiops_torch.mathops.math import apply_mat3_batched
from nvalchemiops_torch.types import INDEX_DTYPE, placed

__all__ = [
    "bspline_weight",
    "bspline_derivative",
    "compute_fractional_coords",
    "bspline_grid_offset",
    "bspline_weight_3d",
    "bspline_weight_gradient_3d",
    "wrap_grid_index",
    "dense_spread_single",
    "dense_gather_single",
    "dense_gather_gradient_single",
    "spline_spread",
    "spline_gather",
    "spline_gather_vec3",
    "spline_gather_gradient",
    "spline_spread_channels",
    "spline_gather_channels",
    "compute_bspline_deconvolution",
    "compute_bspline_deconvolution_1d",
]


def _piecewise(u, pieces):
    """``pieces[k]`` on ``[k, k+1)``, zero outside ``[0, len(pieces))``."""
    out = torch.zeros_like(u)
    for k in reversed(range(len(pieces))):
        out = torch.where((u >= k) & (u < k + 1), pieces[k], out)
    return out


def bspline_weight(u, order: int):
    """Cardinal B-spline basis M_order(u) on [0, order), vectorized."""
    if order == 1:
        return _piecewise(u, [torch.ones_like(u)])
    if order == 2:
        return _piecewise(u, [u, 2.0 - u])
    if order == 3:
        return _piecewise(u, [0.5 * u * u, 0.75 - (u - 1.5) * (u - 1.5),
                              0.5 * ((3.0 - u) * (3.0 - u))])
    if order == 4:
        return _piecewise(u, [
            u * u * u / 6.0,
            (-3.0 * (u * u * u) + 12.0 * (u * u) - 12.0 * u + 4.0) / 6.0,
            (3.0 * (u * u * u) - 24.0 * (u * u) + 60.0 * u - 44.0) / 6.0,
            (4.0 - u) * (4.0 - u) * (4.0 - u) / 6.0,
        ])
    raise ValueError(f"spline order must be 1-4, got {order}")


def bspline_derivative(u, order: int):
    """dM_order/du, vectorized."""
    if order == 1:
        return torch.zeros_like(u)
    if order == 2:
        return _piecewise(u, [torch.ones_like(u), -torch.ones_like(u)])
    if order == 3:
        return _piecewise(u, [u, -2.0 * (u - 1.5), -(3.0 - u)])
    if order == 4:
        return _piecewise(u, [
            0.5 * u * u,
            (-9.0 * (u * u) + 24.0 * u - 12.0) / 6.0,
            (9.0 * (u * u) - 48.0 * u + 60.0) / 6.0,
            -0.5 * ((4.0 - u) * (4.0 - u)),
        ])
    raise ValueError(f"spline order must be 1-4, got {order}")


def _local_weights(theta, order: int):
    """Stencil weights and derivatives ``[.., order]`` of fractional mesh
    offsets ``theta`` in ``[0, 1)``, for the stencil of :func:`_stencil`
    (point ``i`` takes piece ``order - 1 - i`` of the basis at the same
    local coordinate ``t``: ``theta`` for even orders, ``theta -/+ 1/2``
    for order 3).

    Equal to :func:`bspline_weight` / :func:`bspline_derivative` at
    ``u = order/2 + theta - offset``, but written as polynomials in ``t``:
    the forms in ``u`` cancel terms of up to ~200 against weights below
    1, which in f32 costs them ~2e-6, while these lose nothing beyond the
    rounding of ``theta``.
    """
    t = theta[..., None]
    if order == 1:
        return torch.ones_like(t), torch.zeros_like(t)
    if order == 2:
        return (torch.cat([1.0 - t, t], -1),
                torch.cat([-torch.ones_like(t), torch.ones_like(t)], -1))
    if order == 3:
        # centred on the nearest mesh point: s = theta - 1/2 or + 1/2
        s = torch.where(t < 0.5, t + 0.5, t - 0.5)
        w = torch.cat([0.5 * (1.0 - s) * (1.0 - s),
                       0.75 - (s - 0.5) * (s - 0.5), 0.5 * s * s], -1)
        dw = torch.cat([-(1.0 - s), -2.0 * (s - 0.5), s], -1)
        return w, dw
    if order == 4:
        w = torch.cat([(1.0 - t) * (1.0 - t) * (1.0 - t) / 6.0,
                       ((3.0 * t - 6.0) * t * t + 4.0) / 6.0,
                       (((-3.0 * t + 3.0) * t + 3.0) * t + 1.0) / 6.0,
                       t * t * t / 6.0], -1)
        dw = torch.cat([-0.5 * ((1.0 - t) * (1.0 - t)),
                        (3.0 * t - 4.0) * t / 2.0,
                        ((-3.0 * t + 2.0) * t + 1.0) / 2.0,
                        0.5 * t * t], -1)
        return w, dw
    raise ValueError(f"spline order must be 1-4, got {order}")


# ---------------------------------------------------------------------------
# Low-level stencil helpers (the JAX package's public building blocks)
# ---------------------------------------------------------------------------


def compute_fractional_coords(positions, cell, mesh_dims, batch_idx=None,
                              device="cuda"):
    """Mesh coordinates of each atom: ``(base_grid, theta)``, the floor of
    the mesh-scaled fractional coordinate as int32 ``[.., 3]`` and its
    remainder in ``[0, 1)`` in the dtype of ``positions``; on the device of
    ``positions`` (or of ``cell``) where it is a tensor, else on
    ``device``."""
    positions, cell = placed((positions, cell), device)
    frac, _ = _cell_inverse_per_atom(positions, cell, batch_idx)
    mesh_coords = frac * torch.tensor([float(d) for d in mesh_dims],
                                      dtype=positions.dtype,
                                      device=positions.device)
    base = torch.floor(mesh_coords)
    return base.to(INDEX_DTYPE), mesh_coords - base


def bspline_grid_offset(point_idx, order: int, theta, device="cuda"):
    """Grid offset ``[.., 3]`` (int32) of linear stencil point(s)
    ``point_idx`` of the ``order**3`` cube, including the ``floor(theta -
    (order-2)/2)`` start shift that keeps ``u`` inside ``[0, order)``; on
    the device of a tensor input, else on ``device``."""
    theta, point_idx = placed((theta, point_idx), device)
    point_idx = point_idx.to(INDEX_DTYPE)
    i = torch.div(point_idx, order * order, rounding_mode="floor")
    j = torch.div(torch.remainder(point_idx, order * order), order,
                  rounding_mode="floor")
    k = torch.remainder(point_idx, order)
    ijk = torch.stack(torch.broadcast_tensors(i, j, k), dim=-1)
    start = torch.floor(theta - 0.5 * (order - 2)).to(INDEX_DTYPE)
    return ijk + start


def _spline_u(theta, offset, order: int, device):
    theta, offset = placed((theta, offset), device)
    return 0.5 * order + theta - offset.to(theta.dtype)


def bspline_weight_3d(theta, offset, order: int, device="cuda"):
    """Separable 3-D weight ``M(u_x) M(u_y) M(u_z)``; zero outside ``u in
    [0, order)``.  On the device of a tensor input, else on ``device``."""
    u = _spline_u(theta, offset, order, device)
    return (bspline_weight(u[..., 0], order)
            * bspline_weight(u[..., 1], order)
            * bspline_weight(u[..., 2], order))


def bspline_weight_gradient_3d(theta, offset, order: int, mesh_dims,
                               device="cuda"):
    """Gradient ``[.., 3]`` of :func:`bspline_weight_3d` with respect to
    ``theta``, scaled by ``mesh_dims``."""
    u = _spline_u(theta, offset, order, device)
    dims = [float(d) for d in mesh_dims]
    wx, wy, wz = (bspline_weight(u[..., d], order) for d in range(3))
    dwx, dwy, dwz = (bspline_derivative(u[..., d], order) * dims[d]
                     for d in range(3))
    return torch.stack([dwx * wy * wz, wx * dwy * wz, wx * wy * dwz], dim=-1)


def wrap_grid_index(idx, dim, device="cuda"):
    """Periodic grid-index wrap into ``[0, dim)`` (int32); on the device of
    a tensor input, else on ``device``."""
    idx, dim = placed((idx, dim), device)
    return torch.remainder(idx.to(INDEX_DTYPE), dim.to(INDEX_DTYPE))


# ---------------------------------------------------------------------------
# Separable stencil and the dense path
# ---------------------------------------------------------------------------


def _cell_inverse_per_atom(positions, cell, batch_idx=None):
    """Fractional coordinates ``s = r @ cell^-1`` and the inverse cell.

    ``positions [.., N, 3]`` with ``cell [.., 3, 3]``; or concatenated
    systems ``positions [N, 3]`` with ``cell [B, 3, 3]`` and ``batch_idx
    [N]``, each atom through its own system's inverse (the inverse comes
    back ``[B, 3, 3]``)."""
    cell = torch.as_tensor(cell, dtype=positions.dtype,
                           device=positions.device)
    if batch_idx is not None:
        inv = torch.linalg.inv(cell.reshape(-1, 3, 3))
        if inv.shape[0] > 1:
            inv_a = inv[torch.as_tensor(batch_idx,
                                        device=positions.device).long()]
            frac = sum(positions[:, d:d + 1] * inv_a[:, d] for d in range(3))
            return frac, inv
        return apply_mat3_batched(positions, inv[0]), inv
    inv = torch.linalg.inv(cell.reshape(positions.shape[:-2] + (3, 3)))
    return apply_mat3_batched(positions, inv), inv


def _stencil(positions, cell, mesh_dims, order: int, batch_idx=None):
    """Per-atom separable stencil.

    Returns ``(gidx [.., N, 3, order]`` wrapped int32 indices, ``w`` the
    weights, ``dw`` the derivative weights scaled by the mesh dims, ``inv``
    the inverse cell ``[.., 3, 3])``; ``batch_idx`` as in
    :func:`_cell_inverse_per_atom`.  The weights are the local forms of
    :func:`_local_weights`, as the tile-windowed path computes them, so
    the dense, windowed and scatter paths round alike in f32.
    """
    dtype = positions.dtype
    dims = torch.tensor([int(d) for d in mesh_dims], dtype=INDEX_DTYPE,
                        device=positions.device)
    frac, inv = _cell_inverse_per_atom(positions, cell, batch_idx)
    mesh_coord = frac * dims.to(dtype)
    base_f = torch.floor(mesh_coord)
    theta = mesh_coord - base_f
    base = base_f.to(INDEX_DTYPE)
    i = torch.arange(order, dtype=INDEX_DTYPE, device=positions.device)
    offset_start = torch.floor(theta - (order - 2) * 0.5).to(INDEX_DTYPE)
    offset = i + offset_start[..., None]                      # [.., N, 3, o]
    w, dw = _local_weights(theta, order)
    dw = dw * dims.to(dtype)[:, None]
    gidx = torch.remainder(base[..., None] + offset, dims[:, None])
    return gidx.to(INDEX_DTYPE).contiguous(), w.contiguous(), \
        dw.contiguous(), inv


def _flat_indices(gidx, mesh_dims, batch_idx, num_systems: int):
    """Flattened ``order^3`` mesh indices per atom ``[N, order^3]``
    (int64), offset by each atom's system mesh when batched."""
    nx, ny, nz = (int(d) for d in mesh_dims)
    g = gidx.long()
    flat = ((g[:, 0, :, None, None] * ny + g[:, 1, None, :, None]) * nz
            + g[:, 2, None, None, :])
    flat = flat.reshape(gidx.shape[0], -1)
    if batch_idx is not None and num_systems > 1:
        flat = flat + batch_idx.long()[:, None] * (nx * ny * nz)
    return flat


def _outer3(a, b, c):
    """``[N, o^3]`` products ``a_i b_j c_k`` of three ``[N, o]`` factors."""
    return (a[:, :, None, None] * b[:, None, :, None]
            * c[:, None, None, :]).reshape(a.shape[0], -1)


def _batched(positions):
    """``positions`` with a leading system axis, and whether one was added."""
    single = positions.dim() == 2
    return (positions[None] if single else positions), single


def _dense_spread(pos_b, planes, cell, mesh_dims, order: int):
    """Spread each per-atom plane (``[B, N]`` values) with one stencil of
    ``pos_b [B, N, 3]``: a list of ``[B, nx, ny, nz]`` meshes, one kernel
    launch per plane."""
    gidx, w, _, _ = _stencil(pos_b, cell, mesh_dims, order)
    return [separable_spread(gidx, w, v.reshape(pos_b.shape[:2]).to(
        w.dtype).contiguous(), mesh_dims) for v in planes]


def _dense_gather(pos_b, planes, cell, order: int):
    """Interpolate each ``[B, nx, ny, nz]`` mesh plane at ``pos_b [B, N,
    3]`` with one stencil: a list of ``[B, N]``, one kernel launch per
    plane."""
    dims = tuple(planes[0].shape[-3:])
    gidx, w, _, _ = _stencil(pos_b, cell, dims, order)
    return [separable_gather(p.reshape((pos_b.shape[0],) + dims).contiguous(),
                             gidx, w) for p in planes]


def dense_spread_single(positions, values, cell, mesh_dims,
                        spline_order: int = 4):
    """``mesh[x, y, z] = sum_n values[n] Sx[n, x] Sy[n, y] Sz[n, z]``:
    ``[nx, ny, nz]``, or ``[B, nx, ny, nz]`` for ``[B, N, 3]`` positions."""
    pos_b, single = _batched(positions)
    mesh, = _dense_spread(pos_b, [values], cell, mesh_dims, spline_order)
    return mesh[0] if single else mesh


def dense_gather_single(positions, mesh, cell, spline_order: int = 4):
    """Interpolate ``mesh`` at the atoms: ``[N]`` or ``[B, N]``."""
    pos_b, single = _batched(positions)
    val, = _dense_gather(pos_b, [mesh], cell, spline_order)
    return val[0] if single else val


def dense_gather_gradient_single(positions, charges, mesh, cell,
                                 spline_order: int = 4):
    """Forces ``F = -q sum_g mesh(g) grad w`` (the convention of the JAX
    package's ``spline_gather_gradient``): ``[N, 3]`` or ``[B, N, 3]``."""
    pos_b, single = _batched(positions)
    gidx, w, dw, inv = _stencil(pos_b, cell, tuple(mesh.shape[-3:]),
                                spline_order)
    mesh_b = mesh.reshape((pos_b.shape[0],) + tuple(mesh.shape[-3:]))
    _, grad = separable_gather(mesh_b.contiguous(), gidx, w, dw)
    q = charges.reshape(pos_b.shape[:2])
    forces = apply_mat3_batched(-q[..., None] * grad, inv.transpose(-1, -2))
    return forces[0] if single else forces


# ---------------------------------------------------------------------------
# Public spread / gather
# ---------------------------------------------------------------------------


def _num_systems(cell, batch_idx) -> int:
    """Systems of a call: a batched cell's count, else 1 without
    ``batch_idx``, else ``max(batch_idx) + 1`` (one scalar read)."""
    if isinstance(cell, torch.Tensor) and cell.dim() == 3 \
            and cell.shape[0] > 1:
        return cell.shape[0]
    if batch_idx is None:
        return 1
    return int(batch_idx.max()) + 1


def _single_tiles(positions, cell, mesh_dims, order: int, need_grad: bool):
    """The windowed route's tiles for one system, or None where the mesh
    does not suit the windows or a tile overflows its capacity (one read
    of the largest tile occupancy)."""
    from nvalchemiops_torch import spline_windowed as sw

    if not sw.windowed_applicable(mesh_dims, order):
        return None
    cap = sw.mesh_tile_capacity(positions.shape[0], mesh_dims)
    tiles = sw.build_mesh_tiles(positions, cell, mesh_dims, order, cap,
                                need_grad=need_grad)
    return tiles if int(tiles.counts_max) <= cap else None


def _cell_of(positions, cell):
    return torch.as_tensor(cell, dtype=positions.dtype,
                           device=positions.device)


def _spread_impl(positions, values, cell, batch_idx, mesh_dims,
                 spline_order: int, channels: bool):
    """The spread routes of the JAX package's ``_spread_impl``: ``values
    [N]`` (``[N, C]`` with ``channels``) onto ``[nx, ny, nz]`` (``[C, nx,
    ny, nz]``) for one system, ``[B, nx, ny, nz]`` (``[B, C, nx, ny, nz]``)
    for concatenated ones."""
    from nvalchemiops_torch import spline_windowed as sw

    mesh_dims = tuple(int(d) for d in mesh_dims)
    cell = _cell_of(positions, cell)
    ns = _num_systems(cell, batch_idx)
    planes = ([values[:, c] for c in range(values.shape[1])] if channels
              else [values])
    if batch_idx is None and ns == 1:
        cell1 = cell.reshape(3, 3)
        tiles = _single_tiles(positions, cell1, mesh_dims, spline_order,
                              False)
        if tiles is not None:
            meshes = [sw.windowed_spread(tiles, v.contiguous())
                      for v in planes]
        else:
            meshes = [m[0] for m in _dense_spread(positions[None], planes,
                                                  cell1, mesh_dims,
                                                  spline_order)]
        return torch.stack(meshes) if channels else meshes[0]
    b_of = None if batch_idx is None else torch.as_tensor(
        batch_idx, device=positions.device)
    gidx, w, _, _ = _stencil(positions, cell, mesh_dims, spline_order, b_of)
    flat = _flat_indices(gidx, mesh_dims, b_of, ns).reshape(-1)
    wxyz = _outer3(w[:, 0], w[:, 1], w[:, 2])
    meshes = []
    for v in planes:
        mesh = torch.zeros(ns * math.prod(mesh_dims), dtype=positions.dtype,
                           device=positions.device)
        mesh.index_add_(0, flat, (v[:, None] * wxyz).reshape(-1))
        meshes.append(mesh.reshape((ns,) + mesh_dims))
    mesh = torch.stack(meshes, dim=1) if channels else meshes[0]
    return mesh[0] if ns == 1 and batch_idx is None else mesh


def spline_spread(positions, values, cell, mesh_dims, spline_order: int = 4,
                  batch_idx=None, cell_inv_t=None):
    """Spread per-atom values onto a periodic mesh: ``[nx, ny, nz]`` for
    one system, ``[B, nx, ny, nz]`` with ``batch_idx``.  ``cell_inv_t`` is
    accepted and unused (the inverse is computed), as in the JAX package.
    """
    del cell_inv_t
    return _spread_impl(positions, values, cell, batch_idx, mesh_dims,
                        spline_order, False)


def spline_spread_channels(positions, values, cell, mesh_dims,
                           spline_order: int = 4, batch_idx=None):
    """Multi-channel spread of ``values [N, C]``: ``[C, nx, ny, nz]`` for
    one system, ``[B, C, nx, ny, nz]`` with ``batch_idx``; each channel is
    the spread of :func:`spline_spread` (one kernel launch per channel)."""
    return _spread_impl(positions, values, cell, batch_idx, mesh_dims,
                        spline_order, True)


def _gather_impl(positions, mesh, charges, cell, batch_idx,
                 spline_order: int, mode: str):
    """The gather routes of the JAX package's ``_gather_impl``.  ``mode``:
    ``"scalar"`` (``[N]``), ``"vec3"`` (``q`` times the interpolated
    ``[.., nx, ny, nz, 3]`` field, ``[N, 3]``), ``"channels"`` (``[.., C,
    nx, ny, nz]`` -> ``[N, C]``) or ``"gradient"`` (forces ``-q sum_g
    mesh(g) grad w`` rotated to Cartesian, ``[N, 3]``)."""
    from nvalchemiops_torch import spline_windowed as sw

    cell = _cell_of(positions, cell)
    ns = _num_systems(cell, batch_idx)
    o = spline_order
    if batch_idx is None and ns == 1:
        cell1 = cell.reshape(3, 3)
        if mode == "vec3":
            dims = tuple(mesh.shape[0:3])
            planes = [mesh[..., c] for c in range(3)]
        elif mode == "channels":
            dims = tuple(mesh.shape[1:4] if mesh.dim() == 4
                         else mesh.shape[0:3])
            planes = [mesh[c] for c in range(mesh.shape[0])]
        else:
            dims = tuple(mesh.shape[-3:])
            planes = [mesh]
        tiles = _single_tiles(positions, cell1, dims, o, mode == "gradient")
        if tiles is not None:
            if mode == "gradient":
                _vals, g = sw.windowed_gather(tiles, mesh, with_gradient=True)
                return apply_mat3_batched(-charges[:, None] * g, tiles.inv.T)
            cols = [sw.windowed_gather(tiles, p) for p in planes]
        elif mode == "gradient":
            return dense_gather_gradient_single(positions, charges, mesh,
                                                cell1, o)
        else:
            cols = [c[0] for c in _dense_gather(positions[None], planes,
                                                cell1, o)]
        if mode == "scalar":
            return cols[0]
        if mode == "vec3":
            cols = [charges * c for c in cols]
        return torch.stack(cols, dim=-1)

    if mode == "channels":
        mesh_b = mesh if mesh.dim() == 5 else mesh[None]  # [B, C, nx, ny, nz]
        dims = tuple(mesh_b.shape[2:5])
        planes = [mesh_b[:, c].reshape(-1) for c in range(mesh_b.shape[1])]
    elif mode == "vec3":
        mesh_b = mesh if mesh.dim() == 5 else mesh[None]  # [B, nx, ny, nz, 3]
        dims = tuple(mesh_b.shape[1:4])
        planes = [mesh_b[..., c].reshape(-1) for c in range(3)]
    else:
        mesh_b = mesh if mesh.dim() == 4 else mesh[None]  # [B, nx, ny, nz]
        dims = tuple(mesh_b.shape[1:4])
        planes = [mesh_b.reshape(-1)]
    b_of = None if batch_idx is None else torch.as_tensor(
        batch_idx, device=positions.device)
    gidx, w, dw, inv = _stencil(positions, cell, dims, o, b_of)
    flat = _flat_indices(gidx, dims, b_of, ns)
    wxyz = _outer3(w[:, 0], w[:, 1], w[:, 2])
    if mode != "gradient":
        cols = [(p[flat] * wxyz).sum(1) for p in planes]
        if mode == "scalar":
            return cols[0]
        if mode == "vec3":
            cols = [charges * c for c in cols]
        return torch.stack(cols, dim=-1)
    vals = planes[0][flat]                                    # [N, o^3]
    f_frac = -charges[:, None] * torch.stack([
        (vals * _outer3(dw[:, 0], w[:, 1], w[:, 2])).sum(1),
        (vals * _outer3(w[:, 0], dw[:, 1], w[:, 2])).sum(1),
        (vals * _outer3(w[:, 0], w[:, 1], dw[:, 2])).sum(1)], dim=-1)
    if b_of is not None and inv.shape[0] > 1:
        inv_a = inv[b_of.long()]
        return sum(f_frac[:, d:d + 1] * inv_a[:, :, d] for d in range(3))
    return apply_mat3_batched(f_frac, inv.reshape(-1, 3, 3)[0].T)


def spline_gather(positions, mesh, cell, spline_order: int = 4,
                  batch_idx=None, cell_inv_t=None):
    """Interpolate the mesh at the atoms ``[N]`` (``mesh [B, nx, ny, nz]``
    with ``batch_idx``)."""
    del cell_inv_t
    return _gather_impl(positions, mesh, None, cell, batch_idx,
                        spline_order, "scalar")


def spline_gather_vec3(positions, charges, mesh, cell, spline_order: int = 4,
                       batch_idx=None, cell_inv_t=None):
    """Charge-weighted vector-field interpolation: ``q_i`` times the
    ``[nx, ny, nz, 3]`` field (``[B, nx, ny, nz, 3]`` with ``batch_idx``)
    at atom ``i``, ``[N, 3]``."""
    del cell_inv_t
    return _gather_impl(positions, mesh, charges, cell, batch_idx,
                        spline_order, "vec3")


def spline_gather_gradient(positions, charges, mesh, cell,
                           spline_order: int = 4, batch_idx=None,
                           cell_inv_t=None):
    """Forces ``F_i = -q_i sum_g phi(g) grad w`` ``[N, 3]``."""
    del cell_inv_t
    return _gather_impl(positions, mesh, charges, cell, batch_idx,
                        spline_order, "gradient")


def spline_gather_channels(positions, mesh, cell, spline_order: int = 4,
                           batch_idx=None):
    """Multi-channel interpolation of ``mesh [C, nx, ny, nz]`` (``[B, C,
    nx, ny, nz]`` with ``batch_idx``): ``[N, C]``."""
    return _gather_impl(positions, mesh, None, cell, batch_idx,
                        spline_order, "channels")


# ---------------------------------------------------------------------------
# Deconvolution
# ---------------------------------------------------------------------------

#: the cardinal B-spline at the integers, per order
_BSPLINE_INTEGER_VALUES = {
    1: [1.0],
    2: [0.5, 0.5],
    3: [1 / 6, 4 / 6, 1 / 6],
    4: [1 / 24, 11 / 24, 11 / 24, 1 / 24],
    5: [1 / 120, 26 / 120, 66 / 120, 26 / 120, 1 / 120],
}


def _bspline_modulus_sq(k, n: int, order: int):
    """|b(k)|^2 of the cardinal B-spline (Essmann et al. 1995, Eq. 4.7)."""
    m_vals = _BSPLINE_INTEGER_VALUES[order]
    w = 2.0 * math.pi * k / n
    b_re = sum(m_vals[j] * torch.cos(w * j) for j in range(order))
    b_im = sum(m_vals[j] * torch.sin(w * j) for j in range(order))
    b_sq = b_re ** 2 + b_im ** 2
    return torch.where(k == 0, torch.ones_like(b_sq), b_sq)


def _fft_k(n: int, dtype, device):
    return torch.fft.fftfreq(n, dtype=dtype, device=device) * n


def compute_bspline_deconvolution_1d(n: int, spline_order: int = 4,
                                     dtype=torch.float64, device="cuda"):
    """1-D deconvolution factors ``1/|b(k)|^2`` on the full FFT grid
    (``dtype`` / ``device`` of the result)."""
    k = _fft_k(int(n), dtype, device)
    return 1.0 / torch.clamp(_bspline_modulus_sq(k, int(n), spline_order),
                             min=1e-15)


def compute_bspline_deconvolution(mesh_dims, spline_order: int = 4,
                                  dtype=torch.float64, device="cuda"):
    """Separable 3-D deconvolution ``1/(|bx|^2 |by|^2 |bz|^2)`` on the
    ``fftn`` grid; multiply with ``fftn(mesh)`` to undo the B-spline
    smoothing."""
    nx, ny, nz = (int(d) for d in mesh_dims)
    bx, by, bz = (_bspline_modulus_sq(_fft_k(d, dtype, device), d,
                                      spline_order) for d in (nx, ny, nz))
    b3 = bx[:, None, None] * by[None, :, None] * bz[None, None, :]
    return 1.0 / torch.clamp(b3, min=1e-15)

# SPDX-License-Identifier: Apache-2.0
"""Cardinal B-splines and the dense separable spread/gather (counterpart
of ``nvalchemiops_tpu.spline``: the basis and the single-system dense
path).

Orders 1-4 on ``[0, order)``; mesh parameter ``u = order/2 + theta -
offset`` as in the JAX package, so the order weights per axis sum to 1.
Fractional coordinates are ``s = r @ cell^-1`` (lattice vectors are cell
rows), mesh indices wrap periodically.

The dense path (``dense_spread_single``, ``dense_gather_single``,
``dense_gather_gradient_single``) takes an optional leading system axis in
place of the JAX package's ``vmap``: positions ``[B, N, 3]`` with cells
``[B, 3, 3]``.  Spread and gathers go through the separable-spline kernels
(kernels/separable_spline.py), which take the compact per-atom stencil.

The public ``spline_spread`` / ``spline_gather`` / ``spline_gather_gradient``
take one system through the tile-windowed path (the dense path where a
tile overflows or the mesh does not suit the windows), and concatenated
systems with ``batch_idx`` through the scatter path: one ``index_add_``
over the ``order^3`` outer product per atom for the spread, indexing for
the gathers, as the JAX package runs them as XLA scatter and gather.
"""

from __future__ import annotations

import math

import torch

from nvalchemiops_torch.kernels.separable_spline import (
    separable_gather,
    separable_spread,
)
from nvalchemiops_torch.mathops.math import apply_mat3_batched
from nvalchemiops_torch.types import INDEX_DTYPE

__all__ = ["bspline_weight", "bspline_derivative", "dense_spread_single",
           "dense_gather_single", "dense_gather_gradient_single",
           "spline_spread", "spline_gather", "spline_gather_gradient"]


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
            inv_a = inv[batch_idx.long()]
            frac = sum(positions[:, d:d + 1] * inv_a[:, d] for d in range(3))
            return frac, inv
        return apply_mat3_batched(positions, inv[0]), inv
    inv = torch.linalg.inv(cell.reshape(positions.shape[:-2] + (3, 3)))
    return apply_mat3_batched(positions, inv), inv


def _stencil(positions, cell, mesh_dims, order: int, batch_idx=None,
             local_weights: bool = False):
    """Per-atom separable stencil.

    Returns ``(gidx [.., N, 3, order]`` wrapped int32 indices, ``w`` the
    weights, ``dw`` the derivative weights scaled by the mesh dims, ``inv``
    the inverse cell ``[.., 3, 3])``; ``batch_idx`` as in
    :func:`_cell_inverse_per_atom`.  The weights are the basis functions'
    expanded forms, as the tile-windowed path computes them (so the dense
    and windowed engines round alike in f32), or with ``local_weights``
    the better-conditioned forms of :func:`_local_weights` (the scatter
    path of ``batch_idx``).
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
    if local_weights:
        w, dw = _local_weights(theta, order)
    else:
        u = order * 0.5 + theta[..., None] - offset.to(dtype)
        w, dw = bspline_weight(u, order), bspline_derivative(u, order)
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


def dense_spread_single(positions, values, cell, mesh_dims,
                        spline_order: int = 4):
    """``mesh[x, y, z] = sum_n values[n] Sx[n, x] Sy[n, y] Sz[n, z]``:
    ``[nx, ny, nz]``, or ``[B, nx, ny, nz]`` for ``[B, N, 3]`` positions."""
    pos_b, single = _batched(positions)
    gidx, w, _, _ = _stencil(pos_b, cell, mesh_dims, spline_order)
    vals = values.reshape(pos_b.shape[:2]).to(w.dtype).contiguous()
    mesh = separable_spread(gidx, w, vals, mesh_dims)
    return mesh[0] if single else mesh


def dense_gather_single(positions, mesh, cell, spline_order: int = 4):
    """Interpolate ``mesh`` at the atoms: ``[N]`` or ``[B, N]``."""
    pos_b, single = _batched(positions)
    gidx, w, _, _ = _stencil(pos_b, cell, tuple(mesh.shape[-3:]),
                             spline_order)
    mesh_b = mesh.reshape((pos_b.shape[0],) + tuple(mesh.shape[-3:]))
    val = separable_gather(mesh_b.contiguous(), gidx, w)
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


def spline_spread(positions, values, cell, mesh_dims, spline_order: int = 4,
                  batch_idx=None, cell_inv_t=None):
    """Spread per-atom values onto a periodic mesh: ``[nx, ny, nz]`` for
    one system, ``[B, nx, ny, nz]`` with ``batch_idx``.  ``cell_inv_t`` is
    accepted and unused (the inverse is computed), as in the JAX package.
    """
    del cell_inv_t
    from nvalchemiops_torch import spline_windowed as sw

    mesh_dims = tuple(int(d) for d in mesh_dims)
    cell = _cell_of(positions, cell)
    ns = _num_systems(cell, batch_idx)
    if batch_idx is None and ns == 1:
        cell1 = cell.reshape(3, 3)
        tiles = _single_tiles(positions, cell1, mesh_dims, spline_order,
                              False)
        if tiles is not None:
            return sw.windowed_spread(tiles, values)
        return dense_spread_single(positions, values, cell1, mesh_dims,
                                   spline_order)
    gidx, w, _, _ = _stencil(positions, cell, mesh_dims, spline_order,
                             batch_idx, local_weights=True)
    flat = _flat_indices(gidx, mesh_dims, batch_idx, ns)
    contrib = values[:, None] * _outer3(w[:, 0], w[:, 1], w[:, 2])
    mesh = torch.zeros(ns * math.prod(mesh_dims), dtype=positions.dtype,
                       device=positions.device)
    mesh.index_add_(0, flat.reshape(-1), contrib.reshape(-1))
    mesh = mesh.reshape((ns,) + mesh_dims)
    return mesh[0] if ns == 1 and batch_idx is None else mesh


def _gather(positions, mesh, charges, cell, batch_idx, spline_order: int,
            gradient: bool):
    """Scalar interpolation, or forces ``-q sum_g mesh(g) grad w`` rotated
    to Cartesian (``gradient``)."""
    from nvalchemiops_torch import spline_windowed as sw

    cell = _cell_of(positions, cell)
    ns = _num_systems(cell, batch_idx)
    o = spline_order
    if batch_idx is None and ns == 1:
        cell1 = cell.reshape(3, 3)
        dims = tuple(mesh.shape[-3:])
        tiles = _single_tiles(positions, cell1, dims, o, gradient)
        if tiles is None:
            if gradient:
                return dense_gather_gradient_single(positions, charges, mesh,
                                                    cell1, o)
            return dense_gather_single(positions, mesh, cell1, o)
        if not gradient:
            return sw.windowed_gather(tiles, mesh)
        _vals, g = sw.windowed_gather(tiles, mesh, with_gradient=True)
        return apply_mat3_batched(-charges[:, None] * g, tiles.inv.T)

    mesh_b = mesh if mesh.dim() == 4 else mesh[None]
    dims = tuple(mesh_b.shape[1:4])
    gidx, w, dw, inv = _stencil(positions, cell, dims, o, batch_idx,
                                local_weights=True)
    flat = _flat_indices(gidx, dims, batch_idx, ns)
    vals = mesh_b.reshape(-1)[flat]                           # [N, o^3]
    if not gradient:
        return (vals * _outer3(w[:, 0], w[:, 1], w[:, 2])).sum(1)
    f_frac = -charges[:, None] * torch.stack([
        (vals * _outer3(dw[:, 0], w[:, 1], w[:, 2])).sum(1),
        (vals * _outer3(w[:, 0], dw[:, 1], w[:, 2])).sum(1),
        (vals * _outer3(w[:, 0], w[:, 1], dw[:, 2])).sum(1)], dim=-1)
    if batch_idx is not None and inv.shape[0] > 1:
        inv_a = inv[batch_idx.long()]
        return sum(f_frac[:, d:d + 1] * inv_a[:, :, d] for d in range(3))
    return apply_mat3_batched(f_frac, inv[0].T)


def spline_gather(positions, mesh, cell, spline_order: int = 4,
                  batch_idx=None, cell_inv_t=None):
    """Interpolate the mesh at the atoms ``[N]`` (``mesh [B, nx, ny, nz]``
    with ``batch_idx``)."""
    del cell_inv_t
    return _gather(positions, mesh, None, cell, batch_idx, spline_order,
                   False)


def spline_gather_gradient(positions, charges, mesh, cell,
                           spline_order: int = 4, batch_idx=None,
                           cell_inv_t=None):
    """Forces ``F_i = -q_i sum_g phi(g) grad w`` ``[N, 3]``."""
    del cell_inv_t
    return _gather(positions, mesh, charges, cell, batch_idx, spline_order,
                   True)

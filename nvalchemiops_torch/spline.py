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
The scatter-add paths with ``batch_idx`` are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import torch

from nvalchemiops_torch.kernels.separable_spline import (
    separable_gather,
    separable_spread,
)
from nvalchemiops_torch.mathops.math import apply_mat3_batched
from nvalchemiops_torch.types import INDEX_DTYPE

__all__ = ["bspline_weight", "bspline_derivative", "dense_spread_single",
           "dense_gather_single", "dense_gather_gradient_single"]


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


# ---------------------------------------------------------------------------
# Separable stencil and the dense path
# ---------------------------------------------------------------------------


def _cell_inverse_per_atom(positions, cell):
    """Fractional coordinates ``s = r @ cell^-1`` and the inverse cell
    (``positions [.., N, 3]``, ``cell [.., 3, 3]``)."""
    cell = torch.as_tensor(cell, dtype=positions.dtype,
                           device=positions.device)
    inv = torch.linalg.inv(cell.reshape(positions.shape[:-2] + (3, 3)))
    return apply_mat3_batched(positions, inv), inv


def _stencil(positions, cell, mesh_dims, order: int):
    """Per-atom separable stencil.

    Returns ``(gidx [.., N, 3, order]`` wrapped int32 indices, ``w`` the
    weights, ``dw`` the derivative weights scaled by the mesh dims, ``inv``
    the inverse cell ``[.., 3, 3])``.
    """
    dtype = positions.dtype
    dims = torch.tensor([int(d) for d in mesh_dims], dtype=INDEX_DTYPE,
                        device=positions.device)
    frac, inv = _cell_inverse_per_atom(positions, cell)
    mesh_coord = frac * dims.to(dtype)
    base_f = torch.floor(mesh_coord)
    theta = mesh_coord - base_f
    base = base_f.to(INDEX_DTYPE)
    i = torch.arange(order, dtype=INDEX_DTYPE, device=positions.device)
    offset_start = torch.floor(theta - (order - 2) * 0.5).to(INDEX_DTYPE)
    offset = i + offset_start[..., None]                      # [.., N, 3, o]
    u = order * 0.5 + theta[..., None] - offset.to(dtype)
    w = bspline_weight(u, order)
    dw = bspline_derivative(u, order) * dims.to(dtype)[:, None]
    gidx = torch.remainder(base[..., None] + offset, dims[:, None])
    return gidx.to(INDEX_DTYPE).contiguous(), w.contiguous(), \
        dw.contiguous(), inv


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

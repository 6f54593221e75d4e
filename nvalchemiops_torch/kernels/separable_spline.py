# SPDX-License-Identifier: Apache-2.0
"""Dense separable B-spline spread and gather (csrc/separable_spline.cu).

Counterparts of ``nvalchemiops_tpu/pallas/spread.py``:

- :func:`separable_spread` (``pallas_separable_spread``): ``mesh[b, x, y,
  z] = sum_n q[b, n] Sx[b, n, x] Sy[b, n, y] Sz[b, n, z]``;
- :func:`separable_gather` (``pallas_separable_gather``): ``val[b, n] =
  sum_xyz mesh[b, x, y, z] Sx Sy Sz``, and with derivative weights also the
  fractional gradient ``grad[b, n, d]``, the same sum with the axis-d
  weights swapped for their derivatives.

The JAX kernels take the dense axis matrices ``S_d [N, n_d]`` that feed the
TPU's matrix unit.  Each row of one is the one-hot expansion of the
compact stencil (``spline.py:284-289``), so these take the stencil itself:
``gidx [B, N, 3, order]`` (wrapped mesh indices, int32) and ``w`` (``dw``)
``[B, N, 3, order]``.  The plain versions build the dense matrices
(:func:`axis_weight_matrix`) and contract them in atom chunks, as the JAX
package's ``_separable_spread`` / ``_separable_gather`` do.
"""

from __future__ import annotations

import torch

from nvalchemiops_torch.kernels import launch_counts
from nvalchemiops_torch.kernels.build import (
    check_cuda_tensors, check_launch, current_stream, load_library,
)
from nvalchemiops_torch.types import INDEX_DTYPE

__all__ = ["axis_weight_matrix", "separable_spread", "separable_spread_plain",
           "separable_gather", "separable_gather_plain"]

_CHUNK = 2048   # atoms per contraction of the plain versions, as in JAX


def axis_weight_matrix(gidx_d, w_d, n_mesh: int):
    """Dense per-axis matrix ``[.., N, n_mesh]`` from one axis of the
    stencil (``gidx_d``, ``w_d`` ``[.., N, order]``)."""
    out = torch.zeros(tuple(w_d.shape[:-1]) + (n_mesh,), dtype=w_d.dtype,
                      device=w_d.device)
    return out.scatter_add_(-1, gidx_d.long(), w_d)


def _matrices(gidx, w, mesh_dims):
    return [axis_weight_matrix(gidx[..., d, :], w[..., d, :],
                               int(mesh_dims[d])) for d in range(3)]


def _check(name, gidx, w, dw=None):
    if gidx.dim() != 4 or gidx.shape[2] != 3 or tuple(w.shape) != tuple(
            gidx.shape):
        raise ValueError(f"{name}: gidx and w must be [B, N, 3, order], got "
                         f"{tuple(gidx.shape)} and {tuple(w.shape)}")
    if dw is not None and tuple(dw.shape) != tuple(w.shape):
        raise ValueError(f"{name}: dw {tuple(dw.shape)} must match w")


def _check_index(name, gidx, ref):
    if gidx.device != ref.device:
        raise ValueError(f"{name}: tensors on different devices")
    if gidx.dtype != INDEX_DTYPE or not gidx.is_contiguous():
        raise ValueError(f"{name}: gidx must be contiguous {INDEX_DTYPE}")


def separable_spread_plain(gidx, w, q, mesh_dims):
    """Plain PyTorch version of :func:`separable_spread` (any device and
    dtype): chunked ``(q Sx)^T (Sy (x) Sz)`` contractions."""
    _check("separable_spread", gidx, w)
    nx, ny, nz = (int(d) for d in mesh_dims)
    b, n = w.shape[:2]
    sx, sy, sz = _matrices(gidx, w, mesh_dims)
    qsx = q[..., None] * sx
    mesh = torch.zeros((b, nx, ny * nz), dtype=w.dtype, device=w.device)
    for c in range(0, n, _CHUNK):
        t = (sy[:, c:c + _CHUNK, :, None]
             * sz[:, c:c + _CHUNK, None, :]).flatten(-2)
        mesh += torch.einsum("bnx,bnm->bxm", qsx[:, c:c + _CHUNK], t)
    return mesh.reshape(b, nx, ny, nz)


def separable_spread(gidx, w, q, mesh_dims):
    """Spread ``q [B, N]`` onto ``[B, nx, ny, nz]`` meshes through the
    stencil: CUDA kernel on a CUDA device, plain version on the CPU."""
    _check("separable_spread", gidx, w)
    if tuple(q.shape) != tuple(w.shape[:2]):
        raise ValueError(f"separable_spread: q {tuple(q.shape)} must be "
                         f"[B, N] = {tuple(w.shape[:2])}")
    if w.device.type == "cpu":
        return separable_spread_plain(gidx, w, q, mesh_dims)
    check_cuda_tensors("separable_spread", w, q)
    _check_index("separable_spread", gidx, w)
    nx, ny, nz = (int(d) for d in mesh_dims)
    b, n, _, order = w.shape
    mesh = torch.zeros((b, nx, ny, nz), dtype=w.dtype, device=w.device)
    err = load_library().nv_separable_spread(
        gidx.data_ptr(), w.data_ptr(), q.data_ptr(), mesh.data_ptr(),
        b, n, order, nx, ny, nz, current_stream(w))
    check_launch("separable_spread", err)
    launch_counts["separable_spread"] += 1
    return mesh


def separable_gather_plain(mesh, gidx, w, dw=None):
    """Plain PyTorch version of :func:`separable_gather` (any device and
    dtype): per chunk one ``Sx @ mesh`` projection, reduced against ``Sy``
    and ``Sz``; the x-derivative gather projects ``dSx`` too."""
    _check("separable_gather", gidx, w, dw)
    b, nx, ny, nz = mesh.shape
    n = w.shape[1]
    mesh2 = mesh.reshape(b, nx, ny * nz)
    sx, sy, sz = _matrices(gidx, w, (nx, ny, nz))
    dsx, dsy, dsz = (_matrices(gidx, dw, (nx, ny, nz)) if dw is not None
                     else (None,) * 3)

    def reduce(proj, a, c):
        return torch.einsum("bnyz,bny,bnz->bn", proj, a, c)

    vals, grads = [], []
    for c0 in range(0, n, _CHUNK):
        c = slice(c0, c0 + _CHUNK)
        proj = torch.einsum("bnx,bxm->bnm", sx[:, c], mesh2).reshape(
            b, -1, ny, nz)
        vals.append(reduce(proj, sy[:, c], sz[:, c]))
        if dw is not None:
            projd = torch.einsum("bnx,bxm->bnm", dsx[:, c], mesh2).reshape(
                b, -1, ny, nz)
            grads.append(torch.stack([reduce(projd, sy[:, c], sz[:, c]),
                                      reduce(proj, dsy[:, c], sz[:, c]),
                                      reduce(proj, sy[:, c], dsz[:, c])],
                                     dim=-1))
    val = torch.cat(vals, dim=1)
    return (val, torch.cat(grads, dim=1)) if dw is not None else val


def separable_gather(mesh, gidx, w, dw=None):
    """Interpolate ``mesh [B, nx, ny, nz]`` at the stencils: ``val [B, N]``,
    or ``(val, grad [B, N, 3])`` with derivative weights ``dw`` (one pass
    for the value and the three derivative gathers).  CUDA kernel on a CUDA
    device, plain version on the CPU."""
    _check("separable_gather", gidx, w, dw)
    if mesh.dim() != 4 or mesh.shape[0] != w.shape[0]:
        raise ValueError(f"separable_gather: mesh {tuple(mesh.shape)} must "
                         "be [B, nx, ny, nz]")
    if w.device.type == "cpu":
        return separable_gather_plain(mesh, gidx, w, dw)
    check_cuda_tensors("separable_gather", mesh, w,
                       *([dw] if dw is not None else []))
    _check_index("separable_gather", gidx, w)
    b, nx, ny, nz = mesh.shape
    n, order = w.shape[1], w.shape[3]
    val = torch.empty((b, n), dtype=w.dtype, device=w.device)
    grad = (torch.empty((b, n, 3), dtype=w.dtype, device=w.device)
            if dw is not None else None)
    err = load_library().nv_separable_gather(
        mesh.data_ptr(), gidx.data_ptr(), w.data_ptr(),
        dw.data_ptr() if dw is not None else None, val.data_ptr(),
        grad.data_ptr() if grad is not None else None,
        b, n, order, nx, ny, nz, current_stream(w))
    check_launch("separable_gather", err)
    launch_counts["separable_gather"] += 1
    return (val, grad) if dw is not None else val

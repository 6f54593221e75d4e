# SPDX-License-Identifier: Apache-2.0
"""Full-space voxel-stencil pair sweep, own side only (csrc/stencil_sweep.cu).

Counterpart of ``nvalchemiops_tpu/pallas/stencil_sweep.py:
stencil_sweep_fullspace``.  On the occupancy-1 voxel grid (stencil.py)
every field is a flat plane: candidates ``ext [n_feat, Ez, F]`` with ``F =
Ey*Ex + 2*pad`` (the (y, x) halo inline, ``pad = Ry*Ex + Rx``), own planes
``own [n_feat, Cz, W0]`` with ``W0 = Ey*Ex`` (halo columns parked).  Each own
voxel visits all ``(2Rz+1)(2Ry+1)(2Rx+1) - 1`` offsets and sums its own-side
terms only, so every pair is seen from both sides (energies are halved in
the body) and nothing is scattered.  Bodies (the own side of kernel 1's):

===========  ========================  =============
body         own / candidate features  outputs
===========  ========================  =============
``cn``       px py pz rcov             cn
``chain``    px py pz rcov decn        fx fy fz
``coulomb``  px py pz q                e fx fy fz
===========  ========================  =============

Returns ``out [n_out, Cz, W0]``, zero on the halo columns;
:func:`stencil.own_interior` strips them.

The kernel maps threads over the interior voxels only: a thread holds a
segment of consecutive own voxels of one (y, x) column in registers (the
last segment of a column ragged), streams each (dy, dx)'s candidate rows
of its column once and applies each to the own voxels within Rz of it; the
(dy, dx) pairs are split over the warps of a block (32 columns each),
whose sums are added in a fixed order (equal bits run to run).  ``PLAN``
holds each body's segment and warps.
"""

from __future__ import annotations

import torch

from nvalchemiops_torch.kernels import launch_counts
from nvalchemiops_torch.kernels.build import (
    check_cuda_tensors, check_launch, current_stream, launches_kernel,
    load_library, on_device,
)
from nvalchemiops_torch.kernels.window_sweep import BODY_FNS, SweepParams

__all__ = ["BODIES", "PLAN", "full_offsets", "stencil_slices",
           "stencil_sweep", "stencil_sweep_plain"]

#: body name -> (C body id, n_feat, n_out)
BODIES = {"cn": (0, 4, 1), "chain": (1, 5, 3), "coulomb": (2, 4, 4)}

#: body -> (own voxels of a z column a thread holds, most warps a block):
#: the segment is the kernel's kTz (built for 2 and 4), the warps slices of
#: the (dy, dx) offset pairs (at most kSlices = 16).  Read on the 48^3-voxel
#: crystal at radius 3 (PERF.md, kernel 9): CN and Coulomb fastest at 4
#: voxels and 16 warps, chain at 2 voxels and 12 warps (at 4 it needs 87
#: registers).
PLAN = {"cn": (4, 16), "chain": (2, 12), "coulomb": (4, 16)}


def full_offsets(radius):
    """All (dz, dy, dx) cell offsets of the stencil but (0, 0, 0)."""
    rz, ry, rx = radius
    return [(dz, dy, dx) for dz in range(-rz, rz + 1)
            for dy in range(-ry, ry + 1) for dx in range(-rx, rx + 1)
            if (dz, dy, dx) != (0, 0, 0)]


def stencil_slices(body: str, radius) -> int:
    """Warps a block of the kernel has for ``body``: one a slice of the
    (dy, dx) offset pairs, at most the body's ``PLAN`` count."""
    _, ry, rx = radius
    return min((2 * ry + 1) * (2 * rx + 1), PLAN[body][1])


def _geometry(body, dims, radius, ext, own):
    if body not in BODIES:
        raise ValueError(f"unknown stencil_sweep body {body!r}; one of "
                         f"{list(BODIES)}")
    _, n_feat, _ = BODIES[body]
    cz, cy, cx = dims
    rz, ry, rx = radius
    ey, ex = cy + 2 * ry, cx + 2 * rx
    pad = ry * ex + rx
    if ext.dim() != 3 or own.dim() != 3:
        raise ValueError("ext and own must be stacked 3-D flat planes")
    if ext.shape[0] != n_feat or own.shape[0] != n_feat:
        raise ValueError(f"{body}: expected {n_feat} features, got "
                         f"{ext.shape[0]} and {own.shape[0]}")
    if tuple(ext.shape[1:]) != (cz + 2 * rz, ey * ex + 2 * pad) \
            or tuple(own.shape[1:]) != (cz, ey * ex):
        raise ValueError(f"planes ext {tuple(ext.shape)} / own "
                         f"{tuple(own.shape)} do not match dims {dims} and "
                         f"radius {radius}")
    return ex, pad


def stencil_sweep(body: str, dims, radius, ext, own, params: SweepParams):
    """Run one body over every (own voxel, offset) pair: the CUDA kernel for
    float32 CUDA tensors (on their card), else the plain version
    (:func:`stencil_sweep_plain`) on the tensors' device."""
    _geometry(body, dims, radius, ext, own)
    if not launches_kernel(own):
        return stencil_sweep_plain(body, dims, radius, ext, own, params)
    check_cuda_tensors("stencil_sweep", ext, own)
    body_id, _, n_out = BODIES[body]
    cz, cy, cx = dims
    out = torch.zeros((n_out, cz, own.shape[2]), dtype=own.dtype,
                      device=own.device)
    rz, ry, rx = radius
    p = params
    with on_device(own):
        err = load_library().nv_stencil_sweep(
            body_id, ext.data_ptr(), own.data_ptr(), out.data_ptr(), cz, cy,
            cx, rz, ry, rx, PLAN[body][0], stencil_slices(body, radius),
            p.cutoff * p.cutoff, p.k1, p.alpha, current_stream(own))
    check_launch(f"stencil_sweep[{body}]", err)
    launch_counts[f"stencil_sweep_{body}"] += 1
    return out


def stencil_sweep_plain(body: str, dims, radius, ext, own,
                        params: SweepParams):
    """Plain PyTorch version of :func:`stencil_sweep` (any device/dtype):
    one shifted slice of the candidate planes per offset."""
    ex, pad = _geometry(body, dims, radius, ext, own)
    _, _, n_out = BODIES[body]
    cz, w0 = own.shape[1:]
    rz = radius[0]
    fn = BODY_FNS[body]
    acc = [torch.zeros((cz, w0), dtype=own.dtype, device=own.device)
           for _ in range(n_out)]
    for dz, dy, dx in full_offsets(radius):
        c0 = pad + dy * ex + dx
        cand = ext[:, rz + dz:rz + dz + cz, c0:c0 + w0]
        own_terms, _ = fn(own, cand, params, None, None, None)
        acc = [a + t for a, t in zip(acc, own_terms)]
    return torch.stack(acc)

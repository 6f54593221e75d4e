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

Returns ``out [n_out, Cz, W0]``; :func:`stencil.own_interior` strips the
halo columns.
"""

from __future__ import annotations

import torch

from nvalchemiops_torch.kernels import launch_counts
from nvalchemiops_torch.kernels.build import (
    check_cuda_tensors, check_launch, current_stream, load_library,
)
from nvalchemiops_torch.kernels.window_sweep import BODY_FNS, SweepParams

__all__ = ["BODIES", "full_offsets", "stencil_sweep", "stencil_sweep_plain"]

#: body name -> (C body id, n_feat, n_out)
BODIES = {"cn": (0, 4, 1), "chain": (1, 5, 3), "coulomb": (2, 4, 4)}


def full_offsets(radius):
    """All (dz, dy, dx) cell offsets of the stencil but (0, 0, 0)."""
    rz, ry, rx = radius
    return [(dz, dy, dx) for dz in range(-rz, rz + 1)
            for dy in range(-ry, ry + 1) for dx in range(-rx, rx + 1)
            if (dz, dy, dx) != (0, 0, 0)]


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
    """Run one body over every (own voxel, offset) pair: CUDA kernel on a
    CUDA device, the plain version (:func:`stencil_sweep_plain`) on the
    CPU."""
    ex, pad = _geometry(body, dims, radius, ext, own)
    if own.device.type == "cpu":
        return stencil_sweep_plain(body, dims, radius, ext, own, params)
    check_cuda_tensors("stencil_sweep", ext, own)
    body_id, _, n_out = BODIES[body]
    cz, w0 = own.shape[1:]
    out = torch.empty((n_out, cz, w0), dtype=own.dtype, device=own.device)
    rz, ry, rx = radius
    p = params
    err = load_library().nv_stencil_sweep(
        body_id, ext.data_ptr(), own.data_ptr(), out.data_ptr(), cz, w0,
        ext.shape[1], ext.shape[2], rz, ry, rx, ex, pad, p.cutoff * p.cutoff,
        p.k1, p.alpha, current_stream(own))
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

# SPDX-License-Identifier: Apache-2.0
"""Half-space pair sweep over the halo atom grid (csrc/window_sweep.cu).

Counterpart of ``nvalchemiops_tpu/pallas/window_sweep.py:window_sweep``.
The sweep visits the pair-once enumeration of the grid: the home row
(dz, dy) = (0, 0) and every half-space (dz, dy), each over the 2*rx+1
x-cells of the own cell's row, with the home mask (cells left of centre
skipped, the centre cell keeping slot pairs i < j).  A named pass body
turns each pair into own-side and j-side terms:

=============  ================================  =========  ============
body           own / candidate features          own outs   j outs
=============  ================================  =========  ============
``cn``         px py pz rcov                     cn         cn
``d3_direct``  own: px py pz si w (+ lf rows);   e fx fy    -fx -fy -fz
               cand: px py pz si w z e[mesh]     fz dei     dej
               edc[mesh]
``chain``      px py pz rcov decn                fx fy fz   -fx -fy -fz
``coulomb``    px py pz q                        e fx fy    e -fx -fy
                                                 fz         -fz
=============  ================================  =========  ============

Inputs are stacked feature-major: ``own [n_own, cz, cy, cx, cap]`` holds
interior planes, ``cand [n_cand, ez, ey, ex, cap]`` extended planes.  The
result is ``(own_out [n_out, cz, cy, cx, cap], j_out [n_j, ez, ey, ex,
cap])``; the caller folds ``j_out`` with ``grid.fold_halo``.  Parameters are
runtime floats (:class:`SweepParams`): no rebuild per parameter set.

The bodies match the JAX window bodies term for term (grid_d3.py:1380-1387,
:1465-1534, :1612-1625; grid.py:900-928), including the displacement
validity: parked empty slots fail the distance test, so no body compares
validity flags.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from nvalchemiops_torch.kernels import launch_counts
from nvalchemiops_torch.kernels.build import (
    check_cuda_tensors, check_launch, current_stream, load_library,
)
from nvalchemiops_torch.mathops.math import erfc_approx

__all__ = ["SweepParams", "BODIES", "window_sweep", "window_sweep_plain"]

#: body name -> (C body id, n_own, n_out, n_j); D3 direct has
#: 6 + 2*mesh candidate features, the others as many as own features
BODIES = {
    "cn": (0, 4, 1, 1),
    "d3_direct": (1, 5, 5, 4),
    "chain": (2, 5, 3, 3),
    "coulomb": (3, 4, 4, 4),
}

_TWO_OVER_SQRT_PI = 1.1283791670955126


@dataclass(frozen=True)
class SweepParams:
    """Runtime scalars of the pass bodies (unused ones are ignored)."""

    cutoff: float
    a1: float = 0.0
    a2: float = 0.0
    s6: float = 1.0
    s8: float = 0.0
    k1: float = 16.0
    k3: float = -4.0
    alpha: float = 0.0


def _check(body, radius, own, cand, lf):
    if body not in BODIES:
        raise ValueError(f"unknown sweep body {body!r}; one of {list(BODIES)}")
    _, n_own, _, _ = BODIES[body]
    if own.dim() != 5 or cand.dim() != 5:
        raise ValueError("own and cand must be stacked 5-D planes")
    if own.shape[0] != n_own:
        raise ValueError(f"{body}: expected {n_own} own features, got "
                         f"{own.shape[0]}")
    _, cz, cy, cx, cap = own.shape
    rz, ry, rx = radius
    if tuple(cand.shape[1:]) != (cz + 2 * rz, cy + 2 * ry, cx + 2 * rx, cap):
        raise ValueError(f"cand planes {tuple(cand.shape)} do not extend own "
                         f"planes {tuple(own.shape)} by radius {radius}")
    if body == "d3_direct":
        if lf is None or tuple(lf.shape[:4]) != (cz, cy, cx, cap):
            raise ValueError("d3_direct needs own left features lf "
                             "[cz, cy, cx, cap, 2*zm]")
        mesh2 = cand.shape[0] - 6
        if mesh2 <= 0 or mesh2 % 2 or lf.shape[-1] % (mesh2 // 2):
            raise ValueError("d3_direct candidate features must be px py pz "
                             "si w z e[mesh] edc[mesh]")
    elif cand.shape[0] != n_own:
        raise ValueError(f"{body}: expected {n_own} candidate features, got "
                         f"{cand.shape[0]}")


def window_sweep(body: str, radius, own, cand, params: SweepParams, lf=None):
    """Run one pass body over the grid: CUDA kernel on a CUDA device, the
    plain version (:func:`window_sweep_plain`) on the CPU."""
    _check(body, radius, own, cand, lf)
    if own.device.type == "cpu":
        return window_sweep_plain(body, radius, own, cand, params, lf)
    check_cuda_tensors("window_sweep", own, cand,
                       *([lf] if lf is not None else []))
    body_id, _, n_out, n_j = BODIES[body]
    _, cz, cy, cx, cap = own.shape
    rz, ry, rx = radius
    ez, ey, ex = cz + 2 * rz, cy + 2 * ry, cx + 2 * rx
    own_out = torch.empty((n_out, cz, cy, cx, cap), dtype=own.dtype,
                          device=own.device)
    j_out = torch.zeros((n_j, ez, ey, ex, cap), dtype=own.dtype,
                        device=own.device)
    n_cand = cand.shape[0]
    mesh = (n_cand - 6) // 2 if body == "d3_direct" else 0
    zm = lf.shape[-1] // 2 if lf is not None else 0
    p = params
    err = load_library().nv_window_sweep(
        body_id, own.data_ptr(), cand.data_ptr(),
        lf.data_ptr() if lf is not None else None,
        own_out.data_ptr(), j_out.data_ptr(),
        cz, cy, cx, rz, ry, rx, cap, n_cand,
        p.cutoff * p.cutoff, p.a1, p.a2, p.s6, p.s8, p.k1,
        p.k3, p.alpha, zm, mesh,
        current_stream(own),
    )
    check_launch(f"window_sweep[{body}]", err)
    launch_counts[f"window_sweep_{body}"] += 1
    return own_out, j_out


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _geom(o, c, cut_sq, home):
    dx = c[0] - o[0]
    dy = c[1] - o[1]
    dz = c[2] - o[2]
    d2 = dx * dx + dy * dy + dz * dz
    ok = (d2 > 1e-20) & (d2 < cut_sq)
    if home is not None:
        ok = ok & home
    r2m = torch.where(ok, d2, torch.ones_like(d2))
    return ok, torch.rsqrt(r2m), r2m, dx, dy, dz


def _cn_body(o, c, p, home, lf):
    ok, inv_r, *_ = _geom(o, c, p.cutoff * p.cutoff, home)
    rc = o[3] + c[3]
    f = torch.where(ok, 1.0 / (1.0 + torch.exp(-p.k1 * (rc * inv_r - 1.0))),
                    torch.zeros_like(inv_r))
    return (f,), (f,)


def _d3_direct_body(o, c, p, home, lf):
    ok, inv_r, r2, dx, dy, dz = _geom(o, c, p.cutoff * p.cutoff, home)
    zm = lf.shape[-1] // 2
    mesh = (c.shape[0] - 6) // 2
    zmax1 = zm // mesh
    l0 = lf[..., :zm]
    l1c = lf[..., zm:]
    # candidate features rebuilt per window: rf[(z', q)] = [z_j == z'] e_j[q]
    zj = c[5][..., 0, :]                                    # [.., L]
    zrow = (torch.arange(zm, device=zj.device) // mesh).to(zj.dtype)
    zmask = zj[..., None] == zrow                           # [.., L, zm]
    e = torch.movedim(c[6:6 + mesh, ..., 0, :], 0, -1)      # [.., L, mesh]
    edc = torch.movedim(c[6 + mesh:, ..., 0, :], 0, -1)
    rf = torch.where(zmask, e.repeat((1,) * (e.dim() - 1) + (zmax1,)),
                     torch.zeros((), dtype=e.dtype, device=e.device))
    rfdc = torch.where(zmask, edc.repeat((1,) * (e.dim() - 1) + (zmax1,)),
                       torch.zeros((), dtype=e.dtype, device=e.device))
    zacc = torch.matmul(l0, rf.transpose(-1, -2))           # [.., cap, L]
    z_di = torch.matmul(l1c, rf.transpose(-1, -2))
    z_dj = torch.matmul(l0, rfdc.transpose(-1, -2))
    w = o[4] * c[4]
    good = w > 1e-12
    w_inv = 1.0 / torch.where(good, w, torch.ones_like(w))
    keep = ok & good
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    c6m = torch.where(keep, zacc * w_inv, zero)
    t = o[3] * c[3]
    rr = t * t
    r0 = p.a1 * t + p.a2
    r4 = r2 * r2
    r6 = r4 * r2
    r8 = r4 * r4
    r0_2 = r0 * r0
    r0_6 = r0_2 * r0_2 * r0_2
    r0_8 = r0_6 * r0_2
    den6 = r6 + r0_6
    den8 = r8 + r0_8
    rec = 1.0 / (den6 * den8)
    den6_inv = rec * den8
    den8_inv = rec * den6
    damp = p.s6 * den6_inv + p.s8 * rr * den8_inv
    e_ij = -c6m * damp
    dd6 = -6.0 * p.s6 * r4 * den6_inv * den6_inv
    dd8 = -8.0 * p.s8 * rr * r6 * den8_inv * den8_inv
    coef = -c6m * (dd6 + dd8)
    cfx, cfy, cfz = coef * dx, coef * dy, coef * dz
    m = torch.where(keep, (-2.0 * p.k3) * damp * w_inv, zero)
    return ((e_ij, cfx, cfy, cfz, m * z_di),
            (-cfx, -cfy, -cfz, m * z_dj))


def _chain_body(o, c, p, home, lf):
    ok, inv_r, _, dx, dy, dz = _geom(o, c, p.cutoff * p.cutoff, home)
    rrq = (o[3] + c[3]) * inv_r
    f = 1.0 / (1.0 + torch.exp(-p.k1 * (rrq - 1.0)))
    dcn = -f * (1.0 - f) * p.k1 * rrq * inv_r * inv_r
    coef = torch.where(ok, (o[4] + c[4]) * dcn, torch.zeros_like(dcn))
    cfx, cfy, cfz = coef * dx, coef * dy, coef * dz
    return (cfx, cfy, cfz), (-cfx, -cfy, -cfz)


def _coulomb_body(o, c, p, home, lf):
    ok, inv_r, r2m, dx, dy, dz = _geom(o, c, p.cutoff * p.cutoff, home)
    qq = o[3] * c[3]
    if p.alpha > 0:
        ar = p.alpha * (r2m * inv_r)
        erfc_ar = erfc_approx(ar)
        phi = erfc_ar * inv_r
        mag = (erfc_ar * inv_r
               + _TWO_OVER_SQRT_PI * p.alpha * torch.exp(-ar * ar)
               ) * inv_r * inv_r
    else:
        phi = inv_r
        mag = inv_r * inv_r * inv_r
    zero = torch.zeros((), dtype=qq.dtype, device=qq.device)
    e = torch.where(ok, 0.5 * qq * phi, zero)
    ncoef = torch.where(ok, -(qq * mag), zero)
    mfx, mfy, mfz = ncoef * dx, ncoef * dy, ncoef * dz
    return (e, mfx, mfy, mfz), (e, -mfx, -mfy, -mfz)


_BODY_FNS = {
    "cn": _cn_body,
    "d3_direct": _d3_direct_body,
    "chain": _chain_body,
    "coulomb": _coulomb_body,
}


def halfspace_zy(rz: int, ry: int):
    """Half-space (dz, dy) row offsets (dz > 0, or dz == 0 and dy > 0)."""
    return [(dz, dy) for dz in range(-rz, rz + 1) for dy in range(-ry, ry + 1)
            if dz > 0 or (dz == 0 and dy > 0)]


def window_sweep_plain(body: str, radius, own, cand, params: SweepParams,
                       lf=None):
    """Plain PyTorch version of :func:`window_sweep` (any device/dtype).

    Materializes each offset's ``[cz, cy, cx, cap, (2*rx+1)*cap]`` pair
    blocks, so its memory grows with the grid; the CUDA kernel keeps them
    on chip.
    """
    _check(body, radius, own, cand, lf)
    _, n_own, n_out, n_j = BODIES[body]
    _, cz, cy, cx, cap = own.shape
    rz, ry, rx = radius
    nw = 2 * rx + 1
    ncand = nw * cap
    fn = _BODY_FNS[body]
    own_out = torch.zeros((n_out, cz, cy, cx, cap), dtype=own.dtype,
                          device=own.device)
    j_out = torch.zeros((n_j,) + tuple(cand.shape[1:]), dtype=own.dtype,
                        device=own.device)
    lane = torch.arange(ncand, device=own.device)
    row = torch.arange(cap, device=own.device)[:, None]
    home_mask = (lane >= (rx + 1) * cap) | (
        (lane >= rx * cap) & (lane - rx * cap > row))
    o = own[..., :, None]                          # [n_own, .., cap, 1]
    offsets = [(0, 0, True)] + [(dz, dy, False)
                                for dz, dy in halfspace_zy(rz, ry)]
    for dz, dy, is_home in offsets:
        z0, y0 = rz + dz, ry + dy
        rows = cand[:, z0:z0 + cz, y0:y0 + cy]
        win = torch.cat([rows[:, :, :, c:c + cx] for c in range(nw)], dim=-1)
        own_blocks, j_blocks = fn(o, win[..., None, :], params,
                                  home_mask if is_home else None, lf)
        for k, blk in enumerate(own_blocks):
            own_out[k] += blk.sum(dim=-1)
        for k, blk in enumerate(j_blocks):
            d = blk.sum(dim=-2).reshape(cz, cy, cx, nw, cap)
            for c in range(nw):
                j_out[k, z0:z0 + cz, y0:y0 + cy, c:c + cx] += d[..., c, :]
    return own_out, j_out

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
``d3_direct_   own: px py pz si w q (+ lf);      d3_direct  d3_direct
coulomb``      cand: px py pz si w z q e[mesh]   + ec fcx   + ec -fcx
               edc[mesh]                         fcy fcz    -fcy -fcz
=============  ================================  =========  ============

With ``SweepParams.combine_forces`` the fused body adds the Coulomb forces
into the D3 force outputs (own e, fx, fy, fz, dei, ec; j -fx, -fy, -fz,
dej, ec), as grid_d3.py:1557-1567 does.

Inputs are stacked feature-major: ``own [n_own, cz, cy, cx, cap]`` holds
interior planes, ``cand [n_cand, ez, ey, ex, cap]`` extended planes.  The
result is ``(own_out [n_out, cz, cy, cx, cap], j_out [n_j, ez, ey, ex,
cap])``; the caller folds ``j_out`` with ``grid.fold_halo``.  Parameters are
runtime floats (:class:`SweepParams`): no rebuild per parameter set.
On a batched grid every array takes a leading system axis (``own [B,
n_own, ..]``, ``cand [B, n_cand, ..]``, ``lf [B, ..]``, and the outputs
likewise) and one launch sweeps the B systems.  Where the candidate
windows of a cell do not fit a block's shared memory, the kernel stages
them in groups of slots, and cuts a window that alone exceeds them into
slices (:func:`window_plan`).

The bodies match the JAX window bodies term for term (grid_d3.py:1380-1387,
:1465-1571, :1612-1625; grid.py:900-928), including the displacement
validity: parked empty slots fail the distance test, so no body compares
validity flags.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from nvalchemiops_torch.kernels import launch_counts
from nvalchemiops_torch.kernels.build import (
    check_cuda_tensors, check_launch, current_stream, launches_kernel,
    load_library, on_device,
)
from nvalchemiops_torch.mathops.math import erfc_approx

__all__ = ["SweepParams", "BODIES", "window_sweep", "window_sweep_plain",
           "window_plan", "body_outputs", "BODY_FNS",
           "halfspace_zy"]

#: body name -> (C body id, n_own, n_out, n_j); the D3 bodies have 6 (7 with
#: the charge) + 2*mesh candidate features, the others as many as own
#: features.  ``d3_direct_coulomb`` has 6 own and 5 j outputs (C id 5) with
#: ``SweepParams.combine_forces``.
BODIES = {
    "cn": (0, 4, 1, 1),
    "d3_direct": (1, 5, 5, 4),
    "chain": (2, 5, 3, 3),
    "coulomb": (3, 4, 4, 4),
    "d3_direct_coulomb": (4, 6, 9, 8),
}

_TWO_OVER_SQRT_PI = 1.1283791670955126


@dataclass(frozen=True)
class SweepParams:
    """Runtime scalars of the pass bodies (unused ones are ignored).

    ``cutoff`` is the D3 (or Coulomb-only) cutoff; the fused
    ``d3_direct_coulomb`` body takes the Coulomb pair's own cutoff
    ``ccutoff`` and its ``alpha``, and with ``combine_forces`` folds the
    Coulomb forces into the D3 force channels.
    """

    cutoff: float
    a1: float = 0.0
    a2: float = 0.0
    s6: float = 1.0
    s8: float = 0.0
    k1: float = 16.0
    k3: float = -4.0
    alpha: float = 0.0
    ccutoff: float = 0.0
    combine_forces: bool = False


def body_outputs(body: str, params: SweepParams):
    """(n_out, n_j) of a pass body under ``params``."""
    _, _, n_out, n_j = BODIES[body]
    if body == "d3_direct_coulomb" and params.combine_forces:
        return 6, 5
    return n_out, n_j


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
    if body.startswith("d3_direct"):
        base = 7 if body == "d3_direct_coulomb" else 6
        if lf is None or tuple(lf.shape[:4]) != (cz, cy, cx, cap):
            raise ValueError(f"{body} needs own left features lf "
                             "[cz, cy, cx, cap, 2*zm]")
        mesh2 = cand.shape[0] - base
        if mesh2 <= 0 or mesh2 % 2 or lf.shape[-1] % (mesh2 // 2):
            raise ValueError(f"{body} candidate features must be px py pz si "
                             "w z (q) e[mesh] edc[mesh]")
    elif cand.shape[0] != n_own:
        raise ValueError(f"{body}: expected {n_own} candidate features, got "
                         f"{cand.shape[0]}")


def check_wide(name, bodies, body, radius, own, cand, lf, cf):
    """Shape checks shared by the zm-wide sweeps (kernels 7 and 8)."""
    if body not in bodies:
        raise ValueError(f"unknown {name} body {body!r}; one of "
                         f"{list(bodies)}")
    _, n_own, _, _ = bodies[body]
    if own.dim() != 5 or cand.dim() != 5:
        raise ValueError("own and cand must be stacked 5-D planes")
    if own.shape[0] != n_own or cand.shape[0] != n_own:
        raise ValueError(f"{body}: expected {n_own} own and candidate "
                         f"features, got {own.shape[0]} and {cand.shape[0]}")
    _, cz, cy, cx, cap = own.shape
    rz, ry, rx = radius
    ext = (cz + 2 * rz, cy + 2 * ry, cx + 2 * rx, cap)
    if tuple(cand.shape[1:]) != ext:
        raise ValueError(f"cand planes {tuple(cand.shape)} do not extend own "
                         f"planes {tuple(own.shape)} by radius {radius}")
    if body.startswith("d3_direct"):
        if lf is None or cf is None or tuple(lf.shape[:4]) != (cz, cy, cx,
                                                                cap) \
                or tuple(cf.shape[:4]) != ext or lf.shape[-1] != cf.shape[-1] \
                or lf.shape[-1] % 2:
            raise ValueError(f"{body} needs own rows lf [cz, cy, cx, cap, "
                             "2*zm] and candidate rows cf [ez, ey, ex, cap, "
                             "2*zm]")


def batched(name, check, own, cand, *rows):
    """The planes of a sweep with a leading system axis (one grid: B = 1):
    ``own``, ``cand`` and the optional feature ``rows`` (None stays None),
    the first system's shapes checked by ``check(own, cand, *rows)``;
    returns ``(own, cand, *rows, single)``, ``single`` where they came
    without the axis."""
    single = own.dim() == 5
    if single:
        own, cand = own[None], cand[None]
        rows = tuple(None if r is None else r[None] for r in rows)
    if own.dim() != 6 or cand.dim() != 6 or cand.shape[0] != own.shape[0] \
            or any(r is not None and r.shape[0] != own.shape[0]
                   for r in rows):
        raise ValueError(f"{name}: batched planes must be own [B, n_own, cz, "
                         "cy, cx, cap], cand [B, n_cand, ez, ey, ex, cap] and "
                         "feature rows [B, cz, cy, cx, cap, 2*zm] with one B")
    if own.shape[0] > 65535:
        raise ValueError(f"at most 65,535 systems a launch, got "
                         f"{own.shape[0]}")
    check(own[0], cand[0], *(None if r is None else r[0] for r in rows))
    return (own, cand, *rows, single)


def per_system(fn, own, cand, *rows_single):
    """A plain version's loop over the systems of :func:`batched`'s planes
    ``(own, cand, *rows, single)``: ``fn(own, cand, *rows)`` on each
    system's planes, the outputs stacked (one grid: its own outputs)."""
    *rows, single = rows_single
    outs = [fn(own[b], cand[b], *(None if r is None else r[b] for r in rows))
            for b in range(own.shape[0])]
    if single:
        return outs[0]
    return tuple(torch.stack(o) for o in zip(*outs))


def wide_batched(name, bodies, body, radius, own, cand, lf, cf):
    """:func:`batched` for kernels 7 and 8 (:func:`check_wide`); returns
    ``(own, cand, lf, cf, single)``."""
    return batched(name, lambda o, c, l, f: check_wide(
        name, bodies, body, radius, o, c, l, f), own, cand, lf, cf)


def stage_slices(own_bytes: int, cand_bytes: int, budget: int, m: int,
                 w: int) -> tuple[int, int]:
    """Own slots and candidates a block of kernel 7 or 8 stages at once
    where a chunk of ``m`` own slots and its window of ``w`` candidates do
    not fit ``budget`` bytes of shared memory: half the budget to own slots
    (``own_bytes`` each, at most m), the rest to candidates (``cand_bytes``
    each, at most w)."""
    m_s = min(m, 0x7fff, max(1, budget // 2 // own_bytes))
    w_s = min(w, 0xffff, (budget - m_s * own_bytes) // cand_bytes)
    if w_s < 1:
        raise ValueError(f"one own slot and one candidate exceed {budget} "
                         "bytes of shared memory")
    return m_s, w_s


#: shared memory one block may use on the H100 (227 KB), for kernels 1, 7
#: and 8; the ints of each warp's pair queue (csrc/pair_bodies.cuh: kQueue)
SMEM_BYTES = 232448
QUEUE = 64
#: kernel 1's warps a block (csrc/window_sweep.cu: kWarps)
WARPS = 8


def window_lengths(radius, cap: int) -> list[int]:
    """Slots of each candidate window of an own cell, in the kernel's order:
    the home row from the centre cell on, then every half-space row."""
    rz, ry, rx = radius
    return [(rx + 1) * cap] + [(2 * rx + 1) * cap] * (ry + rz * (2 * ry + 1))


def window_plan(body: str, radius, cap: int, n_cand: int,
                params: SweepParams, blocks: int = 0,
                n_sm: int = 0) -> tuple[int, int]:
    """Kernel 1's staging plan ``(slots, own)``: the candidate slots a
    staging group holds in shared memory and the own slots a block takes.

    Every window at once where that fits, else the most slots that fit
    (the kernel cuts the windows into groups of them, a window that
    exceeds them into slices).  A block takes the whole cell unless
    its own sums would fill more than a quarter of the 227 KB, or a window
    alone exceeds the slots while the launch's ``blocks`` (cells times
    systems) leave some of the card's ``n_sm`` SMs idle; the cell's slots
    are then split evenly over blocks (the grid's third axis), at least
    4 own slots a warp."""
    n_out, n_j = body_outputs(body, params)
    lens = window_lengths(radius, cap)

    def fit(own):
        fixed = 4 * (n_out * own + WARPS * QUEUE)
        return min(sum(lens), (SMEM_BYTES - fixed) // (4 * (n_cand + n_j)))

    split = -(-cap // (SMEM_BYTES // 4 // (4 * n_out)))
    if fit(-(-cap // split)) < max(lens) and 0 < blocks < n_sm:
        split = max(split, min(-(-n_sm // blocks), -(-cap // (4 * WARPS))))
    own = -(-cap // split)
    return fit(own), own


def _planes(body, radius, own, cand, lf):
    """Kernel 1's :func:`batched` planes ``(own, cand, lf, single)``."""
    return batched("window_sweep", lambda o, c, l: _check(
        body, radius, o, c, l), own, cand, lf)


def window_sweep(body: str, radius, own, cand, params: SweepParams, lf=None,
                 plan=None):
    """Run one pass body over the grid: the CUDA kernel for float32 CUDA
    tensors (on their card), else the plain version
    (:func:`window_sweep_plain`) on the tensors' device.

    One grid's planes (``own [n_own, cz, cy, cx, cap]``, ``cand``, ``lf``)
    or a batched grid's, with a leading system axis (``own [B, n_own,
    ..]``): the B systems then run in one launch and the outputs carry the
    axis too.  ``plan`` replaces :func:`window_plan`'s ``(slots, own)``."""
    own_b, cand_b, lf_b, single = _planes(body, radius, own, cand, lf)
    if not launches_kernel(own_b):
        return window_sweep_plain(body, radius, own, cand, params, lf)
    out = _launch(body, radius, own_b, cand_b, params, lf_b, plan)
    launch_counts[f"window_sweep_{body}"] += 1
    return (out[0][0], out[1][0]) if single else out


def _launch(body, radius, own, cand, params, lf, plan):
    """Launch kernel 1 over the systems of ``own [B, ..]``; returns
    ``(own_out [B, ..], j_out [B, ..])``."""
    check_cuda_tensors("window_sweep", own, cand,
                       *([lf] if lf is not None else []))
    body_id = BODIES[body][0]
    if body == "d3_direct_coulomb" and params.combine_forces:
        body_id = 5
    n_out, n_j = body_outputs(body, params)
    n_sys, n_cand, cz, cy, cx, cap = own.shape[:1] + cand.shape[1:2] \
        + own.shape[2:]
    rz, ry, rx = radius
    ez, ey, ex = cz + 2 * rz, cy + 2 * ry, cx + 2 * rx
    slots, own_slots = plan or window_plan(
        body, radius, cap, n_cand, params, n_sys * cz * cy * cx,
        torch.cuda.get_device_properties(own.device).multi_processor_count)
    own_out = torch.empty((n_sys, n_out, cz, cy, cx, cap), dtype=own.dtype,
                          device=own.device)
    j_out = torch.zeros((n_sys, n_j, ez, ey, ex, cap), dtype=own.dtype,
                        device=own.device)
    base = 7 if body == "d3_direct_coulomb" else 6
    mesh = (n_cand - base) // 2 if body.startswith("d3_direct") else 0
    zm = lf.shape[-1] // 2 if lf is not None else 0
    p = params
    with on_device(own):
        err = load_library().nv_window_sweep(
            body_id, own.data_ptr(), cand.data_ptr(),
            lf.data_ptr() if lf is not None else None,
            own_out.data_ptr(), j_out.data_ptr(),
            cz, cy, cx, rz, ry, rx, cap, n_cand,
            p.cutoff * p.cutoff, p.a1, p.a2, p.s6, p.s8, p.k1,
            p.k3, p.alpha, p.ccutoff * p.ccutoff, zm, mesh, n_sys, slots,
            own_slots, current_stream(own),
        )
    check_launch(f"window_sweep[{body}]", err)
    return own_out, j_out


# ---------------------------------------------------------------------------
# Plain PyTorch pass bodies, shared by the plain versions of kernels 1, 7, 8
# and 9.  ``o [n_own, .., R, 1]`` and ``c [n_cand, .., 1, W]`` are feature
# stacks, ``mask [R, W]`` (or None) the pair-once mask; ``lf [.., R, 2 zm]``
# are the own left rows and ``cf [.., W, 2 zm]`` the candidates' zm-wide
# rows (rf | rfdc), or None for kernel 1's factored mesh form, rebuilt from
# the candidate features z, e[mesh], edc[mesh].  Each returns own-side and
# j-side ``[.., R, W]`` blocks.
# ---------------------------------------------------------------------------


def _geom(o, c, cut_sq, mask):
    dx = c[0] - o[0]
    dy = c[1] - o[1]
    dz = c[2] - o[2]
    d2 = dx * dx + dy * dy + dz * dz
    ok = (d2 > 1e-20) & (d2 < cut_sq)
    if mask is not None:
        ok = ok & mask
    r2m = torch.where(ok, d2, torch.ones_like(d2))
    return ok, torch.rsqrt(r2m), r2m, dx, dy, dz


def _cn_body(o, c, p, mask, lf, cf):
    ok, inv_r, *_ = _geom(o, c, p.cutoff * p.cutoff, mask)
    rc = o[3] + c[3]
    f = torch.where(ok, 1.0 / (1.0 + torch.exp(-p.k1 * (rc * inv_r - 1.0))),
                    torch.zeros_like(inv_r))
    return (f,), (f,)


def _c6_dots(c, lf, cf, e_at):
    """The three C6 contractions ``(l0 . rf, l1c . rf, l0 . rfdc)``."""
    zm = lf.shape[-1] // 2
    if cf is None:
        # kernel 1: rf[(z', q)] = [z_j == z'] e_j[q], rebuilt per window
        mesh = (c.shape[0] - e_at) // 2
        zj = c[5][..., 0, :]                                    # [.., W]
        zrow = (torch.arange(zm, device=zj.device) // mesh).to(zj.dtype)
        zmask = zj[..., None] == zrow                           # [.., W, zm]
        e = torch.movedim(c[e_at:e_at + mesh, ..., 0, :], 0, -1)
        edc = torch.movedim(c[e_at + mesh:, ..., 0, :], 0, -1)
        zero = torch.zeros((), dtype=e.dtype, device=e.device)
        reps = (1,) * (e.dim() - 1) + (zm // mesh,)
        rf = torch.where(zmask, e.repeat(reps), zero)
        rfdc = torch.where(zmask, edc.repeat(reps), zero)
    else:
        rf, rfdc = cf[..., :zm], cf[..., zm:]
    zacc = torch.matmul(lf[..., :zm], rf.transpose(-1, -2))
    z_di = torch.matmul(lf[..., zm:], rf.transpose(-1, -2))
    z_dj = torch.matmul(lf[..., :zm], rfdc.transpose(-1, -2))
    return zacc, z_di, z_dj


def _d3_terms(o, c, p, ok, r2, zacc, z_di, z_dj):
    """BJ-damped pair energy, force coefficient and dE/dCN blocks."""
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
    m = torch.where(keep, (-2.0 * p.k3) * damp * w_inv, zero)
    return e_ij, coef, m * z_di, m * z_dj


def _d3_direct_body(o, c, p, mask, lf, cf):
    ok, _, r2, dx, dy, dz = _geom(o, c, p.cutoff * p.cutoff, mask)
    e_ij, coef, dei, dej = _d3_terms(o, c, p, ok, r2, *_c6_dots(c, lf, cf, 6))
    cfx, cfy, cfz = coef * dx, coef * dy, coef * dz
    return (e_ij, cfx, cfy, cfz, dei), (-cfx, -cfy, -cfz, dej)


def _coulomb_terms(qq, alpha, ok, inv_r, r2m):
    """Half the pair energy and the own-side force coefficient."""
    if alpha > 0:
        ar = alpha * (r2m * inv_r)
        erfc_ar = erfc_approx(ar)
        phi = erfc_ar * inv_r
        mag = (erfc_ar * inv_r
               + _TWO_OVER_SQRT_PI * alpha * torch.exp(-ar * ar)
               ) * inv_r * inv_r
    else:
        phi = inv_r
        mag = inv_r * inv_r * inv_r
    zero = torch.zeros((), dtype=qq.dtype, device=qq.device)
    return torch.where(ok, 0.5 * qq * phi, zero), torch.where(ok, -(qq * mag),
                                                              zero)


def _chain_body(o, c, p, mask, lf, cf):
    ok, inv_r, _, dx, dy, dz = _geom(o, c, p.cutoff * p.cutoff, mask)
    rrq = (o[3] + c[3]) * inv_r
    f = 1.0 / (1.0 + torch.exp(-p.k1 * (rrq - 1.0)))
    dcn = -f * (1.0 - f) * p.k1 * rrq * inv_r * inv_r
    coef = torch.where(ok, (o[4] + c[4]) * dcn, torch.zeros_like(dcn))
    cfx, cfy, cfz = coef * dx, coef * dy, coef * dz
    return (cfx, cfy, cfz), (-cfx, -cfy, -cfz)


def _coulomb_body(o, c, p, mask, lf, cf):
    ok, inv_r, r2m, dx, dy, dz = _geom(o, c, p.cutoff * p.cutoff, mask)
    e, ncoef = _coulomb_terms(o[3] * c[3], p.alpha, ok, inv_r, r2m)
    mfx, mfy, mfz = ncoef * dx, ncoef * dy, ncoef * dz
    return (e, mfx, mfy, mfz), (e, -mfx, -mfy, -mfz)


def _d3_direct_coulomb_body(o, c, p, mask, lf, cf):
    """D3 direct and the Coulomb pair on one geometry (grid_d3.py:1535-1571):
    the Coulomb test has its own cutoff; kernel 1's candidates carry q at
    feature 6 (after z), kernels 7 and 8's at feature 5."""
    dx = c[0] - o[0]
    dy = c[1] - o[1]
    dz = c[2] - o[2]
    d2 = dx * dx + dy * dy + dz * dz
    base = d2 > 1e-20
    if mask is not None:
        base = base & mask
    one = torch.ones_like(d2)
    ok = base & (d2 < p.cutoff * p.cutoff)
    r2 = torch.where(ok, d2, one)
    e_ij, coef, dei, dej = _d3_terms(
        o, c, p, ok, r2, *_c6_dots(c, lf, cf, 7))
    ok_c = base & (d2 < p.ccutoff * p.ccutoff)
    r2c = torch.where(ok_c, d2, one)
    q_c = c[6] if cf is None else c[5]
    e_c, ncoef = _coulomb_terms(o[5] * q_c, p.alpha, ok_c, torch.rsqrt(r2c),
                                r2c)
    cfx, cfy, cfz = coef * dx, coef * dy, coef * dz
    mgx, mgy, mgz = ncoef * dx, ncoef * dy, ncoef * dz
    if p.combine_forces:
        fx, fy, fz = cfx + mgx, cfy + mgy, cfz + mgz
        return (e_ij, fx, fy, fz, dei, e_c), (-fx, -fy, -fz, dej, e_c)
    return ((e_ij, cfx, cfy, cfz, dei, e_c, mgx, mgy, mgz),
            (-cfx, -cfy, -cfz, dej, e_c, -mgx, -mgy, -mgz))


#: body name -> plain pass body ``fn(o, c, params, mask, lf, cf)``
BODY_FNS = {
    "cn": _cn_body,
    "d3_direct": _d3_direct_body,
    "chain": _chain_body,
    "coulomb": _coulomb_body,
    "d3_direct_coulomb": _d3_direct_coulomb_body,
}


def halfspace_zy(rz: int, ry: int):
    """Half-space (dz, dy) row offsets (dz > 0, or dz == 0 and dy > 0)."""
    return [(dz, dy) for dz in range(-rz, rz + 1) for dy in range(-ry, ry + 1)
            if dz > 0 or (dz == 0 and dy > 0)]


def window_sweep_plain(body: str, radius, own, cand, params: SweepParams,
                       lf=None):
    """Plain PyTorch version of :func:`window_sweep` (any device/dtype); a
    batched grid's planes run as the loop over its systems."""
    n_out, n_j = body_outputs(body, params)
    return per_system(lambda o, c, l: cell_windows_plain(
        BODY_FNS[body], radius, o, c, params, n_out, n_j, lf=l),
        *_planes(body, radius, own, cand, lf))


def cell_windows_plain(fn, radius, own, cand, params, n_out, n_j, lf=None,
                       cf=None):
    """The pair-once enumeration by own cell: the home row and every
    half-space row offset, each own cell against its 2*rx+1 x-cells (home:
    cells left of centre skipped, the centre keeping slot pairs i < j).

    Materializes each offset's ``[cz, cy, cx, cap, (2*rx+1)*cap]`` pair
    blocks, so its memory grows with the grid; the CUDA kernels keep them
    on chip.  ``cf [ez, ey, ex, cap, F]`` are zm-wide candidate rows.
    """
    _, cz, cy, cx, cap = own.shape
    rz, ry, rx = radius
    nw = 2 * rx + 1
    ncand = nw * cap
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
        cf_win = None
        if cf is not None:
            frows = cf[z0:z0 + cz, y0:y0 + cy]
            cf_win = torch.cat([frows[:, :, c:c + cx] for c in range(nw)],
                               dim=-2)
        own_blocks, j_blocks = fn(o, win[..., None, :], params,
                                  home_mask if is_home else None, lf, cf_win)
        for k, blk in enumerate(own_blocks):
            own_out[k] += blk.sum(dim=-1)
        for k, blk in enumerate(j_blocks):
            d = blk.sum(dim=-2).reshape(cz, cy, cx, nw, cap)
            for c in range(nw):
                j_out[k, z0:z0 + cz, y0:y0 + cy, c:c + cx] += d[..., c, :]
    return own_out, j_out

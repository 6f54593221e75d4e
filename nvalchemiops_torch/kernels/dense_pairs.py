# SPDX-License-Identifier: Apache-2.0
"""Batched triangle-block dense pair sweep (csrc/dense_pairs.cu).

Counterpart of ``nvalchemiops_tpu/pallas/dense_sweep.py:dense_sweep`` with
the three pass bodies of the JAX package's dense DFT-D3
(``dense_d3.py:349-362``, ``:388-438``, ``:454-478``).  Atoms of every
system are cut into ``TILE``-atom tiles; every upper-triangle tile pair
``(bi, bj)``, ``bi <= bj``, is visited once (diagonal tiles keep the strict
upper triangle ``j > i``).  Each pair adds its i-side terms to atom i's rows
and its j-side terms to atom j's rows, so both directions of a pair come
out of one evaluation.  Displacements are the minimum image plus the
second-image combos, in the base + delta form of ``combo_carts``
(``dense_d3.py:307-343``).

=========  ==================================  ==================  =========
body       features per atom ``[S, n_pad, F]``  outputs             j side
=========  ==================================  ==================  =========
``cn``     fx fy fz rcov alive                 cn                  cn
``direct`` fx fy fz si z ew[mesh] edcw[mesh]   e de fx fy fz       de -f
           (+ i rows ``lw = [l0w | l1cw]``)
``chain``  fx fy fz rcov alive de              fx fy fz            -f
=========  ==================================  ==================  =========

``f*`` are fractional coordinates; the cell rows ride along as ``cells [S,
9]``.  The result is ``out [n_out, S, n_pad]`` with i- and j-side sums
combined; the direct energy is summed on the i side only (pairs once).
The C6 interpolation of the direct body is three mesh-term dots against
the i row at the ``z_j * mesh`` offset: the w-prescaled features ``l0w,
l1cw`` (i) and ``ew, edcw`` (j) of ``dense_d3.py:369-377``.
"""

from __future__ import annotations

import ctypes

import torch

from nvalchemiops_torch.kernels import launch_counts
from nvalchemiops_torch.kernels.build import (
    check_cuda_tensors, check_launch, current_stream, launches_kernel,
    load_library, on_device,
)
from nvalchemiops_torch.kernels.window_sweep import SweepParams

__all__ = ["TILE", "DENSE_BODIES", "dense_pairs", "dense_pairs_plain"]

#: atoms per tile; ``n_pad`` must be a multiple of it
TILE = 64
_MAX_COMBOS = 8

#: body name -> (C body id, n_out, first output with a j-side term)
DENSE_BODIES = {"cn": (0, 1, 0), "direct": (1, 5, 1), "chain": (2, 3, 0)}
_N_FEAT = {"cn": 5, "chain": 6}     # direct: 5 + 2 * mesh
#: elements of each pair plane the plain version materializes at once
_PLAIN_PAIR_ELEMS = 1 << 22


def _combo_bits(combos):
    return [int(bx) | (int(by) << 1) | (int(bz) << 2)
            for bx, by, bz in combos]


def _check(body, feats, cells, combos, lw):
    if body not in DENSE_BODIES:
        raise ValueError(f"unknown dense body {body!r}; one of "
                         f"{list(DENSE_BODIES)}")
    if feats.dim() != 3 or feats.shape[1] % TILE:
        raise ValueError(f"feats must be [S, n_pad, F] with n_pad a multiple "
                         f"of {TILE}, got {tuple(feats.shape)}")
    s_count = feats.shape[0]
    if tuple(cells.shape) != (s_count, 9):
        raise ValueError(f"cells must be [S, 9], got {tuple(cells.shape)}")
    if not 1 <= len(combos) <= _MAX_COMBOS:
        raise ValueError(f"1..{_MAX_COMBOS} image combos, got {len(combos)}")
    if body == "direct":
        if lw is None or tuple(lw.shape[:2]) != tuple(feats.shape[:2]):
            raise ValueError("direct needs i rows lw [S, n_pad, 2*zm]")
        mesh2 = feats.shape[2] - 5
        if mesh2 <= 0 or mesh2 % 2 or lw.shape[2] % mesh2:
            raise ValueError("direct features must be fx fy fz si z "
                             "ew[mesh] edcw[mesh]")
    elif feats.shape[2] != _N_FEAT[body]:
        raise ValueError(f"{body}: expected {_N_FEAT[body]} features, "
                         f"got {feats.shape[2]}")


def dense_pairs(body: str, feats, cells, combos, params: SweepParams,
                lw=None):
    """Run one pass body over every tile pair of every system: the CUDA
    kernel for float32 CUDA tensors (on their card), else
    :func:`dense_pairs_plain` on the tensors' device.  Returns ``out
    [n_out, S, n_pad]``."""
    _check(body, feats, cells, combos, lw)
    if not launches_kernel(feats):
        return dense_pairs_plain(body, feats, cells, combos, params, lw)
    check_cuda_tensors("dense_pairs", feats, cells,
                       *([lw] if lw is not None else []))
    body_id, n_out, _ = DENSE_BODIES[body]
    s_count, n_pad, n_feat = feats.shape
    out = torch.zeros((n_out, s_count, n_pad), dtype=feats.dtype,
                      device=feats.device)
    mesh = (n_feat - 5) // 2 if body == "direct" else 0
    zm = lw.shape[2] // 2 if lw is not None else 0
    bits = _combo_bits(combos)
    combo_arr = (ctypes.c_int * _MAX_COMBOS)(*(bits + [0] * (_MAX_COMBOS
                                                            - len(bits))))
    p = params
    with on_device(feats):
        err = load_library().nv_dense_pairs(
            body_id, feats.data_ptr(), cells.data_ptr(),
            lw.data_ptr() if lw is not None else None, out.data_ptr(),
            s_count, n_pad, n_feat, p.cutoff * p.cutoff, p.a1, p.a2, p.s6,
            p.s8, p.k1, p.k3, mesh, zm, len(bits), combo_arr,
            current_stream(feats))
    check_launch(f"dense_pairs[{body}]", err)
    launch_counts[f"dense_pairs_{body}"] += 1
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def triangle_tiles(n_tiles: int):
    """Upper-triangle tile pairs ``(bi, bj)``, ``bi <= bj``, row-major (the
    CUDA kernel's block order)."""
    return [(bi, bj) for bi in range(n_tiles) for bj in range(bi, n_tiles)]


def _combo_carts(gi, gj, cells, combos):
    """Displacements per combo: the minimum image once, each further combo
    as ``base - sum_{c in bits} sign(d0_c) cell_row_c``."""
    def cell(k):
        return cells[:, k].reshape(-1, 1, 1, 1)

    ds0 = []
    for c in range(3):
        d = gj[..., c] - gi[..., c]
        ds0.append(d - torch.round(d))
    base = [ds0[0] * cell(ax) + ds0[1] * cell(3 + ax) + ds0[2] * cell(6 + ax)
            for ax in range(3)]
    sgn = [torch.where(d >= 0, 1.0, -1.0).to(d.dtype) for d in ds0]
    outs = []
    for bits in combos:
        d = list(base)
        for c in range(3):
            if bits[c]:
                d = [d[ax] - sgn[c] * cell(c * 3 + ax) for ax in range(3)]
        outs.append(d)
    return outs


def _ok(pair_ok, r2, p):
    return pair_ok & (r2 < p.cutoff * p.cutoff) & (r2 > 1e-20)


def _cn_body(gi, gj, li, cells, combos, p, pair_ok):
    rc = gi[..., 3] + gj[..., 3]
    alive = gi[..., 4] * gj[..., 4]
    acc = torch.zeros_like(rc)
    for dx, dy, dz in _combo_carts(gi, gj, cells, combos):
        r2 = dx * dx + dy * dy + dz * dz
        ok = _ok(pair_ok, r2, p)
        inv_r = torch.rsqrt(torch.where(ok, r2, torch.ones_like(r2)))
        f = 1.0 / (1.0 + torch.exp(-p.k1 * (rc * inv_r - 1.0)))
        acc = acc + torch.where(ok, f, torch.zeros_like(f)) * alive
    return [acc], [acc]


def _direct_body(gi, gj, li, cells, combos, p, pair_ok):
    mesh = (gj.shape[-1] - 5) // 2
    zm = li.shape[-1] // 2
    zmax1 = zm // mesh
    zj = gj[..., 0, :, 4]                                  # [S, P, TILE]
    zrow = (torch.arange(zm, device=zj.device) // mesh).to(zj.dtype)
    zmask = zj[..., None] == zrow                           # [S, P, TILE, zm]
    zero = torch.zeros((), dtype=gj.dtype, device=gj.device)
    ew = gj[..., 0, :, 5:5 + mesh].repeat(1, 1, 1, zmax1)
    edcw = gj[..., 0, :, 5 + mesh:].repeat(1, 1, 1, zmax1)
    rfw = torch.where(zmask, ew, zero).transpose(-1, -2)
    rfdcw = torch.where(zmask, edcw, zero).transpose(-1, -2)
    l0w, l1cw = li[..., :zm], li[..., zm:]                  # [S, P, TILE, zm]
    zacc = torch.matmul(l0w, rfw)
    zdi = torch.matmul(l1cw, rfw)
    zdj = torch.matmul(l0w, rfdcw)
    good = pair_ok & (zacc >= 1e-12)
    c6m = torch.where(good, zacc, zero)
    zdiw = torch.where(good, (-2.0 * p.k3) * zdi, zero)
    zdjw = torch.where(good, (-2.0 * p.k3) * zdj, zero)
    t = gi[..., 3] * gj[..., 3]
    rr = t * t
    r0 = p.a1 * t + p.a2
    r0_2 = r0 * r0
    r0_6 = r0_2 * r0_2 * r0_2
    r0_8 = r0_6 * r0_2
    ds_acc = torch.zeros_like(t)
    fxb, fyb, fzb = (torch.zeros_like(t) for _ in range(3))
    for dx, dy, dz in _combo_carts(gi, gj, cells, combos):
        r2 = dx * dx + dy * dy + dz * dz
        ok = _ok(pair_ok, r2, p)
        r2s = torch.where(ok, r2, torch.ones_like(r2))
        r4 = r2s * r2s
        r6 = r4 * r2s
        r8 = r4 * r4
        den6 = r6 + r0_6
        den8 = r8 + r0_8
        rec = 1.0 / (den6 * den8)
        den6_inv = rec * den8
        den8_inv = rec * den6
        damp = torch.where(ok, p.s6 * den6_inv + p.s8 * rr * den8_inv, zero)
        ds_acc = ds_acc + damp
        dd6 = -6.0 * p.s6 * r4 * den6_inv * den6_inv
        dd8 = -8.0 * p.s8 * rr * r6 * den8_inv * den8_inv
        coef = torch.where(ok, -c6m * (dd6 + dd8), zero)
        fxb = fxb + coef * dx
        fyb = fyb + coef * dy
        fzb = fzb + coef * dz
    return ([c6m * ds_acc, ds_acc * zdiw, fxb, fyb, fzb],
            [None, ds_acc * zdjw, -fxb, -fyb, -fzb])


def _chain_body(gi, gj, li, cells, combos, p, pair_ok):
    rc = gi[..., 3] + gj[..., 3]
    alive = gi[..., 4] * gj[..., 4]
    de_pair = gi[..., 5] + gj[..., 5]
    zero = torch.zeros((), dtype=gi.dtype, device=gi.device)
    fxb, fyb, fzb = (torch.zeros_like(rc) for _ in range(3))
    for dx, dy, dz in _combo_carts(gi, gj, cells, combos):
        r2 = dx * dx + dy * dy + dz * dz
        ok = _ok(pair_ok, r2, p)
        inv_r = torch.rsqrt(torch.where(ok, r2, torch.ones_like(r2)))
        rrq = rc * inv_r
        f3 = 1.0 / (1.0 + torch.exp(-p.k1 * (rrq - 1.0)))
        dcn = -f3 * (1.0 - f3) * p.k1 * rrq * inv_r * inv_r
        coef = torch.where(ok, de_pair * dcn * alive, zero)
        fxb = fxb + coef * dx
        fyb = fyb + coef * dy
        fzb = fzb + coef * dz
    return [fxb, fyb, fzb], [-fxb, -fyb, -fzb]


_BODY_FNS = {"cn": _cn_body, "direct": _direct_body, "chain": _chain_body}


def dense_pairs_plain(body: str, feats, cells, combos, params: SweepParams,
                      lw=None):
    """Plain PyTorch version of :func:`dense_pairs` (any device/dtype).

    Visits the kernel's tile pairs, a chunk of pairs at a time: each chunk
    materializes ``[S, pairs, TILE, TILE]`` pair planes (about
    ``_PLAIN_PAIR_ELEMS`` elements each), reduced into the i rows and j
    rows.
    """
    _check(body, feats, cells, combos, lw)
    _, n_out, _ = DENSE_BODIES[body]
    s_count, n_pad, n_feat = feats.shape
    nt = n_pad // TILE
    dev = feats.device
    fn = _BODY_FNS[body]
    out = torch.zeros((n_out, s_count, nt, TILE), dtype=feats.dtype,
                      device=dev)
    tiles = feats.reshape(s_count, nt, TILE, n_feat)
    ltiles = None if lw is None else lw.reshape(s_count, nt, TILE, -1)
    pairs = triangle_tiles(nt)
    chunk = max(1, _PLAIN_PAIR_ELEMS // (s_count * TILE * TILE))
    tri = (torch.arange(TILE, device=dev)[None, :]
           > torch.arange(TILE, device=dev)[:, None])       # j > i
    for c0 in range(0, len(pairs), chunk):
        sel = pairs[c0:c0 + chunk]
        bi = torch.tensor([a for a, _ in sel], device=dev)
        bj = torch.tensor([b for _, b in sel], device=dev)
        gi = tiles[:, bi][:, :, :, None, :]                 # [S, P, T, 1, F]
        gj = tiles[:, bj][:, :, None, :, :]                 # [S, P, 1, T, F]
        li = None if ltiles is None else ltiles[:, bi]
        pair_ok = (bi != bj)[None, :, None, None] | tri
        i_blks, j_blks = fn(gi, gj, li, cells, combos, params, pair_ok)
        for k in range(n_out):
            out[k].index_add_(1, bi, i_blks[k].sum(-1))
            if j_blks[k] is not None:
                out[k].index_add_(1, bj, j_blks[k].sum(-2))
    return out.reshape(n_out, s_count, n_pad)

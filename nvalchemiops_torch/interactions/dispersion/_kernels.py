# SPDX-License-Identifier: Apache-2.0
"""DFT-D3(BJ) compute core of :func:`dftd3`, in plain PyTorch.

Counterpart of ``nvalchemiops_tpu/interactions/dispersion/_kernels.py``:
the same three sweeps (CN; energy, direct forces and dE/dCN; CN chain-rule
forces) over the neighbour matrix (:func:`dftd3_matrix_kernel`) or the
CSR-ordered pair list (:func:`dftd3_list_kernel`), with the same math: the
switched dE/dCN, the 0.5 factors on energy and virial, the ``c6 >= 1e-12``
pair gate, ``numbers == 0`` as padding, ``r > 1e-12`` and per-atom cells
under ``batch_idx``.  The JAX module's two TPU layout rules are left
behind: geometry travels as ``[.., 3]`` vectors and the C6 tables as
``[.., 5, 5]`` gathers, and the C6 interpolation is the vectorised
masked-max form (:func:`_c6_interpolate`) instead of the 25-step unrolled
online softmax; both are exact stabilisations of one log-sum-exp.

Both sweeps cut the pairs into chunks of at most ``D3_PAIR_CHUNK`` slots:
whole rows first, and the columns of a row only where one row is wider
than the cap.  Every per-atom quantity is a row sum (a ``sum`` over the
matrix's columns, a ``segment_reduce`` over the list's sorted rows), and
per-system totals are sums of those rows in atom order, so the results
do not depend on the order of any atomic; on the matrix, cutting rows
only gives the same bits at every chunk size.
"""

from __future__ import annotations

import numpy as np
import torch

#: pair slots per pass chunk.  The C6 stage holds about seven ``[P, 5, 5]``
#: temporaries (~0.7 KB a slot in f32, ~1.4 KB in f64), so a chunk of 2^20
#: slots keeps them near 1 GiB.
D3_PAIR_CHUNK = 1 << 20

_NEG_BIG = -1e20


def _s5_switch(r, r_on, r_off, inv_w):
    """C2-smooth S5 switch and its derivative (``r_off <= r_on``: off)."""
    one = torch.ones((), dtype=r.dtype, device=r.device)
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    if r_off <= r_on:
        return one.expand_as(r), zero.expand_as(r)
    t = torch.clamp((r - r_on) * inv_w, 0.0, 1.0)
    t2 = t * t
    t3 = t2 * t
    t4 = t3 * t
    s5 = 10.0 * t3 - 15.0 * t4 + 6.0 * t4 * t
    ds5 = (-30.0 * t2 + 60.0 * t3 - 30.0 * t4) * inv_w
    sw = torch.where(r <= r_on, one, torch.where(r >= r_off, zero, 1.0 - s5))
    dsw = torch.where((r <= r_on) | (r >= r_off), zero, ds5)
    return sw, dsw


def _c6_interpolate(cn_i, cn_j, c6ab_mat, cnref_i_mat, cnref_j_mat, k3):
    """Gaussian C6 interpolation and its CN derivatives over pairs.

    ``cn_i``/``cn_j [...]``, tables ``[..., 5, 5]`` (``cnref_j_mat`` as
    stored, ``cn_ref[z_j, z_i]``).  The exponents are stabilised by their
    largest value over the available references (a masked max, then one
    exp).  Returns ``(c6, dC6/dCN_i, dC6/dCN_j)``.
    """
    ref_ok = c6ab_mat != 0.0
    di = cn_i[..., None, None] - cnref_i_mat
    dj = cn_j[..., None, None] - cnref_j_mat.transpose(-1, -2)
    arg = di * di
    arg.addcmul_(dj, dj).mul_(k3)
    max_exp = arg.masked_fill(~ref_ok, _NEG_BIG).amax(dim=(-2, -1))
    has_ref = max_exp > 0.1 * _NEG_BIG
    zero = torch.zeros((), dtype=arg.dtype, device=arg.device)
    max_exp = torch.where(has_ref, max_exp, zero)
    # masked to -inf before the exp (exp gives 0 there): the in-place ops
    # stay differentiable, as exp_ saves its output and nothing writes it
    l_pq = arg.sub_(max_exp[..., None, None]).masked_fill_(
        ~ref_ok, -float("inf")).exp_()
    zl = c6ab_mat * l_pq
    w = l_pq.sum(dim=(-2, -1))
    z = zl.sum(dim=(-2, -1))
    w_di = (l_pq * di).sum(dim=(-2, -1))
    w_dj = (l_pq * dj).sum(dim=(-2, -1))
    z_di = (zl * di).sum(dim=(-2, -1))
    z_dj = (zl * dj).sum(dim=(-2, -1))
    good = has_ref & (w > 1e-12)
    w_safe = torch.where(good, w, torch.ones_like(w))
    c6 = torch.where(good, z / w_safe, zero)
    factor = 2.0 * k3 / w_safe
    dc6_dcni = torch.where(good, factor * (z_di - c6 * w_di), zero)
    dc6_dcnj = torch.where(good, factor * (z_dj - c6 * w_dj), zero)
    return c6, dc6_dcni, dc6_dcnj


def _row_chunks(lengths, cap):
    """Chunks of at most ``cap`` slots over rows of ``lengths`` slots:
    ``(a0, a1, cols)`` with rows ``a0:a1`` whole (``cols`` None), or one
    row ``a0`` cut to the columns ``cols = (c0, c1)`` where it alone is
    wider than ``cap``."""
    cap = max(int(cap), 1)
    ends = np.cumsum(lengths, dtype=np.int64)
    chunks, a0, start = [], 0, 0
    while a0 < len(lengths):
        a1 = int(np.searchsorted(ends, start + cap, side="right"))
        if a1 > a0:
            chunks.append((a0, a1, None))
        else:
            width = int(lengths[a0])
            chunks.extend((a0, a0 + 1, (c0, min(c0 + cap, width)))
                          for c0 in range(0, width, cap))
            a1 = a0 + 1
        start, a0 = int(ends[a1 - 1]), a1
    return chunks


def _cartesian(shifts, cell):
    """Cartesian shifts ``s @ cell`` from integer shifts ``[.., 3]`` and a
    cell ``[3, 3]`` or per-pair cells ``[.., 3, 3]``, in full precision
    (elementwise, no matrix product)."""
    s = shifts.to(cell.dtype)
    return (s[..., 0:1] * cell[..., 0, :] + s[..., 1:2] * cell[..., 1, :]
            + s[..., 2:3] * cell[..., 2, :])


def _clipped(idx, n):
    """Atom indices clipped to ``0..n-1`` as the JAX sweeps clip them; a
    copy only where one is out of range (one host read)."""
    if idx.numel() == 0:
        return idx
    lo, hi = torch.stack(torch.aminmax(idx)).tolist()
    if lo >= 0 and hi < n:
        return idx
    return idx.clamp(0, max(n - 1, 0))


def _system_sum(x, bidx, num_systems):
    """Per-system sums ``[num_systems, ..]`` of per-atom rows ``x [N, ..]``
    in atom order (segment sums over ``bidx``; a stable sort first where
    it is not sorted), so equal inputs give equal bits."""
    if bidx is None:
        return x.sum(dim=0, keepdim=True)
    lengths = torch.bincount(bidx.long(), minlength=num_systems)
    if x.shape[0] > 1 and bool((bidx[1:] < bidx[:-1]).any()):
        x = x[torch.argsort(bidx, stable=True)]
    return torch.segment_reduce(x, "sum", lengths=lengths, axis=0)


class _Tables:
    """The D3 tables and scalars of one call, in the positions' dtype."""

    def __init__(self, rcov, r4r2, c6ab, cn_ref, a1, a2, s8, k1, k3, s6,
                 s5_on, s5_off):
        self.rcov, self.r4r2 = rcov, r4r2
        zmax1 = c6ab.shape[0]
        mesh = c6ab.shape[-1]
        self.zmax1 = zmax1
        self.c6 = c6ab.reshape(zmax1 * zmax1, mesh, mesh)
        self.cn_ref = cn_ref.reshape(zmax1 * zmax1, mesh, mesh)
        self.a1, self.a2, self.s8 = float(a1), float(a2), float(s8)
        self.k1, self.k3, self.s6 = float(k1), float(k3), float(s6)
        self.s5_on, self.s5_off = float(s5_on), float(s5_off)
        self.inv_w = (1.0 / max(self.s5_off - self.s5_on, 1e-30)
                      if self.s5_off > self.s5_on else 0.0)


def _cn_terms(t, z_i, z_j, valid, r_safe):
    """Pass 1: the counting function of each pair (0 where invalid)."""
    rcov_ij = t.rcov[z_i] + t.rcov[z_j]
    f_cn = 1.0 / (1.0 + torch.exp(-t.k1 * (rcov_ij / r_safe - 1.0)))
    return torch.where(valid, f_cn, torch.zeros_like(f_cn))


def _direct_terms(t, z_i, z_j, cn_i, cn_j, valid, d, r_safe, virial):
    """Pass 2 per pair: ``(e, f [.., 3], decn, v [.., 9] or None)``, the
    switched energy, the direct force on i, dE/dCN_i and the virial
    terms ``f_a d_b``, each 0 outside the pair gate."""
    zi = z_i.long()
    zj = z_j.long()
    pij = zi * t.zmax1 + zj
    pji = zj * t.zmax1 + zi
    c6, dc6_dcni, _ = _c6_interpolate(cn_i, cn_j, t.c6[pij], t.cn_ref[pij],
                                      t.cn_ref[pji], t.k3)
    pair_ok = valid & (c6 >= 1e-12)
    r4r2_ij = 3.0 * t.r4r2[zi] * t.r4r2[zj]
    r0 = t.a1 * torch.sqrt(r4r2_ij) + t.a2
    r2 = r_safe * r_safe
    r4 = r2 * r2
    r6 = r4 * r2
    r8 = r4 * r4
    r0_2 = r0 * r0
    r0_6 = r0_2 * r0_2 * r0_2
    r0_8 = r0_2 * r0_2 * r0_2 * r0_2
    den6_inv = 1.0 / (r6 + r0_6)
    den8_inv = 1.0 / (r8 + r0_8)
    damp_sum = t.s6 * den6_inv + t.s8 * r4r2_ij * den8_inv
    e_ij = -c6 * damp_sum
    dd6 = -6.0 * t.s6 * (r4 * r_safe) * den6_inv * den6_inv
    dd8 = -8.0 * t.s8 * r4r2_ij * (r6 * r_safe) * den8_inv * den8_inv
    de_dr = -c6 * (dd6 + dd8)
    sw, dsw = _s5_switch(r_safe, t.s5_on, t.s5_off, t.inv_w)
    de_dr_sw = sw * de_dr + e_ij * dsw
    zero = torch.zeros((), dtype=r_safe.dtype, device=r_safe.device)
    coef = torch.where(pair_ok, de_dr_sw / r_safe, zero)
    f = coef[..., None] * d
    e = torch.where(pair_ok, e_ij * sw, zero)
    # switched dE/dCN (the JAX module's note on the reference's unswitched
    # accumulation)
    decn = torch.where(pair_ok, -damp_sum * sw * dc6_dcni, zero)
    v = None
    if virial:
        v = (f[..., :, None] * d[..., None, :]).flatten(-2)
    return e, f, decn, v


def _chain_terms(t, z_i, z_j, decn_i, decn_j, valid, d, r_safe, virial):
    """Pass 3 per pair: the CN chain-rule force on i and its virial
    terms."""
    rr = (t.rcov[z_i] + t.rcov[z_j]) / r_safe
    f_cn = 1.0 / (1.0 + torch.exp(-t.k1 * (rr - 1.0)))
    dcn_dr = -f_cn * (1.0 - f_cn) * t.k1 * rr / r_safe
    coef = torch.where(valid, (decn_i + decn_j) * dcn_dr / r_safe,
                       torch.zeros_like(rr))
    f = coef[..., None] * d
    v = (f[..., :, None] * d[..., None, :]).flatten(-2) if virial else None
    return f, v


def _separation(pos_i, pos_j, shifts, cell, valid):
    """``d = (r_j + s @ cell) - r_i``, ``r`` and the validity ``r >
    1e-12``; ``r_safe`` is 1 where the pair is invalid."""
    d = pos_j + _cartesian(shifts, cell) - pos_i if shifts is not None \
        else pos_j - pos_i
    r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    pos_r2 = r2 > 0
    r = torch.sqrt(torch.where(pos_r2, r2, torch.ones_like(r2))) * pos_r2
    valid = valid & (r > 1e-12)
    return valid, d, torch.where(valid, r, torch.ones_like(r))


def _sweeps(n, dtype, device, chunks, pair_fn, reduce_fn, t, virial,
            num_systems, bidx):
    """The three passes over ``chunks``: ``pair_fn(chunk)`` gives the
    chunk's ``(rows, own, z_i, z_j, j, valid, d, r_safe)``, where ``rows``
    selects the chunk's atoms and ``own(x)`` gives a per-atom ``x`` of each
    pair's own atom, broadcasting against the per-pair values;
    ``reduce_fn(chunk, x)`` sums per-pair ``x`` over each row.  Returns
    ``(energy, forces, coord_num, virial)``."""
    cn = torch.zeros(n, dtype=dtype, device=device)
    for ch in chunks:
        rows, _, z_i, z_j, _, valid, _, r_safe = pair_fn(ch)
        cn[rows] += reduce_fn(ch, _cn_terms(t, z_i, z_j, valid, r_safe))

    e_at = torch.zeros(n, dtype=dtype, device=device)
    f_at = torch.zeros((n, 3), dtype=dtype, device=device)
    decn = torch.zeros(n, dtype=dtype, device=device)
    v_at = torch.zeros((n, 9), dtype=dtype, device=device) if virial else None
    for ch in chunks:
        rows, own, z_i, z_j, j, valid, d, r_safe = pair_fn(ch)
        e, f, de, v = _direct_terms(t, z_i, z_j, own(cn), cn[j], valid, d,
                                    r_safe, virial)
        e_at[rows] += reduce_fn(ch, e)
        f_at[rows] += reduce_fn(ch, f)
        decn[rows] += reduce_fn(ch, de)
        if virial:
            v_at[rows] += reduce_fn(ch, v)

    for ch in chunks:
        rows, own, z_i, z_j, j, valid, d, r_safe = pair_fn(ch)
        f, v = _chain_terms(t, z_i, z_j, own(decn), decn[j], valid, d,
                            r_safe, virial)
        f_at[rows] += reduce_fn(ch, f)
        if virial:
            v_at[rows] += reduce_fn(ch, v)

    energy = 0.5 * _system_sum(e_at, bidx, num_systems)
    vir = torch.zeros((num_systems, 3, 3), dtype=dtype, device=device)
    if virial:
        vir = -0.5 * _system_sum(v_at, bidx, num_systems).reshape(-1, 3, 3)
    return energy, f_at, cn, vir


def dftd3_matrix_kernel(positions, numbers, neighbor_matrix, shifts, cell_b,
                        batch_idx, rcov, r4r2, c6ab, cn_ref, a1, a2, s8, k1,
                        k3, s6, s5_on, s5_off, fill_value: int,
                        periodic: bool, num_systems: int,
                        compute_virial: bool):
    """D3 over a padded neighbour matrix ``[N, K]``: row sums, no scatter.

    ``shifts`` are integer ``[N, K, 3]`` unit shifts (None when not
    periodic), ``cell_b [B, 3, 3]``; per-atom cells ``cell_b[batch_idx]``
    where ``B > 1``.  Chunks of whole rows of at most ``D3_PAIR_CHUNK``
    slots; a row wider than that is cut into columns.
    Returns ``(energy [S], forces [N, 3], coord_num [N], virial [S, 3,
    3])``.
    """
    n, k = neighbor_matrix.shape
    dtype, device = positions.dtype, positions.device
    t = _Tables(rcov, r4r2, c6ab, cn_ref, a1, a2, s8, k1, k3, s6, s5_on,
                s5_off)
    z = numbers
    per_atom_cell = periodic and batch_idx is not None and cell_b.shape[0] > 1
    chunks = _row_chunks(np.full(n, k), D3_PAIR_CHUNK)

    def pair_fn(ch):
        a0, a1_, cols = ch
        c0, c1 = cols if cols is not None else (0, k)
        rows = slice(a0, a1_)
        nm = neighbor_matrix[rows, c0:c1]
        valid = (nm < fill_value) & (nm >= 0)
        j = nm.clamp(0, max(n - 1, 0)).long()
        z_i = z[rows, None]
        z_j = z[j]
        valid &= (z_j != 0) & (z_i != 0)
        sh = cell = None
        if periodic:
            sh = shifts[rows, c0:c1]
            cell = (cell_b[batch_idx[rows].long()][:, None] if per_atom_cell
                    else cell_b[0])
        valid, d, r_safe = _separation(positions[rows, None], positions[j],
                                       sh, cell, valid)
        return (rows, lambda x: x[rows, None], z_i, z_j, j, valid, d,
                r_safe)

    def reduce_fn(ch, x):
        return x.sum(dim=1)

    return _sweeps(n, dtype, device, chunks, pair_fn, reduce_fn, t,
                   compute_virial, num_systems, batch_idx)


def dftd3_list_kernel(positions, numbers, idx_i, idx_j, unit_shifts, cell_b,
                      batch_idx, rcov, r4r2, c6ab, cn_ref, a1, a2, s8, k1,
                      k3, s6, s5_on, s5_off, periodic: bool,
                      num_systems: int, compute_virial: bool):
    """D3 over a COO pair list in CSR order (``idx_i`` ascending).

    Each chunk holds whole rows of at most ``D3_PAIR_CHUNK`` pairs, and a
    row longer than that is cut; per-atom sums are ``segment_reduce`` over
    the rows' lengths, so nothing depends on the order of an atomic.  An
    unsorted list is sorted (stable) by ``idx_i`` first.  ``unit_shifts`` are integer ``[P, 3]`` (None when
    not periodic).  Returns as :func:`dftd3_matrix_kernel`.
    """
    n = positions.shape[0]
    dtype, device = positions.dtype, positions.device
    t = _Tables(rcov, r4r2, c6ab, cn_ref, a1, a2, s8, k1, k3, s6, s5_on,
                s5_off)
    ii, jj = _clipped(idx_i, n), _clipped(idx_j, n)
    if ii.shape[0] > 1 and bool((ii[1:] < ii[:-1]).any()):
        order = torch.argsort(ii, stable=True)
        ii, jj = ii[order], jj[order]
        unit_shifts = unit_shifts[order] if unit_shifts is not None else None
    counts = torch.bincount(ii, minlength=n)
    counts_host = counts.cpu().numpy()
    starts = np.concatenate([[0], np.cumsum(counts_host)])
    chunks = _row_chunks(counts_host, D3_PAIR_CHUNK)
    per_pair_cell = periodic and batch_idx is not None and cell_b.shape[0] > 1
    z = numbers

    def span(ch):
        a0, a1_, cols = ch
        if cols is None:
            return int(starts[a0]), int(starts[a1_])
        return int(starts[a0]) + cols[0], int(starts[a0]) + cols[1]

    def pair_fn(ch):
        p0, p1 = span(ch)
        i = ii[p0:p1].long()
        j = jj[p0:p1].long()
        z_i, z_j = z[i], z[j]
        valid = (z_i != 0) & (z_j != 0)
        sh = cell = None
        if periodic:
            sh = unit_shifts[p0:p1]
            cell = cell_b[batch_idx[i].long()] if per_pair_cell else cell_b[0]
        valid, d, r_safe = _separation(positions[i], positions[j], sh, cell,
                                       valid)
        return (slice(ch[0], ch[1]), lambda x: x[i], z_i, z_j, j, valid, d,
                r_safe)

    def reduce_fn(ch, x):
        a0, a1_, cols = ch
        lengths = (counts[a0:a1_] if cols is None else torch.tensor(
            [cols[1] - cols[0]], device=device))
        return torch.segment_reduce(x, "sum", lengths=lengths, axis=0)

    return _sweeps(n, dtype, device, chunks, pair_fn, reduce_fn, t,
                   compute_virial, num_systems, batch_idx)

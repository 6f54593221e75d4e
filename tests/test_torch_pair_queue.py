# SPDX-License-Identifier: Apache-2.0
"""The enumeration of the two distance-first pair sweeps, on the CPU.

Kernel 4 (``csrc/dense_pairs.cu``) and kernel 1 (``csrc/window_sweep.cu``)
test the distance of every pair they meet first, queue the pairs in range
per warp (a ballot and popcount prefix into shared memory), and run the
pass body only on the queued pairs, 32 at a time.  Torch emulations of
both kernels' work partitions and queues, in f64, show that:

- every pair in range enters a queue exactly once, and nothing out of range
  (or dead, for the CN and chain bodies) enters one;
- every pop of the dense kernel's queue holds one i row, so its i-side sums
  stay in registers until the row ends;
- the bodies run on the queued pairs sum to the plain versions
  (``dense_pairs_plain``, ``window_sweep_plain``) to 1e-12.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nvalchemiops_torch import grid
from nvalchemiops_torch.interactions.dispersion import dense_d3, grid_d3
from nvalchemiops_torch.kernels import chunk_sweep as cs
from nvalchemiops_torch.kernels import dense_pairs as dp
from nvalchemiops_torch.kernels import row_sweep as rs
from nvalchemiops_torch.kernels import window_sweep as ws


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: Tier-1 runs six test workers on the CPU, and a
    torch thread pool in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F64 = torch.float64
LANES = 32
WARPS = 8            # warps per block in both kernels
J_TILES = 8          # j tiles per block of the dense kernel
RTOL = 1e-12


class WarpQueue:
    """A warp's queue as the kernels keep it: each round appends its hits
    in lane order; once 32 or more wait, the oldest 32 run as one batch."""

    def __init__(self):
        self.waiting = []
        self.batches = []

    def push(self, hits):
        assert len(hits) <= LANES
        self.waiting.extend(hits)
        if len(self.waiting) >= LANES:
            self.batches.append(self.waiting[:LANES])
            self.waiting = self.waiting[LANES:]

    def drain(self):
        if self.waiting:
            self.batches.append(self.waiting)
            self.waiting = []
        assert all(len(b) == LANES for b in self.batches[:-1])
        return self.batches


def _close(got, want):
    for g, w in zip(got, want):
        scale = max(w.abs().max().item(), 1e-300)
        assert (g - w).abs().max().item() <= RTOL * scale


def _d3_tables(rng, zmax=4):
    rcov = np.concatenate([[0.0], rng.uniform(0.6, 1.4, zmax)])
    r4r2 = np.concatenate([[0.0], rng.uniform(2.0, 6.0, zmax)])
    cna = np.concatenate([np.zeros((1, 5)),
                          np.cumsum(rng.uniform(0.3, 1.0, (zmax, 5)), 1)])
    c6 = rng.uniform(5.0, 40.0, (zmax + 1, zmax + 1, 5, 5))
    c6[0] = 0.0
    c6[:, 0] = 0.0
    c6 = 0.5 * (c6 + np.swapaxes(np.swapaxes(c6, 0, 1), 2, 3))
    return rcov, r4r2, c6, cna


def _record(fn, *targets):
    """Run ``fn`` with each ``(module, name)`` of ``targets`` recording its
    calls; returns them in call order as ``[(args, kwargs)]``."""
    calls = []
    undo = []
    for module, name in targets:
        orig = getattr(module, name)

        def wrapper(*args, _orig=orig, **kwargs):
            calls.append((args, kwargs))
            return _orig(*args, **kwargs)

        setattr(module, name, wrapper)
        undo.append((module, name, orig))
    try:
        fn()
    finally:
        for module, name, orig in reversed(undo):
            setattr(module, name, orig)
    return calls


# ---------------------------------------------------------------------------
# Kernel 4: the dense triangle sweep
# ---------------------------------------------------------------------------


def dense_blocks(n_tiles):
    """``(bi, bj0, j tiles)`` of the kernel's blocks, in blockIdx.x order: an
    i tile and a chunk of up to J_TILES j tiles of the upper triangle."""
    return [(bi, bj0, min(J_TILES, n_tiles - bj0)) for bi in range(n_tiles)
            for bj0 in range(bi, n_tiles, J_TILES)]


def combo_masks(body, fi, fj, cells9, combos, params):
    """The kernel's distance test of atoms ``fi [A, F]`` against ``fj [B,
    F]``: ``[A, B]`` masks with bit k set where combo k is in range (and,
    for CN and chain, both atoms alive)."""
    carts = dp._combo_carts(fi[None, None, :, None], fj[None, None, None],
                            cells9, combos)
    mask = torch.zeros((fi.shape[0], fj.shape[0]), dtype=torch.int64)
    for k, (dx, dy, dz) in enumerate(carts):
        r2 = (dx * dx + dy * dy + dz * dz)[0, 0]
        mask |= (((r2 < params.cutoff ** 2) & (r2 > 1e-20)).long() << k)
    if body != "direct":
        mask[(fi[:, 4, None] * fj[None, :, 4]) == 0] = 0
    return mask


def emulate_dense(body, feats, cells, combos, params, lw=None):
    """The dense kernel's partition and queues in torch.  Returns ``(out
    [n_out, S, n_pad], visits)``: the sums of the bodies run on the queued
    pairs, and every queued ``(s, a, b, mask)`` (a < b atom indices)."""
    s_count, n_pad, _ = feats.shape
    _, n_out, j_first = dp.DENSE_BODIES[body]
    tile = dp.TILE
    out = torch.zeros((n_out, s_count, n_pad), dtype=feats.dtype)
    visits = []
    for s in range(s_count):
        cell9 = cells[s:s + 1]
        for bi, bj0, njt in dense_blocks(n_pad // tile):
            i0, j0, njw = bi * tile, bj0 * tile, njt * tile
            masks = combo_masks(body, feats[s, i0:i0 + tile],
                                feats[s, j0:j0 + njw], cell9, combos,
                                params).numpy()
            entries = []
            n_chunks = njw // LANES
            for w in range(WARPS):
                # the warp's rows one at a time, its chunks from its own;
                # the queue drains at each row's end
                for i in range(w, tile, WARPS):
                    queue = WarpQueue()
                    for k in range(n_chunks):
                        c0 = (k + w % n_chunks) % n_chunks * LANES
                        lanes = np.arange(c0, c0 + LANES)
                        m = masks[i, lanes]
                        if bj0 == bi and c0 < tile:       # diagonal tile
                            m = np.where(lanes > i, m, 0)
                        queue.push([(i, int(jj), int(m[jj - c0]))
                                    for jj in lanes[m != 0]])
                    for batch in queue.drain():
                        # a pop holds one row: its i-side sums stay in
                        # registers and leave once a row
                        assert {e[0] for e in batch} == {i}
                        entries += batch
            if not entries:
                continue
            ii = torch.tensor([e[0] for e in entries])
            jj = torch.tensor([e[1] for e in entries])
            visits += [(s, i0 + e[0], j0 + e[1], e[2]) for e in entries]
            gi = feats[s, i0 + ii][None, :, None, None]
            gj = feats[s, j0 + jj][None, :, None, None]
            li = None if lw is None else lw[s, i0 + ii][None, :, None]
            ok = torch.ones((1, len(entries), 1, 1), dtype=torch.bool)
            i_blks, j_blks = dp._BODY_FNS[body](gi, gj, li, cell9, combos,
                                                params, ok)
            for k in range(n_out):
                out[k, s].index_add_(0, i0 + ii, i_blks[k].reshape(-1))
                if k >= j_first:
                    out[k, s].index_add_(0, j0 + jj, j_blks[k].reshape(-1))
    return out, visits


def in_range_pairs(body, feats, cells, combos, params):
    """Every ``(s, a, b, mask)``, a < b, with a combo in range: all pairs of
    each system tested at once."""
    found = []
    for s in range(feats.shape[0]):
        m = combo_masks(body, feats[s], feats[s], cells[s:s + 1], combos,
                        params)
        a, b = torch.nonzero(torch.triu(m, diagonal=1), as_tuple=True)
        found += [(s, int(x), int(y), int(m[x, y])) for x, y in zip(a, b)]
    return found


def dense_calls(seed, b, n, box, cutoff, dead=0):
    """The three dense sweep calls of ``batch_dense_dftd3`` in f64 on the
    CPU (atoms padded to a multiple of the tile; ``dead`` element-0 atoms
    at random places)."""
    rng = np.random.default_rng(seed)
    tab = _d3_tables(rng)
    pos = torch.as_tensor(rng.uniform(0, box, (b, n, 3)), dtype=F64)
    numbers = rng.integers(1, 5, (b, n)).astype(np.int32)
    if dead:
        numbers[:, rng.choice(n, dead, replace=False)] = 0
    calls = _record(lambda: dense_d3.batch_dense_dftd3(
        pos, numbers, torch.eye(3, dtype=F64) * box, cutoff, *tab, 0.42,
        4.1, 1.7), (dense_d3, "dense_pairs"))
    assert [c[0][0] for c in calls] == ["cn", "direct", "chain"]
    return calls


DENSE_CASES = {
    # n not a multiple of 64: a padded last tile; 5 tiles: two j chunks
    "padded, minimum image": (1, 2, 300, 16.0, 5.0, 7),
    "padded, image combos": (2, 1, 150, 11.0, 7.5, 5),
    "no pair in range": (3, 1, 100, 30.0, 0.05, 0),
    "every pair in range, 8 combos": (4, 1, 70, 4.0, 3.6, 3),
}


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_dense_queue_visits_each_pair_once_and_sums_to_plain(case):
    seed, b, n, box, cutoff, dead = DENSE_CASES[case]
    for args, kwargs in dense_calls(seed, b, n, box, cutoff, dead):
        body, feats, cells, combos, params = args[:5]
        lw = args[5] if len(args) > 5 else kwargs.get("lw")
        got, visits = emulate_dense(body, feats, cells, combos, params, lw)
        want = in_range_pairs(body, feats, cells, combos, params)
        assert len(visits) == len(set(visits))
        assert sorted(visits) == sorted(want)
        if case == "no pair in range":
            assert not visits and not got.any()
        if case.startswith("every pair"):
            assert len(combos) == 8
            idx = torch.arange(feats.shape[1])
            live = (idx < n) if body == "direct" else feats[0, :, 4] != 0
            idx = idx[live].tolist()
            seen = {v[:3] for v in visits}
            assert all((0, x, y) in seen for x in idx for y in idx if x < y)
        _close(got, dp.dense_pairs_plain(body, feats, cells, combos, params,
                                         lw))


def test_dense_blocks_cover_the_triangle_once():
    for n_tiles in (1, 2, 3, 4, 5, 9, 32):
        seen = [(bi, bj0 + t) for bi, bj0, njt in dense_blocks(n_tiles)
                for t in range(njt)]
        assert sorted(seen) == dp.triangle_tiles(n_tiles)


# ---------------------------------------------------------------------------
# Kernel 1: the half-space window sweep
# ---------------------------------------------------------------------------


def cell_windows(radius, dims, cap):
    """``(first extended slot [n_cells], length)`` of every own cell's
    windows in the kernel's order: the home row from the centre cell on,
    then every half-space row over its 2*rx+1 x-cells."""
    rz, ry, rx = radius
    cz, cy, cx = dims
    ey, ex = cy + 2 * ry, cx + 2 * rx
    cell = torch.arange(cz * cy * cx)
    z, y, x = cell // (cy * cx), (cell // cx) % cy, cell % cx
    rows = [(0, 0, rx, (rx + 1) * cap)] + [
        (dz, dy, 0, (2 * rx + 1) * cap) for dz, dy in ws.halfspace_zy(rz, ry)]
    return [((((z + rz + dz) * ey + (y + ry + dy)) * ex + x + x0) * cap, n)
            for dz, dy, x0, n in rows]


def window_groups(radius, cap: int, slots: int):
    """The staging groups of kernel 1 (csrc/window_sweep.cu: the staging loop
    of ``sweep_kernel``, mirrored here), each a list of
    ``(window, first slot, length, offset)`` segments of at most ``slots``
    slots in all: from window w0's slot l0 on, the rest of w0 (or a slice of
    ``slots`` of it) and as many whole windows after it as fit."""
    lens = ws.window_lengths(radius, cap)
    groups, w0, l0 = [], 0, 0
    while w0 < len(lens):
        seg0 = min(lens[w0] - l0, slots)
        group, staged, w1 = [(w0, l0, seg0, 0)], seg0, w0 + 1
        if l0 + seg0 == lens[w0]:
            while w1 < len(lens) and staged + lens[w1] <= slots:
                group.append((w1, 0, lens[w1], staged))
                staged += lens[w1]
                w1 += 1
        groups.append(group)
        if l0 + seg0 < lens[w0]:
            l0 += seg0
        else:
            w0, l0 = w1, 0
    return groups


def reach_sq(body, params):
    cut = params.cutoff
    if body == "d3_direct_coulomb":
        cut = max(cut, params.ccutoff)
    return cut * cut


def emulate_window(body, radius, own, cand, params, lf=None, capacity=None):
    """Kernel 1's partition and queues in torch: per own cell, its windows
    staged in the groups of :func:`window_groups` of at most ``capacity``
    candidates (all at once by default; a window longer than that in
    slices); per own slot, every staged candidate tested and the hits
    queued in staged order (the warp pops them 32 at a time: the order and
    the batches change no sum), the body run on the queued pairs.  All
    cells at once.  Returns ``(own_out, j_out, visits)`` with every queued
    (own slot, extended slot)."""
    n_out, n_j = ws.body_outputs(body, params)
    n_own, cz, cy, cx, cap = own.shape
    own_f = own.reshape(n_own, -1)
    cand_f = cand.reshape(cand.shape[0], -1)
    lf_f = None if lf is None else lf.reshape(-1, lf.shape[-1])
    reach = reach_sq(body, params)
    n_cells = cz * cy * cx
    wins = cell_windows(radius, (cz, cy, cx), cap)
    own_slot = torch.arange(n_cells * cap).reshape(n_cells, cap)
    own_slots, cand_slots = [], []
    groups = window_groups(radius, cap,
                              capacity or sum(n for _, n in wins))
    for group in groups:
        staged = torch.cat([wins[k][0][:, None] + l0 + torch.arange(n)
                            for k, l0, n, _ in group], dim=1)  # [cells, L]
        d = [cand_f[a][staged][:, None, :] - own_f[a][own_slot][..., None]
             for a in range(3)]
        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]     # [cells, cap, L]
        hit = (d2 > 1e-20) & (d2 < reach)
        if group[0][0] == 0:         # the centre cell keeps slot pairs i < j
            # staged candidate c is home slot c + l0, by absolute slot
            pos = torch.arange(staged.shape[1]) + group[0][1]
            hit &= (pos[None, :] >= cap) | (pos[None, :] > torch.arange(
                cap)[:, None])
        cell, i, k = torch.nonzero(hit, as_tuple=True)
        own_slots.append(own_slot[cell, i])
        cand_slots.append(staged[cell, k])
    oi, ci = torch.cat(own_slots), torch.cat(cand_slots)
    own_out = torch.zeros((n_out, n_cells * cap), dtype=own.dtype)
    j_out = torch.zeros((n_j, cand_f.shape[1]), dtype=own.dtype)
    if len(oi):
        o = own_f[:, oi][..., None, None]
        c = cand_f[:, ci][..., None, None]
        li = None if lf_f is None else lf_f[oi][:, None]
        own_blocks, j_blocks = ws.BODY_FNS[body](o, c, params, None, li,
                                                 None)
        for k, blk in enumerate(own_blocks):
            own_out[k].index_add_(0, oi, blk.reshape(-1))
        for k, blk in enumerate(j_blocks):
            j_out[k].index_add_(0, ci, blk.reshape(-1))
    return (own_out.reshape((n_out,) + tuple(own.shape[1:])),
            j_out.reshape((n_j,) + tuple(cand.shape[1:])),
            list(zip(oi.tolist(), ci.tolist())))


def grid_case(seed, n, box, cutoff, half_empty=False, full_cell=False):
    """A random f64 system on the CPU in a halo grid built for ``cutoff``,
    with no atom past a cell's capacity: positions in half the box
    (``half_empty``: empty cells), and the cap equal to the largest
    occupancy (``full_cell``: a full cell)."""
    rng = np.random.default_rng(seed)
    tab = _d3_tables(rng)
    lo = rng.uniform(0, box, (n, 3))
    if half_empty:
        lo[:, 0] *= 0.5
    pos = torch.as_tensor(lo, dtype=F64)
    cell = torch.eye(3, dtype=F64) * box
    numbers = rng.integers(1, 5, n).astype(np.int32)
    q = torch.as_tensor(rng.normal(size=n), dtype=F64)
    dims, radius, cap = grid.estimate_grid_geometry(cell, [True] * 3, cutoff,
                                                    n, 0.6)
    probe = grid.build_atom_grid(pos, cell, [True] * 3, dims, radius, cap)
    most = int(probe.counts_max)
    cap = most if full_cell else max(cap, most)
    g = grid.build_atom_grid(pos, cell, [True] * 3, dims, radius, cap)
    assert int(g.counts_max) <= cap
    return g, pos, numbers, q, tab


def window_calls(g, numbers, q, tab, cutoff, ccutoff):
    """Every window sweep call of the D3 passes, the Coulomb sweep and the
    fused D3 + Coulomb pass (separate and combined forces)."""
    def run():
        grid_d3.grid_dftd3(g, numbers, *tab, cutoff, 0.42, 4.1, 1.7)
        grid.grid_coulomb_energy_forces(g, q, cutoff, 0.35)
        for combine in (False, True):
            grid_d3.grid_dftd3_coulomb(
                g, numbers, q, *tab, cutoff, 0.42, 4.1, 1.7,
                coulomb_cutoff=ccutoff, alpha=0.35, engine="window",
                combine_forces=combine)

    calls = _record(run, (grid_d3, "window_sweep"), (grid, "window_sweep"))
    bodies = [c[0][0] for c in calls]
    assert bodies == ["cn", "d3_direct", "chain", "coulomb", "cn",
                      "d3_direct_coulomb", "chain", "cn", "d3_direct_coulomb",
                      "chain"], bodies
    return calls


def atom_pairs(g, visits):
    """The queued (own, candidate) slots as unordered atom-id pairs."""
    rz, ry, rx = g.radius
    cz, cy, cx = g.dims
    cap = g.cap
    aid = g.ext_aid.reshape(-1)
    own_slot, ext_slot = (torch.tensor([v[k] for v in visits],
                                       dtype=torch.long) for k in (0, 1))
    cell, i = own_slot // cap, own_slot % cap
    z, y, x = cell // (cy * cx), (cell // cx) % cy, cell % cx
    ext_own = (((z + rz) * (cy + 2 * ry) + y + ry) * (cx + 2 * rx)
               + x + rx) * cap + i
    a, b = aid[ext_own].long(), aid[ext_slot].long()
    return list(zip(torch.minimum(a, b).tolist(),
                    torch.maximum(a, b).tolist()))


def brute_pairs(pos, box, cutoff):
    """Unordered atom pairs within ``cutoff`` under the minimum image
    (``cutoff`` < box / 2, so each pair has at most one image in range)."""
    d = pos[None, :, :] - pos[:, None, :]
    d = d - box * torch.round(d / box)
    r2 = (d * d).sum(-1)
    a, b = torch.nonzero(torch.triu((r2 < cutoff ** 2) & (r2 > 1e-20),
                                    diagonal=1), as_tuple=True)
    return [(int(x), int(y)) for x, y in zip(a, b)]


WINDOW_CASES = {
    # (seed, n, box, cutoff, ccutoff, half_empty, full_cell)
    "ccutoff below cutoff, full cell": (5, 400, 16.0, 5.0, 4.0, False, True),
    "ccutoff above cutoff, empty cells": (6, 300, 16.0, 4.0, 5.0, True,
                                          False),
}


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_window_queue_visits_each_pair_once_and_sums_to_plain(case):
    seed, n, box, cutoff, ccutoff, half_empty, full_cell = WINDOW_CASES[case]
    reach = max(cutoff, ccutoff)
    g, pos, numbers, q, tab = grid_case(seed, n, box, reach, half_empty,
                                        full_cell)
    n_cells = int(np.prod(g.dims))
    counts = torch.bincount(g.flat_slot.long() // g.cap,
                            minlength=n_cells)[:n_cells]
    if full_cell:
        assert int(counts.max()) == g.cap
    if half_empty:
        assert int((counts == 0).sum()) > 0
    for args, kwargs in window_calls(g, numbers, q, tab, cutoff, ccutoff):
        body, radius, own, cand, params = args[:5]
        lf = args[5] if len(args) > 5 else kwargs.get("lf")
        own_out, j_out, visits = emulate_window(body, radius, own, cand,
                                                params, lf)
        pairs = atom_pairs(g, visits)
        assert len(pairs) == len(set(pairs))
        cut = reach if body == "d3_direct_coulomb" else params.cutoff
        assert sorted(pairs) == sorted(brute_pairs(pos, box, cut))
        want = ws.window_sweep_plain(body, radius, own, cand, params, lf)
        _close(own_out, want[0])
        _close(j_out, want[1])


@pytest.mark.parametrize("capacity", ["one window", "two windows",
                                      "slices of a window",
                                      "slices of the centre cell"])
def test_window_queue_in_staged_groups_sums_to_plain(capacity):
    """Where the windows do not fit in shared memory at once, the kernel
    stages them in groups, and where one window does not fit, in slices
    of it (the home row's centre cell cut mid-cell too); the sums do not
    change."""
    g, _, numbers, q, tab = grid_case(7, 300, 16.0, 5.0)
    calls = window_calls(g, numbers, q, tab, 5.0, 4.5)
    _, _, _, _, cap = calls[0][0][2].shape
    rx = g.radius[2]
    per = {"one window": (2 * rx + 1) * cap,
           "two windows": 2 * (2 * rx + 1) * cap,
           "slices of a window": cap + 7,
           "slices of the centre cell": cap // 2 + 1}[capacity]
    for args, kwargs in (calls[1], calls[3], calls[5], calls[8]):
        body, radius, own, cand, params = args[:5]
        lf = args[5] if len(args) > 5 else kwargs.get("lf")
        own_out, j_out, visits = emulate_window(body, radius, own, cand,
                                                params, lf, capacity=per)
        whole = emulate_window(body, radius, own, cand, params, lf)
        assert sorted(visits) == sorted(whole[2])
        want = ws.window_sweep_plain(body, radius, own, cand, params, lf)
        _close(own_out, want[0])
        _close(j_out, want[1])


def test_window_fused_reach_is_the_larger_cutoff():
    """The fused body's distance test keeps every pair inside either
    cutoff, and only those."""
    g, pos, numbers, q, tab = grid_case(8, 250, 15.0, 5.0)
    args, kwargs = window_calls(g, numbers, q, tab, 4.0, 5.0)[5]
    body, radius, own, cand, params = args[:5]
    lf = args[5] if len(args) > 5 else kwargs.get("lf")
    for cut, ccut in ((4.0, 5.0), (5.0, 3.0), (4.5, 4.5)):
        p = dataclasses.replace(params, cutoff=cut, ccutoff=ccut)
        own_out, j_out, visits = emulate_window(body, radius, own, cand, p,
                                                lf)
        assert sorted(atom_pairs(g, visits)) == sorted(
            brute_pairs(pos, 15.0, max(cut, ccut)))
        want = ws.window_sweep_plain(body, radius, own, cand, p, lf)
        _close(own_out, want[0])
        _close(j_out, want[1])


# ---------------------------------------------------------------------------
# The staging plans of kernels 1, 7 and 8 where a window overflows shared
# memory
# ---------------------------------------------------------------------------

SMEM = 232448
#: (name, cap, zm-wide row width nf): the reference's batched D3 row (128 x
#: 2,000 atoms in 41.2 A boxes at 21.2 A: dims 1^3, zmax-16 tables) and the
#: dry run's 400 atoms in a 4 A box at 4 A (occupancy 0.3, zmax 4)
OVERFLOW_CAPS = (("batched D3 row", 3032, 170), ("dry run", 1336, 50))
#: (cx, cap, rx, nf) of grids whose windows fit today: the main path (16
#: cells a row, cap 40, zm = 15), zmax-16 tables at cap 32, a 3-cell row
#: at cap 120 and radius 2 at cap 26
PLANS_TODAY = ((16, 40, 1, 30), (16, 32, 1, 170), (3, 120, 1, 30),
               (6, 26, 2, 30))


def _kernel1_cases(cap, nf):
    mesh = 5
    for body in ws.BODIES:
        base = {"d3_direct": 6, "d3_direct_coulomb": 7}.get(body)
        n_cand = base + 2 * mesh if base else ws.BODIES[body][1]
        for combine in ((False, True) if body == "d3_direct_coulomb"
                        else (False,)):
            yield body, n_cand, ws.SweepParams(cutoff=1.0, combine_forces=(
                combine))


def _today_slots(body, radius, cap, n_cand, params):
    """Kernel 1's plan before slicing (the launcher's own formula): every
    window where that fits, else the most slots that fit, refused where
    one window did not fit (None)."""
    n_out, n_j = ws.body_outputs(body, params)
    lens = ws.window_lengths(radius, cap)
    fixed = 4 * n_out * cap + 4 * 8 * 64
    per = 4 * (n_cand + n_j)
    ncs = sum(lens) if fixed + per * sum(lens) <= SMEM else (
        SMEM - fixed) // per
    return ncs if ncs >= max(lens) else None


@pytest.mark.parametrize("name,cap,nf", OVERFLOW_CAPS)
def test_staging_plans_fit_and_cover_every_slot(name, cap, nf):
    """At the overflow caps every kernel gets a plan within 232,448 bytes:
    kernel 1's groups cover each window's slots exactly once (slices of a
    window in order, none past its end), kernels 7 and 8 stage G = 1 in
    slices whose own and candidate ranges cover the cell and its window
    exactly once."""
    radius = (1, 1, 1)
    for body, n_cand, params in _kernel1_cases(cap, nf):
        slots, own = ws.window_plan(body, radius, cap, n_cand, params)
        n_out, n_j = ws.body_outputs(body, params)
        assert 4 * ((n_cand + n_j) * slots + n_out * own + 8 * 64) <= SMEM
        # one cell of one system on a card of 132 SMs: where a window alone
        # overflows the slots, the cell's own slots split over blocks, at
        # least 32 each; the slots fit with them
        slots1, own1 = ws.window_plan(body, radius, cap, n_cand, params,
                                      blocks=1, n_sm=132)
        if slots < max(ws.window_lengths(radius, cap)):
            assert 32 <= own1 < cap and slots1 >= slots
        else:
            assert (slots1, own1) == (slots, own)
        assert 4 * ((n_cand + n_j) * slots1 + n_out * own1 + 8 * 64) <= SMEM
        if body.startswith("d3_direct"):     # refused before slicing
            assert _today_slots(body, radius, cap, n_cand, params) is None
        assert own <= cap and -(-cap // own) * own - cap < -(-cap // own)
        lens = ws.window_lengths(radius, cap)
        seen = [np.zeros(n, int) for n in lens]
        for group in window_groups(radius, cap, slots):
            assert sum(n for _, _, n, _ in group) <= slots
            offs = [off for _, _, _, off in group]
            assert offs == sorted(offs) and offs[0] == 0
            for w, l0, n, _ in group:
                seen[w][l0:l0 + n] += 1
        assert all((s == 1).all() for s in seen)
    for kernel, picker, slicer, smem in (
            ("row", lambda b: rs.row_group_cells(b, 1, cap, 1, nf),
             lambda b, g: rs.row_slices(b, g, 1, cap, 1, nf),
             lambda b, g, m, w: rs.row_smem_bytes(b, g, 1, cap, 1, nf, m,
                                                  w)),
            ("chunk", lambda b: cs.super_chunk_cells(b, 1, cap, 1, nf),
             lambda b, g: cs.chunk_slices(b, g, cap, 1, nf),
             lambda b, g, m, w: cs.chunk_smem_bytes(b, g, cap, 1, nf, m,
                                                    w))):
        for body in ("d3_direct",):
            g = picker(body)
            assert g == 1, kernel
            m_s, w_s = slicer(body, g)
            assert (m_s, w_s) != (cap, 3 * cap) and smem(body, g, m_s,
                                                         w_s) <= SMEM
            own = np.zeros(cap, int)
            for i0 in range(0, cap, m_s):
                own[i0:i0 + m_s] += 1
            cand = np.zeros(3 * cap, int)
            for c0 in range(0, 3 * cap, w_s):
                cand[c0:c0 + w_s] += 1
            assert (own == 1).all() and (cand == 1).all()


@pytest.mark.parametrize("cx,cap,rx,nf", PLANS_TODAY)
def test_staging_plans_that_fit_stay_as_they_were(cx, cap, rx, nf):
    """Where a cell's windows fit, kernel 1 stages the same slot count in
    the same whole-window groups as before slicing, a block takes the
    whole cell, and kernels 7 and 8 keep their G with the whole group and
    window staged."""
    radius = (rx, rx, rx)
    for body, n_cand, params in _kernel1_cases(cap, nf):
        today = _today_slots(body, radius, cap, n_cand, params)
        if today is None:
            continue
        for blocks in (0, 1, 1000):
            assert ws.window_plan(body, radius, cap, n_cand, params, blocks,
                                  132) == (today, cap)
        lens = ws.window_lengths(radius, cap)
        for group in window_groups(radius, cap, today):
            assert all(l0 == 0 and n == lens[w] for w, l0, n, _ in group)
    for body in rs.BODIES:
        width = nf if body == "d3_direct" else 0
        g = rs.row_group_cells(body, cx, cap, rx, width)
        assert rs.row_smem_bytes(body, g, cx, cap, rx, width) <= SMEM
        assert rs.row_slices(body, g, cx, cap, rx, width) == (
            g * cap, (g + 2 * rx) * cap)
    for body in cs.BODIES:
        width = nf if body.startswith("d3_direct") else 0
        g = cs.super_chunk_cells(body, cx, cap, rx, width)
        assert cs.chunk_smem_bytes(body, g, cap, rx, width) <= SMEM
        assert cs.chunk_slices(body, g, cap, rx, width) == (
            g * cap, (g + 2 * rx) * cap)

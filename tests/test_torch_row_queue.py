# SPDX-License-Identifier: Apache-2.0
"""The enumeration of the per-row pair sweep (kernel 7), on the CPU.

``csrc/row_sweep.cu`` runs one block per (own row, row offset).  The
block stages the own row and its whole extended candidate row once, or
groups of G consecutive own x-cells with their merged window where that
exceeds a block's shared memory (``row_group_cells``, budget
``row_smem_bytes``).  Its warps (32 for the D3 direct body, 16 for the
others) take the staged own slots in turn; a warp skips a parked own slot
(``|px| >= DISPLACE / 2``: empty slots and padding atoms) where
``skips_parked`` allows it, tests the others against the
2*rx + 1 x-cells around the slot's cell, 32 candidates at a time, queues
the hits of all its slots in one queue (entries ``own << 16 | candidate``)
and runs the pass body on 32 queued pairs at a time; each pop's own-side
terms are summed per slot over its lanes.  A torch emulation of that
partition and those pops, in f64, shows that:

- every pair the plain version counts in range is queued exactly once, and
  nothing out of the body's reach is queued;
- the home row keeps only candidates past the own slot (the own cell's
  later slots and the rx cells to its right), so each pair is seen once;
- no parked own slot has a pair in reach where the skip applies (and where
  it does not, one can);
- the bodies run on the queued pairs, summed pop by pop, equal
  ``row_sweep_plain`` to 1e-12.

Cases: every body, full and empty cells, padding atoms, groups of one
cell, of several cells (the last one ragged) and the whole row; the shared
memory budget at the main path's and the zmax-16 tables' shapes.
"""

import numpy as np
import pytest
import torch

from nvalchemiops_torch import grid
from nvalchemiops_torch.interactions.dispersion import grid_d3
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
RTOL = 1e-12
PARKED = grid.DISPLACE / 2


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


def offsets(radius):
    """(dz, dy, home) of every row offset, in the kernel's block order."""
    rz, ry, _ = radius
    return [(0, 0, True)] + [(dz, dy, False)
                             for dz, dy in ws.halfspace_zy(rz, ry)]


def row_pairs(radius, own, cand, g_cells, reach, parked, tested_only,
              slices=None):
    """Every pair the sweep meets in range, as rows (own flat slot,
    candidate flat slot, block, group, own index in the group, candidate
    index in the group's window, slice): with ``tested_only`` the kernel's
    tests (own slots with ``|px| < parked``, each against the 2*rx + 1
    x-cells around its cell), else every own slot against the group's whole
    merged window.  The home row keeps candidates past the own slot.  Block
    = row * n_offsets + offset, as the kernel numbers them.  ``slices =
    (own slots, candidates)`` stages each group in slices as the kernel
    does (own slices over blocks, candidate slices one after another; each
    own slot's tested range clipped to the staged slice, in staged
    indices); slice = own slice * candidate slices + candidate slice."""
    _, cz, cy, cx, cap = own.shape
    rz, ry, rx = radius
    _, ez, ey, ex, _ = cand.shape
    offs = offsets(radius)
    z = torch.arange(cz)[:, None]
    y = torch.arange(cy)[None, :]
    own_f = own.reshape(own.shape[0], -1)
    cand_f = cand.reshape(cand.shape[0], -1)
    found = []
    for gi, g0 in enumerate(range(0, cx, g_cells)):
        gn = min(g_cells, cx - g0)
        m_all, w_all = gn * cap, (gn + 2 * rx) * cap
        m_s, w_s = slices or (m_all, w_all)
        n_cs = -(-((g_cells + 2 * rx) * cap) // w_s)
        for si, i0 in enumerate(range(0, m_all, m_s)):
            m = min(m_s, m_all - i0)
            own_idx = ((z * cy + y) * cx + g0)[..., None] * cap + i0 \
                + torch.arange(m)
            i = i0 + torch.arange(m)[:, None]
            gl = i // cap
            ox = own_f[0][own_idx]                         # [cz, cy, m]
            live = (ox.abs() < parked)[..., None]
            for ci, c0 in enumerate(range(0, w_all, w_s)):
                w = min(w_s, w_all - c0)
                cc = torch.arange(w)[None, :]
                for k, (dz, dy, home) in enumerate(offs):
                    cand0 = (((z + rz + dz) * ey + (y + ry + dy)) * ex
                             + g0) * cap + c0
                    cand_idx = cand0[..., None] + torch.arange(w)
                    if tested_only:
                        j0 = torch.clamp(i + rx * cap + 1 if home
                                         else gl * cap, min=c0) - c0
                        j1 = torch.clamp((gl + 2 * rx + 1) * cap,
                                         max=c0 + w) - c0
                        keep = (cc >= j0) & (cc < j1)
                    else:
                        keep = torch.ones((m, w), dtype=torch.bool)
                        if home:
                            keep &= c0 + cc > i + rx * cap
                    d = [cand_f[a][cand_idx][..., None, :]
                         - own_f[a][own_idx][..., None] for a in range(3)]
                    d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
                    hit = keep & (d2 > 1e-20) & (d2 < reach) & live
                    zz, yy, ii, jj = torch.nonzero(hit, as_tuple=True)
                    block = (zz * cy + yy) * len(offs) + k
                    found.append(torch.stack([
                        own_idx[zz, yy, ii], cand_idx[zz, yy, jj], block,
                        torch.full_like(ii, gi), i0 + ii, c0 + jj,
                        torch.full_like(ii, si * n_cs + ci)], dim=1))
    return torch.cat(found)


def emulate_row(body, radius, own, cand, params, g_cells, lf=None, cf=None,
                parked=PARKED, slices=None):
    """Kernel 7's partition, queues and pops in torch.  The visits are
    ordered as a warp pushes them (warp = own index % warps; its slots in
    turn, candidates ascending), each warp's queue popped 32 entries at a
    time within a group; each pop's own-side terms are summed per own slot
    (the segmented reduction) before they reach the slot's sum, the j-side
    terms added entry by entry; with ``slices`` a queue per staged slice.
    Returns ``(own_out, j_out, visits)``."""
    _, n_out, n_j = rs.BODIES[body][1:]
    visits = row_pairs(radius, own, cand, g_cells, params.cutoff ** 2,
                       parked, tested_only=True, slices=slices)
    own_f = own.reshape(own.shape[0], -1)
    cand_f = cand.reshape(cand.shape[0], -1)
    own_out = torch.zeros((n_out, own_f.shape[1]), dtype=own.dtype)
    j_out = torch.zeros((n_j, cand_f.shape[1]), dtype=own.dtype)
    if len(visits) == 0:
        return (own_out.reshape((n_out,) + tuple(own.shape[1:])),
                j_out.reshape((n_j,) + tuple(cand.shape[1:])), visits)
    assert int(visits[:, 4].max()) < 1 << 15        # own index fits the entry
    assert int(visits[:, 5].max()) < 1 << 16        # and the candidate
    blk, gi, i, c, sl = (visits[:, k] for k in range(2, 7))
    warps = rs.WARPS[body]
    # a warp takes staged own indices warp, warp + warps, ..
    warp = (i % slices[0] if slices else i) % warps
    queue = ((blk * (int(gi.max()) + 1) + gi) * (int(sl.max()) + 1)
             + sl) * warps + warp
    order = torch.argsort(queue * (1 << 32) + i * (1 << 16) + c)
    visits, queue = visits[order], queue[order]
    _, counts = torch.unique_consecutive(queue, return_counts=True)
    start = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    pop = torch.arange(len(visits)) - start                # rank in queue
    pop = pop // 32
    oi, ci = visits[:, 0], visits[:, 1]
    o = own_f[:, oi][..., None, None]
    cv = cand_f[:, ci][..., None, None]
    li = None if lf is None else lf.reshape(-1, lf.shape[-1])[oi][:, None]
    cfi = None if cf is None else cf.reshape(-1, cf.shape[-1])[ci][:, None]
    own_blocks, j_blocks = ws.BODY_FNS[body](o, cv, params, None, li, cfi)
    # one segment per (queue, pop, own slot): the lanes a reduction sums
    seg_key = torch.stack([queue, pop, oi], dim=1)
    segs, seg_of = torch.unique_consecutive(seg_key, dim=0,
                                            return_inverse=True)
    for k, blk_terms in enumerate(own_blocks):
        seg_sum = torch.zeros(len(segs), dtype=own.dtype).index_add_(
            0, seg_of, blk_terms.reshape(-1))
        own_out[k].index_add_(0, segs[:, 2], seg_sum)
    for k, blk_terms in enumerate(j_blocks):
        j_out[k].index_add_(0, ci, blk_terms.reshape(-1))
    return (own_out.reshape((n_out,) + tuple(own.shape[1:])),
            j_out.reshape((n_j,) + tuple(cand.shape[1:])), visits)


def grid_case(seed, n, box, cutoff, half_empty=False, full_cell=False,
              pbc=(True, True, True)):
    """A random f64 system in a halo grid built for ``cutoff``, with no atom
    past a cell's capacity and three padding atoms (``half_empty``: atoms
    in half the box along x, so some cells are empty; ``full_cell``: the
    cap equal to the largest occupancy)."""
    rng = np.random.default_rng(seed)
    tab = _d3_tables(rng)
    lengths = np.broadcast_to(np.asarray(box, dtype=float), (3,))
    lo = rng.uniform(0, 1, (n, 3)) * lengths
    if half_empty:
        lo[:, 0] = 0.5 * (lo[:, 0] + lengths[0])   # x in the upper half
    pos = torch.as_tensor(lo, dtype=F64)
    cell = torch.diag(torch.as_tensor(lengths.copy(), dtype=F64))
    numbers = rng.integers(1, 5, n).astype(np.int32)
    numbers[:3] = 0                               # padding atoms are parked
    dims, radius, cap = grid.estimate_grid_geometry(cell, list(pbc), cutoff,
                                                    n, 0.6)
    probe = grid.build_atom_grid(pos, cell, list(pbc), dims, radius, cap)
    most = int(probe.counts_max)
    cap = most if full_cell else max(cap, most)
    g = grid.build_atom_grid(pos, cell, list(pbc), dims, radius, cap)
    n_cells = int(np.prod(g.dims))
    counts = torch.bincount(g.flat_slot.long() // g.cap,
                            minlength=n_cells)[:n_cells]
    if full_cell:
        assert int(counts.max()) == g.cap
    if half_empty:
        assert int((counts == 0).sum()) > 0
    return g, numbers, tab


def row_calls(g, numbers, tab, cutoff):
    """The three per-row sweep calls of ``grid_dftd3(engine="pallas")``."""
    calls = []
    orig = grid_d3.row_sweep

    def wrapper(*args, **kwargs):
        calls.append((args, kwargs))
        return orig(*args, **kwargs)

    grid_d3.row_sweep = wrapper
    try:
        grid_d3.grid_dftd3(g, numbers, *tab, cutoff, 0.42, 4.1, 1.7,
                           engine="pallas")
    finally:
        grid_d3.row_sweep = orig
    assert [c[0][0] for c in calls] == ["cn", "d3_direct", "chain"]
    return calls


def _unpack(args, kwargs):
    body, radius, own, cand, params = args[:5]
    lf = args[5] if len(args) > 5 else kwargs.get("lf")
    cf = args[6] if len(args) > 6 else kwargs.get("cf")
    return body, radius, own, cand, params, lf, cf


def check_call(body, radius, own, cand, params, g_cells, lf, cf,
               slices=None):
    """The emulation at ``g_cells`` (and ``slices``) against the plain
    enumeration and the plain version; returns the visits."""
    dims = tuple(own.shape[1:4])
    assert rs.skips_parked(dims, radius)
    own_out, j_out, visits = emulate_row(body, radius, own, cand, params,
                                         g_cells, lf, cf, slices=slices)
    rows = [tuple(v) for v in visits[:, :3].tolist()]
    assert len(rows) == len(set(rows))             # each pair queued once
    want = row_pairs(radius, own, cand, g_cells, params.cutoff ** 2,
                     float("inf"), tested_only=False)
    assert sorted(rows) == sorted(tuple(v) for v in want[:, :3].tolist())
    # no parked own slot has a pair in reach: skipping them loses nothing
    own_f = own.reshape(own.shape[0], -1)
    assert bool((own_f[0][want[:, 0]].abs() < PARKED).all())
    assert bool((own_f[0].abs() >= PARKED).any())  # and there are some
    # nothing out of reach: every queued pair lies inside it
    cand_f = cand.reshape(cand.shape[0], -1)
    d2 = sum((cand_f[a][visits[:, 1]] - own_f[a][visits[:, 0]]) ** 2
             for a in range(3))
    assert bool(((d2 > 1e-20) & (d2 < params.cutoff ** 2)).all())
    # the home row: candidates past the own slot, none left of its cell
    n_off = len(offsets(radius))
    home = visits[:, 2] % n_off == 0
    rx, cap = radius[2], own.shape[-1]
    assert bool((visits[home, 5] > visits[home, 4] + rx * cap).all())
    want_out = rs.row_sweep_plain(body, radius, own, cand, params, lf, cf)
    _close(own_out, want_out[0])
    _close(j_out, want_out[1])
    return visits


CASES = {
    # (seed, n, box, cutoff, half_empty, full_cell)
    "full cell": (71, 400, 16.0, 5.0, False, True),
    "empty cells": (72, 300, 16.0, 5.0, True, False),
}


@pytest.mark.parametrize("width", ["one cell", "several cells",
                                   "whole row", "slices of one cell",
                                   "slices of several cells"])
@pytest.mark.parametrize("case", list(CASES))
def test_row_queue_visits_each_pair_once_and_sums_to_plain(case, width):
    """The slices (where one cell and its window do not fit) cut a cell's
    slots mid-cell and the window at an odd slot, and stage several
    candidate slices a group."""
    seed, n, box, cutoff, half_empty, full_cell = CASES[case]
    g, numbers, tab = grid_case(seed, n, box, cutoff, half_empty, full_cell)
    cx, cap = g.dims[2], g.cap
    assert cx >= 3
    several = 2 if cx % 2 else cx - 1
    g_cells = {"one cell": 1, "several cells": several, "whole row": cx,
               "slices of one cell": 1,
               "slices of several cells": several}[width]
    slices = (cap // 2 + 3, cap + 7) if width.startswith("slices") else None
    if "several cells" in width:
        assert 1 < g_cells < cx and cx % g_cells   # the last group ragged
    for args, kwargs in row_calls(g, numbers, tab, cutoff):
        body, radius, own, cand, params, lf, cf = _unpack(args, kwargs)
        visits = check_call(body, radius, own, cand, params, g_cells, lf, cf,
                            slices)
        assert len(visits) > 0


def test_row_queue_at_the_wrappers_group_width():
    """The wrapper's pick of G for each body of the case's calls (the whole
    row here: the D3 rows are narrow) enumerates the same pairs."""
    g, numbers, tab = grid_case(73, 350, 16.0, 5.0)
    for args, kwargs in row_calls(g, numbers, tab, 5.0):
        body, radius, own, cand, params, lf, cf = _unpack(args, kwargs)
        nf = 0 if lf is None else lf.shape[-1]
        cx, cap = own.shape[3], own.shape[4]
        g_cells = rs.row_group_cells(body, cx, cap, radius[2], nf)
        assert g_cells == cx
        check_call(body, radius, own, cand, params, g_cells, lf, cf)


def test_row_parked_skip_needs_more_cells_than_radius():
    """Along a short non-periodic axis (one cell, radius 2) the halo fill
    beside a parked own slot lies within the cutoff: ``skips_parked`` is
    False there, and the kernel tests every slot, as the plain version
    does (the CN body on the grid's own planes)."""
    g, _, _ = grid_case(74, 200, (16.0, 16.0, 3.0), 5.0, half_empty=True,
                        pbc=(True, True, False))
    assert g.dims[0] == 1 and g.radius[0] == 2
    assert not rs.skips_parked(g.dims, g.radius)
    (cz, cy, cx), (rz, ry, rx) = g.dims, g.radius
    cand = torch.stack([g.ext_px, g.ext_py, g.ext_pz,
                        torch.ones_like(g.ext_px)])
    own = cand[:, rz:rz + cz, ry:ry + cy, rx:rx + cx].contiguous()
    params = ws.SweepParams(cutoff=5.0, k1=16.0)
    want = row_pairs(g.radius, own, cand, cx, 25.0, float("inf"),
                     tested_only=False)
    own_f = own.reshape(own.shape[0], -1)
    assert bool((own_f[0][want[:, 0]].abs() >= PARKED).any())
    own_out, j_out, _ = emulate_row("cn", g.radius, own, cand, params, cx,
                                    parked=float("inf"))
    plain = rs.row_sweep_plain("cn", g.radius, own, cand, params)
    _close(own_out, plain[0])
    _close(j_out, plain[1])


def test_row_shared_memory_budget():
    """``row_smem_bytes`` counts the extended row's j sums, the staged group
    and its window, the own sums and the warps' queues, as the kernel's
    does; the main path (16 cells a row, cap 40, zm = 15) stages whole rows,
    the zmax-16 tables (zm = 85, cap 32) groups, and at cap 128 slices of
    one cell and its window, all within 227 KB."""
    for body, (_, n_feat, n_out, n_j) in rs.BODIES.items():
        nf = 30 if body == "d3_direct" else 0
        fs = nf | 1 if nf else 0
        for g in (1, 3, 16):
            m, w = g * 40, (g + 2) * 40
            staged = 4 * ((n_feat + fs) * (m + w) + n_out * m
                          + n_j * 18 * 40)
            assert rs.row_smem_bytes(body, g, 16, 40, 1, nf) == (
                staged + 4 * rs.WARPS[body] * rs.QUEUE)
        g = rs.row_group_cells(body, 16, 40, 1, nf)
        assert g == 16
        assert rs.row_smem_bytes(body, g, 16, 40, 1, nf) <= 232448
    g = rs.row_group_cells("d3_direct", 16, 32, 1, 170)
    assert 1 < g < 16
    assert rs.row_smem_bytes("d3_direct", g, 16, 32, 1, 170) <= 232448
    assert rs.row_smem_bytes("d3_direct", g + 1, 16, 32, 1, 170) > 232448
    # one cell and its window do not fit: G = 1, slices of both
    assert rs.row_group_cells("d3_direct", 16, 128, 1, 170) == 1
    m_s, w_s = rs.row_slices("d3_direct", 1, 16, 128, 1, 170)
    assert m_s <= 128 and w_s < 3 * 128
    assert rs.row_smem_bytes("d3_direct", 1, 16, 128, 1, 170, m_s,
                             w_s) <= 232448

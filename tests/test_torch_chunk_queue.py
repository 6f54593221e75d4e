# SPDX-License-Identifier: Apache-2.0
"""The enumeration of the distance-first super-chunk sweep (kernel 8), on
the CPU.

``csrc/chunk_sweep.cu`` gives the own slots of a chunk of G cells to the
block's warps in turn; a warp tests each of its slots against the staged
candidates of the 2*rx + 1 x-cells around the slot's cell, 32 at a time
(r^2 against the body's reach: the larger of the two cutoffs for the fused
body), queues the hits of all its slots in one queue and runs the pass
body only on queued pairs, 32 at a time.  A torch emulation of that
partition, in f64, shows that:

- every pair the plain version counts in range is queued exactly once, and
  nothing out of the body's reach is queued (so the x-cells left untested
  hold no pair in range);
- the home offset keeps only candidates past the own slot (flat candidate
  index > own index + rx*cap), so each pair is seen once;
- the bodies run on the queued pairs sum to ``chunk_sweep_plain`` to 1e-12.

Cases: every body, the Coulomb cutoff above and below the D3 cutoff, a full
cell and empty cells, G above 1 (the card's pick, and every divisor of cx).
"""

import dataclasses

import numpy as np
import pytest
import torch

from nvalchemiops_torch import grid
from nvalchemiops_torch.interactions.dispersion import grid_d3
from nvalchemiops_torch.kernels import chunk_sweep as cs
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


def reach_sq(body, params):
    cut = params.cutoff
    if body == "d3_direct_coulomb":
        cut = max(cut, params.ccutoff)
    return cut * cut


def offsets(radius):
    """(dz, dy, home) of every row offset, in the kernel's order."""
    rz, ry, _ = radius
    return [(0, 0, True)] + [(dz, dy, False)
                             for dz, dy in ws.halfspace_zy(rz, ry)]


def chunk_pairs(radius, own, cand, g_cells, reach, tested_only):
    """Every (own flat slot, candidate flat slot, offset) the sweep meets
    in range: with ``tested_only`` the kernel's tests (the 2*rx + 1 x-cells
    around each own slot's cell), else the plain version's whole merged
    window; the home offset keeps candidates past the own slot.  All rows
    and chunks at once."""
    _, cz, cy, cx, cap = own.shape
    rz, ry, rx = radius
    _, ez, ey, ex, _ = cand.shape
    g = int(g_cells)
    nch, m, w = cx // g, g * cap, (g + 2 * rx) * cap
    z = torch.arange(cz)[:, None, None]
    y = torch.arange(cy)[None, :, None]
    ch = torch.arange(nch)[None, None, :]
    own0 = ((z * cy + y) * cx + ch * g) * cap              # [cz, cy, nch]
    own_idx = own0[..., None] + torch.arange(m)            # [.., m]
    i = torch.arange(m)[:, None]
    c = torch.arange(w)[None, :]
    gl = i // cap
    own_f = own.reshape(own.shape[0], -1)
    cand_f = cand.reshape(cand.shape[0], -1)
    found = []
    for k, (dz, dy, home) in enumerate(offsets(radius)):
        cand0 = (((z + rz + dz) * ey + (y + ry + dy)) * ex + ch * g) * cap
        cand_idx = cand0[..., None] + torch.arange(w)      # [.., w]
        keep = torch.ones((m, w), dtype=torch.bool)
        if home:
            keep &= c > i + rx * cap
        if tested_only:
            keep &= (c >= gl * cap) & (c < (gl + 2 * rx + 1) * cap)
        d = [cand_f[a][cand_idx][..., None, :] - own_f[a][own_idx][..., None]
             for a in range(3)]
        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]       # [.., m, w]
        hit = keep & (d2 > 1e-20) & (d2 < reach)
        zz, yy, cc, ii, jj = torch.nonzero(hit, as_tuple=True)
        found.append(torch.stack([
            own_idx[zz, yy, cc, ii], cand_idx[zz, yy, cc, jj],
            torch.full_like(ii, k), ii, jj], dim=1))
    return torch.cat(found)


def emulate_chunk(body, radius, own, cand, params, g_cells, lf=None,
                  cf=None):
    """Kernel 8's partition and queues in torch: each own slot tested
    against the 2*rx + 1 x-cells around its cell, the hits queued (a warp
    pops its slots' hits 32 at a time and sums both sides in shared memory:
    the order and the batches change no sum) and the body run on the
    queued pairs.  Returns ``(own_out, j_out,
    visits)``, visits as rows (own slot, candidate slot, offset, own index
    in the chunk, candidate index in the merged window)."""
    _, n_out, n_j = cs.BODIES[body][1:]
    visits = chunk_pairs(radius, own, cand, g_cells,
                         reach_sq(body, params), tested_only=True)
    own_f = own.reshape(own.shape[0], -1)
    cand_f = cand.reshape(cand.shape[0], -1)
    own_out = torch.zeros((n_out, own_f.shape[1]), dtype=own.dtype)
    j_out = torch.zeros((n_j, cand_f.shape[1]), dtype=own.dtype)
    if len(visits):
        oi, ci = visits[:, 0], visits[:, 1]
        o = own_f[:, oi][..., None, None]
        c = cand_f[:, ci][..., None, None]
        li = None if lf is None else lf.reshape(-1, lf.shape[-1])[oi][:, None]
        cfi = None if cf is None else cf.reshape(-1, cf.shape[-1])[ci][:,
                                                                      None]
        own_blocks, j_blocks = ws.BODY_FNS[body](o, c, params, None, li, cfi)
        for k, blk in enumerate(own_blocks):
            own_out[k].index_add_(0, oi, blk.reshape(-1))
        for k, blk in enumerate(j_blocks):
            j_out[k].index_add_(0, ci, blk.reshape(-1))
    return (own_out.reshape((n_out,) + tuple(own.shape[1:])),
            j_out.reshape((n_j,) + tuple(cand.shape[1:])), visits)


def grid_case(seed, n, box, cutoff, half_empty=False, full_cell=False):
    """A random f64 system in a halo grid built for ``cutoff``, with no atom
    past a cell's capacity (``half_empty``: atoms in half the box, so some
    cells are empty; ``full_cell``: the cap equal to the largest
    occupancy)."""
    rng = np.random.default_rng(seed)
    tab = _d3_tables(rng)
    lo = rng.uniform(0, box, (n, 3))
    if half_empty:
        lo[:, 0] *= 0.5
    pos = torch.as_tensor(lo, dtype=F64)
    cell = torch.eye(3, dtype=F64) * box
    numbers = rng.integers(1, 5, n).astype(np.int32)
    numbers[:3] = 0                               # padding atoms are parked
    q = torch.as_tensor(rng.normal(size=n), dtype=F64)
    dims, radius, cap = grid.estimate_grid_geometry(cell, [True] * 3, cutoff,
                                                    n, 0.6)
    probe = grid.build_atom_grid(pos, cell, [True] * 3, dims, radius, cap)
    most = int(probe.counts_max)
    cap = most if full_cell else max(cap, most)
    g = grid.build_atom_grid(pos, cell, [True] * 3, dims, radius, cap)
    n_cells = int(np.prod(g.dims))
    counts = torch.bincount(g.flat_slot.long() // g.cap,
                            minlength=n_cells)[:n_cells]
    if full_cell:
        assert int(counts.max()) == g.cap
    if half_empty:
        assert int((counts == 0).sum()) > 0
    return g, numbers, q, tab


def chunk_calls(g, numbers, q, tab, cutoff, ccutoff):
    """Every super-chunk sweep call of the block engines: the D3 passes,
    the fused D3 + Coulomb pass (separate and combined forces) and the
    Coulomb sweep."""
    calls = []
    undo = []
    for module in (grid_d3, grid):
        orig = module.chunk_sweep

        def wrapper(*args, _orig=orig, **kwargs):
            calls.append((args, kwargs))
            return _orig(*args, **kwargs)

        module.chunk_sweep = wrapper
        undo.append((module, orig))
    try:
        grid_d3.grid_dftd3(g, numbers, *tab, cutoff, 0.42, 4.1, 1.7,
                           engine="block")
        for combine in (False, True):
            grid_d3.grid_dftd3_coulomb(
                g, numbers, q, *tab, cutoff, 0.42, 4.1, 1.7,
                coulomb_cutoff=ccutoff, alpha=0.35, engine="block",
                combine_forces=combine)
        grid.grid_coulomb_energy_forces(g, q, cutoff, 0.35, engine="block")
    finally:
        for module, orig in undo:
            module.chunk_sweep = orig
    bodies = [c[0][0] for c in calls]
    assert bodies == ["cn", "d3_direct", "chain", "cn", "d3_direct_coulomb",
                      "chain", "cn", "d3_direct_coulomb", "chain",
                      "coulomb"], bodies
    return calls


def _unpack(args, kwargs):
    body, radius, own, cand, params, g_cells = args[:6]
    lf = args[6] if len(args) > 6 else kwargs.get("lf")
    cf = args[7] if len(args) > 7 else kwargs.get("cf")
    return body, radius, own, cand, params, g_cells, lf, cf


def check_call(body, radius, own, cand, params, g_cells, lf, cf):
    own_out, j_out, visits = emulate_chunk(body, radius, own, cand, params,
                                           g_cells, lf, cf)
    rows = [tuple(v) for v in visits[:, :3].tolist()]
    assert len(rows) == len(set(rows))             # each pair queued once
    want = chunk_pairs(radius, own, cand, g_cells, reach_sq(body, params),
                       tested_only=False)
    assert sorted(rows) == sorted(tuple(v) for v in want[:, :3].tolist())
    # nothing out of reach: every queued pair lies inside it
    own_f = own.reshape(own.shape[0], -1)
    cand_f = cand.reshape(cand.shape[0], -1)
    d2 = sum((cand_f[a][visits[:, 1]] - own_f[a][visits[:, 0]]) ** 2
             for a in range(3))
    assert bool(((d2 > 1e-20) & (d2 < reach_sq(body, params))).all())
    # the home offset keeps candidates past the own slot
    home = visits[:, 2] == 0
    rx, cap = radius[2], own.shape[-1]
    assert bool((visits[home, 4] > visits[home, 3] + rx * cap).all())
    want_out = cs.chunk_sweep_plain(body, radius, own, cand, params, g_cells,
                                    lf, cf)
    _close(own_out, want_out[0])
    _close(j_out, want_out[1])
    return visits


CASES = {
    # (seed, n, box, cutoff, ccutoff, half_empty, full_cell)
    "ccutoff below cutoff, full cell": (61, 400, 16.0, 5.0, 4.0, False,
                                        True),
    "ccutoff above cutoff, empty cells": (62, 300, 16.0, 4.0, 5.0, True,
                                          False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_chunk_queue_visits_each_pair_once_and_sums_to_plain(case):
    seed, n, box, cutoff, ccutoff, half_empty, full_cell = CASES[case]
    g, numbers, q, tab = grid_case(seed, n, box, max(cutoff, ccutoff),
                                   half_empty, full_cell)
    calls = chunk_calls(g, numbers, q, tab, cutoff, ccutoff)
    assert max(_unpack(*c)[5] for c in calls) > 1     # G above 1
    for args, kwargs in calls:
        visits = check_call(*_unpack(args, kwargs))
        assert len(visits) > 0


@pytest.mark.parametrize("which", ["G = 1", "G = cx"])
def test_chunk_queue_at_every_chunk_width(which):
    """The same enumeration with G = 1 and with one chunk a row (G = cx):
    the merged window's edge cells move, the pairs do not."""
    g, numbers, q, tab = grid_case(63, 350, 16.0, 5.0)
    calls = chunk_calls(g, numbers, q, tab, 5.0, 4.5)
    cx = g.dims[2]
    width = 1 if which == "G = 1" else cx
    for args, kwargs in (calls[0], calls[1], calls[4], calls[9]):
        body, radius, own, cand, params, _, lf, cf = _unpack(args, kwargs)
        check_call(body, radius, own, cand, params, width, lf, cf)


def test_chunk_fused_reach_is_the_larger_cutoff():
    """The fused body's test keeps every pair inside either cutoff, and
    only those; the sums do not change with which cutoff is larger."""
    g, numbers, q, tab = grid_case(64, 250, 15.0, 5.0)
    args, kwargs = chunk_calls(g, numbers, q, tab, 4.0, 5.0)[4]
    body, radius, own, cand, params, g_cells, lf, cf = _unpack(args, kwargs)
    for cut, ccut in ((4.0, 5.0), (5.0, 3.0), (4.5, 4.5)):
        p = dataclasses.replace(params, cutoff=cut, ccutoff=ccut)
        visits = check_call(body, radius, own, cand, p, g_cells, lf, cf)
        own_f = own.reshape(own.shape[0], -1)
        cand_f = cand.reshape(cand.shape[0], -1)
        d2 = sum((cand_f[a][visits[:, 1]] - own_f[a][visits[:, 0]]) ** 2
                 for a in range(3))
        if cut != ccut:          # pairs between the two cutoffs are queued
            assert float(d2.max()) > min(cut, ccut) ** 2


def test_chunk_shared_memory_counts_the_queues():
    """The G picker's budget counts the own and j sums and the warps'
    queues (8 warps of 64 ints) beside the staged chunk, as the kernel's
    does."""
    cap, rx = 40, 1
    for body, (_, n_feat, n_out, n_j) in cs.BODIES.items():
        nf = 30 if body.startswith("d3_direct") else 0
        fs = nf | 1 if nf else 0
        for g in (1, 2, 4):
            m, w = g * cap, (g + 2 * rx) * cap
            staged = 4 * ((n_feat + fs) * (m + w) + n_out * m + n_j * w)
            assert cs.chunk_smem_bytes(body, g, cap, rx, nf) == (
                staged + 4 * cs.WARPS * cs.QUEUE)
        g = cs.super_chunk_cells(body, 16, cap, rx, nf)
        assert cs.chunk_smem_bytes(body, g, cap, rx, nf) <= cs.SMEM_BYTES

# SPDX-License-Identifier: Apache-2.0
"""The band-only design of the windowed gather (kernel 2), on the CPU.

``csrc/windowed_gather.cu`` finds each slot's band on every axis once, from
a bit mask of the non-zero columns of its S and dS rows: four columns from
the first non-zero one (moved left at the window's edge) when the non-zero
columns span at most four, else every column they span.  Each of the
slot's four threads then contracts one z row of the band (z rows a, a + 4,
...) against the band's (y, x) window entries, and a butterfly over the
four lanes sums the value and the three gradient components.  A torch
emulation of that, in f64, shows that:

- every non-zero S or dS entry lies inside its slot's band, so a skipped
  term has an exactly-zero factor;
- the band-only sums equal ``gather_grad_planes_plain`` to 1e-12, at W = 8,
  12 and 20, B-spline orders 1-4, with empty and padded slots, bands at the
  window's edge and dense rows.
"""

import numpy as np
import pytest
import torch

from nvalchemiops_torch import spline_windowed
from nvalchemiops_torch.kernels import windowed_gather as wg


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
THREADS = 4          # threads a slot


def band(smat, w):
    """``(live [t, cap], start [t, cap, 3], length [t, cap, 3])``: the
    kernel's band per slot and axis (x, y, z) from the non-zero columns of
    S | dS; ``live`` where every axis has one (else every term has a zero
    factor and the slot's outputs are zero)."""
    t, cap, _ = smat.shape
    nz = smat.reshape(t, cap, 6, w) != 0
    mask = nz[:, :, :3] | nz[:, :, 3:]                    # [t, cap, 3, W]
    col = torch.arange(w)
    lo = torch.where(mask, col, w).min(-1).values
    hi = torch.where(mask, col, -1).max(-1).values
    fixed = hi - lo < 4
    start = torch.where(fixed, torch.clamp(lo, max=w - 4), lo)
    length = torch.where(fixed, torch.full_like(lo, 4), hi - lo + 1)
    return mask.any(-1).all(-1), start, length


def emulate_gather(smat, win, w):
    """Kernel 2's band-only contraction in torch: ``(val, gx, gy, gz)``
    ``[t, cap]``."""
    t, cap, _ = smat.shape
    live, start, length = band(smat, w)
    rows = smat.reshape(t, cap, 6, w)
    span = int(length.max()) if live.any() else 4
    k = torch.arange(span)
    pos = start[..., None] + k                            # [t, cap, 3, L]
    inside = (k < length[..., None]) & live[..., None, None]
    pos = torch.clamp(pos, max=w - 1)

    def pick(axis):
        """S and dS of ``axis`` at the band's columns, zero past its end."""
        p = pos[:, :, axis]
        s = torch.gather(rows[:, :, axis], -1, p)
        ds = torch.gather(rows[:, :, axis + 3], -1, p)
        keep = inside[:, :, axis]
        return (torch.where(keep, s, 0.0), torch.where(keep, ds, 0.0))

    (sx, dsx), (sy, dsy), (sz, dsz) = pick(0), pick(1), pick(2)
    px, py, pz = pos[:, :, 0], pos[:, :, 1], pos[:, :, 2]
    flat = (pz[..., :, None, None] * (w * w) + py[..., None, :, None] * w
            + px[..., None, None, :])                     # [t, cap, L, L, L]
    wb = torch.gather(win.reshape(t, 1, -1).expand(t, cap, -1), -1,
                      flat.reshape(t, cap, -1)).reshape(flat.shape)
    p_x = (wb * sx[..., None, None, :]).sum(-1)           # [t, cap, Lz, Ly]
    p_dx = (wb * dsx[..., None, None, :]).sum(-1)
    q = (p_x * sy[..., None, :]).sum(-1)                  # [t, cap, Lz]
    qx = (p_dx * sy[..., None, :]).sum(-1)
    qy = (p_x * dsy[..., None, :]).sum(-1)
    terms = torch.stack([sz * q, sz * qx, sz * qy, dsz * q])  # [4, t, cap, L]
    # thread a holds z rows a, a + 4, ...; the butterfly adds lanes 0 + 1
    # and 2 + 3, then the two pairs
    lane = torch.zeros((4,) + terms.shape[1:3] + (THREADS,), dtype=F64)
    lane.index_add_(-1, k % THREADS, terms)
    out = (lane[..., 0] + lane[..., 1]) + (lane[..., 2] + lane[..., 3])
    return tuple(out)


def check(smat, win, w):
    live, start, length = band(smat, w)
    rows = smat.reshape(smat.shape[0], smat.shape[1], 6, w)
    col = torch.arange(w)
    for axis in range(3):
        s, e = start[:, :, axis, None], (start + length)[:, :, axis, None]
        outside = (col < s) | (col >= e)
        for blk in (axis, axis + 3):
            assert bool((rows[:, :, blk][outside & live[..., None]] == 0)
                        .all())
    got = emulate_gather(smat, win, w)
    want = wg.gather_grad_planes_plain(smat, win, w)
    for g, x in zip(got, want):
        scale = max(float(x.abs().max()), 1e-300)
        assert float((g - x).abs().max()) <= RTOL * scale
    return live, length


def tiles_case(seed, tile, order, n=500, cap_extra=3):
    """Mesh tiles of ``n`` random atoms in f64 (caps above the largest
    occupancy: padded slots), a few atoms on mesh points (bands with an
    exact zero weight), the upper z tiles empty, and a random window."""
    rng = np.random.default_rng(seed)
    mesh = (2 * tile, 2 * tile, 4 * tile)
    box = 9.0
    pos = rng.uniform(0.0, box, (n, 3))
    pos[:n // 8] = rng.integers(0, mesh[0], (n // 8, 3)) * (
        box / np.array(mesh))
    pos[:, 2] *= 0.6
    cell = torch.eye(3, dtype=F64) * box
    pos_t = torch.as_tensor(pos, dtype=F64)
    probe = spline_windowed.build_mesh_tiles(pos_t, cell, mesh, order, cap=8,
                                             tile=tile)
    cap = int(probe.counts_max) + cap_extra
    tiles = spline_windowed.build_mesh_tiles(pos_t, cell, mesh, order,
                                             cap=cap, tile=tile)
    w = tiles.w_win
    win = torch.as_tensor(rng.normal(size=(tiles.smat.shape[0], w, w * w)),
                          dtype=F64)
    return tiles.smat.clone(), win, w


@pytest.mark.parametrize("order", [1, 2, 3, 4])
@pytest.mark.parametrize("tile", [4, 8, 16])
def test_band_only_gather_equals_plain(tile, order):
    smat, win, w = tiles_case(70 + tile + order, tile, order)
    assert w == tile + 4
    live, length = check(smat, win, w)
    assert bool((~live).any())                # empty and padded slots
    assert bool((length[live] == 4).all())    # order <= 4: four-wide bands


@pytest.mark.parametrize("tile", [4, 8, 16])
def test_band_at_window_edge_and_dense_rows(tile):
    """Synthetic rows: a band in the last columns of the window (its start
    moves left), a band in the first, one axis with a single non-zero
    column, rows wider than four columns and a dense row."""
    smat, win, w = tiles_case(80 + tile, tile, 4, n=200)
    rng = np.random.default_rng(90 + tile)
    rows = smat.view(smat.shape[0], smat.shape[1], 6, w)
    rows[0, 0] = 0.0
    rows[0, 0, :, w - 2:] = torch.as_tensor(rng.uniform(0.1, 1.0, (6, 2)))
    rows[0, 1] = 0.0
    rows[0, 1, :, :3] = torch.as_tensor(rng.uniform(0.1, 1.0, (6, 3)))
    rows[0, 2, 2] = 0.0
    rows[0, 2, 5] = 0.0
    rows[0, 2, 2, w - 1] = 0.7                  # z: one column, at the edge
    rows[1, 0] = 0.0
    rows[1, 0, :, 1:7] = torch.as_tensor(rng.uniform(0.1, 1.0, (6, 6)))
    rows[1, 1] = torch.as_tensor(rng.uniform(-1.0, 1.0, (6, w)))   # dense
    live, start, length = band(smat, w)
    assert int(start[0, 0, 0]) == w - 4 and int(length[0, 0, 0]) == 4
    assert int(start[0, 1, 1]) == 0
    assert int(length[1, 0, 2]) == 6 and int(length[1, 1, 0]) == w
    check(smat, win, w)

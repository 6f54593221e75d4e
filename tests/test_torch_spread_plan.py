# SPDX-License-Identifier: Apache-2.0
"""The CPU-side design of the two PME spread kernels.

- The dense spread's slab plan (``separable_spline.spread_plan``): every
  mesh point has exactly one owning block, and every block fits in shared
  memory.  A torch emulation of the kernel's owner-computes partition (per
  block: the (atom, x-point) pairs inside its planes, each adding its
  order^2 (y, z) points within its rows) equals the plain spread in f64.
  Its 64-bit fixed-point sum gives the same bits in any order of the adds
  and stays within f32 rounding of the f64 spread.
- The windowed spread's band skip: a torch emulation that adds only the
  terms the kernel adds (non-zero Sy and Sx entries, four z from the start
  of a narrow q*Sz band), found by scanning the rows as the kernel does,
  equals the plain spread in f64.
"""

import numpy as np
import pytest
import torch

from nvalchemiops_torch import spline, spline_windowed
from nvalchemiops_torch.kernels import separable_spline as ss
from nvalchemiops_torch.kernels import windowed_gather as wg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: Tier-1 runs six test workers on the CPU, and a
    torch thread pool in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMEM_LIMIT = 232_448       # bytes of shared memory one H100 block may use

MESHES = [(8, 8, 8), (16, 16, 16), (24, 32, 40), (32, 32, 32), (5, 7, 9),
          (48, 64, 80), (64, 64, 64), (96, 96, 96), (128, 128, 128),
          (128, 64, 32), (8, 128, 128), (100, 7, 13), (4, 256, 256),
          (2, 300, 320)]


@pytest.mark.parametrize("mesh", MESHES)
def test_spread_plan_owns_every_point_once(mesh):
    nx, ny, _ = mesh
    for batch in (1, 3, 8, 64, 200):
        for order in (1, 2, 3, 4):
            plan = ss.spread_plan(mesh, order, batch)
            owners = np.zeros((nx, ny), dtype=np.int64)
            for j in range(plan.y_slabs):
                for i in range(plan.x_slabs):
                    (x0, x1), (y0, y1) = plan.slab(i, j, mesh)
                    assert 0 < x1 - x0 <= plan.planes
                    assert 0 < y1 - y0 <= plan.rows
                    owners[x0:x1, y0:y1] += 1
            assert (owners == 1).all(), (mesh, batch, order)
            assert plan.blocks == batch * plan.x_slabs * plan.y_slabs


@pytest.mark.parametrize("mesh", MESHES)
def test_spread_plan_fits_shared_memory(mesh):
    for batch in (1, 64):
        plan = ss.spread_plan(mesh, 4, batch)
        slab = 8 * plan.planes * plan.rows * mesh[2]    # 64-bit sums
        assert slab + ss.SPREAD_LIST_BYTES <= plan.smem_bytes <= SMEM_LIMIT
        # a plane that fits is owned whole (rows == ny)
        if 8 * mesh[1] * mesh[2] + ss.SPREAD_LIST_BYTES <= SMEM_LIMIT:
            assert plan.rows == mesh[1]


def test_spread_plan_shapes_of_the_paths():
    """The batched PME, the 128^3 fallback and the composite take at most
    one block per SM, and as many as that allows."""
    batched = ss.spread_plan((32, 32, 32), 4, 64)
    assert batched.planes == 16 and batched.blocks == 128
    fallback = ss.spread_plan((128, 128, 128), 4, 1)
    assert fallback.planes == 1 and fallback.blocks == 128
    composite = ss.spread_plan((32, 32, 32), 4, 1)
    assert composite.planes == 1 and composite.blocks == 32
    thickest = ss.spread_plan((128, 128, 128), 4, 1, n_sm=1)
    assert thickest.planes == 1 and thickest.smem_bytes <= SMEM_LIMIT
    assert ss.spread_plan((32, 32, 32), 4, 1, n_sm=1).planes == 24
    with pytest.raises(ValueError, match="order"):
        ss.spread_plan((32, 32, 32), 5, 1)


def _emulate_owner_spread(gidx, w, q, mesh_dims, plan):
    """The spread kernel's partition in torch: per block, the (atom,
    x-point) pairs inside its planes add their order^2 (y, z) points that
    fall in its rows to its slab; each slab is written once."""
    nx, ny, nz = mesh_dims
    b_n, n, _, order = w.shape
    out = torch.full((b_n, nx, ny, nz), float("nan"), dtype=w.dtype)
    g = gidx.long()
    for b in range(b_n):
        for j in range(plan.y_slabs):
            for i in range(plan.x_slabs):
                (x0, x1), (y0, y1) = plan.slab(i, j, mesh_dims)
                slab = torch.zeros((x1 - x0, y1 - y0, nz), dtype=w.dtype)
                atom, a = torch.nonzero((g[b, :, 0] >= x0) & (g[b, :, 0] < x1),
                                        as_tuple=True)
                ga, wa = g[b, atom], w[b, atom]                 # [pairs, 3, o]
                y = ga[:, 1, :, None].expand(-1, order, order)
                z = ga[:, 2, None, :].expand_as(y)
                x = ga[:, 0].gather(1, a[:, None])[:, :, None].expand_as(y)
                val = ((q[b, atom] * wa[:, 0].gather(1, a[:, None])[:, 0])
                       [:, None, None] * wa[:, 1, :, None] * wa[:, 2, None, :])
                keep = (y >= y0) & (y < y1)
                slab.index_put_((x[keep] - x0, y[keep] - y0, z[keep]),
                                val[keep], accumulate=True)
                out[b, x0:x1, y0:y1] = slab
    return out


def _stencil_with_seams(seed, b, n, mesh_dims, order, box=11.0):
    """Stencils of random atoms, a few of them on the periodic seam of
    every axis (and exactly on mesh points: theta = 0)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, box, (b, n, 3))
    pos[:, :4] = [[0.0, 0.0, 0.0], [box - 1e-3] * 3, [1e-3, box - 1e-3, 0.0],
                  [box * 0.5, box - 1e-3, 1e-3]]
    q = torch.as_tensor(rng.normal(size=(b, n)))
    cells = torch.as_tensor(np.stack([np.eye(3) * box] * b))
    gidx, w, _, _ = spline._stencil(torch.as_tensor(pos), cells, mesh_dims,
                                    order)
    return gidx, w, q


@pytest.mark.parametrize("order", [1, 2, 3, 4])
@pytest.mark.parametrize("mesh,b,n,n_sm", [
    ((16, 16, 16), 3, 200, 132),        # thin slabs, one plane each
    ((12, 10, 8), 2, 300, 4),           # thick slabs
    ((3, 5, 7), 2, 40, 132),            # stencils wider than the mesh
    ((3, 160, 200), 1, 150, 132),       # planes too large: y-rows
])
def test_owner_partition_equals_plain(order, mesh, b, n, n_sm):
    gidx, w, q = _stencil_with_seams(60 + order, b, n, mesh, order)
    plan = ss.spread_plan(mesh, order, b, n_sm=n_sm)
    got = _emulate_owner_spread(gidx, w, q, mesh, plan)
    want = ss.separable_spread_plain(gidx, w, q, mesh)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12 * float(
        want.abs().max()))
    if mesh[1] * mesh[2] * 8 > ss.SMEM_LIMIT:
        assert plan.y_slabs > 1


def _band(rows):
    """``(lo, hi)`` of each row's first and last non-zero column, as the
    kernel scans them; ``lo > hi`` for an all-zero row."""
    nz = rows != 0
    width = rows.shape[-1]
    cols = torch.arange(width)
    lo = torch.where(nz, cols, width).amin(-1)
    hi = torch.where(nz, cols, -1).amax(-1)
    return lo, hi


def _emulate_band_spread(smat, q_t, w_win):
    """The windowed spread as the kernel adds it: a (y, x) column takes a
    slot only where its Sy and Sx entries are non-zero, and then the four z
    from ``min(lo, W - 4)`` when the slot's q*Sz band is at most four wide
    (else the band itself)."""
    sx, sy, sz = (smat[..., k * w_win:(k + 1) * w_win] for k in range(3))
    qsz = q_t[..., None] * sz
    cols = torch.arange(w_win)
    lo, hi = _band(qsz)
    narrow = hi - lo < 4
    start = torch.where(narrow, torch.clamp(lo, max=w_win - 4), lo)
    stop = torch.where(narrow, start + 3, hi)
    inside = (cols >= start[..., None]) & (cols <= stop[..., None])
    zpart = torch.where(inside, qsz, torch.zeros_like(qsz))
    ypart = torch.where(sy != 0, sy, torch.zeros_like(sy))
    xpart = torch.where(sx != 0, sx, torch.zeros_like(sx))
    out = torch.einsum("tcz,tcy,tcx->tzyx", zpart, ypart, xpart)
    return out.reshape(smat.shape[0], w_win, w_win * w_win)


@pytest.mark.parametrize("tile", [4, 8, 16])
@pytest.mark.parametrize("on_points", [True, False])
def test_band_skipped_windowed_spread_equals_plain(tile, on_points):
    """Rows from the tile build at theta = 0 (weights 1/6, 2/3, 1/6, 0: the
    band ends before the stencil does) and at random theta, with empty
    slots, empty tiles, a zero charge and one dense row."""
    rng = np.random.default_rng(70 + tile)
    mesh = (2 * tile, 2 * tile, 4 * tile)
    box = 9.0
    n = 150
    if on_points:
        pos = rng.integers(0, mesh[0], (n, 3)) * (box / np.array(mesh))
    else:
        pos = rng.uniform(0.0, box, (n, 3))
    pos[:, 2] *= 0.6                    # the upper z tiles stay empty
    cell = torch.as_tensor(np.eye(3) * box)
    tiles = spline_windowed.build_mesh_tiles(
        torch.as_tensor(pos), cell, mesh, 4, cap=45, tile=tile)
    w_win = tiles.w_win
    smat = tiles.smat.clone()
    smat[0, 0, :3 * w_win] = torch.as_tensor(
        rng.uniform(0.1, 1.0, 3 * w_win))
    q = torch.as_tensor(rng.normal(size=n))
    q[0] = 0.0
    padded = torch.cat([q, q.new_zeros(1)])
    q_t = padded[tiles.aid.long()].reshape(smat.shape[0], tiles.cap)
    q_t[0, 0] = 1.5
    assert (q_t == 0).any(-1).all()             # every tile has empty slots
    assert (q_t == 0).all(-1).any()             # and some tiles are empty
    got = _emulate_band_spread(smat, q_t, w_win)
    want = wg.spread_windows_plain(smat, q_t, w_win)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12 * float(
        want.abs().max()))
    if on_points:
        # theta = 0: three non-zero weights of four
        lo, hi = _band(tiles.smat[..., :w_win])
        occupied = lo <= hi
        assert ((hi - lo)[occupied] == 2).all()


def _fixed_point_spread(gidx, w, q, mesh_dims, order_of_terms):
    """The dense spread kernel's arithmetic in torch: f32 terms q wx wy wz
    (in the kernel's order), each rounded to a 64-bit integer of scale
    2^e (e = 61 - k for sum |q| * 1.0625 < 2^k), summed exactly, and the
    sum rounded once to f32.  ``order_of_terms`` permutes the adds."""
    nx, ny, nz = mesh_dims
    b_n, n, _, o = w.shape
    w32, q32 = w.float(), q.float()
    out = []
    for b in range(b_n):
        qsum = float(q32[b].abs().sum())
        e = 61 - int(np.frexp(np.float32(qsum) * np.float32(1.0625))[1])
        qx = q32[b][:, None] * w32[b, :, 0]                       # [n, a]
        qxy = qx[:, :, None] * w32[b, :, 1][:, None, :]           # [n, a, bb]
        v = qxy[..., None] * w32[b, :, 2][:, None, None, :]       # [n, a, bb, cc]
        g = gidx[b].long()
        flat = ((g[:, 0, :, None, None] * ny + g[:, 1, None, :, None]) * nz
                + g[:, 2, None, None, :]).reshape(-1)
        fixed = torch.round(v.double().reshape(-1) * 2.0 ** e).long()
        perm = order_of_terms(flat.numel())
        acc = torch.zeros(nx * ny * nz, dtype=torch.int64)
        acc.index_add_(0, flat[perm], fixed[perm])
        out.append((acc.to(torch.float32) * 2.0 ** -e).reshape(nx, ny, nz))
    return torch.stack(out)


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_fixed_point_spread_is_order_free_and_f32_exact(order):
    """The fixed-point sum gives the same bits in any order of the adds,
    and each mesh value within one f32 rounding (and the f32 terms') of
    the f64 plain spread."""
    mesh = (12, 10, 8)
    gidx, w, q = _stencil_with_seams(80 + order, 2, 400, mesh, order)
    gen = torch.Generator().manual_seed(order)
    forward = _fixed_point_spread(gidx, w, q, mesh, torch.arange)
    shuffled = _fixed_point_spread(
        gidx, w, q, mesh, lambda m: torch.randperm(m, generator=gen))
    assert torch.equal(forward, shuffled)
    want = ss.separable_spread_plain(gidx, w, q, mesh)
    scale = float(want.abs().max())
    assert float((forward.double() - want).abs().max()) <= 1e-6 * scale

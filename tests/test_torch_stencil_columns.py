# SPDX-License-Identifier: Apache-2.0
"""The thread partition of the voxel-stencil sweep (kernel 9), on the CPU.

``csrc/stencil_sweep.cu`` maps its threads over the interior voxels only.
A block holds 32 interior columns (y-major, the last block's lanes past
the end idle) of one z segment of the body's ``PLAN`` own voxels (the last
segment of a column ragged) and ``stencil_slices(body, radius)`` warps,
slice s taking the (dy, dx) offset pairs s, s + S, ...  A thread streams, for each of its
(dy, dx),
the segment's candidate rows k = 0 .. nz + 2*Rz - 1 and applies row k to
its own voxels t with dz = k - Rz - t inside [-Rz, Rz], skipping the self
pair; the slices' sums are added in slice order.  A torch emulation of
those loops, in f64, shows that:

- every (own voxel, offset) pair is seen exactly once, and row k is the
  candidate plane of that offset;
- the halo columns of ``out`` stay zero (the wrapper allocates it zeroed);
- the sums equal ``stencil_sweep_plain`` to 1e-12 for ``cn``, ``chain`` and
  ``coulomb``.

Cases: radius (1, 1, 1), (3, 3, 3) and (1, 4, 2) (9, 49 and 45 (dy, dx)
pairs over at most 16 warps, so a slice takes several pairs); non-cubic
dims, a non-periodic axis, segments of 2 and 4 voxels (ragged where they
do not divide Cz).
"""

import numpy as np
import pytest
import torch

from nvalchemiops_torch import stencil
from nvalchemiops_torch.kernels import stencil_sweep as ss
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


def thread_loops(dims, radius, tz, n_slices):
    """The (own z, dz, dy, dx, slice, candidate row) of every iteration one
    thread runs, in the kernel's loop order, for every z segment: the
    same for every column."""
    cz, _, _ = dims
    rz, ry, rx = radius
    nxw = 2 * rx + 1
    items = []
    for z0 in range(0, cz, tz):
        nz = min(tz, cz - z0)
        for s in range(n_slices):
            for pr in range(s, (2 * ry + 1) * nxw, n_slices):
                dy, dx = pr // nxw - ry, pr % nxw - rx
                for k in range(nz + 2 * rz):
                    for t in range(nz):
                        dz = k - rz - t
                        if abs(dz) > rz or (dz, dy, dx) == (0, 0, 0):
                            continue
                        items.append((z0 + t, dz, dy, dx, s, z0 + k))
    return torch.tensor(items)


def emulate_stencil(body, dims, radius, ext, own, params, tz):
    """Kernel 9's threads in torch: blocks of 32 interior columns, their
    loops (``thread_loops``), each slice's sums, then the slices added in
    order into a zeroed ``out [n_out, Cz, W0]``.  Returns ``(out, visits)``,
    visits as rows (own z, interior column, dz, dy, dx)."""
    cz, cy, cx = dims
    rz, ry, rx = radius
    ex = cx + 2 * rx
    pad = ry * ex + rx
    w0 = own.shape[2]
    n_out = ss.BODIES[body][2]
    n_chunks = -(-cy * cx // 32)
    lanes = torch.arange(n_chunks * 32)               # chunk * 32 + lane
    ci = lanes[lanes < cy * cx]                       # the active lanes
    y, x = ci // cx, ci % cx
    col = (y + ry) * ex + (x + rx)
    n_slices = ss.stencil_slices(body, radius)
    loops = thread_loops(dims, radius, tz, n_slices)
    z, dz, dy, dx, s, krow = (loops[:, i][:, None] for i in range(6))
    assert bool((krow == z + dz + rz).all())          # row k is z + dz
    own_col = col[None, :].expand(len(loops), -1)
    cand_col = pad + dy * ex + dx + own_col
    z_b = z.expand_as(own_col)
    o = own[:, z_b, own_col]                          # [n_feat, L, C]
    c = ext[:, krow.expand_as(own_col), cand_col]
    own_terms, _ = ws.BODY_FNS[body](o, c, params, None, None, None)
    flat = (z_b * w0 + own_col).reshape(-1)
    slice_of = s.expand_as(own_col).reshape(-1)
    out = torch.zeros((n_out, cz * w0), dtype=own.dtype)
    for k, term in enumerate(own_terms):
        term = term.expand_as(own_col).reshape(-1)
        partial = torch.zeros((n_slices, cz * w0), dtype=own.dtype)
        partial.index_put_((slice_of, flat), term, accumulate=True)
        for sl in range(n_slices):                    # in slice order
            out[k] += partial[sl]
    visits = torch.stack([z_b, ci[None, :].expand_as(own_col),
                          *(v.expand_as(own_col) for v in (dz, dy, dx))],
                         dim=-1).reshape(-1, 5)
    return out.reshape(n_out, cz, w0), visits


def crystal_stencil(seed, counts, radius, cutoff, pbc):
    """A jittered lattice of ``counts`` (x, y, z) sites at a = 3 A, one
    atom a voxel, on a stencil of those dims and ``radius``; random rcov,
    decn and charges."""
    rng = np.random.default_rng(seed)
    a = 3.0
    nx, ny, nz = counts
    lat = np.stack(np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                               indexing="ij"), -1).reshape(-1, 3)
    pos = (lat + 0.5) * a + rng.uniform(-0.2, 0.2, lat.shape)
    pos = torch.as_tensor(pos, dtype=F64)
    cell = torch.diag(torch.tensor([nx * a, ny * a, nz * a], dtype=F64))
    sg = stencil.build_stencil_grid(pos, cell, pbc, (nz, ny, nx), radius)
    assert int(sg.counts_max) == 1
    n = pos.shape[0]
    extra = (torch.as_tensor(rng.uniform(0.6, 1.4, n), dtype=F64),
             torch.as_tensor(rng.normal(size=n), dtype=F64),
             torch.as_tensor(rng.normal(size=n), dtype=F64))
    return sg, extra


def stencil_calls(sg, extra, cutoff):
    """The kernel-9 wrapper's calls of the three stencil functions."""
    rcov, decn, q = extra
    calls = []
    orig = stencil.stencil_sweep

    def wrapper(*args, **kwargs):
        calls.append((args, kwargs))
        return orig(*args, **kwargs)

    stencil.stencil_sweep = wrapper
    try:
        stencil.stencil_coordination_numbers(sg, rcov, cutoff, engine="stack")
        stencil.stencil_cn_chain_forces(sg, rcov, decn, cutoff,
                                        engine="stack")
        stencil.stencil_coulomb_energy_forces(sg, q, cutoff, 0.35,
                                              engine="stack")
    finally:
        stencil.stencil_sweep = orig
    assert [c[0][0] for c in calls] == ["cn", "chain", "coulomb"]
    return calls


CASES = {
    # (seed, (nx, ny, nz) sites, radius (z, y, x), cutoff, pbc (x, y, z))
    "radius 1, z open": (81, (7, 5, 6), (1, 1, 1), 2.9,
                         (True, True, False)),
    "radius 3": (82, (7, 5, 6), (3, 3, 3), 8.5, (True, True, True)),
    "radius (1, 4, 2), y open": (83, (6, 9, 5), (1, 4, 2), 5.5,
                                 (True, False, True)),
}


@pytest.mark.parametrize("tz", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_stencil_columns_visit_each_offset_once_and_sum_to_plain(case, tz):
    seed, counts, radius, cutoff, pbc = CASES[case]
    sg, extra = crystal_stencil(seed, counts, radius, cutoff, pbc)
    cz, cy, cx = sg.dims
    if tz == 4:
        assert cz % tz                                # a ragged segment
    n_offsets = len(ss.full_offsets(radius))
    for args, kwargs in stencil_calls(sg, extra, cutoff):
        body, dims, rad, ext, own, params = args
        got, visits = emulate_stencil(body, dims, rad, ext, own, params, tz)
        # every (own voxel, offset) once
        assert len(visits) == cz * cy * cx * n_offsets
        assert len(torch.unique(visits, dim=0)) == len(visits)
        # the halo columns stay zero, as the plain version's are
        want = ss.stencil_sweep_plain(body, dims, rad, ext, own, params)
        halo = torch.ones(sg.ext_dims[1:], dtype=torch.bool)
        halo[radius[1]:radius[1] + cy, radius[2]:radius[2] + cx] = False
        halo = halo.reshape(-1)
        assert not got[:, :, halo].any() and not want[:, :, halo].any()
        assert bool((want != 0).any())
        for g, w in zip(got, want):
            scale = w.abs().max().item()
            assert (g - w).abs().max().item() <= RTOL * scale


def test_stencil_plan_is_one_the_kernel_has():
    """Each body's segment is one the kernel is built for, and a block's
    warps stay within the kernel's 16."""
    for body in ss.BODIES:
        segment, warps = ss.PLAN[body]
        assert segment in (2, 4) and 1 <= warps <= 16
        assert ss.stencil_slices(body, (3, 3, 3)) == min(49, warps)
        assert ss.stencil_slices(body, (0, 0, 0)) == 1

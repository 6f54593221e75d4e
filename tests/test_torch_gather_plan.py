# SPDX-License-Identifier: Apache-2.0
"""The design of the dense separable gather (kernel 6), on the CPU.

``csrc/separable_spline.cu`` gathers on one of two paths, which
``kernels.separable_spline.gather_plan`` picks:

- staged: block ``(b, s)`` copies system ``b``'s mesh into shared memory and
  gives each of its threads one atom of slice ``s`` a pass; the thread sums
  the atom's order^2 rows as separable partial sums (z, then y, then x);
- L2: a group of lanes an atom, one lane (all rows) or one lane a stencil
  row (order^2 rounded up to a power of two, the idle lanes adding zero),
  the lanes' terms summed by a fixed xor butterfly; lane j of the group
  writes output j (value, then the three gradient components).

A torch emulation of both in f64 shows that every atom is gathered once,
every (atom, row) is visited once, the butterfly leaves every lane of a
group with the same bits, every output is written once, and the sums equal
``separable_gather_plain`` to 1e-12: at orders 1-4, with a mesh narrower
than the stencil, atoms on the periodic seam, ragged and empty slices and
several passes a thread, with and without derivative weights.  The plan is
held to the shapes ``chip_smoke.py`` drives and to the shared memory a
block may use.
"""

import numpy as np
import pytest
import torch

from nvalchemiops_torch import spline
from nvalchemiops_torch.kernels import separable_spline as ss


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


def stencil_case(seed, b, n, dims, order, box=9.0):
    """Mesh, stencil and derivative weights of ``b`` systems of ``n``
    random atoms in f64, the first four on the periodic seam of every axis
    and on mesh points (theta = 0)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, box, (b, n, 3))
    seam = [[0.0, 0.0, 0.0], [box - 1e-9] * 3, [1e-9, box - 1e-9, 0.0],
            [box * 0.5, box - 1e-9, 1e-9]]
    pos[:, :min(4, n)] = seam[:min(4, n)]
    cells = torch.eye(3, dtype=F64).expand(b, 3, 3) * box
    gidx, w, dw, _ = spline._stencil(torch.as_tensor(pos), cells, dims, order)
    mesh = torch.as_tensor(rng.normal(size=(b,) + tuple(dims)))
    return mesh, gidx, w, dw


def rows_of(order, lanes):
    """``(a, b, live)`` ``[lanes, rows a lane]``: the stencil rows lane j
    of an atom's group sums (``live`` False where it has none)."""
    if lanes == 1:
        a, b = torch.meshgrid(torch.arange(order), torch.arange(order),
                              indexing="ij")
        return a.reshape(1, -1), b.reshape(1, -1), torch.ones(
            1, order * order, dtype=torch.bool)
    j = torch.arange(lanes)[:, None]
    live = j < order * order
    return (torch.where(live, j // order, 0), torch.where(live, j % order, 0),
            live)


def lane_terms(mesh, gidx, w, dw, order, lanes):
    """Each lane's (value, d/dx, d/dy, d/dz) terms ``[4, B, N, lanes]`` as
    the kernel forms them, and the count of lanes that visit each (atom,
    row) ``[B, N, order, order]``."""
    bsz, n = w.shape[:2]
    a, b, live = rows_of(order, lanes)                 # [lanes, k]
    g = gidx.long()
    sys = torch.arange(bsz)[:, None, None, None]
    gx = g[:, :, 0][..., a]                            # [B, N, lanes, k]
    gy = g[:, :, 1][..., b]
    gz = g[:, :, 2]                                    # [B, N, order]
    m = mesh[sys[..., None], gx[..., None], gy[..., None],
             gz[:, :, None, None, :]]                  # [B, N, lanes, k, o]
    dz = dw[:, :, 2] if dw is not None else torch.zeros_like(w[:, :, 2])
    r = (m * w[:, :, 2][:, :, None, None, :]).sum(-1)  # z first
    rdz = (m * dz[:, :, None, None, :]).sum(-1)
    r, rdz = r * live, rdz * live
    wx, wy = w[:, :, 0][..., a], w[:, :, 1][..., b]
    d = dw if dw is not None else torch.zeros_like(w)
    dx, dy = d[:, :, 0][..., a], d[:, :, 1][..., b]
    terms = torch.stack([(wx * wy * r).sum(-1), (dx * wy * r).sum(-1),
                         (wx * dy * r).sum(-1), (wx * wy * rdz).sum(-1)])
    visits = torch.zeros(bsz, n, order, order, dtype=torch.long)
    for k in range(a.shape[1]):
        for lane in range(a.shape[0]):
            if live[lane, k]:
                visits[:, :, a[lane, k], b[lane, k]] += 1
    return terms, visits


def butterfly(terms, lanes):
    """The kernel's xor butterfly over the group's lanes: offsets L / 2,
    ..., 1, each lane adding its partner's sum to its own."""
    j = torch.arange(lanes)
    k = lanes // 2
    while k:
        terms = terms + terms[..., j ^ k]
        k //= 2
    return terms


def write(sums, lanes, with_grad):
    """Lane j of a group writes outputs j, j + L, ...: ``(val, grad,
    writes [B, N, 4])``."""
    val = torch.full(sums.shape[1:3], float("nan"), dtype=F64)
    grad = torch.full(sums.shape[1:3] + (3,), float("nan"), dtype=F64)
    writes = torch.zeros(sums.shape[1:3] + (4,), dtype=torch.long)
    for j in range(lanes):
        for k in range(j, 4 if with_grad else 1, lanes):
            if k == 0:
                val = sums[0, :, :, j].clone()
            else:
                grad[..., k - 1] = sums[k, :, :, j]
            writes[..., k] += 1
    return val, grad, writes


def emulate(mesh, gidx, w, dw, plan):
    """The gather under ``plan``: ``(val, grad)``; checks the partition,
    the rows visited, the butterfly and the writes."""
    bsz, n, _, order = w.shape
    if plan.staged:
        # every atom in one slice, one thread, one pass
        owner = torch.zeros(n, plan.threads, dtype=torch.long)
        for s in range(plan.slices):
            n0, n1 = plan.atoms(s, n)
            atoms = torch.arange(n0, n1)
            owner[atoms, (atoms - n0) % plan.threads] += 1
        assert bool((owner.sum(-1) == 1).all())
        assert plan.blocks == bsz * plan.slices
    else:
        per = plan.threads // plan.lanes
        assert plan.atoms_per_block == per
        assert plan.blocks * per >= bsz * n > (plan.blocks - 1) * per
    terms, visits = lane_terms(mesh, gidx, w, dw, order, plan.lanes)
    assert bool((visits == 1).all())
    sums = butterfly(terms, plan.lanes)
    assert bool((sums == sums[..., :1]).all())        # every lane, same bits
    val, grad, writes = write(sums, plan.lanes, dw is not None)
    assert bool((writes[..., :4 if dw is not None else 1] == 1).all())
    return val, grad


def close(got, want):
    scale = max(float(want.abs().max()), 1e-300)
    assert float((got - want).abs().max()) <= RTOL * scale


# ---- the plan --------------------------------------------------------------

@pytest.mark.parametrize("dims,b,n,staged,lanes,slices", [
    ((32, 32, 32), 64, 2000, True, 1, 2),        # the batched dense PME
    ((32, 32, 32), 1, 1024, False, 16, 0),       # the composite, B = 1
    ((128, 128, 128), 1, 109_744, False, 1, 0),  # the 128^3 fallback
    ((64, 64, 64), 8, 2000, False, 1, 0),        # engine="dense" at 64^3
])
def test_plan_at_the_driven_shapes(dims, b, n, staged, lanes, slices):
    plan = ss.gather_plan(dims, 4, b, n)
    assert (plan.staged, plan.lanes, plan.slices) == (staged, lanes, slices)
    if staged:
        assert plan.blocks == 128 and plan.atoms_per_block == 1000
        assert plan.threads == ss.GATHER_THREADS
        assert plan.smem_bytes == 4 * 32 ** 3 + ss.GATHER_STATIC_SMEM
    else:
        assert plan.smem_bytes == 0 and plan.threads == ss.GATHER_L2_THREADS


def test_staged_mesh_within_shared_memory():
    """A staged mesh never takes more than 232,448 bytes, and is a whole
    number of 16-byte units; one that would is refused when forced."""
    seen = 0
    for nx in range(1, 48, 3):
        for ny in (nx, 32, 36):
            for nz in (nx, 32, 37):
                for b, n in ((64, 2000), (1, 200_000)):
                    plan = ss.gather_plan((nx, ny, nz), 4, b, n)
                    points = nx * ny * nz
                    fits = (points % 4 == 0 and 4 * points
                            + ss.GATHER_STATIC_SMEM <= ss.SMEM_LIMIT)
                    if plan.staged:
                        seen += 1
                        assert plan.smem_bytes <= ss.SMEM_LIMIT
                        assert plan.smem_bytes == 4 * points \
                            + ss.GATHER_STATIC_SMEM
                        assert points % 4 == 0
                    if fits:
                        forced = ss.gather_plan((nx, ny, nz), 4, b, n,
                                                staged=True)
                        assert forced.smem_bytes <= ss.SMEM_LIMIT
                    else:
                        assert not plan.staged
                        with pytest.raises(ValueError):
                            ss.gather_plan((nx, ny, nz), 4, b, n,
                                           staged=True)
    assert seen > 0


def test_plan_lanes_and_crossover():
    """The L2 path spreads a small batch over one lane a row and gives a
    large one a lane an atom; the staged path takes a block's atoms only
    where they read at least STAGED_READS_MIN points per copied point."""
    assert [ss.row_lanes(o) for o in (1, 2, 3, 4)] == [1, 4, 16, 16]
    small = ss.L2_ROW_LANES_MAX_ATOMS
    assert ss.gather_plan((64,) * 3, 4, 1, small).lanes == 16
    assert ss.gather_plan((64,) * 3, 4, 1, small + 1).lanes == 1
    for b in (1, 4, 16, 32, 64, 128, 256):
        plan = ss.gather_plan((32,) * 3, 4, b, 2000)
        per = -(-2000 // max(1, ss.N_SM // b))
        assert plan.staged == (per * 64 >= ss.STAGED_READS_MIN * 32 ** 3)


# ---- the emulation ---------------------------------------------------------

@pytest.mark.parametrize("order", [1, 2, 3, 4])
@pytest.mark.parametrize("grad", [True, False])
@pytest.mark.parametrize("case", ["staged, ragged and empty slices",
                                  "staged, three passes", "l2 rows",
                                  "l2 atoms", "narrow mesh"])
def test_emulated_gather_matches_plain(order, grad, case):
    dims, b, n, n_sm, staged, lanes = {
        "staged, ragged and empty slices": ((8, 12, 16), 2, 1003, 264,
                                            True, 1),
        "staged, three passes": ((8, 8, 8), 1, 2500, 1, True, 1),
        "l2 rows": ((12, 8, 10), 3, 300, ss.N_SM, False, None),
        "l2 atoms": ((12, 8, 10), 3, 300, ss.N_SM, False, 1),
        "narrow mesh": ((3, 2, 5), 2, 200, ss.N_SM, False, None),
    }[case]
    plan = ss.gather_plan(dims, order, b, n, n_sm=n_sm, staged=staged)
    if lanes is not None and not plan.staged:
        per = ss.GATHER_L2_THREADS // lanes
        plan = type(plan)(**{**plan.__dict__, "lanes": lanes,
                             "atoms_per_block": per,
                             "blocks": -(-b * n // per)})
    if case.startswith("staged, ragged"):
        assert n % plan.slices and n < plan.slices * plan.atoms_per_block
        assert plan.atoms(plan.slices - 1, n) == (n, n)  # an empty slice
    if case == "staged, three passes":
        assert -(-plan.atoms_per_block // plan.threads) == 3
    mesh, gidx, w, dw = stencil_case(60 + order, b, n, dims, order)
    dw = dw if grad else None
    val, grad_k = emulate(mesh, gidx, w, dw, plan)
    want = ss.separable_gather_plain(mesh, gidx, w, dw)
    if dw is None:
        close(val, want)
    else:
        close(val, want[0])
        for d in range(3):
            close(grad_k[..., d], want[1][..., d])


def test_wrapper_takes_the_plain_version_on_cpu():
    """On CPU tensors the wrapper returns the plain version's result and
    launches nothing."""
    from nvalchemiops_torch.kernels import launch_counts

    mesh, gidx, w, dw = stencil_case(7, 2, 50, (8, 8, 8), 4)
    before = launch_counts["separable_gather"]
    got = ss.separable_gather(mesh, gidx, w, dw)
    want = ss.separable_gather_plain(mesh, gidx, w, dw)
    assert launch_counts["separable_gather"] == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

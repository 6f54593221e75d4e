# SPDX-License-Identifier: Apache-2.0
"""Dense separable B-spline spread and gather (csrc/separable_spline.cu).

Counterparts of ``nvalchemiops_tpu/pallas/spread.py``:

- :func:`separable_spread` (``pallas_separable_spread``): ``mesh[b, x, y,
  z] = sum_n q[b, n] Sx[b, n, x] Sy[b, n, y] Sz[b, n, z]``;
- :func:`separable_gather` (``pallas_separable_gather``): ``val[b, n] =
  sum_xyz mesh[b, x, y, z] Sx Sy Sz``, and with derivative weights also the
  fractional gradient ``grad[b, n, d]``, the same sum with the axis-d
  weights swapped for their derivatives.

The JAX kernels take the dense axis matrices ``S_d [N, n_d]`` that feed the
TPU's matrix unit.  Each row of one is the one-hot expansion of the
compact stencil (``spline.py:284-289``), so these take the stencil itself:
``gidx [B, N, 3, order]`` (wrapped mesh indices, int32) and ``w`` (``dw``)
``[B, N, 3, order]``.  The plain versions build the dense matrices
(:func:`axis_weight_matrix`) and contract them in atom chunks, as the JAX
package's ``_separable_spread`` / ``_separable_gather`` do.

The spread kernel owns the mesh in slabs, each accumulated in one block's
shared memory in 64-bit fixed point (so its result does not depend on the
order of the adds) and written once; :func:`spread_plan` picks the slabs.
The gather kernel reads each atom's stencil rows from a copy of its
system's mesh in shared memory (one atom a thread) or through L2 (one
lane an atom, or one a row); :func:`gather_plan` picks the path.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from nvalchemiops_torch.kernels import launch_counts
from nvalchemiops_torch.kernels.build import (
    check_cuda_tensors, check_launch, current_stream, launches_kernel,
    load_library, on_device,
)
from nvalchemiops_torch.types import INDEX_DTYPE

__all__ = ["axis_weight_matrix", "SpreadPlan", "spread_plan", "GatherPlan",
           "gather_plan", "separable_spread", "separable_spread_plain",
           "separable_gather", "separable_gather_plain"]

_CHUNK = 2048   # atoms per contraction of the plain versions, as in JAX

# the spread kernel's launch (csrc/separable_spline.cu: kThreads, kList,
# kSmemLimit) and the card it fills
SPREAD_THREADS = 1024
SPREAD_LIST_BYTES = 4 * (8192 + 4)    # the round's pair list and its count
POINT_BYTES = 8             # a mesh point's 64-bit fixed-point sum
SMEM_LIMIT = 232_448        # shared memory one block may use (H100: 227 KB)
N_SM = 132                  # streaming multiprocessors of an H100 SXM

# the gather kernel's launch (csrc/separable_spline.cu: kGatherThreads,
# kGatherL2Threads, kGatherStaticSmem)
GATHER_THREADS = 1024       # a staged block, one atom a thread
GATHER_L2_THREADS = 256     # an L2 block
GATHER_STATIC_SMEM = 16     # a staged block's barrier
# the staged path when a block's atoms read at least this many stencil
# points per mesh point it copies (order^3 an atom against nx ny nz): at
# 32^3 it lost to the L2 path at 0.49 (16 x 2,000 atoms) and won at 0.98
# (32 x 2,000; pair_sweep_times.py --gather-paths, PERF.md)
STAGED_READS_MIN = 0.75
# the L2 path gives each atom one lane a stencil row (order^2 lanes,
# rounded up to a power of two) up to this many atoms in the batch, and
# one lane above: few atoms spread over more lanes, many fill the card
# with one lane each (rows won at 8,000 atoms, one lane at 32,000)
L2_ROW_LANES_MAX_ATOMS = 64 * N_SM


@dataclass(frozen=True)
class SpreadPlan:
    """How the spread kernel cuts a ``[B, nx, ny, nz]`` batch of meshes.

    Block ``(b, j, i)`` owns x-planes ``[i * planes, (i + 1) * planes)``
    and y-rows ``[j * rows, (j + 1) * rows)`` of system ``b`` (cut at the
    mesh's edge), all of z, in shared memory (8 bytes a point).
    """

    planes: int
    rows: int
    x_slabs: int
    y_slabs: int
    threads: int
    smem_bytes: int
    blocks: int

    def slab(self, i: int, j: int, mesh_dims):
        """``((x0, x1), (y0, y1))`` owned by x-slab ``i`` of y-slab ``j``."""
        nx, ny = int(mesh_dims[0]), int(mesh_dims[1])
        x0, y0 = min(i * self.planes, nx), min(j * self.rows, ny)
        return ((x0, min(x0 + self.planes, nx)),
                (y0, min(y0 + self.rows, ny)))


@functools.lru_cache(maxsize=64)
def _plan(mesh_dims, order: int, batch: int, n_sm: int) -> SpreadPlan:
    nx, ny, nz = mesh_dims
    if not 1 <= order <= 4:
        raise ValueError(f"spline order must be 1-4, got {order}")
    if min(nx, ny, nz) < 1:
        raise ValueError(f"mesh dims must be positive, got {mesh_dims}")
    budget = SMEM_LIMIT - SPREAD_LIST_BYTES
    if POINT_BYTES * nz > budget:
        raise ValueError(f"separable_spread: a z-row of {nz} points does not "
                         f"fit in {budget} bytes of shared memory")
    if POINT_BYTES * ny * nz <= budget:
        rows, fit = ny, min(nx, budget // (POINT_BYTES * ny * nz))
    else:
        rows, fit = budget // (POINT_BYTES * nz), 1
    y_slabs = -(-ny // rows)
    wanted = max(1, n_sm // max(batch * y_slabs, 1))
    planes = max(1, min(fit, -(-nx // wanted)))
    x_slabs = -(-nx // planes)
    words = -(-planes * rows * nz // 4) * 4
    return SpreadPlan(planes=planes, rows=rows, x_slabs=x_slabs,
                      y_slabs=y_slabs, threads=SPREAD_THREADS,
                      smem_bytes=2 * 4 * words + SPREAD_LIST_BYTES,
                      blocks=batch * y_slabs * x_slabs)


def spread_plan(mesh_dims, order: int, batch: int,
                n_sm: int = N_SM) -> SpreadPlan:
    """Slab plan of :func:`separable_spread` for ``batch`` meshes of
    ``mesh_dims`` at spline ``order``.

    Slabs are whole x-planes (y-rows when one plane does not fit in shared
    memory), as many as fit, thinned while the batch's slabs stay within
    one block per SM (a block takes the SM's threads).  A thin slab costs
    little more: every block scans its system's stencils, but spreads only
    the (atom, x-point) pairs that fall in its planes.
    """
    return _plan(tuple(int(d) for d in mesh_dims), int(order), int(batch),
                 int(n_sm))


@dataclass(frozen=True)
class GatherPlan:
    """How the gather kernel walks a ``[B, nx, ny, nz]`` batch of meshes.

    Staged: block ``(b, s)`` copies mesh ``b`` into shared memory and
    gathers atoms ``[s * atoms_per_block, (s + 1) * atoms_per_block)`` of
    system ``b`` (cut at ``N``), one a thread.  L2 (``slices == 0``):
    ``lanes`` lanes an atom (1, or one a stencil row), rows read from
    device memory, ``atoms_per_block`` atoms a block of ``threads``.
    """

    staged: bool
    lanes: int
    slices: int
    threads: int
    smem_bytes: int
    blocks: int
    atoms_per_block: int

    def atoms(self, s: int, n_atoms: int):
        """``(n0, n1)``: the atoms of slice ``s`` of a staged system."""
        n0 = min(s * self.atoms_per_block, n_atoms)
        return n0, min(n0 + self.atoms_per_block, n_atoms)


def row_lanes(order: int) -> int:
    """Lanes of an atom's group when each lane takes one stencil row:
    ``order^2`` rounded up to a power of two."""
    return 1 << (order * order - 1).bit_length()


@functools.lru_cache(maxsize=64)
def _gather_plan(mesh_dims, order: int, batch: int, atoms: int, n_sm: int,
                 staged) -> GatherPlan:
    nx, ny, nz = mesh_dims
    if not 1 <= order <= 4:
        raise ValueError(f"spline order must be 1-4, got {order}")
    if min(nx, ny, nz) < 1:
        raise ValueError(f"mesh dims must be positive, got {mesh_dims}")
    points = nx * ny * nz
    smem = 4 * points + GATHER_STATIC_SMEM
    fits = points % 4 == 0 and smem <= SMEM_LIMIT
    slices = max(1, n_sm // max(batch, 1))
    per = -(-atoms // slices)
    if staged and not fits:
        raise ValueError(f"separable_gather: a {mesh_dims} mesh cannot be "
                         f"staged ({smem} bytes, {points} points)")
    if staged is None:
        staged = fits and per * order ** 3 >= STAGED_READS_MIN * points
    if staged:
        return GatherPlan(staged=True, lanes=1, slices=slices,
                          threads=GATHER_THREADS, smem_bytes=smem,
                          blocks=batch * slices, atoms_per_block=per)
    lanes = (row_lanes(order) if batch * atoms <= L2_ROW_LANES_MAX_ATOMS
             else 1)
    per = GATHER_L2_THREADS // lanes
    return GatherPlan(staged=False, lanes=lanes, slices=0,
                      threads=GATHER_L2_THREADS, smem_bytes=0,
                      blocks=-(-batch * atoms // per), atoms_per_block=per)


def gather_plan(mesh_dims, order: int, batch: int, atoms: int,
                n_sm: int = N_SM, staged=None) -> GatherPlan:
    """Path of :func:`separable_gather` for ``batch`` meshes of
    ``mesh_dims`` and ``atoms`` atoms a system at spline ``order``.

    Staged where the mesh fits in a block's shared memory (a whole number
    of 16-byte units, up to ~38^3 points) and each block, one of ``n_sm
    // batch`` slices of its system's atoms (the batch then fills the SMs,
    one block each), reads at least ``STAGED_READS_MIN`` stencil points
    per mesh point it copies; the L2 path otherwise, one lane a stencil
    row up to ``L2_ROW_LANES_MAX_ATOMS`` atoms and one lane an atom above.
    ``staged`` True or False forces a path (a measurement's probe, or a
    mesh not on 16 bytes); a staged mesh that does not fit raises
    ``ValueError``.
    """
    return _gather_plan(tuple(int(d) for d in mesh_dims), int(order),
                        int(batch), int(atoms), int(n_sm),
                        None if staged is None else bool(staged))


def axis_weight_matrix(gidx_d, w_d, n_mesh: int):
    """Dense per-axis matrix ``[.., N, n_mesh]`` from one axis of the
    stencil (``gidx_d``, ``w_d`` ``[.., N, order]``)."""
    out = torch.zeros(tuple(w_d.shape[:-1]) + (n_mesh,), dtype=w_d.dtype,
                      device=w_d.device)
    return out.scatter_add_(-1, gidx_d.long(), w_d)


def _matrices(gidx, w, mesh_dims):
    return [axis_weight_matrix(gidx[..., d, :], w[..., d, :],
                               int(mesh_dims[d])) for d in range(3)]


def _check(name, gidx, w, dw=None):
    if gidx.dim() != 4 or gidx.shape[2] != 3 or tuple(w.shape) != tuple(
            gidx.shape):
        raise ValueError(f"{name}: gidx and w must be [B, N, 3, order], got "
                         f"{tuple(gidx.shape)} and {tuple(w.shape)}")
    if dw is not None and tuple(dw.shape) != tuple(w.shape):
        raise ValueError(f"{name}: dw {tuple(dw.shape)} must match w")


def _check_index(name, gidx, ref):
    if gidx.device != ref.device:
        raise ValueError(f"{name}: tensors on different devices")
    if gidx.dtype != INDEX_DTYPE or not gidx.is_contiguous():
        raise ValueError(f"{name}: gidx must be contiguous {INDEX_DTYPE}")


def separable_spread_plain(gidx, w, q, mesh_dims):
    """Plain PyTorch version of :func:`separable_spread` (any device and
    dtype): chunked ``(q Sx)^T (Sy (x) Sz)`` contractions."""
    _check("separable_spread", gidx, w)
    nx, ny, nz = (int(d) for d in mesh_dims)
    b, n = w.shape[:2]
    sx, sy, sz = _matrices(gidx, w, mesh_dims)
    qsx = q[..., None] * sx
    mesh = torch.zeros((b, nx, ny * nz), dtype=w.dtype, device=w.device)
    for c in range(0, n, _CHUNK):
        t = (sy[:, c:c + _CHUNK, :, None]
             * sz[:, c:c + _CHUNK, None, :]).flatten(-2)
        mesh += torch.einsum("bnx,bnm->bxm", qsx[:, c:c + _CHUNK], t)
    return mesh.reshape(b, nx, ny, nz)


def separable_spread(gidx, w, q, mesh_dims):
    """Spread ``q [B, N]`` onto ``[B, nx, ny, nz]`` meshes through the
    stencil: the CUDA kernel for float32 CUDA tensors, on their card (slabs
    of :func:`spread_plan`, every mesh point written by its owner), else
    the plain version on the tensors' device.  The
    stencil's indices are consecutive mod n along each axis, as
    ``spline._stencil`` builds them; the kernel finds an atom's x-points
    from the first.  The kernel sums in fixed point, so two launches on
    the same inputs give the same bits."""
    _check("separable_spread", gidx, w)
    if tuple(q.shape) != tuple(w.shape[:2]):
        raise ValueError(f"separable_spread: q {tuple(q.shape)} must be "
                         f"[B, N] = {tuple(w.shape[:2])}")
    if not launches_kernel(w):
        return separable_spread_plain(gidx, w, q, mesh_dims)
    check_cuda_tensors("separable_spread", w, q)
    _check_index("separable_spread", gidx, w)
    nx, ny, nz = (int(d) for d in mesh_dims)
    b, n, _, order = w.shape
    plan = spread_plan((nx, ny, nz), order, b)
    xbase = gidx[:, :, 0, 0].contiguous()      # what the kernel's scan reads
    mesh = torch.empty((b, nx, ny, nz), dtype=w.dtype, device=w.device)
    with on_device(w):
        err = load_library().nv_separable_spread(
            gidx.data_ptr(), xbase.data_ptr(), w.data_ptr(), q.data_ptr(),
            mesh.data_ptr(),
            b, n, order, nx, ny, nz, plan.planes, plan.rows, plan.x_slabs,
            plan.y_slabs, current_stream(w))
    check_launch("separable_spread", err)
    launch_counts["separable_spread"] += 1
    return mesh


def separable_gather_plain(mesh, gidx, w, dw=None):
    """Plain PyTorch version of :func:`separable_gather` (any device and
    dtype): per chunk one ``Sx @ mesh`` projection, reduced against ``Sy``
    and ``Sz``; the x-derivative gather projects ``dSx`` too."""
    _check("separable_gather", gidx, w, dw)
    b, nx, ny, nz = mesh.shape
    n = w.shape[1]
    mesh2 = mesh.reshape(b, nx, ny * nz)
    sx, sy, sz = _matrices(gidx, w, (nx, ny, nz))
    dsx, dsy, dsz = (_matrices(gidx, dw, (nx, ny, nz)) if dw is not None
                     else (None,) * 3)

    def reduce(proj, a, c):
        return torch.einsum("bnyz,bny,bnz->bn", proj, a, c)

    vals, grads = [], []
    for c0 in range(0, n, _CHUNK):
        c = slice(c0, c0 + _CHUNK)
        proj = torch.einsum("bnx,bxm->bnm", sx[:, c], mesh2).reshape(
            b, -1, ny, nz)
        vals.append(reduce(proj, sy[:, c], sz[:, c]))
        if dw is not None:
            projd = torch.einsum("bnx,bxm->bnm", dsx[:, c], mesh2).reshape(
                b, -1, ny, nz)
            grads.append(torch.stack([reduce(projd, sy[:, c], sz[:, c]),
                                      reduce(proj, dsy[:, c], sz[:, c]),
                                      reduce(proj, sy[:, c], dsz[:, c])],
                                     dim=-1))
    val = torch.cat(vals, dim=1)
    return (val, torch.cat(grads, dim=1)) if dw is not None else val


def separable_gather(mesh, gidx, w, dw=None):
    """Interpolate ``mesh [B, nx, ny, nz]`` at the stencils: ``val [B, N]``,
    or ``(val, grad [B, N, 3])`` with derivative weights ``dw`` (one pass
    for the value and the three derivative gathers).  The CUDA kernel for
    float32 CUDA tensors, on their card (rows staged in shared memory or
    read through L2, as :func:`gather_plan` decides; each output written
    once in a fixed order, so two launches give the same bits), else the
    plain version on the tensors' device."""
    _check("separable_gather", gidx, w, dw)
    if mesh.dim() != 4 or mesh.shape[0] != w.shape[0]:
        raise ValueError(f"separable_gather: mesh {tuple(mesh.shape)} must "
                         "be [B, nx, ny, nz]")
    if not launches_kernel(w):
        return separable_gather_plain(mesh, gidx, w, dw)
    check_cuda_tensors("separable_gather", mesh, w,
                       *([dw] if dw is not None else []))
    _check_index("separable_gather", gidx, w)
    b, nx, ny, nz = mesh.shape
    n, order = w.shape[1], w.shape[3]
    if order == 4 and any(t.data_ptr() % 16 for t in (gidx, w, dw)
                          if t is not None):
        raise ValueError("separable_gather: order-4 stencils must start on "
                         "16 bytes (the kernel loads whole z rows)")
    # the staged copy moves whole 16-byte units
    plan = gather_plan((nx, ny, nz), order, b, n,
                       staged=None if mesh.data_ptr() % 16 == 0 else False)
    val = torch.empty((b, n), dtype=w.dtype, device=w.device)
    grad = (torch.empty((b, n, 3), dtype=w.dtype, device=w.device)
            if dw is not None else None)
    with on_device(w):
        err = load_library().nv_separable_gather(
            mesh.data_ptr(), gidx.data_ptr(), w.data_ptr(),
            dw.data_ptr() if dw is not None else None, val.data_ptr(),
            grad.data_ptr() if grad is not None else None,
            b, n, order, nx, ny, nz, plan.lanes, plan.slices,
            current_stream(w))
    check_launch("separable_gather", err)
    launch_counts["separable_gather"] += 1
    return (val, grad) if dw is not None else val

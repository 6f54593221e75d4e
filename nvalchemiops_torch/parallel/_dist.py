# SPDX-License-Identifier: Apache-2.0
"""Collective plumbing of the multi-rank paths (port-private).

The JAX package drives every device from one process (``shard_map`` with
``ppermute``, or GSPMD annotations).  The port runs one process per rank
under ``torch.distributed``: every rank calls a function with the same
replicated inputs and gets the whole result back.  This module holds what
those functions share:

- the transport: collectives go over the mesh's process group; where the
  group's backend is gloo and the tensors lie on a CUDA device, they are
  staged through host buffers (gloo's point-to-point takes CPU tensors).
  The choice is read from ``dist.get_backend(group)`` and nothing else;
- the z ring (:func:`halo_exchange`, :func:`fold_z_ring`): ``rz`` cell rows
  sent up and ``rz`` down with ``dist.batch_isend_irecv``, the
  counterparts of ``domain.py``'s ``_halo_exchange`` and ``_fold_z_ring``;
  a ring of one is a local copy with both lattice shifts, as JAX's
  ``ppermute`` 0 -> 0 is;
- the local y/x halos (:func:`wrap_pad_yx`, :func:`fold_yx`);
- a launcher for tests and smoke runs (:func:`spawn_ranks`): one spawned
  process per rank, a ``file://`` store, a wall-clock deadline.

A slab's rank is its rank in the mesh group, so slab ``r`` holds interior
cell rows ``[r*lz, (r+1)*lz)`` of every plane.
"""

from __future__ import annotations

import multiprocessing
import os
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

__all__ = ["axis_group", "transport", "all_reduce_sum", "all_gather_cat",
           "halo_exchange", "fold_z_ring", "wrap_pad_yx", "fold_yx",
           "slab_rows", "spawn_ranks"]

#: seconds a spawned rank waits in a collective before it fails
COLLECTIVE_TIMEOUT_S = 120.0

#: this process's ring traffic: point-to-point exchanges made (each sends
#: one message up and one down) and the bytes it sent; callers reset it
ring_stats = {"exchanges": 0, "bytes": 0}


def axis_group(mesh, axis: str):
    """``(group, size, rank)`` of the mesh axis ``axis``: its process
    group, the group's size and this process's rank in it."""
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no axis {axis!r} (axes "
                         f"{mesh.mesh_dim_names})")
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), dist.get_rank(group)


def _via_host(group, t) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def transport(group, device) -> str:
    """How tensors on ``device`` travel over ``group``: ``"gloo via
    host"``, ``"gloo"`` or ``"nccl"`` (the group's backend)."""
    backend = str(dist.get_backend(group))
    if backend == "gloo" and torch.device(device).type == "cuda":
        return "gloo via host"
    return backend


def _staged(group, t):
    """``t`` as the group's backend takes it: contiguous, on the host for
    gloo with a CUDA tensor."""
    return t.detach().cpu() if _via_host(group, t) else t.contiguous()


def all_reduce_sum(t, group):
    """The sum of ``t`` over the group (a new tensor on ``t``'s device)."""
    buf = _staged(group, t).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.device)


def all_gather_cat(t, group, dim: int = 0):
    """Every rank's ``t``, concatenated along ``dim`` in group-rank order."""
    size = dist.get_world_size(group)
    if size == 1:
        return t
    src = _staged(group, t)
    bufs = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(bufs, src, group=group)
    return torch.cat(bufs, dim=dim).to(t.device)


def _ring_shift(send_up, send_down, group):
    """Send ``send_up`` to rank + 1 and ``send_down`` to rank - 1 around
    the ring; returns ``(from_below, from_above)``: what rank - 1 sent up
    and what rank + 1 sent down.  A ring of one returns copies of its own
    rows."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if size == 1:
        return send_up.clone(), send_down.clone()
    device = send_up.device
    up, down = _staged(group, send_up), _staged(group, send_down)
    ring_stats["exchanges"] += 1
    ring_stats["bytes"] += (up.numel() * up.element_size()
                            + down.numel() * down.element_size())
    from_below, from_above = torch.empty_like(up), torch.empty_like(down)
    above = dist.get_global_rank(group, (rank + 1) % size)
    below = dist.get_global_rank(group, (rank - 1) % size)
    # tag 0 travels up, tag 1 down; with two ranks both peers are one
    # process, and the NCCL order (sends up, down; receives from below,
    # from above) matches each send with its receive as well
    ops = [dist.P2POp(dist.isend, up, above, group, 0),
           dist.P2POp(dist.isend, down, below, group, 1),
           dist.P2POp(dist.irecv, from_below, below, group, 0),
           dist.P2POp(dist.irecv, from_above, above, group, 1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_below.to(device), from_above.to(device)


def _per_feature(v, like):
    """``v [F]`` shaped to broadcast over ``like [F, ..]``."""
    return v.to(like.dtype).reshape((-1,) + (1,) * (like.dim() - 1))


def halo_exchange(local, rz: int, group, z_shift=None, periodic=True,
                  park=None):
    """``local [F, lz, cy, cx, cap]`` -> ``[F, lz + 2 rz, cy, cx, cap]``
    with z halos fetched from the ring neighbours.

    ``z_shift [F]`` (the lattice shift ``cell[2, comp]`` per feature, 0
    for features that are not positions) is subtracted on rank 0's low
    halo and added on the last rank's high halo, which wrapped around the
    ring.  With ``periodic=False`` those two halos hold ``park [F]``
    instead (``DISPLACE`` for positions, 0 for features).
    """
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    lz = local.shape[1]
    halo_lo, halo_hi = _ring_shift(local[:, lz - rz:].contiguous(),
                                   local[:, :rz].contiguous(), group)
    if z_shift is not None:
        s = _per_feature(z_shift, local)
        if rank == 0:
            halo_lo = halo_lo - s
        if rank == size - 1:
            halo_hi = halo_hi + s
    if not periodic:
        p = _per_feature(park, local)
        if rank == 0:
            halo_lo = p.expand_as(halo_lo)
        if rank == size - 1:
            halo_hi = p.expand_as(halo_hi)
    return torch.cat([halo_lo, local, halo_hi], dim=1)


def wrap_pad_yx(ext, ry: int, rx: int, pbc_y: bool, pbc_x: bool, park,
                y_shift, x_shift):
    """Local y/x halos of ``ext [F, Z, cy, cx, cap]``: periodic copies with
    the lattice shift per feature (``y_shift`` / ``x_shift [F]``, 0 off the
    position features) applied to the wrapped ghosts, or ``park [F]`` on an
    open axis (``domain.py``'s ``_wrap_pad_yx``)."""
    for axis, r, periodic, shift in ((2, ry, pbc_y, y_shift),
                                     (3, rx, pbc_x, x_shift)):
        if r == 0:
            continue
        n = ext.shape[axis]
        if periodic:
            s = _per_feature(shift, ext)
            lo = ext.narrow(axis, n - r, r) - s
            hi = ext.narrow(axis, 0, r) + s
        else:
            shape = list(ext.shape)
            shape[axis] = r
            lo = hi = _per_feature(park, ext).expand(shape)
        ext = torch.cat([lo, ext, hi], dim=axis)
    return ext


def fold_yx(acc, ry: int, rx: int, cy: int, cx: int):
    """Fold the y/x halo rows of ``acc [F, Z, ey, ex, cap]`` back onto the
    interior (``domain.py``'s ``_fold_yx``)."""
    for axis, r, c in ((2, ry, cy), (3, rx, cx)):
        if r == 0:
            continue
        core = acc.narrow(axis, r, c).clone()
        core.narrow(axis, 0, r).add_(acc.narrow(axis, r + c, r))
        core.narrow(axis, c - r, r).add_(acc.narrow(axis, 0, r))
        acc = core
    return acc


def fold_z_ring(acc_ext, rz: int, group):
    """Return the j-side z-halo rows of ``acc_ext [F, lz + 2 rz, ..]`` to
    their owners over the ring and add them: ``[F, lz, ..]``."""
    z = acc_ext.shape[1]
    core = acc_ext[:, rz:z - rz].clone()
    from_below, from_above = _ring_shift(
        acc_ext[:, z - rz:].contiguous(), acc_ext[:, :rz].contiguous(), group)
    core[:, core.shape[1] - rz:] += from_above
    core[:, :rz] += from_below
    return core


def slab_rows(rank: int, size: int, cz: int) -> slice:
    """The interior cell rows of slab ``rank`` of ``size``."""
    lz = cz // size
    return slice(rank * lz, (rank + 1) * lz)


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------


def _rank_main(fn, rank, world_size, backend, init_method, threads, args,
               err_path, card=None):
    try:
        if card is not None:
            # before anything starts CUDA: this rank's card is its cuda:0
            os.environ["CUDA_VISIBLE_DEVICES"] = card
        if threads:
            torch.set_num_threads(threads)
        dist.init_process_group(
            backend, init_method=init_method, rank=rank,
            world_size=world_size,
            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        try:
            fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        # recorded for the parent's error message, then raised again
        with open(err_path.format(rank=rank), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_ranks(fn, world_size: int, backend: str, args=(),
                deadline_s: float = 600.0, threads: int = 1):
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes, each in a process group of ``backend`` initialised from a
    ``file://`` store in a temporary directory, its collectives timing out
    after ``COLLECTIVE_TIMEOUT_S``, with ``threads`` torch threads (0
    leaves the default).

    ``fn`` and ``args`` must pickle (``fn`` a module-level function of a
    module the children can import without JAX).  The children inherit
    the parent's environment.  NCCL takes one card per rank, and each rank
    launches its kernels on cuda:0: under ``"nccl"`` rank ``r`` sees the
    ``r``-th card the parent sees as its only one (``CUDA_VISIBLE_DEVICES``,
    set in the child before the process group starts), and fewer visible
    cards than ranks raise ``ValueError``.  The parent joins the children
    until ``deadline_s`` wall-clock seconds have passed, kills any still
    running and raises ``TimeoutError``; a child that raises or exits non-zero makes this
    raise ``RuntimeError`` with its traceback.
    """
    ctx = multiprocessing.get_context("spawn")
    cards = [None] * world_size
    if backend == "nccl":
        seen = os.environ.get("CUDA_VISIBLE_DEVICES")
        ids = ([c.strip() for c in seen.split(",") if c.strip()]
               if seen is not None else
               [str(i) for i in range(torch.cuda.device_count())])
        if len(ids) < world_size:
            raise ValueError(f"spawn_ranks: {world_size} ranks, one card "
                             f"each, but {len(ids)} cards are visible")
        cards = ids[:world_size]
    with tempfile.TemporaryDirectory(prefix="nvalchemiops_ranks_") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        err_path = os.path.join(tmp, "rank{rank}.err")
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            fn, rank, world_size, backend, init_method, threads,
            tuple(args), err_path, cards[rank]))
            for rank in range(world_size)]
        for p in procs:
            p.start()
        end = time.monotonic() + deadline_s
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
        late = [i for i, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if late:
            raise TimeoutError(f"spawn_ranks: ranks {late} still running "
                               f"after {deadline_s} s; killed")
        failed = []
        for rank, p in enumerate(procs):
            if p.exitcode != 0:
                tb = ""
                if os.path.exists(err_path.format(rank=rank)):
                    with open(err_path.format(rank=rank)) as f:
                        tb = f.read()
                failed.append(f"rank {rank} exit {p.exitcode}\n{tb}")
        if failed:
            raise RuntimeError("spawn_ranks: " + "\n".join(failed))

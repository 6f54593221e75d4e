# SPDX-License-Identifier: Apache-2.0
"""Per-row half-space pair sweep with zm-wide D3 features (csrc/row_sweep.cu).

Counterpart of ``nvalchemiops_tpu/pallas/row_sweep.py:row_sweep``, the
substrate of ``grid_dftd3(engine="pallas")``.  The pairs are kernel 1's
pair-once enumeration (kernels/window_sweep.py), organised by own row: one
CUDA block per own (z, y) row and row offset (the home row and every
half-space (dz, dy), in one launch).  Bodies and features:

=============  ================================================  ====  ====
body           own / candidate features                          own   j
=============  ================================================  ====  ====
``cn``         px py pz rcov                                     1     1
``d3_direct``  px py pz si w, + own ``lf [.., cap, 2 zm]`` and   5     4
               candidate rows ``cf [ez, ey, ex, cap, 2 zm]``
``chain``      px py pz rcov decn                                3     3
=============  ================================================  ====  ====

The D3 direct body takes the JAX engine's inputs: the own left rows ``lf =
[l0 | l1c]`` and the candidates' zm-wide rows ``cf = [rf | rfdc]`` with
``rf[(z, q)] = [z_j == z] e_j[q]``, so each pair contracts three dots of
length ``zm = zmax1 * mesh`` (kernel 1 contracts three of length mesh).
Outputs as kernel 1's: ``(own_out [n_out, cz, cy, cx, cap], j_out [n_j, ez,
ey, ex, cap])``, the caller folds ``j_out`` with ``grid.fold_halo``.

A block stages its own row and the whole extended candidate row once, or,
where that exceeds a block's shared memory, groups of G consecutive own
x-cells with their merged window (:func:`row_group_cells`), or, where one
own cell and its window exceed it, slices of the cell's own slots (over
blocks) and of its window (one after another; :func:`row_slices`).  On a
batched grid every array takes a leading system axis and one launch
sweeps the B systems.  It tests each
own slot's distance to the 2*rx + 1 x-cells around its cell first and runs
the body only on the pairs inside the cutoff; parked own slots (empty slots
and padding atoms, ``|px| >= DISPLACE / 2``) are skipped where
:func:`skips_parked` shows that none of them meets a candidate in reach.
"""

from __future__ import annotations

import torch

from nvalchemiops_torch.grid import DISPLACE
from nvalchemiops_torch.kernels import launch_counts
from nvalchemiops_torch.kernels.build import (
    check_cuda_tensors, check_launch, current_stream, launches_kernel,
    load_library, on_device,
)
from nvalchemiops_torch.kernels.window_sweep import (
    BODY_FNS, QUEUE, SMEM_BYTES, SweepParams, cell_windows_plain,
    chunk_slot_pairs, per_system, stage_slices, wide_batched,
)
from nvalchemiops_torch.trace import count

__all__ = ["BODIES", "row_group_cells", "row_slices", "row_smem_bytes",
           "row_sweep", "row_sweep_plain", "skips_parked"]

#: body name -> (C body id, n_own (= n_cand), n_out, n_j)
BODIES = {
    "cn": (0, 4, 1, 1),
    "d3_direct": (1, 5, 5, 4),
    "chain": (2, 5, 3, 3),
}

#: the kernel's warps a block, by body (csrc/row_sweep.cu: kRowWarps)
WARPS = {"cn": 16, "d3_direct": 32, "chain": 16}


def row_smem_bytes(body: str, g: int, cx: int, cap: int, rx: int, nf: int,
                   own_slots: int | None = None,
                   cand_slots: int | None = None) -> int:
    """Shared memory of one block (csrc/row_sweep.cu:row_smem_bytes): the
    j sums, ``own_slots`` staged own slots of a group of ``g`` cells (its
    ``g * cap``: the whole group) and ``cand_slots`` candidates of its
    merged window (``(g + 2 rx) * cap``: the whole window), the own sums
    and the warps' queues.  The j sums cover the extended row where the
    whole group and window are staged, else one candidate slice."""
    _, n_feat, n_out, n_j = BODIES[body]
    m = g * cap if own_slots is None else own_slots
    w = (g + 2 * rx) * cap if cand_slots is None else cand_slots
    whole = m == g * cap and w == (g + 2 * rx) * cap
    fs = (nf | 1) if nf else 0
    return 4 * (n_j * ((cx + 2 * rx) * cap if whole else w)
                + (n_feat + fs) * (m + w) + n_out * m + WARPS[body] * QUEUE)


def row_group_cells(body: str, cx: int, cap: int, rx: int,
                    nf: int = 0) -> int:
    """G, the own x-cells a block stages at once: the whole row (cx) where
    it fits a block's shared memory, else as few equal groups as fit, else
    1 (where one own cell and its window do not fit: :func:`row_slices`
    then stages them in slices)."""
    fit = [g for g in range(1, cx + 1)
           if row_smem_bytes(body, g, cx, cap, rx, nf) <= SMEM_BYTES]
    if not fit:
        return 1
    n_groups = -(-cx // fit[-1])
    return -(-cx // n_groups)


def row_slices(body: str, g: int, cx: int, cap: int, rx: int,
               nf: int = 0) -> tuple[int, int]:
    """``(own slots, candidates)`` a block stages at once for groups of
    ``g`` cells: the whole group and its window where they fit, else slices
    of both (:func:`window_sweep.stage_slices`), the j sums then flushed a
    candidate slice at a time."""
    m, w = g * cap, (g + 2 * rx) * cap
    if row_smem_bytes(body, g, cx, cap, rx, nf) <= SMEM_BYTES:
        return m, w
    _, n_feat, n_out, n_j = BODIES[body]
    fs = (nf | 1) if nf else 0
    return stage_slices(4 * (n_feat + fs + n_out), 4 * (n_feat + fs + n_j),
                        SMEM_BYTES - 4 * WARPS[body] * QUEUE, m, w)


def skips_parked(dims, radius) -> bool:
    """Whether the kernel may skip parked own slots untested: a parked
    slot's only candidates within reach are its own periodic images (or
    the halo fill beside it), which lie one box length away along an axis;
    no window holds them when every axis has more cells than its radius."""
    return all(c > r for c, r in zip(dims, radius))


def row_sweep(body: str, radius, own, cand, params: SweepParams, lf=None,
              cf=None, plan=None):
    """Run one pass body over the grid by own rows: the CUDA kernel for
    float32 CUDA tensors (on their card), else the plain version
    (:func:`row_sweep_plain`) on the tensors' device.

    One grid's planes or a batched grid's, with a leading system axis
    (``own [B, n_own, ..]``, ``cand``, ``lf``, ``cf``): the B systems then
    run in one launch and the outputs carry the axis too.  ``plan``
    replaces :func:`row_slices`'s ``(own slots, candidates)``."""
    own_b, cand_b, lf_b, cf_b, single = wide_batched(
        "row_sweep", BODIES, body, radius, own, cand, lf, cf)
    if not launches_kernel(own_b):
        return row_sweep_plain(body, radius, own, cand, params, lf, cf)
    wide = body == "d3_direct"
    check_cuda_tensors("row_sweep", own_b, cand_b,
                       *((lf_b, cf_b) if wide else ()))
    body_id, _, n_out, n_j = BODIES[body]
    n_sys, _, cz, cy, cx, cap = own_b.shape
    rz, ry, rx = radius
    nf = lf_b.shape[-1] if wide else 0
    g_cells = row_group_cells(body, cx, cap, rx, nf)
    m_s, w_s = plan or row_slices(body, g_cells, cx, cap, rx, nf)
    parked = (DISPLACE / 2 if skips_parked((cz, cy, cx), radius)
              else float("inf"))
    own_out = torch.zeros((n_sys, n_out, cz, cy, cx, cap), dtype=own.dtype,
                          device=own.device)
    j_out = torch.zeros((n_sys, n_j) + tuple(cand_b.shape[2:]),
                        dtype=own.dtype, device=own.device)
    p = params
    with on_device(own_b):
        err = load_library().nv_row_sweep(
            body_id, own_b.data_ptr(), cand_b.data_ptr(),
            lf_b.data_ptr() if wide else None,
            cf_b.data_ptr() if wide else None, own_out.data_ptr(),
            j_out.data_ptr(), cz, cy, cx, rz, ry, rx, cap, g_cells, nf,
            n_sys, m_s, w_s, p.cutoff * p.cutoff, p.a1, p.a2, p.s6, p.s8,
            p.k1, p.k3, parked, current_stream(own_b))
    check_launch(f"row_sweep[{body}]", err)
    launch_counts[f"row_sweep_{body}"] += 1
    count(f"slot_pairs.row_sweep_{body}",
          chunk_slot_pairs(radius, cap, n_sys * cz * cy * cx))
    return (own_out[0], j_out[0]) if single else (own_out, j_out)


def row_sweep_plain(body: str, radius, own, cand, params: SweepParams,
                    lf=None, cf=None):
    """Plain PyTorch version of :func:`row_sweep` (any device/dtype): the
    same pair-once enumeration with the zm-wide contractions as matmuls; a
    batched grid's planes run as the loop over its systems."""
    _, _, n_out, n_j = BODIES[body]
    return per_system(lambda o, c, l, f: cell_windows_plain(
        BODY_FNS[body], radius, o, c, params, n_out, n_j, lf=l, cf=f),
        *wide_batched("row_sweep", BODIES, body, radius, own, cand, lf, cf))

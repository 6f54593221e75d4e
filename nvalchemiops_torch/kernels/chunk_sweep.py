# SPDX-License-Identifier: Apache-2.0
"""Super-chunk half-space pair sweep (csrc/chunk_sweep.cu).

Counterpart of ``nvalchemiops_tpu/pallas/block_sweep.py:block_sweep``, the
substrate of ``grid_dftd3(engine="block")``, ``grid_dftd3_coulomb`` and
``grid_coulomb_energy_forces(engine="block")``.  G consecutive own x-cells
of one row (M = G*cap own slots) meet one merged candidate window of W =
(G + 2*rx)*cap slots per row offset; the home offset keeps pairs whose flat
candidate index exceeds the own index plus rx*cap (each pair once).  Pairs
further than rx cells apart in x lie beyond the cutoff and fail the
distance test, so the result is kernel 1's up to summation order.  One CUDA
block per (own row, offset, chunk); a warp tests one own slot against the
2*rx + 1 x-cells around it and runs the body only on the pairs inside the
body's reach (distance first, as kernel 1).  Bodies and features:

=====================  =======================================  ====  ====
body                   own / candidate features                 own   j
=====================  =======================================  ====  ====
``cn``                 px py pz rcov                            1     1
``d3_direct``          px py pz si w, + ``lf`` / ``cf`` rows    5     4
``d3_direct_coulomb``  px py pz si w q, + ``lf`` / ``cf`` rows  9     8
``chain``              px py pz rcov decn                       3     3
``coulomb``            px py pz q                               4     4
=====================  =======================================  ====  ====

``lf [cz, cy, cx, cap, 2 zm]`` are the own left rows ``[l0 | l1c]``, ``cf
[ez, ey, ex, cap, 2 zm]`` the candidates' zm-wide rows ``[rf | rfdc]``, as
the JAX engine takes them.  G must divide cx; :func:`super_chunk_cells`
picks one for the card's shared memory, and where one own cell and its
window do not fit, a block stages slices of them (:func:`chunk_slices`).
On a batched grid every array takes a leading system axis and one launch
sweeps the B systems.
"""

from __future__ import annotations

import torch

from nvalchemiops_torch.kernels import launch_counts
from nvalchemiops_torch.kernels.build import (
    check_cuda_tensors, check_launch, current_stream, launches_kernel,
    load_library, on_device,
)
from nvalchemiops_torch.kernels.window_sweep import (
    BODY_FNS, QUEUE, SMEM_BYTES, SweepParams, chunk_slot_pairs,
    halfspace_zy, per_system, stage_slices, wide_batched,
)
from nvalchemiops_torch.trace import count

__all__ = ["BODIES", "chunk_slices", "chunk_sweep", "chunk_sweep_plain",
           "super_chunk_cells"]

#: body name -> (C body id, n_own (= n_cand), n_out, n_j)
BODIES = {
    "cn": (0, 4, 1, 1),
    "d3_direct": (1, 5, 5, 4),
    "chain": (2, 5, 3, 3),
    "coulomb": (3, 4, 4, 4),
    "d3_direct_coulomb": (4, 6, 9, 8),
}

#: the kernel's warps a block (csrc/pair_bodies.cuh: kWideWarps)
WARPS = 8


def chunk_smem_bytes(body: str, g: int, cap: int, rx: int, nf: int,
                     own_slots: int | None = None,
                     cand_slots: int | None = None) -> int:
    """Shared memory of one block (csrc/chunk_sweep.cu:chunk_smem_bytes):
    ``own_slots`` staged own slots of a chunk of ``g`` cells (its ``g *
    cap``: the whole chunk) and ``cand_slots`` candidates of its window
    (``(g + 2 rx) * cap``: the whole window), their sums and the warps'
    queues."""
    _, n_feat, n_out, n_j = BODIES[body]
    m = g * cap if own_slots is None else own_slots
    w = (g + 2 * rx) * cap if cand_slots is None else cand_slots
    fs = (nf | 1) if nf else 0
    return 4 * ((n_feat + fs + n_out) * m + (n_feat + fs + n_j) * w
                + WARPS * QUEUE)


def super_chunk_cells(body: str, cx: int, cap: int, rx: int,
                      nf: int = 0) -> int:
    """G for the card: a divisor of cx whose chunk fits one block's shared
    memory, with M = G*cap closest to 128 own rows (ties: the smaller),
    so a block's 8 warps get 16 rows each with few idle lanes left over;
    1 where one own cell and its window do not fit (:func:`chunk_slices`
    then stages them in slices)."""
    best = None
    for g in range(1, cx + 1):
        if cx % g or chunk_smem_bytes(body, g, cap, rx, nf) > SMEM_BYTES:
            continue
        key = (abs(g * cap - 128), g)
        if best is None or key < best[0]:
            best = (key, g)
    return 1 if best is None else best[1]


def chunk_slices(body: str, g: int, cap: int, rx: int,
                 nf: int = 0) -> tuple[int, int]:
    """``(own slots, candidates)`` a block stages at once for chunks of
    ``g`` cells: the whole chunk and window where they fit, else slices of
    both (:func:`window_sweep.stage_slices`): the chunk's own slots over
    blocks, its window one slice after another."""
    m, w = g * cap, (g + 2 * rx) * cap
    if chunk_smem_bytes(body, g, cap, rx, nf) <= SMEM_BYTES:
        return m, w
    _, n_feat, n_out, n_j = BODIES[body]
    fs = (nf | 1) if nf else 0
    return stage_slices(4 * (n_feat + fs + n_out), 4 * (n_feat + fs + n_j),
                        SMEM_BYTES - 4 * WARPS * QUEUE, m, w)


def chunk_sweep(body: str, radius, own, cand, params: SweepParams, g_cells,
                lf=None, cf=None, plan=None):
    """Run one pass body over the grid by super-chunks of ``g_cells`` cells:
    the CUDA kernel for float32 CUDA tensors (on their card), else the
    plain version (:func:`chunk_sweep_plain`) on the tensors' device.

    One grid's planes or a batched grid's, with a leading system axis
    (``own [B, n_own, ..]``, ``cand``, ``lf``, ``cf``): the B systems then
    run in one launch and the outputs carry the axis too.  ``plan``
    replaces :func:`chunk_slices`'s ``(own slots, candidates)``."""
    own_b, cand_b, lf_b, cf_b, single = wide_batched(
        "chunk_sweep", BODIES, body, radius, own, cand, lf, cf)
    cx = own_b.shape[4]
    if g_cells < 1 or cx % g_cells:
        raise ValueError(f"G={g_cells} must divide cx={cx}")
    if not launches_kernel(own_b):
        return chunk_sweep_plain(body, radius, own, cand, params, g_cells, lf,
                                 cf)
    wide = body.startswith("d3_direct")
    check_cuda_tensors("chunk_sweep", own_b, cand_b,
                       *((lf_b, cf_b) if wide else ()))
    body_id, _, n_out, n_j = BODIES[body]
    n_sys, _, cz, cy, cx, cap = own_b.shape
    rz, ry, rx = radius
    nf = lf_b.shape[-1] if wide else 0
    m_s, w_s = plan or chunk_slices(body, g_cells, cap, rx, nf)
    own_out = torch.zeros((n_sys, n_out, cz, cy, cx, cap), dtype=own.dtype,
                          device=own.device)
    j_out = torch.zeros((n_sys, n_j) + tuple(cand_b.shape[2:]),
                        dtype=own.dtype, device=own.device)
    p = params
    with on_device(own_b):
        err = load_library().nv_chunk_sweep(
            body_id, own_b.data_ptr(), cand_b.data_ptr(),
            lf_b.data_ptr() if wide else None,
            cf_b.data_ptr() if wide else None, own_out.data_ptr(),
            j_out.data_ptr(), cz, cy, cx, rz, ry, rx, cap, g_cells, nf,
            n_sys, m_s, w_s, p.cutoff * p.cutoff, p.a1, p.a2, p.s6, p.s8,
            p.k1, p.k3, p.alpha, p.ccutoff * p.ccutoff, current_stream(own_b))
    check_launch(f"chunk_sweep[{body}]", err)
    launch_counts[f"chunk_sweep_{body}"] += 1
    count(f"slot_pairs.chunk_sweep_{body}",
          chunk_slot_pairs(radius, cap, n_sys * cz * cy * cx))
    return (own_out[0], j_out[0]) if single else (own_out, j_out)


def chunk_sweep_plain(body: str, radius, own, cand, params: SweepParams,
                      g_cells, lf=None, cf=None):
    """Plain PyTorch version of :func:`chunk_sweep` (any device/dtype): the
    same super-chunk enumeration, materializing each offset's ``[cz, cy,
    cx/G, M, W]`` pair blocks; a batched grid's planes run as the loop over
    its systems."""
    return per_system(lambda o, c, l, f: _chunk_plain(
        body, radius, o, c, params, g_cells, l, f),
        *wide_batched("chunk_sweep", BODIES, body, radius, own, cand, lf, cf))


def _chunk_plain(body, radius, own, cand, params, g_cells, lf, cf):
    """:func:`chunk_sweep_plain` on one grid's planes."""
    _, n_own, n_out, n_j = BODIES[body]
    _, cz, cy, cx, cap = own.shape
    rz, ry, rx = radius
    ez, ey, ex = cand.shape[1:4]
    g = int(g_cells)
    nch, m, w = cx // g, g * cap, (g + 2 * rx) * cap
    fn = BODY_FNS[body]
    o = own.reshape(n_own, cz, cy, nch, m)[..., None]      # [.., M, 1]
    lf_c = None if lf is None else lf.reshape(cz, cy, nch, m, lf.shape[-1])
    own_out = torch.zeros((n_out, cz, cy, nch, m), dtype=own.dtype,
                          device=own.device)
    j_out = torch.zeros((n_j, ez, ey, ex * cap), dtype=own.dtype,
                        device=own.device)
    row = torch.arange(m, device=own.device)[:, None]
    col = torch.arange(w, device=own.device)
    tri = col > row + rx * cap
    for dz, dy, home in [(0, 0, True)] + [(dz, dy, False) for dz, dy
                                          in halfspace_zy(rz, ry)]:
        z0, y0 = rz + dz, ry + dy
        rows = cand[:, z0:z0 + cz, y0:y0 + cy].reshape(-1, cz, cy, ex * cap)
        win = rows.unfold(-1, w, m)                        # [.., nch, W]
        cf_win = None
        if cf is not None:
            frows = cf[z0:z0 + cz, y0:y0 + cy].reshape(cz, cy, ex * cap, -1)
            cf_win = frows.unfold(-2, w, m).transpose(-1, -2)
        own_blocks, j_blocks = fn(o, win[..., None, :], params,
                                  tri if home else None, lf_c, cf_win)
        for k, blk in enumerate(own_blocks):
            own_out[k] += blk.sum(dim=-1)
        for k, blk in enumerate(j_blocks):
            d = blk.sum(dim=-2)                            # [cz, cy, nch, W]
            for c in range(nch):
                j_out[k, z0:z0 + cz, y0:y0 + cy, c * m:c * m + w] += d[..., c,
                                                                       :]
    return (own_out.reshape(n_out, cz, cy, cx, cap),
            j_out.reshape(n_j, ez, ey, ex, cap))

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
x-cells with their merged window (:func:`row_group_cells`).  It tests each
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
    check_cuda_tensors, check_launch, current_stream, load_library,
)
from nvalchemiops_torch.kernels.window_sweep import (
    BODY_FNS, SweepParams, cell_windows_plain, check_wide,
)

__all__ = ["BODIES", "row_group_cells", "row_smem_bytes", "row_sweep",
           "row_sweep_plain", "skips_parked"]

#: body name -> (C body id, n_own (= n_cand), n_out, n_j)
BODIES = {
    "cn": (0, 4, 1, 1),
    "d3_direct": (1, 5, 5, 4),
    "chain": (2, 5, 3, 3),
}

#: shared memory one block may use on the H100 (227 KB)
SMEM_BYTES = 232448
#: the kernel's warps a block, by body (csrc/row_sweep.cu: kRowWarps), and
#: the ints of each warp's pair queue (csrc/pair_bodies.cuh: kQueue)
WARPS = {"cn": 16, "d3_direct": 32, "chain": 16}
QUEUE = 64


def row_smem_bytes(body: str, g: int, cx: int, cap: int, rx: int,
                   nf: int) -> int:
    """Shared memory of one block (csrc/row_sweep.cu:row_smem_bytes): the
    j sums of the extended row, a staged group of ``g`` own cells and its
    merged window, the group's own sums and the warps' queues."""
    _, n_feat, n_out, n_j = BODIES[body]
    m, w = g * cap, (g + 2 * rx) * cap
    fs = (nf | 1) if nf else 0
    return 4 * (n_j * (cx + 2 * rx) * cap + (n_feat + fs) * (m + w)
                + n_out * m + WARPS[body] * QUEUE)


def row_group_cells(body: str, cx: int, cap: int, rx: int,
                    nf: int = 0) -> int:
    """G, the own x-cells a block stages at once: the whole row (cx) where
    it fits a block's shared memory, else as few equal groups as fit.
    Raises ``ValueError`` where one own cell and its window do not fit."""
    fit = [g for g in range(1, cx + 1)
           if row_smem_bytes(body, g, cx, cap, rx, nf) <= SMEM_BYTES]
    if not fit:
        raise ValueError(f"row_sweep[{body}]: one x-cell (cap {cap}, rx "
                         f"{rx}, {nf} feature columns) exceeds a block's "
                         "shared memory")
    n_groups = -(-cx // fit[-1])
    return -(-cx // n_groups)


def skips_parked(dims, radius) -> bool:
    """Whether the kernel may skip parked own slots untested: a parked
    slot's only candidates within reach are its own periodic images (or
    the halo fill beside it), which lie one box length away along an axis;
    no window holds them when every axis has more cells than its radius."""
    return all(c > r for c, r in zip(dims, radius))


def row_sweep(body: str, radius, own, cand, params: SweepParams, lf=None,
              cf=None):
    """Run one pass body over the grid by own rows: CUDA kernel on a CUDA
    device, the plain version (:func:`row_sweep_plain`) on the CPU."""
    check_wide("row_sweep", BODIES, body, radius, own, cand, lf, cf)
    if own.device.type == "cpu":
        return row_sweep_plain(body, radius, own, cand, params, lf, cf)
    wide = body == "d3_direct"
    check_cuda_tensors("row_sweep", own, cand, *((lf, cf) if wide else ()))
    body_id, _, n_out, n_j = BODIES[body]
    _, cz, cy, cx, cap = own.shape
    rz, ry, rx = radius
    nf = lf.shape[-1] if wide else 0
    g_cells = row_group_cells(body, cx, cap, rx, nf)
    parked = (DISPLACE / 2 if skips_parked((cz, cy, cx), radius)
              else float("inf"))
    own_out = torch.zeros((n_out, cz, cy, cx, cap), dtype=own.dtype,
                          device=own.device)
    j_out = torch.zeros((n_j,) + tuple(cand.shape[1:]), dtype=own.dtype,
                        device=own.device)
    p = params
    err = load_library().nv_row_sweep(
        body_id, own.data_ptr(), cand.data_ptr(),
        lf.data_ptr() if wide else None, cf.data_ptr() if wide else None,
        own_out.data_ptr(), j_out.data_ptr(), cz, cy, cx, rz, ry, rx, cap,
        g_cells, nf, p.cutoff * p.cutoff, p.a1, p.a2, p.s6, p.s8, p.k1, p.k3,
        parked, current_stream(own))
    check_launch(f"row_sweep[{body}]", err)
    launch_counts[f"row_sweep_{body}"] += 1
    return own_out, j_out


def row_sweep_plain(body: str, radius, own, cand, params: SweepParams,
                    lf=None, cf=None):
    """Plain PyTorch version of :func:`row_sweep` (any device/dtype): the
    same pair-once enumeration with the zm-wide contractions as matmuls."""
    check_wide("row_sweep", BODIES, body, radius, own, cand, lf, cf)
    _, _, n_out, n_j = BODIES[body]
    return cell_windows_plain(BODY_FNS[body], radius, own, cand, params,
                              n_out, n_j, lf=lf, cf=cf)

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
picks one for the card's shared memory.
"""

from __future__ import annotations

import torch

from nvalchemiops_torch.kernels import launch_counts
from nvalchemiops_torch.kernels.build import (
    check_cuda_tensors, check_launch, current_stream, load_library,
)
from nvalchemiops_torch.kernels.window_sweep import (
    BODY_FNS, SweepParams, check_wide, halfspace_zy,
)

__all__ = ["BODIES", "chunk_sweep", "chunk_sweep_plain", "super_chunk_cells"]

#: body name -> (C body id, n_own (= n_cand), n_out, n_j)
BODIES = {
    "cn": (0, 4, 1, 1),
    "d3_direct": (1, 5, 5, 4),
    "chain": (2, 5, 3, 3),
    "coulomb": (3, 4, 4, 4),
    "d3_direct_coulomb": (4, 6, 9, 8),
}

#: shared memory one block may use on the H100 (227 KB)
SMEM_BYTES = 232448
#: the kernel's warps a block and the ints of each warp's pair queue
#: (csrc/pair_bodies.cuh: kWideWarps, kQueue)
WARPS, QUEUE = 8, 64


def chunk_smem_bytes(body: str, g: int, cap: int, rx: int, nf: int) -> int:
    """Shared memory of one block (csrc/chunk_sweep.cu:chunk_smem_bytes):
    the staged chunk, the own and j sums and the warps' queues."""
    _, n_feat, n_out, n_j = BODIES[body]
    m, w = g * cap, (g + 2 * rx) * cap
    fs = (nf | 1) if nf else 0
    return 4 * (n_feat * m + m * fs + n_feat * w + w * fs + n_out * m
                + n_j * w + WARPS * QUEUE)


def super_chunk_cells(body: str, cx: int, cap: int, rx: int,
                      nf: int = 0) -> int:
    """G for the card: a divisor of cx whose chunk fits one block's shared
    memory, with M = G*cap closest to 128 own rows (ties: the smaller),
    so a block's 8 warps get 16 rows each with few idle lanes left over."""
    best = None
    for g in range(1, cx + 1):
        if cx % g or chunk_smem_bytes(body, g, cap, rx, nf) > SMEM_BYTES:
            continue
        key = (abs(g * cap - 128), g)
        if best is None or key < best[0]:
            best = (key, g)
    if best is None:
        raise ValueError(f"chunk_sweep[{body}]: one x-cell (cap {cap}, rx "
                         f"{rx}, {nf} feature columns) exceeds a block's "
                         "shared memory")
    return best[1]


def chunk_sweep(body: str, radius, own, cand, params: SweepParams, g_cells,
                lf=None, cf=None):
    """Run one pass body over the grid by super-chunks of ``g_cells`` cells:
    CUDA kernel on a CUDA device, the plain version
    (:func:`chunk_sweep_plain`) on the CPU."""
    check_wide("chunk_sweep", BODIES, body, radius, own, cand, lf, cf)
    cx = own.shape[3]
    if g_cells < 1 or cx % g_cells:
        raise ValueError(f"G={g_cells} must divide cx={cx}")
    if own.device.type == "cpu":
        return chunk_sweep_plain(body, radius, own, cand, params, g_cells, lf,
                                 cf)
    wide = body.startswith("d3_direct")
    check_cuda_tensors("chunk_sweep", own, cand, *((lf, cf) if wide else ()))
    body_id, _, n_out, n_j = BODIES[body]
    _, cz, cy, cx, cap = own.shape
    rz, ry, rx = radius
    nf = lf.shape[-1] if wide else 0
    if chunk_smem_bytes(body, g_cells, cap, rx, nf) > SMEM_BYTES:
        raise ValueError(f"chunk_sweep[{body}]: G={g_cells} exceeds a "
                         "block's shared memory (see super_chunk_cells)")
    own_out = torch.zeros((n_out, cz, cy, cx, cap), dtype=own.dtype,
                          device=own.device)
    j_out = torch.zeros((n_j,) + tuple(cand.shape[1:]), dtype=own.dtype,
                        device=own.device)
    p = params
    err = load_library().nv_chunk_sweep(
        body_id, own.data_ptr(), cand.data_ptr(),
        lf.data_ptr() if wide else None, cf.data_ptr() if wide else None,
        own_out.data_ptr(), j_out.data_ptr(), cz, cy, cx, rz, ry, rx, cap,
        g_cells, nf, p.cutoff * p.cutoff, p.a1, p.a2, p.s6, p.s8, p.k1, p.k3,
        p.alpha, p.ccutoff * p.ccutoff, current_stream(own))
    check_launch(f"chunk_sweep[{body}]", err)
    launch_counts[f"chunk_sweep_{body}"] += 1
    return own_out, j_out


def chunk_sweep_plain(body: str, radius, own, cand, params: SweepParams,
                      g_cells, lf=None, cf=None):
    """Plain PyTorch version of :func:`chunk_sweep` (any device/dtype): the
    same super-chunk enumeration, materializing each offset's ``[cz, cy,
    cx/G, M, W]`` pair blocks."""
    check_wide("chunk_sweep", BODIES, body, radius, own, cand, lf, cf)
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

# SPDX-License-Identifier: Apache-2.0
"""Per-row half-space pair sweep with zm-wide D3 features (csrc/row_sweep.cu).

Counterpart of ``nvalchemiops_tpu/pallas/row_sweep.py:row_sweep``, the
substrate of ``grid_dftd3(engine="pallas")``.  The pairs are kernel 1's
pair-once enumeration (kernels/window_sweep.py), organised by own row: one
CUDA block per own (z, y) row and row offset (the home row and every
half-space (dz, dy), in one launch), looping over the row's x-cells.
Bodies and features:

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
"""

from __future__ import annotations

import torch

from nvalchemiops_torch.kernels import launch_counts
from nvalchemiops_torch.kernels.build import (
    check_cuda_tensors, check_launch, current_stream, load_library,
)
from nvalchemiops_torch.kernels.window_sweep import (
    BODY_FNS, SweepParams, cell_windows_plain, check_wide,
)

__all__ = ["BODIES", "row_sweep", "row_sweep_plain"]

#: body name -> (C body id, n_own (= n_cand), n_out, n_j)
BODIES = {
    "cn": (0, 4, 1, 1),
    "d3_direct": (1, 5, 5, 4),
    "chain": (2, 5, 3, 3),
}


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
    own_out = torch.zeros((n_out, cz, cy, cx, cap), dtype=own.dtype,
                          device=own.device)
    j_out = torch.zeros((n_j,) + tuple(cand.shape[1:]), dtype=own.dtype,
                        device=own.device)
    p = params
    err = load_library().nv_row_sweep(
        body_id, own.data_ptr(), cand.data_ptr(),
        lf.data_ptr() if wide else None, cf.data_ptr() if wide else None,
        own_out.data_ptr(), j_out.data_ptr(), cz, cy, cx, rz, ry, rx, cap,
        lf.shape[-1] if wide else 0, p.cutoff * p.cutoff, p.a1, p.a2, p.s6,
        p.s8, p.k1, p.k3, current_stream(own))
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

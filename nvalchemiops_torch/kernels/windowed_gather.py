# SPDX-License-Identifier: Apache-2.0
"""Per-tile windowed B-spline spread and gather (csrc/windowed_gather.cu).

Counterparts of ``nvalchemiops_tpu/pallas/windowed_gather.py``:

- :func:`spread_windows` (``_spread_windows``): per-tile spread windows
  ``[t, W, W*W]`` with ``window[t, z, y*W + x] = sum_c q[t, c] Sz[t, c, z]
  Sy[t, c, y] Sx[t, c, x]``; the caller folds them onto the mesh.
- :func:`gather_grad_planes` (``_gather_grad_planes``): for each tile,
  contract every slot's (Sx, Sy, Sz, dSx, dSy, dSz) rows against the tile's
  potential window ``[W, W*W]`` -> four ``[t, cap]`` planes (value and the
  three fractional-gradient components).

``smat [t, cap, k*W]`` holds the axis matrices side by side (blocks Sx, Sy,
Sz[, dSx, dSy, dSz]), as ``spline_windowed.MeshTiles`` stores them.
"""

from __future__ import annotations

import torch

from nvalchemiops_torch.kernels import launch_counts
from nvalchemiops_torch.kernels.build import (
    check_cuda_tensors, check_launch, current_stream, load_library,
)

__all__ = [
    "spread_windows", "spread_windows_plain",
    "gather_grad_planes", "gather_grad_planes_plain",
]

_KERNEL_W = (8, 12, 20)   # window widths the CUDA kernels are built for


def _cuda_checks(name, w_win, *tensors):
    check_cuda_tensors(name, *tensors)
    if w_win not in _KERNEL_W:
        raise ValueError(f"{name}: CUDA kernel built for window widths "
                         f"{_KERNEL_W} (tiles 4, 8, 16), got {w_win}")


def _axis(smat, idx, w):
    return smat[..., idx * w:(idx + 1) * w]


def spread_windows_plain(smat, q_t, w_win: int):
    """Plain PyTorch version of :func:`spread_windows`."""
    qsz = q_t[..., None] * _axis(smat, 2, w_win)                  # [t, c, W]
    sy = _axis(smat, 1, w_win)
    sx = _axis(smat, 0, w_win)
    tyx = (sy[..., :, None] * sx[..., None, :]).flatten(-2)       # [t, c, W*W]
    return torch.einsum("tcz,tcm->tzm", qsz, tyx)


def spread_windows(smat, q_t, w_win: int):
    """Per-tile spread windows ``[t, W, W*W]`` from ``smat`` and slot
    charges ``q_t [t, cap]``: CUDA kernel on a CUDA device, plain version
    on the CPU."""
    t, cap, kw = smat.shape
    if kw % w_win or kw // w_win < 3 or tuple(q_t.shape) != (t, cap):
        raise ValueError(f"spread_windows: smat {tuple(smat.shape)} / q_t "
                         f"{tuple(q_t.shape)} do not match W={w_win}")
    if smat.device.type == "cpu":
        return spread_windows_plain(smat, q_t, w_win)
    _cuda_checks("spread_windows", w_win, smat, q_t)
    out = torch.empty((t, w_win, w_win * w_win), dtype=smat.dtype,
                      device=smat.device)
    err = load_library().nv_windowed_spread(
        smat.data_ptr(), q_t.data_ptr(), out.data_ptr(), t, cap, kw, w_win,
        current_stream(smat))
    check_launch("spread_windows", err)
    launch_counts["windowed_spread"] += 1
    return out


def gather_grad_planes_plain(smat, win, w_win: int):
    """Plain PyTorch version of :func:`gather_grad_planes` (the m-first
    contraction of ``spline_windowed.windowed_gather``)."""
    sx, sy, sz, sdx, sdy, sdz = (_axis(smat, k, w_win) for k in range(6))

    def tyx(a, b):
        return (a[..., :, None] * b[..., None, :]).flatten(-2)   # [t, c, W*W]

    def q_of(prod):
        return torch.einsum("tcm,tzm->tcz", prod, win)

    ys_xs = tyx(sy, sx)
    q = q_of(ys_xs)
    qx = q_of(tyx(sy, sdx))
    qy = q_of(tyx(sdy, sx))
    return ((q * sz).sum(-1), (qx * sz).sum(-1), (qy * sz).sum(-1),
            (q * sdz).sum(-1))


def gather_grad_planes(smat, win, w_win: int):
    """``(val, gx, gy, gz)`` planes ``[t, cap]`` from ``smat [t, cap, 6W]``
    and potential windows ``win [t, W, W*W]``: CUDA kernel on a CUDA
    device, plain version on the CPU."""
    t, cap, kw = smat.shape
    if kw != 6 * w_win or tuple(win.shape) != (t, w_win, w_win * w_win):
        raise ValueError(f"gather_grad_planes: smat {tuple(smat.shape)} / win "
                         f"{tuple(win.shape)} do not match W={w_win} with "
                         "gradient blocks")
    if smat.device.type == "cpu":
        return gather_grad_planes_plain(smat, win, w_win)
    _cuda_checks("gather_grad_planes", w_win, smat, win)
    if smat.data_ptr() % 16 or win.data_ptr() % 16:
        raise ValueError("gather_grad_planes: the CUDA kernel copies smat "
                         "and win in 16-byte units; pass 16-byte aligned "
                         "tensors")
    outs = [torch.empty((t, cap), dtype=smat.dtype, device=smat.device)
            for _ in range(4)]
    err = load_library().nv_windowed_gather_grad(
        smat.data_ptr(), win.data_ptr(), *(o.data_ptr() for o in outs),
        t, cap, kw, w_win, current_stream(smat))
    check_launch("gather_grad_planes", err)
    launch_counts["windowed_gather_grad"] += 1
    return tuple(outs)

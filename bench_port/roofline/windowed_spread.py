# SPDX-License-Identifier: Apache-2.0
"""Kernel 3 (``csrc/windowed_gather.cu``, spread): the B-spline charge
spread into tile windows."""

from bench_port.work import nbytes

WRAPS = (("nvalchemiops_torch.spline_windowed", "spread_windows"),)


def work(args, kwargs, out, ctx):
    """``(bytes, flops)`` of ``spread_windows(smat, q_t, w_win)``: it
    reads the value columns ``Sx | Sy | Sz`` of ``smat`` (the derivative
    columns feed the gather) and the charges; 3 operations a stencil
    point."""
    smat, q_t, w = args[:3]
    size = nbytes(smat[..., :3 * w], q_t, out)
    return size, ctx["pme_atoms"] * ctx["order"] ** 3 * 3

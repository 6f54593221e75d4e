# SPDX-License-Identifier: Apache-2.0
"""Kernel 2 (``csrc/windowed_gather.cu``, gather): the potential and its
gradient gathered from tile windows."""

from bench_port.work import nbytes

WRAPS = (("nvalchemiops_torch.spline_windowed", "gather_grad_planes"),)


def work(args, kwargs, out, ctx):
    """``(bytes, flops)`` of ``gather_grad_planes(smat, win, w_win)``: 8
    operations a stencil point (value and three gradient components)."""
    smat, win = args[:2]
    outs = out if isinstance(out, tuple) else (out,)
    size = nbytes(smat, win, *outs)
    return size, ctx["pme_atoms"] * ctx["order"] ** 3 * 8

# SPDX-License-Identifier: Apache-2.0
"""Kernel 1 (``csrc/window_sweep.cu``): the half-space pair sweep over the
halo grid, one grid or a batch with a leading system axis."""

from bench_port.work import nbytes, pair_flops, pairs_in_cutoff

#: the modules that call the kernel's wrapper, and its name there
WRAPS = (("nvalchemiops_torch.grid", "window_sweep"),
         ("nvalchemiops_torch.interactions.dispersion.grid_d3",
          "window_sweep"))


def work(args, kwargs, out, ctx):
    """``(bytes, flops)`` of ``window_sweep(body, radius, own, cand,
    params, lf=None)``: the half-space windows never reach the low z halo,
    nor the low y halo of the first interior plane, and ``j_out`` is
    written where it is read."""
    body, radius, own, cand = args[:4]
    batched = own.dim() == 6
    rz, ry = radius[0], radius[1]
    own_out, j_out = out
    lead = (slice(None),) * (2 if batched else 1)
    hi = lead + (slice(rz + 1, None),)
    row = lead + (rz, slice(ry, None))
    reads = [own, kwargs.get("lf"), cand[hi], cand[row]]
    size = nbytes(*reads, own_out, j_out[hi], j_out[row])
    cutoff = ctx["coulomb_cutoff"] if body == "coulomb" else ctx["cutoff"]
    pairs = pairs_in_cutoff(ctx["systems"] if batched else 1, ctx["atoms"],
                            ctx["volume"], cutoff)
    return size, pair_flops(body, pairs, ctx["mesh"])

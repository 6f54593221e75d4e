# SPDX-License-Identifier: Apache-2.0
"""Kernel 4 (``csrc/dense_pairs.cu``): the dense upper-triangle pair sweep
of a batch of small periodic systems.  Its bound counts the same work as
kernel 1's on the same systems, the pairs within the cutoff, and not the
pair slots the dense sweep visits."""

from bench_port.work import nbytes, pair_flops, pairs_in_cutoff

WRAPS = (("nvalchemiops_torch.interactions.dispersion.dense_d3",
          "dense_pairs"),)


def work(args, kwargs, out, ctx):
    """``(bytes, flops)`` of ``dense_pairs(body, feats [S, n, F], cells,
    combos, params, lw=None)``."""
    body, feats, cells = args[:3]
    lw = args[5] if len(args) > 5 else kwargs.get("lw")
    size = nbytes(feats, cells, lw, out)
    pairs = pairs_in_cutoff(feats.shape[0], ctx["atoms"], ctx["volume"],
                            ctx["cutoff"])
    return size, pair_flops(body, pairs, ctx["mesh"])

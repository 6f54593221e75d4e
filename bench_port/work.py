# SPDX-License-Identifier: Apache-2.0
"""Shared arithmetic of the roofline work counts (``roofline/<kernel>.py``):
each input the kernel's function reads counts once, each output once,
and pair work counts the pairs the systems hold within the cutoff,
whatever a kernel visits to find them."""

from __future__ import annotations

import math

import torch

# flops per pair inside the cutoff (exp, rsqrt and a divide count as one
# operation each, a multiply-add as two); the displacement and r^2 of
# each pair count DIST_FLOPS more; the D3 direct bodies add 6 per C6
# reference of their three dots
PAIR_FLOPS = {"cn": 10, "d3_direct": 35, "chain": 20, "coulomb": 35,
              "direct": 35, "d3_direct_coulomb": 70}
DIST_FLOPS = 8


def nbytes(*tensors) -> int:
    """Bytes of the tensors among ``tensors`` (other values count 0)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def pairs_in_cutoff(systems: int, n: int, volume: float,
                    cutoff: float) -> float:
    """Atom pairs (over all images) within the cutoff at the systems' mean
    density, each pair once: ``S n^2 (4 pi / 3) rc^3 / (2 V)``."""
    return systems * n * n * (4.0 * math.pi / 3.0) * cutoff ** 3 / (
        2.0 * volume)


def pair_flops(body: str, pairs: float, mesh: int) -> float:
    """Operations of ``pairs`` pairs through ``body``."""
    extra = 6 * mesh if body in ("d3_direct", "direct",
                                 "d3_direct_coulomb") else 0
    return pairs * (DIST_FLOPS + PAIR_FLOPS[body] + extra)

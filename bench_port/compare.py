# SPDX-License-Identifier: Apache-2.0
"""The numbers that decide ``correct``, and their verdict.

Each output of a sampled call is held to the plain reference
(``reference/``, float64) by its largest error over the reference's
largest magnitude; each such number has a limit of its own, set between
the largest that sound runs of the port read and the smallest that the
control (the reference computed in bfloat16, summed in float32) reads
(PERF.md gives both readings of every limit)."""

from __future__ import annotations

import math

import torch


def max_rel(out, ref) -> float:
    """``max |out - ref| / max |ref|`` in float64 (a NaN anywhere reads
    NaN, which no limit passes)."""
    out = torch.as_tensor(out).detach().to("cpu", torch.float64)
    ref = torch.as_tensor(ref).detach().to("cpu", torch.float64)
    if out.shape != ref.shape:
        return math.inf
    if not torch.isfinite(out).all():
        return math.nan
    return float((out - ref).abs().max() / ref.abs().max())


def verdict(numbers: dict, limits: dict):
    """``(correct, compared)``: every number at or below its limit (a
    number without a limit, or a limit without a number, fails), and
    ``{name: {"value", "limit"}}``."""
    compared = {k: {"value": numbers.get(k), "limit": limits.get(k)}
                for k in sorted(set(numbers) | set(limits))}
    correct = all(v["value"] is not None and v["limit"] is not None
                  and v["value"] <= v["limit"] for v in compared.values())
    return correct, compared

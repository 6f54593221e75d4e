# SPDX-License-Identifier: Apache-2.0
"""Window arithmetic: a rate over all the work and all the time of the
window, and a tail over every call in it."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of ``values``, interpolated linearly
    between order statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def window_metrics(call_walls_s, atoms_done: int, window_s: float) -> dict:
    """``atoms_per_s``: every atom of every call completed in the window
    over the window's whole time; ``call_ms_p95``: the 95th percentile of
    every call's wall."""
    if window_s <= 0 or not call_walls_s:
        raise ValueError("an empty window")
    return {"atoms_per_s": atoms_done / window_s,
            "call_ms_p95": percentile([w * 1e3 for w in call_walls_s], 95)}


def spread(values) -> float:
    """The distance between the first and third quartiles over the median
    (Python's ``statistics.quantiles``, exclusive method)."""
    import statistics

    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med

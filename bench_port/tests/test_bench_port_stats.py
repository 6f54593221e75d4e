# SPDX-License-Identifier: Apache-2.0
"""The window arithmetic: a rate over all the work and all the time of the
window, a tail over every call."""

import numpy as np
import pytest

from bench_port.stats import percentile, spread, window_metrics


def test_rate_is_all_work_over_all_time():
    # a slow call in the window weighs by its time, not as one of many
    walls = [0.01] * 99 + [1.0]
    m = window_metrics(walls, atoms_done=100 * 1000, window_s=sum(walls))
    assert m["atoms_per_s"] == pytest.approx(100_000 / 1.99)
    # the window's own time, not the sum of the calls, is the divisor
    m2 = window_metrics(walls, atoms_done=100 * 1000, window_s=2.5)
    assert m2["atoms_per_s"] == pytest.approx(40_000.0)


@pytest.mark.parametrize("n", [1, 7, 100, 1001])
def test_p95_over_every_call_matches_numpy(n):
    rng = np.random.default_rng(n)
    walls = list(rng.lognormal(-4.0, 0.5, n))
    got = window_metrics(walls, 1, 1.0)["call_ms_p95"]
    assert got == pytest.approx(float(np.percentile(np.array(walls) * 1e3,
                                                    95)))


def test_p95_is_not_a_median_of_chunks():
    # ten chunks of 20 calls, two slow calls in each: every chunk's median
    # is fast, the tail of every call is slow
    walls = ([0.010] * 18 + [0.100] * 2) * 10
    assert window_metrics(walls, 1, 1.0)["call_ms_p95"] == pytest.approx(
        100.0)


def test_percentile_ends_and_empty():
    assert percentile([3.0, 1.0, 2.0], 0) == 1.0
    assert percentile([3.0, 1.0, 2.0], 100) == 3.0
    with pytest.raises(ValueError):
        percentile([], 50)
    with pytest.raises(ValueError):
        window_metrics([], 1, 1.0)


def test_spread_is_quartile_distance_over_median():
    import statistics

    v = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert spread(v) == pytest.approx((q3 - q1) / med)

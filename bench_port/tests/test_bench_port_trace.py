# SPDX-License-Identifier: Apache-2.0
"""The trace's arithmetic on synthetic events: the whole-run test, the busy
union, the idle gaps by what the host did, and the roofline share."""

import pytest

from bench_port import peaks
from bench_port.trace import (
    CALL_RANGE, STAGE_RANGE, TraceContext, _union_us, breakdown,
    events_whole, uneven_names,
)


def test_events_whole():
    k = [("a", 0, 1), ("b", 1, 2)] * 3
    assert events_whole(k, launched=6)
    assert uneven_names(k, calls=3) == {}
    # a call's events dropped: fewer device kernels than host launches
    assert not events_whole(k[:-1], launched=6)
    assert not events_whole(k, launched=7)
    assert not events_whole([], launched=0)
    # copies and memsets are no kernels: they cannot stand in for one
    assert not events_whole(k[:-1] + [("Memcpy HtoD (Pageable -> Device)",
                                       5, 6)], launched=6)
    # one call launches another kernel than the rest (its data chose it):
    # nothing lost, the uneven name printed as a hint
    k2 = k[:-1] + [("c", 5, 6)]
    assert events_whole(k2, launched=6)
    assert uneven_names(k2, calls=3) == {"b": 2, "c": 1}


def test_busy_is_the_union_of_intervals():
    assert _union_us([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17


def test_idle_gaps_by_stage_and_host_op():
    kernels = [("k1", 0, 10), ("k2", 30, 40), ("k3", 60, 70), ("k1", 100,
                                                              110)]
    host = [(CALL_RANGE, 0, 75), (STAGE_RANGE + "d3", 0, 50),
            ("aten::nonzero", 12, 28), ("cudaStreamSynchronize", 14, 27),
            (STAGE_RANGE + "pme", 50, 75), (CALL_RANGE, 95, 115)]
    b = breakdown(kernels, host)
    gaps = dict((n, v) for n, v in b["idle_gaps"])
    assert gaps == pytest.approx({"d3: cudaStreamSynchronize": 20e-6,
                                  "pme: python": 20e-6,
                                  "between calls": 30e-6})
    ops = dict((n, v) for n, v in b["device_ops"])
    assert ops == pytest.approx({"k1": 20e-6, "k2": 10e-6, "k3": 10e-6})


def _ctx(**kw):
    base = dict(calls=2, window_s=1.0, busy_s=0.5, host_launches=4,
                lost=False, kernels=[("x_sweep_kernel<A>", 0, 1000),
                                     ("x_sweep_kernel<A>", 2000, 3000),
                                     ("other", 0, 5000)],
                stage_ms={}, works=[("window_sweep", "window_sweep[cn]",
                                     3.35e6, 0.0)] * 2,
                launch_counts={"window_sweep_cn": 2})
    base.update(kw)
    return TraceContext(**base)


def test_roofline_share():
    # two launches of 3.35 MB each: 1 us each at peak bandwidth, over 2 ms
    # of their kernels' device time
    got = _ctx().roofline(("window_sweep_",), ("sweep_kernel",))
    assert got == pytest.approx(100 * 2e-6 / 2e-3)
    assert peaks.PEAK_BYTES_PER_S == 3.35e12


def test_roofline_left_out_where_it_cannot_be_read():
    prefixes, names = ("window_sweep_",), ("sweep_kernel",)
    assert _ctx(lost=True).roofline(prefixes, names) is None
    # a launch without its work count
    assert _ctx(launch_counts={"window_sweep_cn": 3}).roofline(
        prefixes, names) is None
    # nothing launched
    assert _ctx(launch_counts={}).roofline(prefixes, names) is None

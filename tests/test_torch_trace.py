# SPDX-License-Identifier: Apache-2.0
"""The port's counters and spans (``nvalchemiops_torch/trace.py``) on the
CPU: the untraced no-op, span records under a ``torch.profiler`` session
and their clock, the record bound, and the slot pairs the grid sweeps
count, against brute-force enumerations of their windows."""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from nvalchemiops_torch import kernels, trace
from nvalchemiops_torch.kernels.window_sweep import (
    chunk_slot_pairs, halfspace_zy, slot_pairs,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: Tier-1 runs six test workers on the CPU, and a
    torch thread pool in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def test_untraced_span_is_one_shared_no_op():
    before_counts = dict(trace.counts)
    before = trace.records()
    a, b = trace.span("grid_build"), trace.span("d3")
    assert a is b
    with a:
        with trace.span("d3.cn"):
            pass
    assert trace.records() == before
    assert trace.counts == before_counts


def test_counters_count_only_what_touches_a_cuda_device():
    before = dict(trace.counts)
    with trace.host_read("test_site", torch.device("cpu"), 2):
        pass
    t = trace.upload([1.0, 2.0], "cpu", torch.float64, "test_site")
    assert t.dtype == torch.float64 and t.tolist() == [1.0, 2.0]
    assert trace.counts == before


def test_spans_record_names_parents_depths_and_counts():
    before = dict(trace.counts)

    def nest():
        with trace.span("d3"):
            with trace.span("d3.inputs"):
                with trace.span("d3"):          # an entry point inside it
                    pass
            with trace.span("d3.cn"):
                pass
        with trace.span("pme"):
            pass

    _profiled(nest)
    recs = trace.records(last=4)
    got = [(r["name"], r["parent"], r["depth"]) for r in recs]
    assert got == [("d3.inputs", "d3", 1), ("d3.cn", "d3", 1),
                   ("d3", None, 0), ("pme", None, 0)]
    for r in recs:
        assert r["t0_ns"] <= r["t1_ns"]
        assert r["host_ms"] == pytest.approx((r["t1_ns"] - r["t0_ns"]) * 1e-6)
        assert r["dev_ms"] is None              # no CUDA here
    outer, inner = recs[2], recs[0]
    assert outer["t0_ns"] <= inner["t0_ns"] <= inner["t1_ns"] <= outer["t1_ns"]
    delta = {k: v - before.get(k, 0) for k, v in trace.counts.items()
             if k.startswith("span_n.") and v != before.get(k, 0)}
    assert delta == {"span_n.d3": 1, "span_n.d3.inputs": 1,
                     "span_n.d3.cn": 1, "span_n.pme": 1}


def test_spans_share_the_profilers_host_clock():
    # the first session pays the profiler's own start-up
    _profiled(lambda: trace.span("warm").__enter__().__exit__(None, None,
                                                              None))

    def ranged():
        for _ in range(5):
            with record_function("outer"):
                with trace.span("grid_build"):
                    pass

    prof = _profiled(ranged)
    recs = trace.records(last=5)
    origin = prof.profiler.kineto_results.trace_start_ns()
    ranges = sorted((origin + e.time_range.start * 1000,
                     origin + e.time_range.end * 1000)
                    for e in prof.events() if e.name == "outer")
    assert len(ranges) == 5
    after = [r["t0_ns"] - start for r, (start, _) in zip(recs, ranges)]
    # each span starts inside its range: after its start (the least delay,
    # a scheduling hiccup aside, within 1 ms of it) and before its end
    assert all(d >= 0 for d in after) and min(after) <= 1_000_000, after
    assert all(r["t1_ns"] <= end for r, (_, end) in zip(recs, ranges))


def test_spanned_function_keeps_its_name_and_runs_in_its_span():
    @trace.spanned("coulomb")
    def entry(x, y=2):
        """doc"""
        return x + y

    assert entry.__name__ == "entry" and entry.__doc__ == "doc"
    assert entry(1) == 3
    _profiled(lambda: entry(1, y=5))
    assert trace.records(last=1)[0]["name"] == "coulomb"


def test_records_keep_the_newest_max_records():
    trace.clear_records()

    def many():
        for i in range(trace.MAX_RECORDS + 3):
            with trace.span(f"s{i % 5}"):
                pass

    t = time.perf_counter()
    _profiled(many)
    assert time.perf_counter() - t < 30.0
    recs = trace.records()
    assert len(recs) == trace.MAX_RECORDS
    # the three oldest dropped
    assert recs[0]["name"] == "s3"
    assert recs[-1]["name"] == f"s{(trace.MAX_RECORDS + 2) % 5}"
    assert trace.records(last=0) == []
    trace.clear_records()
    assert trace.records() == []


def test_launch_counts_are_the_trace_counters():
    assert kernels.launch_counts is trace.counts
    assert set(kernels.launches()) == set(trace.LAUNCH_KEYS)
    assert all("." not in k for k in trace.LAUNCH_KEYS)
    assert all("." not in f for f in trace.FAMILIES)


def _kernel1_windows(radius, cz, cy, cx, cap):
    """Kernel 1's slot pairs by own slot: the home row from the own cell
    to rx cells right of it, then each half-space row's 2 rx + 1 x-cells,
    every slot of each candidate cell (extended coordinates)."""
    rz, ry, rx = radius
    rows = [(0, 0, range(0, rx + 1))] + [
        (dz, dy, range(-rx, rx + 1)) for dz, dy in halfspace_zy(rz, ry)]
    for z in range(cz):
        for y in range(cy):
            for x in range(cx):
                for s in range(cap):
                    for dz, dy, dxs in rows:
                        for dx in dxs:
                            for t in range(cap):
                                yield ((z, y, x, s),
                                       (z + rz + dz, y + ry + dy,
                                        x + rx + dx, t))


def _chunk_windows(radius, cz, cy, cx, cap):
    """Kernels 7 and 8's slot pairs by own slot (one chunk a row,
    ``sweep_chunk``'s window indices): chunk slot i of cell gl against
    window slots [gl cap, (gl + 2 rx + 1) cap), in the home row only those
    past i + rx cap."""
    rz, ry, rx = radius
    rows = [(0, 0)] + halfspace_zy(rz, ry)
    for z in range(cz):
        for y in range(cy):
            for i in range(cx * cap):
                gl = i // cap
                for dz, dy in rows:
                    j0 = i + rx * cap + 1 if (dz, dy) == (0, 0) else gl * cap
                    for j in range(j0, (gl + 2 * rx + 1) * cap):
                        yield (z, y, i), (z + rz + dz, y + ry + dy, j)


@pytest.mark.parametrize("radius", [(1, 1, 1), (1, 1, 3)])
@pytest.mark.parametrize("systems", [1, 2])
def test_slot_pairs_equal_a_brute_force_enumeration(radius, systems):
    dims, cap = (2, 3, 4), 3
    ncells = dims[0] * dims[1] * dims[2]
    pairs = set(_kernel1_windows(radius, *dims, cap))
    assert slot_pairs(radius, cap, systems * ncells) == systems * len(pairs)
    chunk = set(_chunk_windows(radius, *dims, cap))
    assert chunk_slot_pairs(radius, cap, systems * ncells) == \
        systems * len(chunk)

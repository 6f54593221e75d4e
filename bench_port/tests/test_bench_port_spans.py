# SPDX-License-Identifier: Apache-2.0
"""The per-layer metrics that read the port's spans and counters
(``bench_port/spans.py`` and its eight readers) on synthetic traced
windows: each reading, a window taken again, a port without the span or
counter, and counter keys that no route or roofline prefix matches."""

import json
import os

import pytest

from bench_port import harness
from bench_port.trace import TraceContext
from bench_port.work import DIST_FLOPS, PAIR_FLOPS

READERS = ("span_ms.grid_build", "span_ms.d3", "span_ms.coulomb",
           "span_ms.pme", "dispatch_ms", "host_reads_per_call",
           "upload_kib_per_call", "slot_yield")


def _ctx(counts, calls=2, works=()):
    return TraceContext(calls=calls, window_s=1.0, busy_s=0.5,
                        host_launches=0, lost=False, kernels=[], stage_ms={},
                        works=list(works), launch_counts=dict(counts))


def _rec(name, depth, host_ms, dev_ms, parent=None):
    return {"name": name, "parent": parent, "depth": depth, "t0_ns": 0,
            "t1_ns": int(host_ms * 1e6), "host_ms": host_ms,
            "dev_ms": dev_ms}


@pytest.fixture
def readers():
    layout = harness.Layout()
    return {name: layout.module("metrics", name).read for name in READERS}


@pytest.fixture
def recorded(monkeypatch):
    """``trace.records`` replaced by a list the test fills."""
    from nvalchemiops_torch import trace

    kept = []

    def records(last=None):
        return list(kept if last is None else kept[len(kept) - last:])

    monkeypatch.setattr(trace, "records", records)
    return kept


# one traced call of the MD step, twice: each span's device and host ms
CALL = [_rec("host_read.grid_cells", 2, 0.2, None, "host_read.grid_inv"),
        _rec("host_read.grid_inv", 1, 0.5, None, "grid_build"),
        _rec("grid_build", 0, 3.0, 9.0),
        _rec("d3.cn", 1, 1.0, 9.0, "d3"),
        _rec("d3", 0, 6.0, 59.0),
        _rec("coulomb", 0, 1.0, 14.0),
        _rec("host_read.pme_tile_cap", 1, 2.0, None, "pme"),
        _rec("pme", 0, 5.0, 16.0)]


def _span_counts(records):
    counts = {}
    for r in records:
        counts["span_n." + r["name"]] = counts.get("span_n." + r["name"],
                                                   0) + 1
    return counts


def test_each_reader_on_a_synthetic_window(readers, recorded):
    recorded.extend(CALL * 2)
    counts = dict(_span_counts(CALL * 2), window_sweep_cn=2, **{
        "host_reads.grid_inv": 2, "host_reads.pme_tile_cap": 2,
        "host_reads.d3_tables": 10, "uploads.d3_numbers": 2,
        "upload_bytes.d3_numbers": 2 * 2048 * 1024,
        "upload_bytes.pme_alpha": 2 * 4,
        "slot_pairs.window_sweep_cn": 2 * 1000})
    pairs = 110.0
    works = [("window_sweep", "window_sweep[cn]", 1,
              pairs * (DIST_FLOPS + PAIR_FLOPS["cn"]))] * 2 + [
        ("window_sweep", "window_sweep[chain]", 1, 1e9)]
    ctx = _ctx(counts, calls=2, works=works)
    got = {name: read(ctx) for name, read in readers.items()}
    assert got["span_ms.grid_build"] == pytest.approx(9.0)
    assert got["span_ms.d3"] == pytest.approx(59.0)
    assert got["span_ms.coulomb"] == pytest.approx(14.0)
    assert got["span_ms.pme"] == pytest.approx(16.0)
    # outermost spans' host ms (15) less the host reads' (2.5: the read
    # inside another read counted once), a call
    assert got["dispatch_ms"] == pytest.approx(12.5)
    assert got["host_reads_per_call"] == pytest.approx(7.0)
    assert got["upload_kib_per_call"] == pytest.approx(2048 + 4 / 1024)
    assert got["slot_yield"] == pytest.approx(11.0)


def test_a_window_taken_again_reads_only_the_last_attempt(readers,
                                                          recorded):
    # the first attempt (lost events) recorded spans of other lengths
    first = [dict(r, host_ms=100 * r["host_ms"],
                  dev_ms=r["dev_ms"] and 100 * r["dev_ms"]) for r in CALL]
    recorded.extend(first + CALL * 2)
    ctx = _ctx(_span_counts(CALL * 2), calls=2)
    assert readers["span_ms.d3"](ctx) == pytest.approx(59.0)
    assert readers["dispatch_ms"](ctx) == pytest.approx(12.5)


def test_none_where_the_span_or_counter_is_absent(readers, recorded):
    # the port before its spans and counters: launch counts only
    ctx = _ctx({"window_sweep_cn": 2, "dense_pairs_cn": 0},
               works=[("window_sweep", "window_sweep[cn]", 1, 18.0)])
    got = {name: read(ctx) for name, read in readers.items()}
    assert got == dict.fromkeys(READERS)
    # spans of other layers only, and spans with no device time (CPU)
    recorded.extend([_rec("d3", 0, 6.0, None)])
    ctx = _ctx({"span_n.d3": 1, "host_reads.d3_tables": 0}, calls=1)
    assert readers["span_ms.pme"](ctx) is None
    assert readers["span_ms.d3"](ctx) is None
    assert readers["dispatch_ms"](ctx) == pytest.approx(6.0)
    assert readers["host_reads_per_call"](ctx) == 0.0
    assert readers["upload_kib_per_call"](ctx) is None
    assert readers["slot_yield"](ctx) is None


def _route_and_roofline_prefixes():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    prefixes = set()
    for name in os.listdir(os.path.join(root, "checks")):
        with open(os.path.join(root, "checks", name)) as f:
            route = json.load(f)["route"]
        prefixes.update(route["launch"] + route["forbid"])
    layout = harness.Layout()
    for name, mod in layout.modules("metrics").items():
        prefixes.update(getattr(mod, "LAUNCHES", ()))
    return prefixes


def test_no_counter_key_matches_a_route_or_roofline_prefix():
    from nvalchemiops_torch import trace

    prefixes = _route_and_roofline_prefixes()
    assert {"window_sweep_", "windowed_spread", "dense_pairs_"} <= prefixes
    # every key beside the launch counts is <family>.<name>: a prefix
    # matches some such key only where it and "<family>." overlap
    for family in trace.FAMILIES:
        head = family + "."
        assert not any(head.startswith(p) or p.startswith(head)
                       for p in prefixes), family
    keys = [f"slot_pairs.{k}" for k in trace.LAUNCH_KEYS
            if k.startswith(("window_sweep_", "row_sweep_", "chunk_sweep_"))]
    keys += [f"span_n.{s}" for s in ("grid_build", "d3", "d3.cn", "pme")]
    assert not any(k.startswith(p) for k in keys for p in prefixes)

# SPDX-License-Identifier: Apache-2.0
"""The per-layer metric ``sweep_resident_warps``, which reads the port's
``resident_warps.window_sweep_*`` counters over its
``slot_pairs.window_sweep_*`` counters, on synthetic traced windows."""

import pytest

from bench_port import harness
from bench_port.trace import TraceContext


def _ctx(counts):
    return TraceContext(calls=2, window_s=1.0, busy_s=0.5, host_launches=0,
                        lost=False, kernels=[], stage_ms={}, works=[],
                        launch_counts=dict(counts))


def test_sweep_resident_warps_weighs_warps_by_slot_pairs():
    """Kernel 1's resident warps over the traced window: two bodies at 48
    and 24 warps an SM, weighted by their slot pairs (kernel 7's slot
    pairs left out); None on a port without the counter, and where kernel
    1 did not run in the window."""
    read = harness.Layout().module("metrics", "sweep_resident_warps").read
    counts = {"window_sweep_cn": 2, "slot_pairs.window_sweep_cn": 3000,
              "slot_pairs.window_sweep_d3_direct": 1000,
              "resident_warps.window_sweep_cn": 48 * 3000,
              "resident_warps.window_sweep_d3_direct": 24 * 1000,
              "slot_pairs.row_sweep_cn": 500}
    assert read(_ctx(counts)) == pytest.approx(42.0)
    assert read(_ctx({k: v for k, v in counts.items()
                      if not k.startswith("resident_warps.")})) is None
    assert read(_ctx(dict.fromkeys(counts, 0))) is None

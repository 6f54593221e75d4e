# SPDX-License-Identifier: Apache-2.0
"""The harness on the card at a test's size: each cell's kernels launch on
its route, the run is correct, and the traced run reads every per-layer
metric of the cell within its range.  Skips without a CUDA card (decided
in the fixture); run on a card with ``python -m pytest -p no:cacheprovider
bench_port/tests/test_bench_port_gpu.py``."""

import json
import os
import subprocess
import sys

import pytest

from bench_port.harness import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", ["cscl-md.524k", "d3-batch.dense"])
def test_cell_on_the_card(tiny_layout, card, cell):
    r = run(cell, 2 ** 32 + 3, 1.0, False, card, layout=tiny_layout)
    assert r["correct"], r["compared"]
    assert r["compared"]["off_route_launches"]["value"] == 0
    assert r["device"]["platform"] == "gpu"
    assert r["device"]["memory_peak_bytes"] > 0


@pytest.mark.parametrize("cell", ["cscl-md.524k", "d3-batch.dense"])
def test_traced_run_reads_every_metric(tiny_layout, card, cell):
    # one process a traced run, as the benchmark runs it: a second
    # profiler session in one process loses device events
    script = ("import sys, torch\n"
              "from bench_port.harness import Layout, finite_json, run\n"
              "layout = Layout(sys.argv[1], sys.argv[2])\n"
              "r = run(sys.argv[3], 2 ** 32 + 4, 0.5, True, "
              "torch.device('cuda', 0), layout=layout)\n"
              "print(finite_json(r))\n")
    p = subprocess.run([sys.executable, "-c", script, tiny_layout.root,
                        tiny_layout.bench_dir, cell], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    want = {m["name"] for m in tiny_layout.metrics_of("per_layer", cell)}
    assert set(r["metrics"]) == want
    for name, m in r["metrics"].items():
        if m["unit"] == "%":
            assert 0.0 < m["value"] <= 100.0, name
    assert 0.0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert 1 <= len(r["breakdown"]["device_ops"]) <= 10

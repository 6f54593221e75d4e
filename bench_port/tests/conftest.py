# SPDX-License-Identifier: Apache-2.0
"""Shared fixtures of the benchmark's CPU tests: torch on one thread, and
a copy of the benchmark's files at sizes a CPU test can hold."""

import json
import os
import shutil
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _edit(path, **changes):
    with open(path) as f:
        data = json.load(f)
    for key, value in changes.items():
        node = data
        *parents, leaf = key.split("__")
        for p in parents:
            node = node[p]
        node[leaf] = value
    with open(path, "w") as f:
        json.dump(data, f)


def make_tiny_layout(tmp_path):
    """The benchmark's files under ``tmp_path`` with the cells cut to a
    CPU test's size: the crystal at 432 atoms on a 16^3 mesh with its D3
    cutoff under half its 24.7 A box (9.6 A), the dense batch 4 x 100
    atoms in 15 A boxes at a 5 A cutoff, every system of it compared.
    Limits, routes, metrics and work counts are the real ones."""
    from bench_port.harness import Layout

    bench = tmp_path / "bench_port"
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for d in ("configs", "workloads", "checks", "metrics", "roofline"):
        shutil.copytree(os.path.join(ROOT, "bench_port", d), bench / d)
    _edit(bench / "configs" / "cscl-md.json", lattice__n_rep=6,
          d3__cutoff=9.6, pme__mesh=[16, 16, 16])
    _edit(bench / "configs" / "d3-batch.json", d3__cutoff=5.0)
    _edit(bench / "workloads" / "batch-128x2000.json", systems=4, atoms=100,
          box=15.0)
    _edit(bench / "checks" / "d3-batch.dense.json", sample_systems=4)
    return Layout(str(tmp_path), str(bench))


@pytest.fixture
def tiny_layout(tmp_path):
    return make_tiny_layout(tmp_path)

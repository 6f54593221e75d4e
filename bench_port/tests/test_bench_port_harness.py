# SPDX-License-Identifier: Apache-2.0
"""The harness: files found by name, the result line's keys, the guard
against JAX, and the command's refusal without a card."""

import json
import os
import subprocess
import sys
import types

import pytest

from bench_port import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_new_files_are_found_by_name(tiny_layout):
    # a configuration, a traffic mix, a check and a per-layer metric added
    # as new files, named in BENCHMARK.json, and nothing edited
    bench = tiny_layout.bench_dir
    cfg = json.load(open(os.path.join(bench, "configs", "d3-batch.json")))
    cfg["name"] = "d3-small"
    json.dump(cfg, open(os.path.join(bench, "configs", "d3-small.json"), "w"))
    json.dump({"systems": 2, "atoms": 50, "box": 12.0, "position_sets": 2,
               "warmup_calls": 1, "trace_calls": 2},
              open(os.path.join(bench, "workloads", "batch-2x50.json"), "w"))
    check = json.load(open(os.path.join(bench, "checks",
                                        "d3-batch.dense.json")))
    check["sample_systems"] = 2
    json.dump(check, open(os.path.join(bench, "checks", "d3-small.x.json"),
                          "w"))
    with open(os.path.join(bench, "metrics", "traced_calls.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx.calls\n")
    b = tiny_layout.benchmark
    b["configs"].append(dict(b["configs"][1], name="d3-small",
                             file="bench_port/configs/d3-small.json"))
    b["workloads"].append({"name": "d3-small.x", "config": "d3-small",
                           "traffic": "batch-2x50", "chips": 1, "why": "t"})
    b["per_layer"].append({"name": "traced_calls", "unit": "calls",
                           "better": "higher", "source": "program_counter",
                           "layer": "host dispatch", "moves": "atoms_per_s",
                           "workloads": ["d3-small.x"]})
    json.dump(b, open(os.path.join(tiny_layout.root, "BENCHMARK.json"), "w"))
    layout = harness.Layout(tiny_layout.root, bench)
    r = harness.run("d3-small.x", 3, 0.0, True, "cpu", layout=layout)
    assert r["metrics"]["traced_calls"] == {"value": 2.0, "unit": "calls"}
    assert r["correct"] is True
    assert r["attempted"] == 2


def test_result_line_keys(tiny_layout):
    r = harness.run("d3-batch.dense", 9, 0.2, False, "cpu",
                    layout=tiny_layout)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "compared"]
    assert set(r["metrics"]) == {"atoms_per_s", "call_ms_p95",
                                 "peak_mem_mib", "setup_s"}
    assert r["metrics"]["atoms_per_s"]["unit"] == "atoms/s"
    json.loads(harness.finite_json(r))


def test_same_seed_same_inputs(tiny_layout):
    from bench_port.systems.d3_batch import make_traffic

    cfg = tiny_layout.json("configs", "d3-batch")
    mix = tiny_layout.json("workloads", "batch-128x2000")
    a, b, c = (make_traffic(cfg, mix, s, "cpu")
               for s in (2 ** 33 + 5, 2 ** 33 + 5, 6))
    assert all((x == y).all() for x, y in zip(a.positions, b.positions))
    assert all((x == y).all() for x, y in zip(a.numbers, b.numbers))
    assert not (a.positions[0] == c.positions[0]).all()
    assert [p.shape for p in a.positions] == [p.shape for p in c.positions]


def test_a_loaded_jax_module_stops_the_run(tiny_layout, monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert harness.run("d3-batch.dense", 1, 0.0, False, "cpu",
                       layout=tiny_layout) is None
    monkeypatch.delitem(sys.modules, "jaxlib")
    # whole top-level names: the port's own name is not the JAX package's
    monkeypatch.setitem(sys.modules, "nvalchemiops_tpux",
                        types.ModuleType("nvalchemiops_tpux"))
    assert harness.forbidden_modules() == []


def test_a_metric_reader_that_loads_jax_stops_the_run(tiny_layout,
                                                      tmp_path, monkeypatch):
    # a per-layer metric's reader pulls in a module named jax (a stub here)
    # through its imports: the run, traced, prints no result
    stubs = tmp_path / "stubs" / "jax"
    stubs.mkdir(parents=True)
    (stubs / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path / "stubs"))
    bench = tiny_layout.bench_dir
    with open(os.path.join(bench, "metrics", "loads_jax.py"), "w") as f:
        f.write("import jax  # noqa: F401\n\n\ndef read(ctx):\n"
                "    return 1.0\n")
    b = tiny_layout.benchmark
    b["per_layer"].append({"name": "loads_jax", "unit": "calls",
                           "better": "higher", "source": "program_counter",
                           "layer": "host dispatch", "moves": "atoms_per_s",
                           "workloads": ["d3-batch.dense"]})
    json.dump(b, open(os.path.join(tiny_layout.root, "BENCHMARK.json"), "w"))
    layout = harness.Layout(tiny_layout.root, bench)
    had_jax = "jax" in sys.modules
    try:
        assert harness.run("d3-batch.dense", 4, 0.0, True, "cpu",
                           layout=layout) is None
        assert "jax" in sys.modules
    finally:
        if not had_jax:
            sys.modules.pop("jax", None)


def test_a_traced_run_makes_only_the_calls_it_compares(tiny_layout):
    # the traced calls, then one call on each position set (so the sampled
    # set's answers exist), and no measured window
    import time

    mix = tiny_layout.json("workloads", "batch-128x2000")
    t = time.perf_counter()
    r = harness.run("d3-batch.dense", 12, 30.0, True, "cpu",
                    layout=tiny_layout)
    assert time.perf_counter() - t < 30.0
    assert r["attempted"] == mix["position_sets"]
    assert r["correct"] is True


def test_command_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "bench_port/run.py", "--workload",
                        "cscl-md.524k", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""

# SPDX-License-Identifier: Apache-2.0
"""One run of one cell: set-up, warm-up, the measured window (``--trace
0``) or the traced calls (``--trace 1``), the comparison with the plain
reference, and the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the deployment; its ``"system"`` names the
  module ``systems/<system>.py`` that binds it to the port's entry points;
- ``workloads/<traffic>.json``: the traffic mix, read by the system
  module's ``make_traffic``;
- ``checks/<cell>.json``: what decides ``correct`` in the cell (the
  sample, the route, the limits);
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``;
- ``roofline/<kernel>.py``: a kernel's work count, ``work(...)``, and the
  wrappers it counts (``WRAPS``).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from bench_port.compare import verdict
from bench_port.stats import window_metrics
from bench_port.traffic import numpy_rng

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
#: top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "nvalchemiops_tpu")


def log(msg: str) -> None:
    print(f"[bench_port] {msg}", file=sys.stderr, flush=True)


class Layout:
    """Where the benchmark's files are: ``BENCHMARK.json`` in ``root``,
    the rest under ``bench_dir``."""

    def __init__(self, root: str = ROOT, bench_dir: str = BENCH_DIR):
        self.root, self.bench_dir = root, bench_dir
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.benchmark = json.load(f)

    def json(self, kind: str, name: str):
        with open(os.path.join(self.bench_dir, kind, f"{name}.json")) as f:
            return json.load(f)

    def module(self, kind: str, name: str):
        """``<bench_dir>/<kind>/<name>.py`` loaded by its path (metric names
        hold dots)."""
        path = os.path.join(self.bench_dir, kind, f"{name}.py")
        spec = importlib.util.spec_from_file_location(
            f"bench_port_{kind}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def modules(self, kind: str) -> dict:
        d = os.path.join(self.bench_dir, kind)
        return {f[:-3]: self.module(kind, f[:-3]) for f in sorted(os.listdir(d))
                if f.endswith(".py") and not f.startswith("_")}

    def cell(self, name: str) -> dict:
        for w in self.benchmark["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def metrics_of(self, group: str, cell: str) -> list:
        return [m for m in self.benchmark[group]
                if "workloads" not in m or cell in m["workloads"]]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def card_line(device) -> str:
    """The card's name and power limit, printed beside every number."""
    if torch.device(device).type != "cuda":
        return "cpu"
    name = torch.cuda.get_device_name(device)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=False
        ).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        limit = []
    return f"{name}, power limit {limit[0] if limit else 'not read'}"


def route_faults(check: dict, counts: dict) -> int:
    """Launches off the cell's route: every launch of a forbidden kernel,
    and one for each expected kernel that never launched."""
    route = check["route"]
    off = sum(c for k, c in counts.items()
              if k.startswith(tuple(route["forbid"])))
    return off + sum(1 for k in route["launch"] if counts.get(k, 0) == 0)


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run(cell_name: str, seed: int, seconds: float, trace: bool, device,
        layout: Layout | None = None, mode: str = "program",
        t_start: float | None = None):
    """One run; returns the result dict, or None where the run may print
    no result.  ``mode="control"`` puts the reference, computed in
    bfloat16 and summed in float32, in the program's place in the
    comparison (the control of the limits; never part of a benchmark
    run)."""
    t_start = time.perf_counter() if t_start is None else t_start
    layout = layout or Layout()
    device = torch.device(device)
    on_card = device.type == "cuda"
    spec = layout.cell(cell_name)
    config = layout.json("configs", spec["config"])
    mix = layout.json("workloads", spec["traffic"])
    check = layout.json("checks", cell_name)
    system = importlib.import_module(f"bench_port.systems.{config['system']}")
    from nvalchemiops_torch.kernels import launch_counts

    phases = [("start", time.perf_counter() - t_start)]
    traffic = system.make_traffic(config, mix, seed, device)
    phases.append(("inputs", time.perf_counter() - t_start))
    cell = system.Cell(config, traffic, device, seed)
    phases.append(("geometry", time.perf_counter() - t_start))
    n_sets = len(traffic.positions)
    log(f"{cell_name} seed {seed}: {cell.describe()}; card {card_line(device)}")
    for c in range(int(mix["warmup_calls"])):
        cell.call(c)
        sync(device)
        phases.append((f"warm-up call {c}", time.perf_counter() - t_start))
    log("set-up: " + ", ".join(f"{k} {v:.2f} s" for k, v in phases))

    trace_ctx = None
    if trace:
        from bench_port.trace import traced_window

        trace_ctx = traced_window(cell, int(mix["trace_calls"]),
                                  layout.modules("roofline"), launch_counts)

    rng = numpy_rng(seed, 3)
    k_star = int(rng.integers(n_sets))
    sample = cell.draw_sample(rng, check)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    before = dict(launch_counts)
    setup_s = time.perf_counter() - t_start

    walls, kept, calls = [], None, 0
    t0 = time.perf_counter()
    # closed loop: each call waits for the last; at least one call on
    # every set, so the sampled set's answers exist.  A traced run reports
    # per-layer metrics only: it makes just those calls
    while calls < n_sets or (not trace
                             and time.perf_counter() - t0 < seconds):
        a = time.perf_counter()
        out = cell.call(calls)
        sync(device)
        walls.append(time.perf_counter() - a)
        if calls % n_sets == k_star:
            kept = (calls, out)
        calls += 1
        del out
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    counts = {k: launch_counts[k] - before.get(k, 0) for k in launch_counts}

    kept_call, kept_out = kept
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if mode == "control":
        # the control in the program's place: its outputs are judged
        kept_out = cell.reference(kept_call, sample, dtype=torch.bfloat16,
                                  acc=torch.float32)
    elif mode == "program":
        kept_out = cell.select(kept_out, sample)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    t_ref = time.perf_counter()
    ref = cell.reference(kept_call, sample)
    numbers = cell.compare(kept_out, ref)
    log(f"reference {time.perf_counter() - t_ref:.1f} s (call {kept_call}, "
        f"sample {sample}), peak "
        f"{torch.cuda.max_memory_allocated(device) / 2 ** 20 if on_card else 0:.0f}"
        f" MiB")
    limits = dict(check["limits"])
    if on_card and mode == "program":
        numbers["off_route_launches"] = route_faults(check, counts)
        limits["off_route_launches"] = 0
    correct, compared = verdict(numbers, limits)

    metrics = {}
    if trace:
        for m in layout.metrics_of("per_layer", cell_name):
            v = layout.module("metrics", m["name"]).read(trace_ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = dict(window_metrics(walls, calls * cell.atoms_per_call,
                                  window_s),
                   peak_mem_mib=peak / 2 ** 20, setup_s=setup_s)
        for m in layout.metrics_of("end_to_end", cell_name):
            metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                  "unit": m["unit"]}
    # last, once everything the run loads (the metric readers too) is in
    bad = forbidden_modules()
    if bad:
        log(f"modules that no run may load are loaded: {bad}")
        return None
    result = {
        "correct": bool(correct), "attempted": calls,
        "failed": 0 if correct else 1, "metrics": metrics,
        "device": {"platform": "gpu" if on_card else device.type,
                   "kind": (torch.cuda.get_device_name(device) if on_card
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if trace:
        result["device"]["busy_s"] = trace_ctx.busy_s
        result["device"]["window_s"] = trace_ctx.window_s
        result["breakdown"] = trace_ctx.breakdown
    log(f"{cell_name} seed {seed}: {calls} calls in {window_s:.3f} s, set-up "
        f"{setup_s:.3f} s, peak {peak / 2 ** 20:.1f} MiB, launches "
        f"{ {k: c for k, c in counts.items() if c} }")
    for k, v in compared.items():
        log(f"compared {k}: {v['value']!r} limit {v['limit']!r}")
    result["compared"] = compared
    return result


def finite_json(obj) -> str:
    """The result as one JSON line (a NaN or infinite number reads as a
    string, so the line stays valid JSON)."""
    def fix(o):
        if isinstance(o, float) and not math.isfinite(o):
            return repr(o)
        if isinstance(o, dict):
            return {k: fix(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [fix(v) for v in o]
        if isinstance(o, np.generic):
            return fix(o.item())
        return o
    return json.dumps(fix(obj))

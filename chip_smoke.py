# SPDX-License-Identifier: Apache-2.0
"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

Runs the port's main path -- halo grid -> DFT-D3(BJ) -> erfc real-space
Coulomb -> PME reciprocal space -- through its public entry points, with
the hand-written CUDA kernels built from ``nvalchemiops_torch/csrc``:

1. environment: a CUDA device (else it fails), the card's name and power
   limit, TF32 off for matmuls and cuDNN;
2. build: compiles the kernels with nvcc (timed);
3. accuracy: the f32 composite (1,024-atom CsCl) on the card against the
   committed f64 reference ``benchmarks/data/bench_acc_ref.npz``, held to
   1.25x the JAX package's recorded f32 errors (max and RMS);
4. full width: the 109,744-atom CsCl (n_rep 38, 9.6 A, alpha 0.35, 128^3
   mesh, order 4) once through the entry points, with launch counts that
   show every stage ran on the kernels, finite outputs, ~zero net force,
   stage times (CUDA events) and peak memory;
5. kernel vs plain: every kernel call of phases 3 and 4 is replayed on its
   captured inputs through the kernel and through its plain PyTorch
   version, compared within a stated f32 tolerance and timed.

The last two lines of standard output are the kernel table and the device
record, each one JSON object.  Any failure raises (non-zero exit) before
either is printed.  Usage: ``python3 chip_smoke.py`` from the repo root.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# JAX package's recorded f32-vs-f64 force errors on the 1,024-atom composite
# (BENCH_r05.json, benchmarks/composite_accuracy.py): (max rel, RMS rel)
JAX_F32_BARS = {"d3": (7.54e-4, 7.21e-4), "coulomb": (1.82e-5, 1.69e-5),
                "pme": (7.51e-5, 9.13e-5)}
BAR_FACTOR = 1.25
# kernel vs plain, f32: max |kernel - plain| <= KERNEL_RTOL * max |plain|
# per output.  Both sum in f32 in different orders (and the pair sweep's
# j-side sums with atomics in a run-dependent order); 1e-5 is ~100 f32 ulps
# of the output's scale.
KERNEL_RTOL = 1e-5
NET_FORCE_RTOL = 1e-3      # |sum_i F_i| / sum_i |F_i| per stage
FULL_N_REP = 38            # 2 * 38^3 = 109,744 atoms
FULL_MESH = (128, 128, 128)

KERNEL_SOURCES = {
    "window_sweep": ("nvalchemiops_torch/csrc/window_sweep.cu",
                     "nvalchemiops_tpu/pallas/window_sweep.py:165"),
    "windowed_spread": ("nvalchemiops_torch/csrc/windowed_gather.cu",
                        "nvalchemiops_tpu/pallas/windowed_gather.py:134"),
    "windowed_gather_grad": ("nvalchemiops_torch/csrc/windowed_gather.cu",
                             "nvalchemiops_tpu/pallas/windowed_gather.py:80"),
}


def phase(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def cuda_time_ms(fn, reps=5):
    """Median CUDA-event time of ``fn`` over ``reps`` runs after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


class Capture:
    """Records the first call per key of the kernel wrappers the modules
    imported, so every kernel can be replayed on its main-path inputs."""

    def __init__(self):
        self.calls = {}
        self._undo = []

    def wrap(self, module, name, key_of):
        orig = getattr(module, name)

        def wrapper(*args, **kwargs):
            self.calls.setdefault(key_of(*args), (args, kwargs))
            return orig(*args, **kwargs)

        setattr(module, name, wrapper)
        self._undo.append((module, name, orig))

    def restore(self):
        for module, name, orig in reversed(self._undo):
            setattr(module, name, orig)
        self._undo.clear()


def install_capture():
    from nvalchemiops_torch import grid, spline_windowed
    from nvalchemiops_torch.interactions.dispersion import grid_d3

    cap = Capture()
    for mod in (grid, grid_d3):
        cap.wrap(mod, "window_sweep", lambda body, *a: f"window_sweep[{body}]")
    cap.wrap(spline_windowed, "spread_windows", lambda *a: "windowed_spread")
    cap.wrap(spline_windowed, "gather_grad_planes",
             lambda *a: "windowed_gather_grad")
    return cap


def count_key_of(key):
    """Launch-count key of a kernel table name ("window_sweep[cn]" ->
    "window_sweep_cn")."""
    if key.startswith("window_sweep["):
        return f"window_sweep_{key[len('window_sweep['):-1]}"
    return key


def compare_kernels(calls, label):
    """Replay each captured call through kernel and plain version."""
    from nvalchemiops_torch.kernels import window_sweep as ws
    from nvalchemiops_torch.kernels import windowed_gather as wg

    pairs = {
        "window_sweep": (ws.window_sweep, ws.window_sweep_plain),
        "windowed_spread": (wg.spread_windows, wg.spread_windows_plain),
        "windowed_gather_grad": (wg.gather_grad_planes,
                                 wg.gather_grad_planes_plain),
    }
    from nvalchemiops_torch.kernels import launch_counts

    rows = {}
    for key, (args, kwargs) in sorted(calls.items()):
        kern, plain = pairs[key.split("[")[0]]
        count_key = count_key_of(key)
        before = launch_counts[count_key]
        out_k = kern(*args, **kwargs)
        if launch_counts[count_key] != before + 1:
            raise AssertionError(f"{label} {key}: launch count did not move")
        out_p = plain(*args, **kwargs)
        torch.cuda.synchronize()
        out_k = [t for t in (out_k if isinstance(out_k, tuple) else (out_k,))]
        out_p = [t for t in (out_p if isinstance(out_p, tuple) else (out_p,))]
        max_abs, worst_rel = 0.0, 0.0
        for tk, tp in zip(out_k, out_p):
            for a, b in zip(tk.reshape(len(tk), -1) if tk.dim() == 5 else [tk],
                            tp.reshape(len(tp), -1) if tp.dim() == 5 else [tp]):
                err = (a.double() - b.double()).abs().max().item()
                scale = b.double().abs().max().item()
                if not np.isfinite(err) or err > KERNEL_RTOL * scale:
                    raise AssertionError(
                        f"{label} {key}: kernel vs plain max abs err {err:.3e}"
                        f" > {KERNEL_RTOL:g} x scale {scale:.3e}")
                max_abs = max(max_abs, err)
                worst_rel = max(worst_rel, err / scale if scale else 0.0)
        ms = cuda_time_ms(lambda: kern(*args, **kwargs))
        plain_ms = cuda_time_ms(lambda: plain(*args, **kwargs))
        shape = tuple(args[2].shape) if key.startswith("window_sweep") else \
            tuple(args[0].shape)
        phase(f"{label} {key}: input {shape} max_abs_err {max_abs:.3e} "
              f"(rel {worst_rel:.2e}) kernel {ms:.4f} ms plain "
              f"{plain_ms:.4f} ms")
        rows[key] = {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}
    return rows


def check_forces(name, forces):
    if not torch.isfinite(forces).all():
        raise AssertionError(f"{name}: non-finite forces")
    net = forces.double().sum(0).abs().max().item()
    l1 = forces.double().abs().sum().item()
    if net > NET_FORCE_RTOL * l1:
        raise AssertionError(f"{name}: net force {net:.3e} vs sum |F| {l1:.3e}")
    return net / l1


def main():
    # -- phase 1: environment ------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none found")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 could not be switched off")
    phase(f"environment: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(card, flush=True)

    from benchmarks.composite_accuracy import (
        load_reference, relative_errors, rms_errors,
    )
    from nvalchemiops_torch import composite
    from nvalchemiops_torch.grid import (
        build_atom_grid, choose_grid_geometry, grid_coulomb_energy_forces,
    )
    from nvalchemiops_torch.interactions.dispersion.grid_d3 import (
        compact_d3_elements, grid_dftd3,
    )
    from nvalchemiops_torch.interactions.electrostatics.pme import (
        pme_reciprocal_space,
    )
    from nvalchemiops_torch.kernels import launch_counts, reset_launch_counts
    from nvalchemiops_torch.kernels.build import build_library
    from nvalchemiops_torch.spline_windowed import observed_tile_capacity

    dev = torch.device("cuda", 0)

    # -- phase 2: build ------------------------------------------------------
    t0 = time.perf_counter()
    path, log = build_library()
    phase(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{os.path.relpath(path, ROOT)}")
    if log.strip():
        print(log.strip(), flush=True)

    # -- phase 3: accuracy against the committed f64 reference -------------
    ref = load_reference()
    if ref is None:
        raise RuntimeError("benchmarks/data/bench_acc_ref.npz not found")
    capture = install_capture()
    reset_launch_counts()
    forces = composite.compute_forces(torch.float32, dev)
    small_counts = dict(launch_counts)
    capture.restore()
    small_calls = capture.calls
    rel, rms = relative_errors(forces, ref), rms_errors(forces, ref)
    for k, (bar_max, bar_rms) in JAX_F32_BARS.items():
        phase(f"accuracy {k}: max rel {rel[k]:.3e} (bar "
              f"{BAR_FACTOR * bar_max:.3e}), rms rel {rms[k]:.3e} (bar "
              f"{BAR_FACTOR * bar_rms:.3e})")
        if not (rel[k] <= BAR_FACTOR * bar_max
                and rms[k] <= BAR_FACTOR * bar_rms):
            raise AssertionError(f"accuracy {k} above the 1.25x JAX f32 bar")
    if not all(small_counts.values()):
        raise AssertionError(f"composite skipped a kernel: {small_counts}")

    # -- phase 4: full width through the public entry points ---------------
    (pos_np, cell_np, numbers, charges, rcov, r4r2, cna,
     c6) = composite.build_system(FULL_N_REP)
    numbers, rcov, r4r2, c6, cna = compact_d3_elements(numbers, rcov, r4r2,
                                                       c6, cna)
    pos = torch.as_tensor(pos_np, dtype=torch.float32, device=dev)
    cell = torch.as_tensor(cell_np, dtype=torch.float32, device=dev)
    q = torch.as_tensor(charges, dtype=torch.float32, device=dev)
    pbc = np.array([True] * 3)
    cutoff, alpha = composite.CUTOFF, composite.ALPHA
    n = pos.shape[0]
    stage_ms = {}

    def timed(name, fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        stage_ms[name] = a.elapsed_time(b)
        return out

    capture = install_capture()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    dims, radius, gcap, origin = timed(
        "geometry", lambda: choose_grid_geometry(pos, cell, pbc, cutoff))
    tile_cap = timed("tile_capacity", lambda: observed_tile_capacity(
        pos, cell, FULL_MESH))
    stages = {
        "grid_build": lambda: build_atom_grid(pos, cell, pbc, dims, radius,
                                              gcap, origin=origin),
        "d3": lambda: grid_dftd3(g, numbers, rcov, r4r2, c6, cna, cutoff,
                                 composite.D3_A1, composite.D3_A2,
                                 composite.D3_S8),
        "coulomb": lambda: grid_coulomb_energy_forces(g, q, cutoff, alpha),
        "pme": lambda: pme_reciprocal_space(
            pos, q, cell, alpha, mesh_dimensions=FULL_MESH,
            compute_forces=True, tile_capacity=tile_cap),
    }
    g = timed("grid_build", stages["grid_build"])
    e_d3, f_d3, cn = timed("d3", stages["d3"])
    e_c, f_c = timed("coulomb", stages["coulomb"])
    e_p, f_p = timed("pme", stages["pme"])
    torch.cuda.synchronize()
    main_counts = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated(dev)
    capture.restore()
    full_calls = capture.calls

    counts_max = int(g.counts_max)
    phase(f"full width: {n} atoms, grid dims {dims} radius {radius} cap "
          f"{gcap} origin {None if origin is None else origin.tolist()} "
          f"counts_max {counts_max}, tile cap {tile_cap}")
    if counts_max > gcap:
        raise AssertionError(f"grid overflow: {counts_max} > cap {gcap}")
    for name, t in (("d3 energy", e_d3), ("d3 cn", cn), ("coulomb energies",
                    e_c), ("pme energies", e_p)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{name}: non-finite values")
    for name, f in (("d3", f_d3), ("coulomb", f_c), ("pme", f_p)):
        frac = check_forces(name, f)
        phase(f"full width {name}: max |F| {f.abs().max().item():.4e}, "
              f"net force / sum|F| {frac:.2e}")
    phase(f"full width energies: d3 {e_d3.item():.6e}, coulomb "
          f"{e_c.double().sum().item():.6e}, pme "
          f"{e_p.double().sum().item():.6e}")
    phase("full width stage ms (CUDA events, first call): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stage_ms.items()))
    steady = {k: cuda_time_ms(fn, reps=3) for k, fn in stages.items()}
    phase("full width stage ms (CUDA events, median of 3 after a warm-up): "
          + ", ".join(f"{k} {v:.3f}" for k, v in steady.items()))
    phase(f"full width peak memory: {peak / 2**20:.1f} MiB "
          "(torch.cuda.max_memory_allocated)")
    phase(f"full width launch counts: {main_counts}")
    missing = [k for k, v in main_counts.items() if v == 0]
    if missing:
        raise AssertionError(f"main path never launched: {missing}")

    # -- phase 5: kernel vs plain on the captured main-path inputs ----------
    compare_kernels(small_calls, "composite 1,024 atoms")
    full_rows = compare_kernels(full_calls, f"full width {n} atoms")
    del g, full_calls, small_calls

    kernels = []
    for key, row in sorted(full_rows.items()):
        base = key.split("[")[0]
        source, replaces = KERNEL_SOURCES[base]
        kernels.append({"name": key, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": main_counts[count_key_of(key)], **row})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

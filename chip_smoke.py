# SPDX-License-Identifier: Apache-2.0
"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

Runs the port's paths through their public entry points, with the
hand-written CUDA kernels built from ``nvalchemiops_torch/csrc``:

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
   version, compared within a stated f32 tolerance and timed (with device
   time, bound and library call on the composite and the main path); two
   launches of the windowed spread and of the windowed gather on the main
   path's inputs must agree bit for bit (and in phase 9 two of the dense
   spread, on the batch and the fallback);
6. batched D3, dense: ``batch_dftd3`` on 128 x 2,000 atoms in 41.2 A boxes
   at 21.2 A (4 image combos) and in 27 A boxes at 9 A (minimum image),
   the systems of the JAX package's batched D3 benchmark; the router must
   pick dense; f32 forces against the port's f64 plain path on the card
   (first 2 systems at 21.2 A; at 9 A the first 4, through the dense and
   the grid engine), then dense against grid;
7. batched D3, grid: 4 x 16,000 atoms in 54 A boxes at 9 A; the router
   must pick the grid;
8. PME, dense and batched: 64 x 2,000 atoms (27 A, 32^3, E+F; auto must
   pick dense) against the windowed engine; the 1,024-atom composite
   through the dense engine against the f64 reference; the 109,744-atom
   system with a tile capacity below its occupancy, so the dense fallback
   runs at 128^3, against the phase-4 windowed forces, both against the
   dense path on the plain kernels in f64; 8 x 2,000 atoms at 64^3 on the
   windowed engine (tiles of 16);
9. kernel vs plain for the kernels of phases 6-8, as in phase 5: the 9 A
   batch (with bounds), the grid branch (cap 104) and the windowed batch
   (W = 20) right after their runs, the 21.2 A batch, the dense PME, the
   composite's dense spread (B = 1, 32^3) and the 128^3 fallback with
   bounds; the dense spread of the batch and of the fallback also under
   other slab plans;
10. the 1,024-atom composite on the other grid engines: ``grid_dftd3``
    on the super-chunk (``"block"``, kernel 8) and per-row (``"pallas"``,
    kernel 7) sweeps, ``grid_coulomb_energy_forces(engine="block")`` and
    the fused ``grid_dftd3_coulomb`` on the block and window engines, with
    and without ``combine_forces``; f32 forces against the f64 reference
    at 1.25x the JAX bars (combined forces against the sum of the two
    channels at the D3 bar);
11. the same engines at full width on phase 4's grid, against phase 4's
    window-engine D3 and Coulomb forces at the cross-engine bars, with
    bounds;
12. the voxel stencil (kernel 9) and the hybrid D3 engine on the
    110,592-atom simple-cubic crystal of the JAX package's hybrid probe
    (48^3, a = 3.0 A, 9 A, zmax-16 random tables): the stencil Coulomb and
    ``grid_dftd3(stencil=...)`` with both ``hybrid_cn`` values against the
    window engine on the row grid, and two launches of each kernel 9 call
    on its captured inputs (equal bits); then the f32 kernels against the
    port's plain path in f64 on the card on the same recipe at 13,824
    atoms.

Every drive of phases 10-12 captures its kernel calls and replays them
against their plain versions, and forbids every pair-sweep kernel off its
path.  Each replay of kernels 1, 2, 4, 7 and 8 at 109,744 atoms, at 128 x
2,000 and on the W = 20 windows, and of kernel 9 on the crystal, prints its
device time beside the parent tree's (``PARENT_DEVICE_MS``).

Each phase sets the launch counts to 0 just before it drives its path and
reads them just after; a kernel of the path that did not launch fails the
run.  The last three lines of standard output are the card's name and
power limit, the kernel table and the device record, each on a line of its
own.  Any failure raises (non-zero exit) before they are printed.  Usage:
``python3 chip_smoke.py`` from the repo root.
"""

import contextlib
import json
import math
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
# per output.  Both sum in f32 in different orders (and the pair sweeps'
# j-side sums with global atomics, in a run-dependent order; the windowed
# spread adds its slots in a fixed order, the dense spread in fixed
# point); 1e-5 is ~100 f32 ulps of the output's scale.
KERNEL_RTOL = 1e-5
NET_FORCE_RTOL = 1e-3      # |sum_i F_i| / sum_i |F_i| per stage
FULL_N_REP = 38            # 2 * 38^3 = 109,744 atoms
FULL_MESH = (128, 128, 128)
# the card's published peaks (H100 SXM, at its full 700 W power limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# the JAX package's batched benchmark configurations
# (benchmarks/benchmark_config.yaml: dftd3_batch, pme_batch)
D3_BATCH = dict(b=128, n=2000, box=27.0, cutoff=9.0, zmax=16,
                matched_box=41.2, matched_cutoff=21.2)
D3_PARAMS = (0.4, 4.2, 1.8)               # a1, a2, s8
D3_GRID = dict(b=4, n=16000, box=54.0, cutoff=9.0)
PME_BATCH = dict(b=64, n=2000, box=27.0, mesh=(32, 32, 32), alpha=0.35)
PME_WINDOWED = dict(b=8, mesh=(64, 64, 64))
REFERENCE_D3_BATCH_MS = 46.049            # BASELINE.md:32, H100, 21.2 A
# cross-engine bars (max rel, RMS rel), both engines in f32: 1.25x the
# larger of two readings of runs whose engines each met their f64 witness
# (NVIDIA H100 80GB HBM3, 700 W); 2x for the 32^3 PME batch, whose reading
# moved by 10% between the runs with the order of the spread's atomics.  Dense D3 against the grid at 9 A read 3.961e-4 /
# 4.029e-5: one pair of system 0 lies 3.7e-7 A inside the cutoff, and the
# grid's f32 r^2 rounds to exactly 81, so the grid drops it (D3 has no
# smooth cutoff).  The 128^3 PME dense fallback against the windowed path
# read 5.201e-5 / 2.367e-5, and the 64 x 2,000 dense PME against the
# windowed engine 7.424e-7 / 4.468e-7 (and 6.728e-7 / 4.444e-7).
D3_DENSE_VS_GRID_BAR = (4.95e-4, 5.04e-5)
PME_FALLBACK_VS_WINDOWED_BAR = (6.50e-5, 2.96e-5)
PME_DENSE_VS_WINDOWED_BAR = (1.49e-6, 8.94e-7)
# cross-engine bars of phases 11 and 12 (max rel, RMS rel), both engines in
# f32: the block, pallas and fused engines against phase 4's window engine
# (D3, Coulomb, and D3 + Coulomb for combine_forces), the hybrid D3 and the
# stencil Coulomb against the window engine on the crystal's row grid.
# 1.25x the largest of three readings of sound runs (rounded up; NVIDIA
# H100 80GB HBM3, 700 W): D3 6.936e-6 / 2.929e-6 (the pallas engine),
# Coulomb 2.394e-6 / 9.801e-7 (block; it read 2.210e-6 and 2.302e-6 in the
# others: the order of the atomics), combined 3.303e-6 / 1.463e-6 (window;
# 2.993e-6 twice), hybrid 1.209e-5 / 2.401e-6 (stencil CN), stencil
# Coulomb 5.864e-6 / 1.315e-6.
ENGINE_BARS = {"d3": (8.67e-6, 3.67e-6), "coulomb": (3.00e-6, 1.23e-6),
               "combined": (4.13e-6, 1.83e-6),
               "hybrid_d3": (1.52e-5, 3.01e-6),
               "stencil_coulomb": (7.33e-6, 1.65e-6)}
# the JAX package's hybrid probe system (benchmarks/hybrid_probe.py:33-71):
# jittered simple-cubic crystal from default_rng(0), zmax-16 random tables,
# a1/a2/s8 = 0.4/4.2/1.8; charges drawn after the tables; the f64 witness
# runs the same recipe at witness_n_rep
HYBRID = dict(n_rep=48, a=3.0, jitter=0.2, cutoff=9.0, alpha=0.35, zmax=16,
              witness_n_rep=24)

# device ms per call of every body of kernels 1 and 4 before their
# distance-first redesign (the parent tree's kernels), measured with
# pair_sweep_times.py on an NVIDIA H100 80GB HBM3 at 700.00 W: kernel 1 at
# 109,744 atoms, kernel 4 at 128 x 2,000 atoms; likewise kernels 8 and 2,
# and kernels 7 and 9, before their redesign (PERF.md)
PARENT_DEVICE_MS = {
    "window_sweep[cn]": 0.307, "window_sweep[d3_direct]": 1.789,
    "window_sweep[chain]": 0.515, "window_sweep[coulomb]": 0.501,
    "window_sweep[d3_direct_coulomb]": 3.597,
    "window_sweep[d3_direct_coulomb+combine]": 2.666,
    "dense_pairs[cn] 21.2 A": 2.467, "dense_pairs[direct] 21.2 A": 7.072,
    "dense_pairs[chain] 21.2 A": 2.699, "dense_pairs[cn] 9.0 A": 1.429,
    "dense_pairs[direct] 9.0 A": 8.198, "dense_pairs[chain] 9.0 A": 1.695,
    # kernels 8 and 2 before their redesign, at 109,744 atoms (and the
    # gather of the W = 20 windowed batch)
    "chunk_sweep[cn]": 0.355, "chunk_sweep[d3_direct]": 1.167,
    "chunk_sweep[chain]": 0.497, "chunk_sweep[coulomb]": 0.511,
    "chunk_sweep[d3_direct_coulomb]": 2.992,
    "windowed_gather_grad W=12": 0.1015, "windowed_gather_grad W=20": 0.0832,
    # kernel 7 at 109,744 atoms (grid_dftd3(engine="pallas")) and kernel 9
    # on the 110,592-atom crystal (48^3 voxels, radius 3)
    "row_sweep[cn]": 0.366, "row_sweep[d3_direct]": 1.166,
    "row_sweep[chain]": 0.524,
    "stencil_sweep[cn]": 0.1033, "stencil_sweep[chain]": 0.1403,
    "stencil_sweep[coulomb]": 0.1335,
}

KERNEL_SOURCES = {
    "window_sweep": ("nvalchemiops_torch/csrc/window_sweep.cu",
                     "nvalchemiops_tpu/pallas/window_sweep.py:165"),
    "windowed_spread": ("nvalchemiops_torch/csrc/windowed_gather.cu",
                        "nvalchemiops_tpu/pallas/windowed_gather.py:134"),
    "windowed_gather_grad": ("nvalchemiops_torch/csrc/windowed_gather.cu",
                             "nvalchemiops_tpu/pallas/windowed_gather.py:80"),
    "dense_pairs": ("nvalchemiops_torch/csrc/dense_pairs.cu",
                    "nvalchemiops_tpu/pallas/dense_sweep.py:64"),
    "separable_spread": ("nvalchemiops_torch/csrc/separable_spline.cu",
                         "nvalchemiops_tpu/pallas/spread.py:45"),
    "separable_gather": ("nvalchemiops_torch/csrc/separable_spline.cu",
                         "nvalchemiops_tpu/pallas/spread.py:87"),
    "row_sweep": ("nvalchemiops_torch/csrc/row_sweep.cu",
                  "nvalchemiops_tpu/pallas/row_sweep.py:89"),
    "chunk_sweep": ("nvalchemiops_torch/csrc/chunk_sweep.cu",
                    "nvalchemiops_tpu/pallas/block_sweep.py:101"),
    "stencil_sweep": ("nvalchemiops_torch/csrc/stencil_sweep.cu",
                      "nvalchemiops_tpu/pallas/stencil_sweep.py:46"),
}
# the half-space pair sweeps over the halo grid (kernels 1, 7, 8)
GRID_SWEEPS = ("window_sweep", "row_sweep", "chunk_sweep")
# launch-count prefixes of every pair-sweep kernel: a drive of phases 10-12
# forbids each one off its path
SWEEP_COUNT_PREFIXES = ("window_sweep_", "row_sweep_", "chunk_sweep_",
                        "stencil_sweep_", "dense_pairs_")

# flops per pair inside the cutoff (exp, rsqrt and a divide count as one
# operation each, a multiply-add as two), for the bound column; the
# displacement and r^2 of every visited pair count 8 more
PAIR_FLOPS = {"cn": 10, "d3_direct": 35, "chain": 20, "coulomb": 35,
              "direct": 35, "d3_direct_coulomb": 70}
DIST_FLOPS = 8


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


#: profiler runs of :func:`device_time_ms` that recorded fewer kernel
#: launches than calls, and were taken again: (busy us, launches, reps)
LOST_PROFILES = []


def device_time_ms(fn, reps=5, tries=3):
    """Device time of one call of ``fn``: the CUDA kernels (memsets
    included) that one torch.profiler run of ``reps`` calls records, summed,
    over ``reps``.  Unlike :func:`cuda_time_ms` it leaves out the time the
    card waits for the host between launches.

    Every call of ``fn`` launches at least one kernel, so a run that
    records fewer launches than calls has lost device events (one run of
    a probe did, with none at all; PERF.md section 7): it is noted in
    ``LOST_PROFILES`` and taken again, up to ``tries`` runs, and then this
    raises.  It never returns None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kern)
        launches = sum(e.count for e in kern)
        if busy > 0 and launches >= reps:
            return busy / 1e3 / reps
        LOST_PROFILES.append((busy, launches, reps))
    raise RuntimeError(f"device_time_ms: {tries} profiler runs of {reps} "
                       f"calls lost their device events: "
                       f"{LOST_PROFILES[-tries:]}")


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
    from nvalchemiops_torch import grid, spline_windowed, stencil
    from nvalchemiops_torch.interactions.dispersion import dense_d3, grid_d3
    from nvalchemiops_torch.interactions.electrostatics import pme

    cap = Capture()
    for mod in (grid, grid_d3):
        cap.wrap(mod, "window_sweep", lambda body, *a: f"window_sweep[{body}]")
        cap.wrap(mod, "chunk_sweep", lambda body, *a: f"chunk_sweep[{body}]")
    cap.wrap(grid_d3, "row_sweep", lambda body, *a: f"row_sweep[{body}]")
    cap.wrap(stencil, "stencil_sweep",
             lambda body, *a: f"stencil_sweep[{body}]")
    cap.wrap(spline_windowed, "spread_windows", lambda *a: "windowed_spread")
    cap.wrap(spline_windowed, "gather_grad_planes",
             lambda *a: "windowed_gather_grad")
    cap.wrap(dense_d3, "dense_pairs", lambda body, *a: f"dense_pairs[{body}]")
    cap.wrap(pme, "separable_spread", lambda *a: "separable_spread")
    cap.wrap(pme, "separable_gather", lambda *a: "separable_gather")
    return cap


def count_key_of(key):
    """Launch-count key of a kernel table name ("window_sweep[cn]" ->
    "window_sweep_cn")."""
    return key.replace("[", "_").rstrip("]")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def pairs_in_cutoff(n_systems, n, volume, cutoff):
    """Atom pairs (over all images) within the cutoff at the systems' mean
    density, pairs once: ``S n^2 (4 pi / 3) rc^3 / (2 V)``."""
    return n_systems * n * n * (4.0 * math.pi / 3.0) * cutoff ** 3 / (
        2.0 * volume)


def work(key, args, kwargs, out, ctx):
    """(bytes, flops) the kernel's function needs on these inputs: each
    input the function reads, read once, each output written once; pair
    work counted for the pairs these systems hold within the cutoff
    (``ctx``)."""
    base = key.split("[")[0]
    outs = out if isinstance(out, tuple) else (out,)
    reads = [*args, *kwargs.values()]
    if base == "windowed_spread":
        # the spread reads Sx | Sy | Sz; the derivative columns feed the gather
        smat, q_t, w = args
        reads = [smat[..., :3 * w], q_t]
    if base in GRID_SWEEPS:
        # the half-space windows never reach the low z halo, nor the low y
        # halo of the first interior plane; j_out is written where read
        rz, ry = args[1][0], args[1][1]
        cand, j_out, cf = args[3], outs[1], kwargs.get("cf")
        reads = [a for a in reads if a is not cand and a is not cf] + [
            cand[:, rz + 1:], cand[:, rz, ry:]]
        if cf is not None:
            # the zm-wide rows cf [.., cap, 2 zm] are [z_j == z] e_j, mostly
            # zeros: the function needs kernel 1's candidate features z,
            # e[mesh], edc[mesh] (1 + 2 mesh floats a slot), so the extra
            # traffic of the wide form shows as distance from the bound
            nk = 1 + 2 * ctx["mesh"]
            reads += [cf[rz + 1:, ..., :nk], cf[rz, ry:, ..., :nk]]
        outs = (outs[0], j_out[:, rz + 1:], j_out[:, rz, ry:])
    nbytes = _nbytes(*reads, *outs)
    if base in GRID_SWEEPS or base == "stencil_sweep":
        # every pair inside the cutoff once (the full-space stencil visits
        # each twice: that shows as distance from the bound); the D3 bodies'
        # three C6 dots have the mesh length on every engine (the zm-wide
        # dots of kernels 7 and 8 add zeros)
        body = key[len(base) + 1:-1]
        pairs = pairs_in_cutoff(1, ctx["n"], ctx["volume"], ctx["cutoff"])
        extra = 6 * ctx["mesh"] if body.startswith("d3_direct") else 0
        return nbytes, pairs * (DIST_FLOPS + PAIR_FLOPS[body] + extra)
    if base == "dense_pairs":
        body = key[len("dense_pairs["):-1]
        s, n, n_combos = ctx["systems"], ctx["n"], ctx["combos"]
        visited = s * n * (n - 1) / 2 * n_combos
        pairs = pairs_in_cutoff(s, n, ctx["volume"], ctx["cutoff"])
        extra = 6 * ctx["mesh"] if body == "direct" else 0
        return nbytes, (visited * DIST_FLOPS
                        + pairs * (PAIR_FLOPS[body] + extra))
    o3 = ctx["order"] ** 3
    if base in ("windowed_spread", "separable_spread"):
        return nbytes, ctx["atoms"] * o3 * 3
    if base == "windowed_gather_grad":
        return nbytes, ctx["atoms"] * o3 * 8
    if base == "separable_gather":
        with_grad = len(args) > 3 and args[3] is not None
        return nbytes, ctx["atoms"] * o3 * (8 if with_grad else 2)
    raise KeyError(key)


def library_call(key, args):
    """One PyTorch call that computes the kernel's function on the same
    inputs (operands rearranged beforehand, untimed), or None."""
    base = key.split("[")[0]
    if base == "windowed_spread":
        smat, q_t, w = args
        sx, sy, sz = (smat[..., k * w:(k + 1) * w] for k in range(3))
        qsz = q_t[..., None] * sz
        tyx = (sy[..., :, None] * sx[..., None, :]).flatten(-2)
        return lambda: torch.einsum("tcz,tcm->tzm", qsz, tyx)
    if base == "windowed_gather_grad":
        smat, win, w = args
        sx, sy, sz, dsx, dsy, dsz = (smat[..., k * w:(k + 1) * w]
                                     for k in range(6))

        def tyx(a, b):
            return (a[..., :, None] * b[..., None, :]).flatten(-2)

        p = torch.stack([tyx(sy, sx), tyx(sy, dsx), tyx(dsy, sx),
                         tyx(sy, sx)], dim=2)            # [t, c, 4, W^2]
        z = torch.stack([sz, sz, sz, dsz], dim=2)         # [t, c, 4, W]
        return lambda: torch.einsum("tckm,tzm,tckz->tck", p, win, z)
    if base.startswith("separable"):
        if base == "separable_spread":
            gidx, w, q, dims = args
            b = q.shape[0]
        else:
            mesh, gidx, w = args[:3]
            b, dims = mesh.shape[0], tuple(mesh.shape[1:])
        nx, ny, nz = (int(d) for d in dims)
        o = w.shape[-1]
        g = gidx.long()
        sys_id = torch.arange(b, device=w.device).reshape(b, 1, 1, 1, 1)
        flat = (((sys_id * nx + g[:, :, 0, :, None, None]) * ny
                 + g[:, :, 1, None, :, None]) * nz
                + g[:, :, 2, None, None, :]).reshape(-1, o ** 3)

        def wxyz(wx, wy, wz):
            return (wx[..., :, None, None] * wy[..., None, :, None]
                    * wz[..., None, None, :]).reshape(-1, o ** 3)

        if base == "separable_spread":
            vals = (q.reshape(-1, 1) * wxyz(w[:, :, 0], w[:, :, 1],
                                            w[:, :, 2])).reshape(-1)
            idx = flat.reshape(-1)
            total = b * nx * ny * nz
            return lambda: torch.zeros(total, dtype=w.dtype,
                                       device=w.device).index_add_(
                                           0, idx, vals)
        dw = args[3] if len(args) > 3 else None
        sets = [(w[:, :, 0], w[:, :, 1], w[:, :, 2])]
        if dw is not None:
            sets += [(dw[:, :, 0], w[:, :, 1], w[:, :, 2]),
                     (w[:, :, 0], dw[:, :, 1], w[:, :, 2]),
                     (w[:, :, 0], w[:, :, 1], dw[:, :, 2])]
        weights = torch.cat([wxyz(*s) for s in sets])
        idx = flat.repeat(len(sets), 1)
        table = mesh.reshape(-1, 1)
        return lambda: torch.nn.functional.embedding_bag(
            idx, table, per_sample_weights=weights, mode="sum")
    return None


def parent_key(key, args, ctx):
    """Key of ``PARENT_DEVICE_MS`` for a replay: kernel 1's fused body names
    its force mode, the dense sweep its cutoff, the gather its window."""
    if key == "window_sweep[d3_direct_coulomb]" and args[4].combine_forces:
        return "window_sweep[d3_direct_coulomb+combine]"
    if key.startswith("dense_pairs"):
        return f"{key} {ctx['cutoff']} A"
    if key == "windowed_gather_grad":
        return f"{key} W={args[2]}"
    return key


def compare_kernels(calls, label, ctx=None):
    """Replay each captured call through kernel and plain version; with
    ``ctx`` also time the library call and compute the bound, and with
    ``ctx["parent"]`` (True, or the kernels whose parent times were read
    at this shape) print the parent tree's device time of the kernels
    redesigned since (``PARENT_DEVICE_MS``) beside their own."""
    from nvalchemiops_torch.kernels import chunk_sweep as cs
    from nvalchemiops_torch.kernels import dense_pairs as ds
    from nvalchemiops_torch.kernels import launch_counts
    from nvalchemiops_torch.kernels import row_sweep as rs
    from nvalchemiops_torch.kernels import separable_spline as ss
    from nvalchemiops_torch.kernels import stencil_sweep as st
    from nvalchemiops_torch.kernels import window_sweep as ws
    from nvalchemiops_torch.kernels import windowed_gather as wg

    pairs = {
        "window_sweep": (ws.window_sweep, ws.window_sweep_plain),
        "windowed_spread": (wg.spread_windows, wg.spread_windows_plain),
        "windowed_gather_grad": (wg.gather_grad_planes,
                                 wg.gather_grad_planes_plain),
        "dense_pairs": (ds.dense_pairs, ds.dense_pairs_plain),
        "separable_spread": (ss.separable_spread, ss.separable_spread_plain),
        "separable_gather": (ss.separable_gather, ss.separable_gather_plain),
        "row_sweep": (rs.row_sweep, rs.row_sweep_plain),
        "chunk_sweep": (cs.chunk_sweep, cs.chunk_sweep_plain),
        "stencil_sweep": (st.stencil_sweep, st.stencil_sweep_plain),
    }
    rows = {}
    for key, (args, kwargs) in sorted(calls.items()):
        base = key.split("[")[0]
        kern, plain = pairs[base]
        count_key = count_key_of(key)
        before = launch_counts[count_key]
        out_k = kern(*args, **kwargs)
        if launch_counts[count_key] != before + 1:
            raise AssertionError(f"{label} {key}: launch count did not move")
        out_p = plain(*args, **kwargs)
        torch.cuda.synchronize()
        # the pair sweeps return stacked planes: each plane on its own scale
        split = base in GRID_SWEEPS + ("dense_pairs", "stencil_sweep")
        out_k = out_k if isinstance(out_k, tuple) else (out_k,)
        out_p = out_p if isinstance(out_p, tuple) else (out_p,)
        max_abs, worst_rel = 0.0, 0.0
        for tk, tp in zip(out_k, out_p):
            for a, b in zip(tk if split else [tk], tp if split else [tp]):
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
        shape = tuple(next(a for a in args
                           if isinstance(a, torch.Tensor)).shape)
        row = {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}
        msg = (f"{label} {key}: input {shape} max_abs_err {max_abs:.3e} "
               f"(rel {worst_rel:.2e}) kernel {ms:.4f} ms plain "
               f"{plain_ms:.4f} ms")
        if ctx is not None:
            nbytes, flops = work(key, args, kwargs, out_k if len(out_k) > 1
                                 else out_k[0], ctx)
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FP32_PER_S * 1e3
            lib = library_call(key, args)
            row["bound_ms"] = max(t_bytes, t_ops)
            row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            row["library_ms"] = cuda_time_ms(lib) if lib else None
            row["device_ms"] = device_time_ms(lambda: kern(*args, **kwargs))
            row["library_device_ms"] = device_time_ms(lib) if lib else None
            parent = PARENT_DEVICE_MS.get(parent_key(key, args, ctx))
            msg += f" (device {row['device_ms']} ms"
            wanted = ctx.get("parent")
            if parent is not None and (wanted is True or wanted
                                       and base in wanted):
                msg += f"; parent tree {parent} ms"
            msg += (f") library "
                    f"{row['library_ms']} ms (device "
                    f"{row['library_device_ms']} ms) bound "
                    f"{row['bound_ms']:.4f} ms ({row['bound_by']}: "
                    f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        phase(msg)
        rows[key] = row
    return rows


def check_deterministic(calls, label, key="windowed_spread"):
    """Two launches of a kernel on the captured inputs give the same bits:
    the windowed spread and gather have one writer per output adding in a
    fixed order, the dense spread sums in fixed point, and the voxel
    stencil writes each output once, its slices added in a fixed order."""
    from nvalchemiops_torch.kernels.separable_spline import separable_spread
    from nvalchemiops_torch.kernels.stencil_sweep import stencil_sweep
    from nvalchemiops_torch.kernels.windowed_gather import (
        gather_grad_planes, spread_windows,
    )

    kern = {"windowed_spread": spread_windows,
            "windowed_gather_grad": gather_grad_planes,
            "separable_spread": separable_spread,
            "stencil_sweep": stencil_sweep}[key.split("[")[0]]
    args, kwargs = calls[key]
    first = kern(*args, **kwargs)
    second = kern(*args, **kwargs)
    torch.cuda.synchronize()
    first = first if isinstance(first, tuple) else (first,)
    second = second if isinstance(second, tuple) else (second,)
    for a, b in zip(first, second):
        if not torch.equal(a, b):
            diff = (a - b).abs().max().item()
            raise AssertionError(f"{label}: two launches differ (max "
                                 f"{diff:.3e})")
    phase(f"{label}: two launches bitwise equal")


def spread_plan_variants(calls, label):
    """The dense spread on its captured inputs under the slab plan and
    under the thickest slabs that fit (fewest blocks), each against the
    plain version and timed (CUDA events and device time): the measurement
    behind ``spread_plan``'s thin slabs."""
    from nvalchemiops_torch.kernels import separable_spline as ss

    args, kwargs = calls["separable_spread"]
    gidx, w, q, dims = args
    b, n, _, order = w.shape
    want = ss.separable_spread_plain(*args, **kwargs)
    scale = want.double().abs().max().item()
    plans = {"plan": ss.spread_plan(dims, order, b),
             "thickest slabs": ss.spread_plan(dims, order, b, n_sm=1)}
    for name, plan in plans.items():
        with plain_kernels(ss, spread_plan=lambda *a, _p=plan, **k: _p):
            got = ss.separable_spread(*args, **kwargs)
            torch.cuda.synchronize()
            err = (got.double() - want.double()).abs().max().item()
            if not err <= KERNEL_RTOL * scale:
                raise AssertionError(f"{label} spread plan {name}: max abs "
                                     f"err {err:.3e} vs scale {scale:.3e}")
            ms = cuda_time_ms(lambda: ss.separable_spread(*args, **kwargs))
            dev_ms = device_time_ms(
                lambda: ss.separable_spread(*args, **kwargs))
        phase(f"{label} dense spread under plan '{name}' (planes "
              f"{plan.planes}, rows {plan.rows}, {plan.blocks} blocks, "
              f"{plan.smem_bytes} B shared): kernel {ms:.4f} ms (device "
              f"{dev_ms} ms), max_abs_err {err:.3e}")


def profile_step(label, fn, top=6):
    """Host wall (synchronized, median of 3 after a warm-up), device busy
    time (the sum of CUDA kernel times in one torch.profiler run), the idle
    share and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    launches = sum(e.count for e in kern)
    if busy == 0.0:
        phase(f"profile {label}: host wall {wall:.3f} ms; device time not "
              "measured (the profiler saw no kernel time)")
        return
    kern.sort(key=lambda e: -e.self_device_time_total)
    tops = "; ".join(f"{e.key[:60]} x{e.count} "
                     f"{e.self_device_time_total / 1e3:.3f} ms"
                     for e in kern[:top])
    phase(f"profile {label}: host wall {wall:.3f} ms (synchronized, median "
          f"of 3), device busy {busy:.3f} ms, idle share "
          f"{1.0 - busy / wall:.3f}, {launches} kernel launches; "
          f"top: {tops}")


def check_forces(name, forces):
    if not torch.isfinite(forces).all():
        raise AssertionError(f"{name}: non-finite forces")
    net = forces.double().sum(-2).abs().max().item()
    l1 = forces.double().abs().sum(-1).sum(-1).min().item()
    if net > NET_FORCE_RTOL * l1:
        raise AssertionError(f"{name}: net force {net:.3e} vs sum |F| {l1:.3e}")
    return net / l1


def force_errors(forces, ref):
    """(max rel, RMS rel) of ``forces`` against ``ref`` (both tensors)."""
    f, r = forces.double(), ref.double()
    rel = ((f - r).abs().max() / r.abs().max()).item()
    rms = (torch.sqrt(((f - r) ** 2).mean())
           / torch.sqrt((r ** 2).mean())).item()
    return rel, rms


@contextlib.contextmanager
def plain_kernels(module, **plain):
    """Route ``module``'s kernel wrappers to their plain versions, which run
    in any dtype: the f64 witnesses."""
    saved = {k: getattr(module, k) for k in plain}
    for k, v in plain.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


def check_errors(name, forces, ref, bar):
    """Print and check the (max rel, RMS rel) force errors against a
    ``(max, rms)`` bar."""
    rel, rms = force_errors(forces, ref)
    phase(f"{name}: max rel {rel:.3e} (bar {bar[0]:.3e}), rms rel {rms:.3e} "
          f"(bar {bar[1]:.3e})")
    if not (rel <= bar[0] and rms <= bar[1]):
        raise AssertionError(f"{name}: above its bar")
    return rel, rms


def drive(name, fn, expect, forbid=()):
    """Counts to 0, run ``fn`` once (CUDA-event timed, peak memory), read
    the counts; fail unless every kernel in ``expect`` launched and none in
    ``forbid`` did."""
    from nvalchemiops_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    counts = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k in expect if not counts[k]]
    wrong = [k for k in forbid if counts[k]]
    if missing or wrong:
        raise AssertionError(f"{name}: kernels not launched {missing}, "
                             f"launched off the path {wrong}: {counts}")
    phase(f"{name}: first call {a.elapsed_time(b):.3f} ms (CUDA events), "
          f"peak memory {peak / 2**20:.1f} MiB, launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    return out, counts


def d3_batch_system(dev):
    """The JAX package's batched D3 benchmark system (run_benchmarks.py
    bench_dftd3_batch): numpy ``default_rng(4)``, zmax-16 random tables,
    positions in 27 A boxes, element ids, then positions in 41.2 A boxes;
    then (drawn after those) the 4 x 16,000-atom grid-branch batch."""
    cfg = D3_BATCH
    rng = np.random.default_rng(4)
    zmax, b, n = cfg["zmax"], cfg["b"], cfg["n"]
    rcov = np.r_[0, rng.uniform(0.6, 1.2, zmax)]
    r4r2 = np.r_[0, rng.uniform(2, 5, zmax)]
    cna = np.vstack([np.zeros(5),
                     np.cumsum(rng.uniform(0.3, 1, (zmax, 5)), 1)])
    c6 = rng.uniform(5, 40, (zmax + 1, zmax + 1, 5, 5))
    c6[0] = 0
    c6[:, 0] = 0
    c6 = 0.5 * (c6 + np.swapaxes(np.swapaxes(c6, 0, 1), 2, 3))
    pos = rng.uniform(0, cfg["box"], (b, n, 3))
    numbers = rng.integers(1, zmax + 1, (b, n)).astype(np.int32)
    pos_m = rng.uniform(0, cfg["matched_box"], (b, n, 3))
    g = D3_GRID
    pos_g = rng.uniform(0, g["box"], (g["b"], g["n"], 3))
    numbers_g = rng.integers(1, zmax + 1, (g["b"], g["n"])).astype(np.int32)
    tables = tuple(np.asarray(t, np.float32) for t in (rcov, r4r2, c6, cna))

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    return tables, f32(pos), numbers, f32(pos_m), f32(pos_g), numbers_g


def run_batched_d3(dev):
    """Phases 6 and 7; returns the dense capture, counts and bound
    context."""
    from nvalchemiops_torch.interactions.dispersion import dense_d3
    from nvalchemiops_torch.interactions.dispersion.dense_d3 import (
        _image_combos, batch_dense_dftd3, batch_dftd3, batch_route,
    )
    from nvalchemiops_torch.interactions.dispersion.grid_d3 import (
        batch_grid_dftd3,
    )
    from nvalchemiops_torch.kernels.dense_pairs import dense_pairs_plain
    from nvalchemiops_torch.grid import (
        batch_build_atom_grid, estimate_grid_geometry,
    )

    cfg = D3_BATCH
    tables, pos, numbers, pos_m, pos_g, numbers_g = d3_batch_system(dev)
    a1, a2, s8 = D3_PARAMS
    pbc = np.array([True] * 3)
    dense_keys = ["dense_pairs_cn", "dense_pairs_direct", "dense_pairs_chain"]
    grid_keys = ["window_sweep_cn", "window_sweep_d3_direct",
                 "window_sweep_chain"]
    d3_bar = tuple(BAR_FACTOR * v for v in JAX_F32_BARS["d3"])

    def f64_witness(p, cell_, cut_):
        """Forces of the port's dense D3 on the plain sweep in f64."""
        with plain_kernels(dense_d3, dense_pairs=dense_pairs_plain):
            return batch_dense_dftd3(
                p.double(), numbers[:len(p)], cell_.double(), cut_,
                *(t.astype(np.float64) for t in tables), a1, a2, s8)[1]

    # -- 21.2 A in 41.2 A boxes: 4 image combos --------------------------
    box, cut = cfg["matched_box"], cfg["matched_cutoff"]
    cell = torch.eye(3, device=dev) * box
    combos = _image_combos(True, np.eye(3) * box, cut)
    if batch_route(np.eye(3) * box, pbc, cut, cfg["n"]) != "dense" or \
            len(combos) != 4:
        raise AssertionError(f"21.2 A batch: route or combos wrong {combos}")

    def run_m():
        return batch_dftd3(pos_m, numbers, cell, pbc, cut, *tables, a1, a2,
                           s8)

    capture = install_capture()
    (e_m, f_m, cn_m), counts_m = drive(
        f"batched D3 {cfg['b']} x {cfg['n']} at {cut} A", run_m, dense_keys,
        forbid=grid_keys)
    capture.restore()
    for name, t in (("energy", e_m), ("cn", cn_m)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"21.2 A batch: non-finite {name}")
    frac = check_forces("21.2 A batch", f_m)
    steady = cuda_time_ms(run_m, reps=3)
    profile_step("batched D3 21.2 A", run_m)
    phase(f"batched D3 21.2 A: steady {steady:.3f} ms (CUDA events, median "
          f"of 3; the reference library's published H100 row is "
          f"{REFERENCE_D3_BATCH_MS} ms, a loose comparison point), net "
          f"force / sum|F| {frac:.2e}, energy[0] {e_m[0].item():.6e}")
    # f32 kernel path against the f64 plain path on the card
    check_errors("batched D3 21.2 A accuracy (f32 kernels vs f64 plain, "
                 "first 2 systems)", f_m[:2], f64_witness(pos_m[:2], cell, cut),
                 d3_bar)

    # -- 9 A in 27 A boxes: minimum image --------------------------------
    box9, cut9 = cfg["box"], cfg["cutoff"]
    cell9 = torch.eye(3, device=dev) * box9
    if batch_route(np.eye(3) * box9, pbc, cut9, cfg["n"]) != "dense":
        raise AssertionError("9 A batch: router did not pick dense")

    def run_9():
        return batch_dftd3(pos, numbers, cell9, pbc, cut9, *tables, a1, a2,
                           s8)

    label9 = f"batched D3 {cfg['b']} x {cfg['n']} at {cut9} A"
    capture9 = install_capture()
    (e_9, f_9, _), _ = drive(label9, run_9, dense_keys, forbid=grid_keys)
    capture9.restore()
    ctx9 = {"systems": cfg["b"], "n": cfg["n"], "volume": box9 ** 3,
            "cutoff": cut9, "combos": 1, "mesh": tables[3].shape[1],
            "parent": True}
    compare_kernels(capture9.calls, label9, ctx9)
    del capture9
    frac9 = check_forces("9 A batch", f_9)
    steady9 = cuda_time_ms(run_9, reps=3)
    profile_step("batched D3 9 A", run_9)
    phase(f"batched D3 9 A: steady {steady9:.3f} ms, net force / sum|F| "
          f"{frac9:.2e}")
    # each engine against the f64 plain witness, then dense against grid
    _, f_g4, _ = batch_grid_dftd3(pos[:4], numbers[:4], cell9, pbc, cut9,
                                  *tables, a1, a2, s8)
    f_w9 = f64_witness(pos[:4], cell9, cut9)
    check_errors("batched D3 9 A dense f32 vs f64 plain (first 4 systems)",
                 f_9[:4], f_w9, d3_bar)
    check_errors("batched D3 9 A grid f32 vs f64 plain (first 4 systems)",
                 f_g4, f_w9, d3_bar)
    check_errors("batched D3 9 A dense vs grid (first 4 systems)", f_9[:4],
                 f_g4, D3_DENSE_VS_GRID_BAR)

    # -- grid branch: 4 x 16,000 atoms in 54 A boxes ---------------------
    g = D3_GRID
    cell_g = torch.eye(3, device=dev) * g["box"]
    if batch_route(np.eye(3) * g["box"], pbc, g["cutoff"], g["n"]) != "grid":
        raise AssertionError("16,000-atom batch: router did not pick grid")
    dims, radius, _ = estimate_grid_geometry(np.eye(3) * g["box"], pbc,
                                             g["cutoff"], g["n"])
    occ = int(batch_build_atom_grid(pos_g, cell_g, pbc, dims, radius,
                                    8).counts_max.max())
    gcap = int(np.ceil((occ + 2) / 8)) * 8

    def run_g():
        return batch_dftd3(pos_g, numbers_g, cell_g, pbc, g["cutoff"],
                           *tables, a1, a2, s8, cap=gcap)

    label_g = (f"batched D3 grid branch {g['b']} x {g['n']} at "
               f"{g['cutoff']} A (dims {dims}, cap {gcap}, observed "
               f"occupancy {occ})")
    capture_g = install_capture()
    (e_g, f_g, _), _ = drive(label_g, run_g, grid_keys, forbid=dense_keys)
    capture_g.restore()
    compare_kernels(capture_g.calls, f"batched D3 grid branch cap {gcap}")
    del capture_g
    if not torch.isfinite(e_g).all():
        raise AssertionError("grid branch: non-finite energy")
    fracg = check_forces("grid branch", f_g)
    phase(f"batched D3 grid branch: steady {cuda_time_ms(run_g, reps=3):.3f}"
          f" ms, net force / sum|F| {fracg:.2e}")
    ctx = {"systems": cfg["b"], "n": cfg["n"], "volume": box ** 3,
           "cutoff": cut, "combos": len(combos), "mesh": tables[3].shape[1],
           "parent": True}
    return capture.calls, counts_m, ctx


def pme_batch_system(dev):
    """The JAX package's batched PME benchmark system (run_benchmarks.py
    bench_pme_batch): numpy ``default_rng(5)``, positions then normal
    charges; returns ``(positions [B, n, 3], charges [B, n], cell)``."""
    cfg = PME_BATCH
    rng = np.random.default_rng(5)
    b, n = cfg["b"], cfg["n"]
    pos = torch.as_tensor(rng.uniform(0, cfg["box"], (b * n, 3)),
                          dtype=torch.float32, device=dev).reshape(b, n, 3)
    q = torch.as_tensor(rng.normal(size=b * n), dtype=torch.float32,
                        device=dev).reshape(b, n)
    return pos, q, torch.eye(3, device=dev) * cfg["box"]


def run_pme(dev, f_p_full, pme_err, full_inputs):
    """Phase 8; returns the dense and fallback captures, counts, contexts,
    and the composite's dense spread call with its context."""
    from nvalchemiops_torch import composite
    from nvalchemiops_torch.interactions.electrostatics import pme
    from nvalchemiops_torch.interactions.electrostatics.pme import (
        batch_pme_reciprocal, pme_reciprocal_space,
    )
    from nvalchemiops_torch.kernels.separable_spline import (
        separable_gather_plain, separable_spread_plain,
    )

    cfg = PME_BATCH
    win_keys = ["windowed_spread", "windowed_gather_grad"]
    dense_keys = ["separable_spread", "separable_gather"]
    b, n = cfg["b"], cfg["n"]
    pos, q, cell = pme_batch_system(dev)

    def run_dense():
        return batch_pme_reciprocal(pos, q, cell, cfg["alpha"], cfg["mesh"],
                                    compute_forces=True)

    capture = install_capture()
    (e_d, f_d), counts = drive(
        f"batched PME {b} x {n} at {cfg['mesh'][0]}^3 (auto engine)",
        run_dense, dense_keys, forbid=win_keys)
    capture.restore()
    dense_calls = capture.calls
    if not (torch.isfinite(e_d).all() and torch.isfinite(f_d).all()):
        raise AssertionError("batched PME: non-finite outputs")
    steady = cuda_time_ms(run_dense, reps=3)
    profile_step("batched PME dense E+F", run_dense)
    e_w, f_w = batch_pme_reciprocal(pos, q, cell, cfg["alpha"], cfg["mesh"],
                                    compute_forces=True, engine="windowed")
    phase(f"batched PME dense: steady {steady:.3f} ms (E+F, CUDA events); "
          f"energies dense vs windowed max |diff| "
          f"{(e_d - e_w).abs().max().item():.3e}")
    check_errors("batched PME dense vs windowed forces", f_d, f_w,
                 PME_DENSE_VS_WINDOWED_BAR)

    # -- the 1,024-atom composite through the dense engine ----------------
    pos_c, cell_c, _, charges, *_ = composite.build_system()
    ref = composite.load_reference()
    capture = install_capture()
    (_, f_c), _ = drive(
        "composite PME on the dense engine (B = 1)",
        lambda: batch_pme_reciprocal(
            torch.as_tensor(pos_c, dtype=torch.float32, device=dev)[None],
            torch.as_tensor(charges, dtype=torch.float32, device=dev)[None],
            torch.as_tensor(cell_c, dtype=torch.float32, device=dev),
            composite.ALPHA, composite.MESH, compute_forces=True,
            engine="dense"), dense_keys, forbid=win_keys)
    capture.restore()
    composite_calls = {k: v for k, v in capture.calls.items()
                       if k == "separable_spread"}
    forces = {"pme": f_c[0].double().cpu().numpy()}
    rel_c = composite.relative_errors(forces, ref)["pme"]
    rms_c = composite.rms_errors(forces, ref)["pme"]
    bar_c = (BAR_FACTOR * pme_err[0], BAR_FACTOR * pme_err[1])
    phase(f"composite PME dense engine vs f64 reference: max rel {rel_c:.3e}"
          f" (bar {bar_c[0]:.3e} = 1.25 x windowed {pme_err[0]:.3e}), rms "
          f"rel {rms_c:.3e} (bar {bar_c[1]:.3e})")
    if not (rel_c <= bar_c[0] and rms_c <= bar_c[1]):
        raise AssertionError("composite PME dense engine above its bar")

    # -- 128^3 fallback: tile capacity below the occupancy ---------------
    pos_f, q_f, cell_f, alpha_f = full_inputs
    capture = install_capture()
    (_, f_fb), counts_fb = drive(
        "PME 128^3 tile-overflow fallback (tile capacity 1)",
        lambda: pme_reciprocal_space(pos_f, q_f, cell_f, alpha_f,
                                     mesh_dimensions=FULL_MESH,
                                     compute_forces=True, tile_capacity=1),
        dense_keys, forbid=win_keys)
    capture.restore()
    fallback_calls = capture.calls
    # both f32 engines against the dense path on the plain kernels in f64:
    # the fallback within 1.25x the windowed engine's own error, then the
    # two against each other
    with plain_kernels(pme, separable_spread=separable_spread_plain,
                       separable_gather=separable_gather_plain):
        _, f_fb64 = pme_reciprocal_space(
            pos_f.double(), q_f.double(), cell_f.double(), alpha_f,
            mesh_dimensions=FULL_MESH, compute_forces=True, tile_capacity=1)
    err_w = check_errors("PME 128^3 windowed f32 vs f64 plain dense", f_p_full,
                         f_fb64, (math.inf, math.inf))
    check_errors("PME 128^3 fallback f32 vs f64 plain dense", f_fb, f_fb64,
                 tuple(BAR_FACTOR * v for v in err_w))
    check_errors("PME 128^3 fallback vs phase-4 windowed forces", f_fb,
                 f_p_full, PME_FALLBACK_VS_WINDOWED_BAR)
    del f_fb64

    # -- windowed engine: 8 x 2,000 atoms at 64^3 ------------------------
    bw, mesh_w = PME_WINDOWED["b"], PME_WINDOWED["mesh"]
    label_w = f"batched PME windowed {bw} x {n} at {mesh_w[0]}^3"
    capture = install_capture()
    (e_w8, f_w8), counts_w = drive(
        label_w,
        lambda: batch_pme_reciprocal(pos[:bw], q[:bw], cell, cfg["alpha"],
                                     mesh_w, compute_forces=True,
                                     engine="windowed"),
        win_keys, forbid=dense_keys)
    capture.restore()
    compare_kernels(capture.calls, f"{label_w} (tile 16, W = 20)",
                    {"atoms": n, "order": 4, "parent": True})
    if counts_w["windowed_spread"] != bw:
        raise AssertionError(f"windowed batch: {counts_w}")
    check_forces("windowed batch", f_w8)
    ctx = {"atoms": b * n, "order": 4}
    ctx_fb = {"atoms": pos_f.shape[0], "order": 4}
    ctx_c = {"atoms": pos_c.shape[0], "order": 4}
    return (dense_calls, counts, ctx, fallback_calls, ctx_fb,
            (composite_calls, ctx_c))


def off_path(expect):
    """Every pair-sweep launch count outside ``expect``."""
    from nvalchemiops_torch.kernels import launch_counts

    return [k for k in launch_counts
            if k.startswith(SWEEP_COUNT_PREFIXES) and k not in expect]


def drive_and_replay(label, fn, expect, ctx=None, profile=False,
                     deterministic=()):
    """One drive of phases 10-12: ``fn`` returns a dict of output tensors
    (force channels named ``d3``, ``coulomb`` or ``combined``); the launch
    counts must show ``expect`` and no other pair sweep.  Checks finite
    outputs and the net force, prints the steady time (and with
    ``profile`` the device busy time and idle share), replays every
    captured kernel call against its plain version and launches each
    kernel named in ``deterministic`` twice on its captured inputs (equal
    bits).  Returns ``(out, counts, rows)``."""
    capture = install_capture()
    out, counts = drive(label, fn, expect, forbid=off_path(expect))
    capture.restore()
    for name, t in out.items():
        if not torch.isfinite(t).all():
            raise AssertionError(f"{label}: non-finite {name}")
    nets = {ch: check_forces(f"{label} {ch}", out[ch])
            for ch in ("d3", "coulomb", "combined") if ch in out}
    phase(f"{label}: steady {cuda_time_ms(fn, reps=3):.3f} ms (CUDA events, "
          f"median of 3 after a warm-up), net force / sum|F| "
          + ", ".join(f"{k} {v:.2e}" for k, v in nets.items()))
    if profile:
        profile_step(label, fn)
    rows = compare_kernels(capture.calls, label, ctx)
    for key in deterministic:
        check_deterministic(capture.calls, f"{label} {key}", key)
    return out, counts, rows


def keep_rows(table, rows, counts):
    """Add each kernel row not yet in ``table`` with its drive's launches."""
    for key, row in rows.items():
        table.setdefault(key, (row, counts[count_key_of(key)]))


def engine_runs(g, d3_args, q, alpha):
    """``(label, fn, expect)`` of the other grid engines on grid ``g``: the
    D3 engines, the block Coulomb and the fused D3 + Coulomb sweep (its
    Coulomb cutoff is the D3 cutoff)."""
    from nvalchemiops_torch.grid import grid_coulomb_energy_forces
    from nvalchemiops_torch.interactions.dispersion.grid_d3 import (
        grid_dftd3, grid_dftd3_coulomb,
    )

    def d3(engine):
        def fn():
            e, f, cn = grid_dftd3(g, *d3_args, engine=engine)
            return {"energy": e, "cn": cn, "d3": f}
        return fn

    def coulomb():
        e, f = grid_coulomb_energy_forces(g, q, d3_args[5], alpha,
                                          engine="block")
        return {"energy": e, "coulomb": f}

    def fused(combine, **engine):
        def fn():
            e, f, cn, ec, fc = grid_dftd3_coulomb(
                g, d3_args[0], q, *d3_args[1:], coulomb_cutoff=d3_args[5],
                alpha=alpha, combine_forces=combine, **engine)
            if combine:
                return {"energy": e, "cn": cn, "ec": ec, "combined": f}
            return {"energy": e, "cn": cn, "ec": ec, "d3": f, "coulomb": fc}
        return fn

    def passes(kernel, direct):
        return [f"{kernel}_cn", f"{kernel}_{direct}", f"{kernel}_chain"]

    return [
        ("grid_dftd3(engine='block')", d3("block"),
         passes("chunk_sweep", "d3_direct")),
        ("grid_dftd3(engine='pallas')", d3("pallas"),
         passes("row_sweep", "d3_direct")),
        ("grid_coulomb_energy_forces(engine='block')", coulomb,
         ["chunk_sweep_coulomb"]),
        ("grid_dftd3_coulomb() [block]", fused(False),
         passes("chunk_sweep", "d3_direct_coulomb")),
        ("grid_dftd3_coulomb(combine_forces=True) [block]", fused(True),
         passes("chunk_sweep", "d3_direct_coulomb")),
        ("grid_dftd3_coulomb(engine='window')", fused(False, engine="window"),
         passes("window_sweep", "d3_direct_coulomb")),
        ("grid_dftd3_coulomb(engine='window', combine_forces=True)",
         fused(True, engine="window"),
         passes("window_sweep", "d3_direct_coulomb")),
    ]


def run_engines(label, g, d3_args, q, alpha, refs, ref_label, bars,
                ctx=None):
    """Phases 10 and 11: each engine of :func:`engine_runs` driven and
    replayed, its force channels held to ``refs`` (named ``ref_label``) at
    ``bars``, ``combined`` against the sum of the D3 and Coulomb
    references.  Returns the kernel rows with their launches."""
    table = {}
    refs = dict(refs, combined=refs["d3"] + refs["coulomb"])
    for name, fn, expect in engine_runs(g, d3_args, q, alpha):
        out, counts, rows = drive_and_replay(f"{label} {name}", fn, expect,
                                             ctx, profile=ctx is not None)
        for ch in ("d3", "coulomb", "combined"):
            if ch in out:
                check_errors(f"{label} {name} {ch} forces vs {ref_label}",
                             out[ch], refs[ch], bars[ch])
        keep_rows(table, rows, counts)
    return table


def hybrid_system(n_rep):
    """benchmarks/hybrid_probe.py:33-71 in numpy: the jittered crystal,
    element ids and zmax-16 tables from ``default_rng(0)``, then normal
    charges.  Returns ``(pos, cell, numbers, charges, tables)``."""
    cfg = HYBRID
    rng = np.random.default_rng(0)
    zmax = cfg["zmax"]
    pts = np.stack(np.meshgrid(*([np.arange(n_rep)] * 3), indexing="ij"),
                   -1).reshape(-1, 3) * cfg["a"]
    pos = pts + rng.uniform(-cfg["jitter"], cfg["jitter"], pts.shape)
    n = pos.shape[0]
    numbers = rng.integers(1, zmax + 1, n).astype(np.int32)
    rcov = np.r_[0.0, rng.uniform(0.6, 1.2, zmax)]
    r4r2 = np.r_[0.0, rng.uniform(2.0, 5.0, zmax)]
    cna = np.vstack([np.zeros(5),
                     np.cumsum(rng.uniform(0.3, 1.0, (zmax, 5)), 1)])
    c6 = rng.uniform(5.0, 40.0, (zmax + 1, zmax + 1, 5, 5))
    c6[0] = 0.0
    c6[:, 0] = 0.0
    c6 = 0.5 * (c6 + np.swapaxes(np.swapaxes(c6, 0, 1), 2, 3))
    charges = rng.normal(size=n)
    return (pos, np.eye(3) * (n_rep * cfg["a"]), numbers, charges,
            (rcov, r4r2, c6, cna))


def run_stencil(dev):
    """Phase 12; returns the kernel rows with their launches."""
    from nvalchemiops_torch import composite, stencil
    from nvalchemiops_torch.grid import grid_coulomb_energy_forces
    from nvalchemiops_torch.interactions.dispersion import grid_d3
    from nvalchemiops_torch.interactions.dispersion.grid_d3 import grid_dftd3
    from nvalchemiops_torch.kernels.stencil_sweep import stencil_sweep_plain
    from nvalchemiops_torch.kernels.window_sweep import window_sweep_plain

    cfg = HYBRID
    cutoff, alpha = cfg["cutoff"], cfg["alpha"]
    a1, a2, s8 = D3_PARAMS
    pbc = np.array([True] * 3)

    def setup(n_rep, dtype):
        """The system on the card in ``dtype``, from its f32 values: the
        f64 witness widens the f32 inputs, so it measures the kernels'
        arithmetic.  (At 9 A = 3a the (3, 0, 0) shell straddles D3's hard
        cutoff; positions rounded to f32 move pairs across it.)"""
        pos, cell, numbers, charges, tables = hybrid_system(n_rep)

        def on_card(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev).to(
                dtype)

        pos, cell, q = on_card(pos), on_card(cell), on_card(charges)
        g = composite.build_grid(pos, cell, cutoff)
        sg = stencil.build_stencil_auto(pos, cell, pbc, cutoff)
        if sg is None or int(sg.counts_max) != 1:
            raise AssertionError(f"crystal n_rep {n_rep}: no occupancy-1 "
                                 "stencil")
        return g, sg, numbers, q, tuple(on_card(t) for t in tables)

    def runs(g, sg, numbers, q, tables):
        def hybrid(cn_mode):
            def fn():
                e, f, cn = grid_dftd3(g, numbers, *tables, cutoff, a1, a2, s8,
                                      stencil=sg, hybrid_cn=cn_mode)
                return {"energy": e, "cn": cn, "d3": f}
            return fn

        def stencil_coulomb():
            e, f = stencil.stencil_coulomb_energy_forces(sg, q, cutoff, alpha)
            return {"energy": e, "coulomb": f}
        return hybrid, stencil_coulomb

    n_full = cfg["n_rep"] ** 3
    g, sg, numbers, q, tables = setup(cfg["n_rep"], torch.float32)
    label = f"crystal {n_full} atoms"
    phase(f"{label}: row grid dims {g.dims} radius {g.radius} cap {g.cap} "
          f"(counts_max {int(g.counts_max)}); stencil dims {sg.dims} radius "
          f"{sg.radius} occupancy {int(sg.counts_max)}")
    if sg.dims != (cfg["n_rep"],) * 3 or sg.radius != (3, 3, 3):
        raise AssertionError(f"{label}: stencil geometry {sg.dims} "
                             f"{sg.radius}, expected 48^3 voxels, radius 3")
    hybrid, stencil_coulomb = runs(g, sg, numbers, q, tables)
    ctx = {"n": n_full, "volume": (cfg["n_rep"] * cfg["a"]) ** 3,
           "cutoff": cutoff, "mesh": tables[3].shape[1],
           "parent": ("stencil_sweep",)}
    window_d3 = ["window_sweep_cn", "window_sweep_d3_direct",
                 "window_sweep_chain"]
    (w_d3, _, _) = drive_and_replay(
        f"{label} grid_dftd3 window engine",
        lambda: dict(zip(("energy", "d3", "cn"), grid_dftd3(
            g, numbers, *tables, cutoff, a1, a2, s8))), window_d3,
        profile=True)
    (w_c, _, _) = drive_and_replay(
        f"{label} grid_coulomb_energy_forces window engine",
        lambda: dict(zip(("energy", "coulomb"), grid_coulomb_energy_forces(
            g, q, cutoff, alpha))), ["window_sweep_coulomb"], profile=True)
    table = {}
    s_c, counts, rows = drive_and_replay(
        f"{label} stencil_coulomb_energy_forces", stencil_coulomb,
        ["stencil_sweep_coulomb"], ctx, profile=True,
        deterministic=["stencil_sweep[coulomb]"])
    keep_rows(table, rows, counts)
    check_errors(f"{label} stencil Coulomb forces vs window engine",
                 s_c["coulomb"], w_c["coulomb"],
                 ENGINE_BARS["stencil_coulomb"])
    phase(f"{label} stencil Coulomb energies vs window engine: max |diff| "
          f"{(s_c['energy'] - w_c['energy']).abs().max().item():.3e}")
    expects = {"stencil": ["stencil_sweep_cn", "window_sweep_d3_direct",
                           "stencil_sweep_chain"],
               "row": ["window_sweep_cn", "window_sweep_d3_direct",
                       "stencil_sweep_chain"]}
    for cn_mode, expect in expects.items():
        h, counts, rows = drive_and_replay(
            f"{label} grid_dftd3(stencil=sg, hybrid_cn={cn_mode!r})",
            hybrid(cn_mode), expect, ctx, profile=True,
            deterministic=[f"stencil_sweep[{k[len('stencil_sweep_'):]}]"
                           for k in expect if k.startswith("stencil")])
        keep_rows(table, rows, counts)
        check_errors(f"{label} hybrid ({cn_mode} CN) D3 forces vs window "
                     "engine", h["d3"], w_d3["d3"], ENGINE_BARS["hybrid_d3"])
        phase(f"{label} hybrid ({cn_mode} CN): energy {h['energy'].item():.6e}"
              f" (window {w_d3['energy'].item():.6e}), CN max |diff| "
              f"{(h['cn'] - w_d3['cn']).abs().max().item():.3e}")
    del g, sg, w_d3, w_c, s_c, h

    # the f64 witness: the same recipe at witness_n_rep, f32 kernels
    # against the port's plain path in f64 on the card
    n_rep = cfg["witness_n_rep"]
    label = f"crystal {n_rep ** 3} atoms"
    k32 = runs(*setup(n_rep, torch.float32))
    with plain_kernels(grid_d3, window_sweep=window_sweep_plain), \
            plain_kernels(stencil, stencil_sweep=stencil_sweep_plain):
        p64 = runs(*setup(n_rep, torch.float64))
        f64_d3 = p64[0]("stencil")()["d3"]
        f64_c = p64[1]()["coulomb"]
    d3_bar = tuple(BAR_FACTOR * v for v in JAX_F32_BARS["d3"])
    c_bar = tuple(BAR_FACTOR * v for v in JAX_F32_BARS["coulomb"])
    for cn_mode in ("stencil", "row"):
        check_errors(f"{label} hybrid ({cn_mode} CN) f32 kernels vs f64 plain",
                     k32[0](cn_mode)()["d3"], f64_d3, d3_bar)
    check_errors(f"{label} stencil Coulomb f32 kernel vs f64 plain",
                 k32[1]()["coulomb"], f64_c, c_bar)
    return table


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
          f"count {torch.cuda.device_count()} card {card}")

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
    ref = composite.load_reference()
    if ref is None:
        raise RuntimeError("benchmarks/data/bench_acc_ref.npz not found")
    capture = install_capture()
    reset_launch_counts()
    forces = composite.compute_forces(torch.float32, dev)
    small_counts = dict(launch_counts)
    capture.restore()
    small_calls = capture.calls
    rel = composite.relative_errors(forces, ref)
    rms = composite.rms_errors(forces, ref)
    for k, (bar_max, bar_rms) in JAX_F32_BARS.items():
        phase(f"accuracy {k}: max rel {rel[k]:.3e} (bar "
              f"{BAR_FACTOR * bar_max:.3e}), rms rel {rms[k]:.3e} (bar "
              f"{BAR_FACTOR * bar_rms:.3e})")
        if not (rel[k] <= BAR_FACTOR * bar_max
                and rms[k] <= BAR_FACTOR * bar_rms):
            raise AssertionError(f"accuracy {k} above the 1.25x JAX f32 bar")
    main_path = ("window_sweep_cn", "window_sweep_d3_direct",
                 "window_sweep_chain", "window_sweep_coulomb",
                 "windowed_spread", "windowed_gather_grad")
    if not all(small_counts[k] for k in main_path):
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
    missing = [k for k in main_path if main_counts[k] == 0]
    if missing:
        raise AssertionError(f"main path never launched: {missing}")

    # -- phase 5: kernel vs plain on the captured main-path inputs ----------
    pos_c, cell_c, _, _, _, _, cna_c, _ = composite.build_system()
    ctx_small = {"n": pos_c.shape[0],
                 "volume": float(abs(np.linalg.det(cell_c))),
                 "cutoff": composite.CUTOFF, "mesh": cna_c.shape[1],
                 "atoms": pos_c.shape[0], "order": 4}
    compare_kernels(small_calls, "composite 1,024 atoms", ctx_small)
    ctx_full = {"n": n, "volume": float(abs(np.linalg.det(cell_np))),
                "cutoff": cutoff, "mesh": cna.shape[1], "atoms": n,
                "order": 4, "parent": True}
    full_rows = compare_kernels(full_calls, f"full width {n} atoms",
                                ctx_full)
    check_deterministic(full_calls, "full width windowed spread")
    check_deterministic(full_calls, "full width windowed gather",
                        "windowed_gather_grad")
    del full_calls, small_calls

    # -- phases 6 and 7: batched D3, dense and grid branch -----------------
    d3_calls, d3_counts, d3_ctx = run_batched_d3(dev)

    # -- phase 8: PME, dense and batched -------------------------------------
    (pme_calls, pme_counts, pme_ctx, fb_calls, fb_ctx,
     (comp_calls, comp_ctx)) = run_pme(dev, f_p, (rel["pme"], rms["pme"]),
                                       (pos, q, cell, alpha))

    # -- phase 9: kernel vs plain for the new kernels ----------------------
    d3_rows = compare_kernels(
        d3_calls, f"batched D3 {D3_BATCH['b']} x {D3_BATCH['n']} at "
        f"{D3_BATCH['matched_cutoff']} A", d3_ctx)
    pme_rows = compare_kernels(
        pme_calls, f"batched PME {PME_BATCH['b']} x {PME_BATCH['n']}",
        pme_ctx)
    compare_kernels(fb_calls, f"PME fallback {n} atoms at 128^3", fb_ctx)
    compare_kernels(comp_calls, "composite PME dense engine (B = 1, 32^3)",
                    comp_ctx)
    check_deterministic(pme_calls, "batched PME dense spread",
                        "separable_spread")
    check_deterministic(fb_calls, "PME 128^3 fallback dense spread",
                        "separable_spread")
    spread_plan_variants(pme_calls, f"batched PME {PME_BATCH['b']} x "
                         f"{PME_BATCH['n']}")
    spread_plan_variants(fb_calls, f"PME fallback {n} atoms at 128^3")

    # -- phase 10: the composite on the other grid engines ------------------
    (pos_s, cell_s, num_s, q_s, rcov_s, r4r2_s, cna_s,
     c6_s) = composite.build_system()
    d3_small = (*compact_d3_elements(num_s, rcov_s, r4r2_s, c6_s, cna_s),
                composite.CUTOFF, composite.D3_A1, composite.D3_A2,
                composite.D3_S8)
    pos_s = torch.as_tensor(pos_s, dtype=torch.float32, device=dev)
    cell_s = torch.as_tensor(cell_s, dtype=torch.float32, device=dev)
    d3_bar = tuple(BAR_FACTOR * v for v in JAX_F32_BARS["d3"])
    run_engines(
        "composite 1,024 atoms", composite.build_grid(pos_s, cell_s),
        d3_small, torch.as_tensor(q_s, dtype=torch.float32, device=dev),
        composite.ALPHA,
        {k: torch.as_tensor(ref[k], device=dev) for k in ("d3", "coulomb")},
        "the f64 reference",
        {"d3": d3_bar, "combined": d3_bar,
         "coulomb": tuple(BAR_FACTOR * v for v in JAX_F32_BARS["coulomb"])})

    # -- phase 11: the other grid engines at full width ---------------------
    rows11 = run_engines(
        f"full width {n} atoms", g,
        (numbers, rcov, r4r2, c6, cna, cutoff, composite.D3_A1,
         composite.D3_A2, composite.D3_S8), q, alpha,
        {"d3": f_d3, "coulomb": f_c}, "phase 4 window engine", ENGINE_BARS,
        ctx_full)
    del g

    # -- phase 12: the voxel stencil and the hybrid D3 engine ---------------
    rows12 = run_stencil(dev)

    kernels = []
    for rows, counts in ((full_rows, main_counts), (d3_rows, d3_counts),
                         (pme_rows, pme_counts)):
        for key, row in sorted(rows.items()):
            source, replaces = KERNEL_SOURCES[key.split("[")[0]]
            kernels.append({"name": key, "route": "cuda", "source": source,
                            "replaces": replaces,
                            "launches": counts[count_key_of(key)], **row})
    listed = {k["name"] for k in kernels}
    for table in (rows11, rows12):
        for key, (row, launches) in sorted(table.items()):
            if key in listed:
                continue
            listed.add(key)
            source, replaces = KERNEL_SOURCES[key.split("[")[0]]
            kernels.append({"name": key, "route": "cuda", "source": source,
                            "replaces": replaces, "launches": launches,
                            **row})
    missing = set(KERNEL_SOURCES) - {k.split("[")[0] for k in listed}
    if missing:
        raise AssertionError(f"kernel table lacks {sorted(missing)}")
    phase(f"profiler runs taken again for lost device events: "
          f"{len(LOST_PROFILES)} {LOST_PROFILES}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

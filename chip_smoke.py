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
   spread, on the batch and the fallback, and two of the dense gather, on
   the batch, the fallback and the composite);
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
   composite's dense spread and gather (B = 1, 32^3) and the 128^3
   fallback with bounds; the dense spread of the batch and of the fallback
   also under other slab plans;
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

13. the neighbor lists and the list/matrix electrostatics (see
    ``run_neighbor_electrostatics``);
14. the spline, PME and electrostatics surface added last
    (``run_surface``): ``grid.build_atom_grid_auto`` on the 109,744-atom
    system (every atom slotted; window-engine D3 and Coulomb on it against
    phase 4's forces); an MD loop of 10 steps of at most 0.01 A in which
    the mesh-tile detector reads False, ``refresh_mesh_tiles`` and the
    windowed PME on the refreshed tiles equal a fresh build bit for bit,
    and a tile crossing reads True; the multi-channel spread and gathers
    (C = 3) at 128^3 (windowed, kernel 3) and 36^3 (dense, kernels 5 and
    6), each channel equal to its single-channel call and within
    ``CHANNEL_F32_RTOL`` of the port's f64 plain path; the 64 x 2,000
    batched PME with ``fft_mode="matmul"`` against ``"xla"`` and both
    against f64; the dense Coulomb on the composite against the f64
    reference and on the 64 x 2,000 batch against the list Coulomb; phase
    3's PME errors before and after the local B-spline forms; every kernel
    call of the phase replayed against its plain version;
15. ``dftd3`` over neighbour matrices and pair lists, and the window
    engine's virial (``run_dftd3``): on the composite after
    ``neighbor_list(method="cell_list")``, its f32 D3 forces against the
    f64 reference, the COO list against the matrix and the energy against
    ``grid_dftd3``'s; ``grid_dftd3(compute_virial=True)`` at 109,744
    atoms on kernel 1 (its three D3 bodies and no other pair sweep, each
    call replayed) against the f64 ``dftd3`` virial on the port's cell
    list, and the window engine's plain path in f64 against it; the
    reference's flagship D3 row (85,750-atom CsCl at 21.2 A, f32 against
    f64, list against matrix) and its batched row (128 x 2,000 at 21.2 A
    with ``batch_idx``, per-system cells and the virial, against phase
    6's ``batch_dftd3``), timed beside the reference's H100 times;
16. ``engine="xla"`` (the JAX package's XLA engines) on the kernels'
    routes (``run_xla_routes``): at 109,744 atoms ``grid_dftd3``, the grid
    Coulomb and the fused D3 + Coulomb with ``engine="xla"`` launch what
    the window engine launches and agree with it; ``compute_virial=True``
    on ``"xla"``, ``"block"`` and ``"pallas"`` with the cell, and with no
    cell (the ghost shifts then from the ghost positions), runs the window
    engine and meets phase 15's f64 ``dftd3`` virial;
    ``grid_neighbor_count`` equals ``cell_list``'s counts and
    ``grid_coordination_numbers`` (plain sweeps, timed with their idle
    share) meets the D3 CNs.  ``engine="xla"`` launches what the default
    launches on the 128 x 2,000 dense batch at 21.2 A (kernel 4), the 4 x
    16,000 grid branch (kernel 1) and the stencil's three sweeps on the
    110,592-atom crystal (kernel 9, the same bits).  The GTO and harmonic
    functions in f32 on the card against f64 on the CPU;
17. the multi-rank paths (``nvalchemiops_torch.parallel``,
    ``run_parallel``) in two spawned runs (``PARALLEL_RUNS``): two ranks
    sharing the card over gloo (the exchanged rows staged through host
    memory) and one rank on NCCL.  On phase 4's 109,744-atom grid (slabs
    of 8 cells at two ranks) each rank calls ``domain_dftd3_cn``,
    ``domain_coulomb_energy_forces``, ``domain_dftd3`` (phase 4's tables),
    ``domain_dftd3_coulomb`` and ``domain_pme_reciprocal`` (128^3, 2,048
    tiles a rank at two ranks), and ``sharded_batch_pme_reciprocal`` on
    phase 8's 64 x 2,000 batch: each f32 output within ``PARALLEL_RTOL``
    of the single-device call's scale, the D3 energy within
    ``PARALLEL_ENERGY_RTOL``; over gloo also the 1,024-atom composite in
    f64 on the CPU against the single-process calls (``PARALLEL_F64_RTOL``).
    Every rank must launch kernel 1's bodies, kernels 3 and 2 and kernels 5
    and 6 where its calls need them and no other pair sweep; each rank's
    stage times, ring traffic, transport and peak memory are printed.
    Then the MLIP forward at ``entry()``'s shapes in f32 on the card
    against f64 on the CPU (``MLIP_BARS``);
18. the MLIP training step, the entry points and kernel 1 batched:
    ``train_step`` at ``TRAIN``'s 4 x 256 and 4 x 1,024 atoms, f32 on the
    card against f64 on the CPU (``TRAIN_BARS``; ms, peak memory);
    ``sharded_train_step`` on two ranks sharing the card over gloo at
    (dp, sp) = (1, 2) and (2, 1) and on one NCCL rank, every rank against
    the single-process step; ``entry()``'s forward and
    ``dryrun_multichip(1)`` on NCCL (``run_training``, after phase 17).
    ``batch_grid_dftd3`` on the 4 x 16,000 grid branch and on 128 x 2,000
    at 9 A (``run_batch_window``, run before phase 17): three kernel-1
    launches a call and no per-system one, the outputs against the
    per-system loop (``BATCH_WINDOW_FORCE_BARS``) and both against the
    f64 plain path, each batched launch replayed against its plain
    version, the batched call and the loop timed and profiled;
19. kernels 1, 7 and 8 where one cell's window overflows shared memory,
    kernels 7 and 8 batched, and the f64 and device routes
    (``run_overflow``, run before phase 17): ``batch_grid_dftd3`` on phase
    6's 128 x 2,000 batch at 21.2 A (dims 1^3, cap 3,032) on the window,
    block and pallas engines, three launches a call, each against kernel
    4's plain version in f64 on the card within 1.25x kernel 4's own f32
    error; ``grid_dftd3`` on the JAX dry run's 400 atoms (cap 1,336) on
    each engine against ``dftd3`` in f64 on the card, and kernel 1 there
    with its own slots split over blocks; kernels 7 and 8 batched on the
    grid branch and the 9 A batch against the per-system loop and kernel 1
    batched (``BATCH_WINDOW_FORCE_BARS``), timed beside the loop; each
    batched launch timed on the whole batch with its bound from the pair
    slots it tests and replayed against its plain version on its first
    systems; ``grid_dftd3``, ``dense_dftd3`` and ``pme_reciprocal_space`` in
    f64 on the card against the CPU (``F64_ROUTE_RTOL``, no launch) and in
    f32 launching their kernels; a kernel call on cuda:1 where the machine
    has a second card.

Every drive of phases 10-12 captures its kernel calls and replays them
against their plain versions, and forbids every pair-sweep kernel off its
path.  Each replay of kernels 1, 2, 4, 7 and 8 at 109,744 atoms, at 128 x
2,000 and on the W = 20 windows, of kernel 9 on the crystal and of kernel
6 on the batched PME, the 128^3 fallback and the composite prints its
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
# phase 13: the neighbor lists and the list/matrix electrostatics.
# NL_SAFETY sizes max_neighbors from a system's own density
# (``estimate_max_neighbors(cutoff, density, NL_SAFETY)``); the default
# density 0.35 / safety 5 would give K = 6,496 at 9.6 A.  Cross-engine and
# cross-precision bars (max rel, RMS rel), both sides on the card: 1.25x
# the larger of two readings of sound runs (rounded up; NVIDIA H100 80GB
# HBM3, 700 W), one bar for energies and forces alike.  Readings: the
# 109,744-atom real space against the window engine 2.799e-5 / 7.771e-6
# (forces; energies 5.051e-6 / 5.062e-7; the window engine's erfc is a
# polynomial good to 1.5e-7), particle_mesh_ewald against
# grid_particle_mesh_ewald 1.790e-5 / 5.261e-6; on the 16 x 2,000 batch,
# f32 against f64 4.123e-7 / 2.028e-7 (Ewald) and 4.092e-7 / 2.644e-7
# (PME), PME against Ewald in f64 5.349e-8 / 2.219e-7, and the batch_idx
# scatter path against the dense engine 9.649e-6 / 4.694e-6 (9.556e-6 in
# the other run: the scatter's atomics; the dense engine's B-spline
# weights round in f32 where the scatter path's local forms do not).
NL_SAFETY = 1.5
ELEC_BARS = {
    "real_vs_grid": (3.50e-5, 9.72e-6),
    "pme_vs_grid": (2.24e-5, 6.58e-6),
    "batch_ewald_f32_vs_f64": (5.16e-7, 2.54e-7),
    "batch_pme_f32_vs_f64": (5.12e-7, 3.31e-7),
    "batch_ewald_vs_pme": (6.69e-8, 2.78e-7),
    "batch_idx_vs_dense": (1.21e-5, 5.87e-6),
}
# phase 14.  The MD loop of the mesh-tile refresh: steps, the largest
# displacement of an atom in a step (A) and the seed of its generator; each
# step moves every atom toward its tile's centre, so no atom leaves its
# tile and the detector must read False.
MD_REFRESH = dict(steps=10, max_step=0.01, seed=14)
# the channel spread/gather meshes: the windowed route and a mesh the
# windows reject (the dense route, as phase 13's 36^3)
CHANNEL_MESHES = ((128, 128, 128), (36, 36, 36))
# f32 channel spread/gather against the port's f64 plain path on the card:
# max |f32 - f64| <= CHANNEL_F32_RTOL x max |f64| per output (the bar of a
# kernel against its plain version: ~100 f32 ulps of the output's scale)
CHANNEL_F32_RTOL = KERNEL_RTOL
# the dense Coulomb of the 64 x 2,000 batch: 9 A, alpha 0.35
DENSE_COULOMB = dict(cutoff=9.0, alpha=0.35)
# phase 14's port-vs-port bars (max rel, RMS rel), both sides in f32
# unless named, one bar for forces and energies: 1.25x the larger of the
# readings of sound runs, rounded up (NVIDIA H100 80GB HBM3, 700 W; three
# runs read the same bits; PERF.md).  Readings: the 64 x 2,000
# PME batch with fft_mode "matmul" against "xla" 1.708e-6 / 7.022e-7
# (forces; energies 3.538e-7 / 2.662e-7), each against the f64 plain path
# 1.470e-6 / 7.865e-7 (matmul) and 9.208e-7 / 6.126e-7 (xla); the dense
# Coulomb of the 64 x 2,000 batch against the list Coulomb 3.582e-5 /
# 2.094e-5 (forces; energies 8.234e-6 / 2.629e-6), in f64 9.834e-8 /
# 1.089e-7 (the erfc polynomial against the exact erfc), and its f32
# forces against its f64 ones 3.568e-5 / 2.084e-5: uniform random
# positions hold pairs far closer than a crystal's, and their f32
# displacements (from fractional coordinates, as in the JAX package) set
# the max.
SURFACE_BARS = {
    "matmul_vs_xla": (2.14e-6, 8.78e-7),
    "pme_f32_vs_f64": (1.84e-6, 9.84e-7),
    "dense_vs_list_coulomb": (4.48e-5, 2.62e-5),
    "dense_vs_list_coulomb_f64": (1.23e-7, 1.37e-7),
    "dense_coulomb_f32_vs_f64": (4.46e-5, 2.61e-5),
}
# phase 3's PME force errors against bench_acc_ref.npz (max rel, RMS rel)
# on the tree before the local B-spline forms, whose single-system
# engines took the expanded forms (that tree's chip_smoke.py on an NVIDIA
# H100 80GB HBM3 at 700.00 W; PERF.md)
PARENT_PHASE3_PME = (7.533e-05, 9.164e-05)

# the simple-cubic analytic oracle: a = 3.0 A, no
# jitter, 4.5 A: 6 neighbors at 3.0 A and 12 at 4.24 A
CRYSTAL = dict(a=3.0, cutoff=4.5, cell_list_n_rep=64, naive_n_rep=25)
# the JAX package's batched Ewald benchmark (run_benchmarks.py:255-296,
# benchmark_config.yaml ewald_batch): default_rng(3) draws the 64 x 2,000
# case, then the 16 x 2,000 one; uniform positions, normal charges
EWALD_BATCH = dict(cases=((64, 2000, 27.0), (16, 2000, 27.0)),
                   accuracy=1e-6, dense_mesh=(32, 32, 32))
# the reference's H100 rows (BASELINE.md:14, 17, 42-43)
REFERENCE_MS = {"naive 16,384": 4.530, "cell list 262,144": 9.815,
                "ewald recip 16 x 2,000": 7.467,
                "ewald recip 64 x 2,000": 24.876}

# the JAX package's hybrid probe system (benchmarks/hybrid_probe.py:33-71):
# jittered simple-cubic crystal from default_rng(0), zmax-16 random tables,
# a1/a2/s8 = 0.4/4.2/1.8; charges drawn after the tables; the f64 witness
# runs the same recipe at witness_n_rep
HYBRID = dict(n_rep=48, a=3.0, jitter=0.2, cutoff=9.0, alpha=0.35, zmax=16,
              witness_n_rep=24)

# phase 15: dftd3 on the port's neighbour matrices and lists.  The
# reference's H100 D3 rows (BASELINE.md:29 and :32, neighbour list
# excluded), ms and peak GB: the 85,750-atom CsCl (n_rep 35) and the
# 128 x 2,000 batch, both at 21.2 A.
REFERENCE_D3 = {"flagship": (16.454, 1.58), "batch": (46.049, 4.71)}
FLAGSHIP_D3 = dict(n_rep=35, cutoff=21.2)
# phase 15's bars, both sides on the card: (max rel, RMS rel) of forces,
# max |diff| / max |ref| over systems of energies, the Frobenius relative
# error of the virial.  1.25x the larger of two readings of sound runs,
# rounded up (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): list vs
# matrix 9.408e-6 / 4.916e-6 (composite), 5.427e-5 / 2.414e-5 (85,750
# atoms); the composite's energy vs grid_dftd3 7.210e-8; f32 vs f64 at
# 85,750 atoms 2.419e-5 / 8.796e-6, energy 9.913e-8; the batch vs
# batch_dftd3 1.680e-5 / 7.766e-6 (1.668e-5 / 7.765e-6 in the other run:
# kernel 4's atomics), energies 1.829e-7; the window virial in f32 vs
# dftd3's in f64, one call, 7.028e-8 (7.013e-8).  List and matrix
# energies read the same f32 bits in both runs (0.0): their bar is one f32
# unit roundoff, 2^-23, where 1.25x of 0 would ask two summation orders
# for equal bits.  The virial's reading moves with the order of kernel 1's
# j-side atomics (a third run read 1.043e-7 in its one call): over
# VIRIAL_CALLS calls its median read 7.023e-8 in two runs and is held to
# the one-call bar, its largest 1.041e-7 and 7.046e-8, held to
# "virial_f32_vs_f64_largest".
DFTD3_BARS = {
    "composite_list_vs_matrix": (1.18e-5, 6.15e-6),
    "flagship_list_vs_matrix": (6.79e-5, 3.02e-5),
    "list_vs_matrix_energy": 1.20e-7,
    "composite_energy_vs_grid": 9.02e-8,
    "flagship_f32_vs_f64": (3.03e-5, 1.10e-5),
    "flagship_energy_f32_vs_f64": 1.24e-7,
    "batch_vs_dense": (2.10e-5, 9.71e-6),
    "batch_energy_vs_dense": 2.29e-7,
    "virial_f32_vs_f64": 8.79e-8,
    "virial_f32_vs_f64_largest": 1.31e-7,
}
# the window engine's plain path in f64 against dftd3's f64 virial
VIRIAL_F64_RTOL = 1e-9
# the f32 window virial moves from call to call with the order of kernel
# 1's j-side atomics: the phase reads it over this many calls and holds
# their median and their largest to their bars (DFTD3_BARS)
VIRIAL_CALLS = 20
# a dftd3 call slower than this (s) is timed once, not three times
DFTD3_SLOW_S = 5.0

# phase 16: ``engine="xla"`` against the default route's call at 109,744
# atoms, both on the card in f32 and both on kernel 1, so the readings are
# those of its j-side atomics' order: (max rel, RMS rel) of forces,
# energies and CNs as max |diff| / max |ref|; the virial with no cell as
# the Frobenius relative error against phase 15's f64 dftd3 virial (with a
# cell it is phase 15's virial and takes its bar);
# grid_coordination_numbers (a plain sweep, no atomics) against
# grid_dftd3's CNs; the math extras as max |f32 - f64| / max |f64| per
# function, the worst.  Readings of two sound runs (NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md): D3 forces 4.335e-6, 3.468e-6 / 1.546e-6,
# 1.539e-6, energy 0.0 both, CN 2.105e-7 both; Coulomb forces 1.658e-6,
# 1.289e-6 / 5.602e-7, 5.562e-7, energies 3.405e-7 both; fused D3 forces
# 3.468e-6 both / 1.332e-6, 1.335e-6, fused Coulomb forces 1.473e-6,
# 1.289e-6 / 4.266e-7, 4.257e-7, fused energy 0.0 both; the virial with no
# cell 7.037e-8, 7.023e-8; CN of the plain sweep 1.684e-6 both; math
# extras 2.718e-7 both.  Bars: 2x the larger reading where kernel 1's
# atomics move it (every reading against a kernel-1 call), 1.25x for the
# math extras (the same bits every call); a reading of 0.0 (the energies:
# the own-side sums gave equal bits) takes one f32 unit roundoff, 1.2e-7,
# as phase 15's list-vs-matrix energy does.
XLA_BARS = {
    "d3_forces": (8.67e-6, 3.09e-6),
    "d3_energy": 1.2e-7,
    "d3_cn": 4.21e-7,
    "coulomb_forces": (3.32e-6, 1.12e-6),
    "coulomb_energies": 6.81e-7,
    "fused_d3_forces": (6.94e-6, 2.67e-6),
    "fused_coulomb_forces": (2.95e-6, 8.53e-7),
    "fused_energy": 1.2e-7,
    "virial_no_cell": 1.41e-7,
    "cn_full_sweep": 3.37e-6,
    "math_f32": 3.40e-7,
}

# device ms per call of every body of kernels 1 and 4 before their
# distance-first redesign (the parent tree's kernels), measured with
# pair_sweep_times.py on an NVIDIA H100 80GB HBM3 at 700.00 W: kernel 1 at
# 109,744 atoms, kernel 4 at 128 x 2,000 atoms; likewise kernels 8 and 2,
# kernels 7 and 9, and kernel 6, before their redesign (PERF.md)
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
    # kernel 6 on the batched dense PME, the 128^3 fallback and the
    # composite on the dense engine
    "separable_gather 64 x 2000, mesh 32x32x32": 0.0667,
    "separable_gather 1 x 109744, mesh 128x128x128": 0.0300,
    "separable_gather 1 x 1024, mesh 32x32x32": 0.01138,
}

# phase 17: the multi-rank paths (nvalchemiops_torch.parallel) in two
# spawned runs, (backend, ranks): two ranks sharing the card over gloo (the
# exchanged rows staged through host memory) and one rank on NCCL (NCCL
# takes one rank per card).  Each run's wall-clock deadline, s
PARALLEL_RUNS = (("gloo", 2), ("nccl", 1))
PARALLEL_DEADLINE_S = 420
# f32 domain outputs against phase 4's single-device calls (the same kernel
# bodies, summed in another order of atomics and folds): max |diff| of each
# output's scale; the D3 total energy, relative; the f64 composite on the
# CPU against the single-process calls, of scale
PARALLEL_RTOL = KERNEL_RTOL
PARALLEL_ENERGY_RTOL = 1e-6
PARALLEL_F64_RTOL = 1e-10
# the MLIP forward at entry()'s shapes (__graft_entry__.py: 4 x 256 atoms,
# zmax 4, cutoff 2.9, 6 A boxes); f32 on the card against f64 on the CPU:
# (energies, forces) max |diff| / scale, 1.25x the larger reading of two
# sound runs (NVIDIA H100 80GB HBM3, 700 W: 3.023e-7 and 2.815e-6 both)
MLIP = dict(b=4, n=256, zmax=4, cutoff=2.9, box=6.0)
MLIP_BARS = (3.779e-7, 3.519e-6)

# phase 18: the MLIP training step at entry()'s 4 x 256 atoms (6 A boxes)
# and at 4 x 1,024 in 9.52 A boxes (entry's density; 2.9 A < half the
# box), f32 on the card against f64 on the CPU: (loss, relative; new
# parameters, max |diff| of each field's scale).  The sharded step on the
# (dp, sp) meshes of two ranks sharing the card over gloo and on one NCCL
# rank, against the single-process f32 step on the card: the same bars
TRAIN = dict(shapes=((4, 256, 6.0), (4, 1024, 9.52)), zmax=4, cutoff=2.9)
TRAIN_BARS = (1e-5, 1e-6)
SHARDED_RUNS = (("gloo", 2, ((1, 2), (2, 1))), ("nccl", 1, ((1, 1),)))
SHARDED_DEADLINE_S = 300
# kernel 1's batched launch under batch_grid_dftd3: the grid branch of
# phase 7 (4 x 16,000, 54 A, 9 A) and phase 6's 128 x 2,000 batch in 27 A
# boxes at 9 A, against the per-system loop of kernel-1 launches.  Energies
# and CNs: max |diff| / scale within KERNEL_RTOL.  Forces differ by the
# order of the j-side atomics, amplified through the CN chain (f32 on the
# card against the f64 plain path reads ~2e-5 of scale at 9 A, phase 6):
# max |diff| / scale within 2x the larger reading of sound runs (NVIDIA
# H100 80GB HBM3, 700 W: grid branch 6.637e-6, 6.860e-6, 5.770e-6;
# 128 x 2,000 2.129e-5).  Against the f64 plain path on the first 4
# systems the batched forces are within 1.25x the loop's own f32 error
# (max rel, RMS rel), and both RMS errors within 1.25x the JAX package's
# f32 D3 RMS bar (JAX_F32_BARS); the max rel has no absolute bar (the grid
# branch read 1.422e-3 for both paths, above the composite's D3 bar; the
# script prints the worst atom and its pairs at D3's hard cutoff)
BATCH_WINDOW_RTOL = KERNEL_RTOL
BATCH_WINDOW_FORCE_BARS = {"grid branch": 1.372e-5, "128 x 2000": 4.258e-5}
BATCH_WINDOW_WITNESS = 4
# phase 19: kernels 1, 7 and 8 where one cell's window overflows shared
# memory, kernels 7 and 8 batched, and the f64 and device routes.  19a:
# batch_grid_dftd3 on phase 6's 128 x 2,000 batch in 41.2 A boxes at 21.2 A
# (dims 1^3, cap 3,032) on each engine, its f32 forces on the first
# OVERFLOW_WITNESS systems against kernel 4's plain version in f64 on the
# card (batch_dftd3 given f64 inputs) within 1.25x kernel 4's own f32
# error (max rel, RMS rel) against the same witness; kernel vs plain on
# the whole batch.  19b: grid_dftd3 on the JAX
# dry run's 400 atoms (4 A box, 4 A, occupancy 0.3: cap 1,336) against
# dftd3 in f64 on the card at the JAX f32 D3 bar (1.25x).  19c: kernels 7
# and 8 batched on the grid branch and the 9 A batch, against the
# per-system loop and kernel 1 batched within BATCH_WINDOW_RTOL (energies,
# CNs) and BATCH_WINDOW_FORCE_BARS (forces); kernel vs plain on the whole
# batch.  19d: f64 on the card against the CPU
# within F64_ROUTE_RTOL of scale, no launch
OVERFLOW_ENGINES = {"window": "window_sweep", "block": "chunk_sweep",
                    "pallas": "row_sweep"}
OVERFLOW_WITNESS = 2
F64_ROUTE_RTOL = 1e-10
# the blocks a cell's own slots are split over in 19b's probe of kernel 1
OWN_SPLIT = 16

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
# the half-space pair sweeps over the halo grid (kernels 1, 7, 8; each
# takes one grid's planes or a batched grid's, with a leading system axis)
GRID_SWEEPS = ("window_sweep", "row_sweep", "chunk_sweep")
# kernel 1's launches under batch_grid_dftd3, one a D3 pass for every
# system (a batched launch counts under the same key as one grid's)
BATCH_KEYS = ["window_sweep_cn", "window_sweep_d3_direct",
              "window_sweep_chain"]
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


#: profiler runs of :func:`device_time_ms` that lost device events and
#: were taken again: (device events kept by kernel name, runtime launches
#: the host recorded, reps, mode)
LOST_PROFILES = []
#: how the runs of one :func:`device_time_ms` call issue their ``reps``
#: calls: back to back first, then with the card synchronized after each
#: call, which mostly kept every event where back to back lost some
#: (PERF.md section 6, PR 16's chip-check follow-up)
PROFILE_MODES = ("back to back", "sync each", "sync each")


def device_events(prof):
    """The device events one torch.profiler run kept: their count by
    kernel name, their summed time (us), and the launches, memsets and
    copies the host recorded, each of which makes one device event."""
    from collections import Counter

    from torch.autograd import DeviceType

    kept = Counter()
    busy = 0.0
    launched = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kept[e.name] += 1
            busy += e.time_range.elapsed_us()
        elif e.name.startswith("cu") and any(
                w in e.name for w in ("Launch", "Memset", "Memcpy")):
            launched += 1
    return kept, busy, launched


def device_time_ms(fn, reps=5):
    """Device time of one call of ``fn``: the CUDA kernels (memsets
    included) that one torch.profiler run of ``reps`` calls records, summed,
    over ``reps``.  Unlike :func:`cuda_time_ms` it leaves out the time the
    card waits for the host between launches.

    Every call of ``fn`` launches the same kernels, so a run has kept all
    its device events only where each kernel name's count is a multiple of
    ``reps`` and there are at least as many as the host recorded launches,
    memsets and copies (:func:`device_events`).  The profiler drops device
    events of whole calls late in a long process (PERF.md section 7), and
    a count of at least ``reps``, the earlier test, let three calls of
    five pass as the device time.  A
    run that lost events is noted in ``LOST_PROFILES`` and taken again
    (``PROFILE_MODES``).  When every run loses events this returns None,
    printed as not measured: the device time is a reading beside the
    CUDA-event time (which the kernels line's ``ms`` carries), never a
    check, so a profiler that drops events does not fail the run."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for mode in PROFILE_MODES:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(reps):
                fn()
                if mode == "sync each":
                    torch.cuda.synchronize()
            torch.cuda.synchronize()
        kept, busy, launched = device_events(prof)
        if busy > 0 and sum(kept.values()) >= launched and all(
                c % reps == 0 for c in kept.values()):
            return busy / 1e3 / reps
        LOST_PROFILES.append(({k[:48]: c for k, c in kept.items()},
                              launched, reps, mode))
    phase(f"device time not measured: {len(PROFILE_MODES)} profiler "
          f"runs of {reps} calls lost device events: "
          f"{LOST_PROFILES[-len(PROFILE_MODES):]}")
    return None


def _ms(v):
    return "not measured" if v is None else f"{v:.4f} ms"


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
    batched = base in GRID_SWEEPS and args[2].dim() == 6
    if base in GRID_SWEEPS:
        # the half-space windows never reach the low z halo, nor the low y
        # halo of the first interior plane; j_out is written where read
        # (a batched call's planes carry the system axis first)
        rz, ry = args[1][0], args[1][1]
        cand, j_out, cf = args[3], outs[1], kwargs.get("cf")
        lead = (slice(None),) * (2 if batched else 1)
        hi = lead + (slice(rz + 1, None),)
        row = lead + (rz, slice(ry, None))
        reads = [a for a in reads if a is not cand and a is not cf] + [
            cand[hi], cand[row]]
        if cf is not None:
            # the zm-wide rows cf [.., cap, 2 zm] are [z_j == z] e_j, mostly
            # zeros: the function needs kernel 1's candidate features z,
            # e[mesh], edc[mesh] (1 + 2 mesh floats a slot), so the extra
            # traffic of the wide form shows as distance from the bound
            nk = 1 + 2 * ctx["mesh"]
            reads += [cf[hi[1:]][..., :nk], cf[row[1:]][..., :nk]]
        outs = (outs[0], j_out[hi], j_out[row])
    nbytes = _nbytes(*reads, *outs)
    if base in GRID_SWEEPS or base == "stencil_sweep":
        # every pair inside the cutoff once (the full-space stencil visits
        # each twice: that shows as distance from the bound); the D3 bodies'
        # three C6 dots have the mesh length on every engine (the zm-wide
        # dots of kernels 7 and 8 add zeros)
        body = key[len(base) + 1:-1]
        pairs = pairs_in_cutoff(ctx["systems"] if batched else 1, ctx["n"],
                                ctx["volume"], ctx["cutoff"])
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
    if key == "separable_gather":
        mesh, w = args[0], args[2]
        return (f"{key} {w.shape[0]} x {w.shape[1]}, mesh "
                f"{'x'.join(str(d) for d in mesh.shape[1:])}")
    return key


def kernel_vs_plain(label, base, out_k, out_p, batched):
    """Hold a kernel's outputs against its plain version's: each plane of a
    pair sweep on its own scale (a batched sweep's plane over every
    system), every other output whole, within ``KERNEL_RTOL`` of its
    scale.  Returns the kernel's outputs as a tuple (a batched sweep's
    [F, B, ..]), the largest absolute error and the worst relative one."""
    split = base in GRID_SWEEPS + ("dense_pairs", "stencil_sweep")
    out_k = out_k if isinstance(out_k, tuple) else (out_k,)
    out_p = out_p if isinstance(out_p, tuple) else (out_p,)
    if batched:
        # [B, F, ..] -> [F, B, ..]: each plane over every system
        out_k = tuple(t.transpose(0, 1) for t in out_k)
        out_p = tuple(t.transpose(0, 1) for t in out_p)
    max_abs, worst_rel = 0.0, 0.0
    for tk, tp in zip(out_k, out_p):
        for a, b in zip(tk if split else [tk], tp if split else [tp]):
            err = (a.double() - b.double()).abs().max().item()
            scale = b.double().abs().max().item()
            if not np.isfinite(err) or err > KERNEL_RTOL * scale:
                raise AssertionError(
                    f"{label}: kernel vs plain max abs err {err:.3e} > "
                    f"{KERNEL_RTOL:g} x scale {scale:.3e}")
            max_abs = max(max_abs, err)
            worst_rel = max(worst_rel, err / scale if scale else 0.0)
    return out_k, max_abs, worst_rel


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
        batched = base in GRID_SWEEPS and args[2].dim() == 6
        out_k, max_abs, worst_rel = kernel_vs_plain(f"{label} {key}", base,
                                                    out_k, out_p, batched)
        ms = cuda_time_ms(lambda: kern(*args, **kwargs))
        plain_ms = cuda_time_ms(lambda: plain(*args, **kwargs))
        shape = tuple(next(a for a in args
                           if isinstance(a, torch.Tensor)).shape)
        row = {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}
        msg = (f"{label} {key}: input {shape} max_abs_err {max_abs:.3e} "
               f"(rel {worst_rel:.2e}) kernel {ms:.4f} ms plain "
               f"{plain_ms:.4f} ms")
        if ctx is not None:
            nbytes, flops = work(key, args, kwargs, tuple(
                t.transpose(0, 1) for t in out_k) if batched
                else out_k if len(out_k) > 1 else out_k[0], ctx)
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FP32_PER_S * 1e3
            lib = library_call(key, args)
            row["bound_ms"] = max(t_bytes, t_ops)
            row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            row["library_ms"] = cuda_time_ms(lib) if lib else None
            row["device_ms"] = device_time_ms(lambda: kern(*args, **kwargs))
            row["library_device_ms"] = device_time_ms(lib) if lib else None
            parent = PARENT_DEVICE_MS.get(parent_key(key, args, ctx))
            msg += f" (device {_ms(row['device_ms'])}"
            wanted = ctx.get("parent")
            if parent is not None and (wanted is True or wanted
                                       and base in wanted):
                msg += f"; parent tree {parent} ms"
            library = (f"{row['library_ms']} ms (device "
                       f"{_ms(row['library_device_ms'])})" if lib
                       else "none")
            msg += (f") library {library} bound "
                    f"{row['bound_ms']:.4f} ms ({row['bound_by']}: "
                    f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        phase(msg)
        rows[key] = row
    return rows


def check_deterministic(calls, label, key="windowed_spread"):
    """Two launches of a kernel on the captured inputs give the same bits:
    the windowed spread and gather and the dense gather have one writer
    per output adding in a fixed order, the dense spread sums in fixed
    point, and the voxel stencil writes each output once, its slices added
    in a fixed order."""
    from nvalchemiops_torch.kernels.separable_spline import (
        separable_gather, separable_spread,
    )
    from nvalchemiops_torch.kernels.stencil_sweep import stencil_sweep
    from nvalchemiops_torch.kernels.windowed_gather import (
        gather_grad_planes, spread_windows,
    )

    kern = {"windowed_spread": spread_windows,
            "windowed_gather_grad": gather_grad_planes,
            "separable_spread": separable_spread,
            "separable_gather": separable_gather,
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
              f"{_ms(dev_ms)}), max_abs_err {err:.3e}")


def profile_step(label, fn, top=6):
    """Host wall (synchronized, median of 3 after a warm-up), device busy
    time (the sum of CUDA kernel times in one torch.profiler run), the idle
    share and the kernels that take the most device time; the busy time
    is marked a lower bound where the run lost device events
    (:func:`device_events`)."""
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
    kept, busy, launched = device_events(prof)
    busy /= 1e3
    launches = sum(kept.values())
    if busy == 0.0:
        phase(f"profile {label}: host wall {wall:.3f} ms; device time not "
              "measured (the profiler saw no kernel time)")
        return
    lost = ("" if launches >= launched else
            f" (at least: the profiler kept {launches} device events of "
            f"the host's {launched} launches, memsets and copies)")
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    kern.sort(key=lambda e: -e.self_device_time_total)
    tops = "; ".join(f"{e.key[:60]} x{e.count} "
                     f"{e.self_device_time_total / 1e3:.3f} ms"
                     for e in kern[:top])
    phase(f"profile {label}: host wall {wall:.3f} ms (synchronized, median "
          f"of 3), device busy {busy:.3f} ms{lost}, idle share "
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
    context, and the 21.2 A batch's energies and forces."""
    from nvalchemiops_torch.interactions.dispersion.dense_d3 import (
        _image_combos, batch_dense_dftd3, batch_dftd3, batch_route,
    )
    from nvalchemiops_torch.interactions.dispersion.grid_d3 import (
        batch_grid_dftd3,
    )
    from nvalchemiops_torch.kernels import launch_counts
    from nvalchemiops_torch.grid import (
        batch_build_atom_grid, estimate_grid_geometry,
    )

    cfg = D3_BATCH
    tables, pos, numbers, pos_m, pos_g, numbers_g = d3_batch_system(dev)
    a1, a2, s8 = D3_PARAMS
    pbc = np.array([True] * 3)
    dense_keys = ["dense_pairs_cn", "dense_pairs_direct", "dense_pairs_chain"]
    grid_keys = [k for k in launch_counts
                 if k.startswith(("window_sweep_", "row_sweep_",
                                  "chunk_sweep_"))]
    d3_bar = tuple(BAR_FACTOR * v for v in JAX_F32_BARS["d3"])

    def f64_witness(p, cell_, cut_):
        """Forces of the port's dense D3 in f64: the plain sweep (f64
        inputs take the plain versions on the card)."""
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
    (e_g, f_g, _), counts_g = drive(label_g, run_g, BATCH_KEYS,
                                    forbid=dense_keys)
    capture_g.restore()
    if any(counts_g[k] != 1 for k in BATCH_KEYS):
        raise AssertionError(f"grid branch: not one kernel-1 launch a pass "
                             f"for the batch: {counts_g}")
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
    return capture.calls, counts_m, ctx, (e_m, f_m)


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
    from nvalchemiops_torch.interactions.electrostatics.pme import (
        batch_pme_reciprocal, pme_reciprocal_space,
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
    composite_calls = capture.calls
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
    # the gather's parent tree times (PARENT_DEVICE_MS) beside its own
    gather = ("separable_gather",)
    ctx = {"atoms": b * n, "order": 4, "parent": gather}
    ctx_fb = {"atoms": pos_f.shape[0], "order": 4, "parent": gather}
    ctx_c = {"atoms": pos_c.shape[0], "order": 4, "parent": gather}
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
    from nvalchemiops_torch.interactions.dispersion.grid_d3 import grid_dftd3

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


def density_max_neighbors(n, cell, cutoff):
    """``max_neighbors`` from the system's own density and ``NL_SAFETY``."""
    from nvalchemiops_torch.neighborlist import estimate_max_neighbors

    volume = abs(float(torch.linalg.det(cell.double().reshape(-1, 3, 3)[0])))
    return estimate_max_neighbors(cutoff, n / volume, NL_SAFETY)


def row_keys(nm, num, sh, fill):
    """Each row of a neighbor matrix as sorted int64 keys of ``(j,
    shift)`` (shifts in -1..1; empty slots last): equal keys, equal sets."""
    code = ((sh[..., 0] + 1) * 9 + (sh[..., 1] + 1) * 3 + sh[..., 2] + 1).long()
    keys = torch.where(nm != fill, nm.long() * 27 + code,
                       torch.full((), 2 ** 62, device=nm.device))
    return keys.sort(dim=1).values


def ewald_batch_systems(dev):
    """The batched Ewald benchmark's systems, f32 on the card:
    ``{(b, n): (positions [b n, 3], charges, cells [b, 3, 3], batch_idx)}``."""
    rng = np.random.default_rng(3)
    out = {}
    for b, n, box in EWALD_BATCH["cases"]:
        pos = rng.uniform(0, box, (b * n, 3))
        q = rng.normal(size=b * n)
        out[(b, n)] = (
            torch.as_tensor(pos, dtype=torch.float32, device=dev),
            torch.as_tensor(q, dtype=torch.float32, device=dev),
            torch.eye(3, device=dev).expand(b, 3, 3).contiguous() * box,
            torch.arange(b, device=dev).repeat_interleave(n).int())
    return out


def run_neighbor_electrostatics(dev, full):
    """Phase 13: the neighbor lists and the list/matrix electrostatics
    (Coulomb, Ewald, PME) through the public entry points; ``full`` holds
    phase 4's inputs and window-engine Coulomb.  The calls of kernels 2
    and 3 are replayed from the main-path PME; the kernel table keeps its
    rows from the earlier phases."""
    from nvalchemiops_torch import composite
    from nvalchemiops_torch.interactions.electrostatics import (
        batch_pme_reciprocal, estimate_ewald_parameters, ewald_real_space,
        ewald_reciprocal_space, ewald_summation,
        generate_k_vectors_ewald_summation, grid_particle_mesh_ewald,
        particle_mesh_ewald, pme, pme_reciprocal_space,
    )
    from nvalchemiops_torch.neighborlist import (
        assert_max_neighbors, cell_list, naive_neighbor_list, neighbor_list,
    )

    pbc = np.array([True] * 3)
    win_keys = ["windowed_spread", "windowed_gather_grad"]
    dense_keys = ["separable_spread", "separable_gather"]
    cutoff, alpha = composite.CUTOFF, composite.ALPHA

    def matrix(pos, cell, cut, **kw):
        k = density_max_neighbors(pos.shape[0], cell, cut)
        nm, num, sh = neighbor_list(pos, cut, cell=cell, pbc=pbc,
                                    max_neighbors=k, **kw)
        assert_max_neighbors(nm, num)
        return nm, num, sh, k

    # -- the 1,024-atom composite ------------------------------------------
    pos_c, cell_c, _, q_c, *_ = composite.build_system()
    pos_c = torch.as_tensor(pos_c, dtype=torch.float32, device=dev)
    cell_c = torch.as_tensor(cell_c, dtype=torch.float32, device=dev)
    q_c = torch.as_tensor(q_c, dtype=torch.float32, device=dev)
    nm, num, sh, k = matrix(pos_c, cell_c, cutoff, method="cell_list")
    e_r, f_r = ewald_real_space(pos_c, q_c, cell_c, alpha, neighbor_matrix=nm,
                                neighbor_matrix_shifts=sh,
                                compute_forces=True)
    ref = composite.load_reference()
    rel = composite.relative_errors(
        {"coulomb": f_r.double().cpu().numpy()}, ref)["coulomb"]
    rms = composite.rms_errors(
        {"coulomb": f_r.double().cpu().numpy()}, ref)["coulomb"]
    bar = tuple(BAR_FACTOR * v for v in JAX_F32_BARS["coulomb"])
    phase(f"composite cell list: K {k}, max count {int(num.max())}, "
          f"{int(num.sum())} pairs; ewald_real_space forces vs f64 "
          f"reference: max rel {rel:.3e} (bar {bar[0]:.3e}), rms rel "
          f"{rms:.3e} (bar {bar[1]:.3e})")
    if not (rel <= bar[0] and rms <= bar[1]):
        raise AssertionError("composite ewald_real_space above the Coulomb "
                             "bar")
    (e_pme, f_pme), _ = drive(
        "composite particle_mesh_ewald (32^3, windowed)",
        lambda: particle_mesh_ewald(
            pos_c, q_c, cell_c, alpha, mesh_dimensions=composite.MESH,
            neighbor_matrix=nm, neighbor_matrix_shifts=sh,
            compute_forces=True), win_keys, forbid=dense_keys)
    e_k, f_k = pme_reciprocal_space(pos_c, q_c, cell_c, alpha,
                                    mesh_dimensions=composite.MESH,
                                    compute_forces=True)
    for name, a, b in (("energies", e_pme, e_r + e_k),
                       ("forces", f_pme, f_r + f_k)):
        diff = (a - b).abs().max().item()
        scale = b.abs().max().item()
        phase(f"composite particle_mesh_ewald {name} vs real + reciprocal "
              f"called apart: max |diff| {diff:.3e} (scale {scale:.3e})")
        if not diff <= 1e-6 * scale:
            raise AssertionError(f"composite particle_mesh_ewald {name} "
                                 "differ from the parts")
    # a single-system mesh the windowed path rejects: the dense route
    mesh36 = (36, 36, 36)
    (_, f36), _ = drive(
        "composite pme_reciprocal_space at 36^3 (dense route)",
        lambda: pme_reciprocal_space(pos_c, q_c, cell_c, alpha,
                                     mesh_dimensions=mesh36,
                                     compute_forces=True),
        dense_keys, forbid=win_keys)
    _, f36_64 = pme_reciprocal_space(
        pos_c.double(), q_c.double(), cell_c.double(), alpha,
        mesh_dimensions=mesh36, compute_forces=True)
    check_errors("composite PME 36^3 dense route f32 kernels vs f64 plain",
                 f36, f36_64, tuple(BAR_FACTOR * v
                                    for v in JAX_F32_BARS["pme"]))
    del nm, sh, f36_64

    # -- the main-path system, 109,744 atoms -------------------------------
    pos, q, cell = full["pos"], full["q"], full["cell"]
    n = pos.shape[0]
    label = f"main path {n} atoms"
    k = density_max_neighbors(n, cell, cutoff)

    def build():
        return cell_list(pos, cutoff, cell, pbc, max_neighbors=k)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    nm, num, sh = build()
    assert_max_neighbors(nm, num)
    e_r, f_r = ewald_real_space(pos, q, cell, alpha, neighbor_matrix=nm,
                                neighbor_matrix_shifts=sh,
                                compute_forces=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    capture = install_capture()
    (e_p, f_p), _ = drive(
        f"{label} particle_mesh_ewald(neighbor_matrix=..., 128^3)",
        lambda: particle_mesh_ewald(pos, q, cell, alpha,
                                    mesh_dimensions=FULL_MESH,
                                    neighbor_matrix=nm,
                                    neighbor_matrix_shifts=sh,
                                    compute_forces=True),
        win_keys, forbid=dense_keys)
    capture.restore()
    phase(f"{label}: cell list K {k}, max count {int(num.max())}, "
          f"{int(num.sum())} pairs; peak memory of the cell list and the "
          f"real space {peak / 2**20:.1f} MiB "
          "(torch.cuda.max_memory_allocated; the PME drive prints its own)")
    for name, t in (("real energies", e_r), ("pme energies", e_p)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{label} {name}: non-finite")
    check_forces(f"{label} real space", f_r)
    check_forces(f"{label} PME", f_p)
    check_errors(f"{label} ewald_real_space forces vs window engine",
                 f_r, full["f_c"], ELEC_BARS["real_vs_grid"])
    check_errors(f"{label} ewald_real_space energies vs window engine",
                 e_r, full["e_c"], ELEC_BARS["real_vs_grid"])
    g = full["grid"]()
    e_g, f_g = grid_particle_mesh_ewald(g, pos, q, cell, cutoff, alpha,
                                        mesh_dimensions=FULL_MESH)
    del g
    check_errors(f"{label} particle_mesh_ewald forces vs "
                 "grid_particle_mesh_ewald", f_p, f_g,
                 ELEC_BARS["pme_vs_grid"])
    check_errors(f"{label} particle_mesh_ewald energies vs "
                 "grid_particle_mesh_ewald", e_p, e_g,
                 ELEC_BARS["pme_vs_grid"])
    stages = {
        "cell_list": build,
        "ewald_real_space": lambda: ewald_real_space(
            pos, q, cell, alpha, neighbor_matrix=nm,
            neighbor_matrix_shifts=sh, compute_forces=True),
        "pme_reciprocal_space": lambda: pme_reciprocal_space(
            pos, q, cell, alpha, mesh_dimensions=FULL_MESH,
            compute_forces=True),
    }
    steady = {name: cuda_time_ms(fn, reps=3) for name, fn in stages.items()}
    phase(f"{label} stage ms (CUDA events, median of 3 after a warm-up): "
          + ", ".join(f"{k_} {v:.3f}" for k_, v in steady.items()))
    profile_step(f"{label} cell list + real space + PME", lambda: (
        stages["cell_list"](), stages["ewald_real_space"](),
        stages["pme_reciprocal_space"]()))
    compare_kernels(capture.calls, f"{label} particle_mesh_ewald")
    del nm, sh, e_r, f_r, e_p, f_p, e_g, f_g

    # -- the simple-cubic crystal ------------------------------------------
    a, rc = CRYSTAL["a"], CRYSTAL["cutoff"]

    def crystal(n_rep):
        pts = np.stack(np.meshgrid(*([np.arange(n_rep)] * 3), indexing="ij"),
                       -1).reshape(-1, 3) * a
        return (torch.as_tensor(pts, dtype=torch.float32, device=dev),
                torch.eye(3, device=dev) * (n_rep * a))

    pos_x, cell_x = crystal(CRYSTAL["cell_list_n_rep"])
    nx_ = pos_x.shape[0]
    kx = 32

    def crystal_cells(half=False):
        return cell_list(pos_x, rc, cell_x, pbc, max_neighbors=kx,
                         half_fill=half)

    torch.cuda.reset_peak_memory_stats(dev)
    nm, num, sh = crystal_cells()
    peak = torch.cuda.max_memory_allocated(dev)
    if not bool((num == 18).all()):
        raise AssertionError(f"crystal {nx_}: counts {num.min().item()}.."
                             f"{num.max().item()}, expected 18")
    _, half, _ = crystal_cells(True)
    if int(half.sum()) != 9 * nx_:
        raise AssertionError(f"crystal {nx_}: half_fill gave "
                             f"{int(half.sum())} pairs, expected {9 * nx_}")
    ms_cl = cuda_time_ms(crystal_cells, reps=3)
    phase(f"crystal {nx_} atoms (a = {a} A, {rc} A) cell_list: every atom "
          f"18 neighbors, half_fill {9 * nx_} pairs; {ms_cl:.3f} ms (CUDA "
          f"events, median of 3; reference H100 "
          f"{REFERENCE_MS['cell list 262,144']} ms), peak memory "
          f"{peak / 2**20:.1f} MiB")
    del nm, sh
    pos_x, cell_x = crystal(CRYSTAL["naive_n_rep"])
    nx_ = pos_x.shape[0]
    nm_n, num_n, sh_n = naive_neighbor_list(pos_x, rc, pbc=pbc, cell=cell_x,
                                            max_neighbors=kx)
    nm_c, num_c, sh_c = cell_list(pos_x, rc, cell_x, pbc, max_neighbors=kx)
    same = torch.equal(row_keys(nm_n, num_n, sh_n, nx_),
                       row_keys(nm_c, num_c, sh_c, nx_))
    lst, ptr, _ = naive_neighbor_list(pos_x, rc, pbc=pbc, cell=cell_x,
                                      max_neighbors=kx,
                                      return_neighbor_list=True)
    if not (same and bool((num_n == 18).all())
            and lst.shape[1] == int(ptr[-1]) == int(num_n.sum())):
        raise AssertionError(f"crystal {nx_}: naive and cell list differ "
                             f"({same}) or the CSR form is off")
    ms_naive = cuda_time_ms(lambda: naive_neighbor_list(
        pos_x, rc, pbc=pbc, cell=cell_x, max_neighbors=kx), reps=3)
    phase(f"crystal {nx_} atoms naive_neighbor_list: rows equal the cell "
          f"list's as sets, CSR length {lst.shape[1]}; {ms_naive:.3f} ms "
          f"(CUDA events, median of 3; reference H100 16,384 atoms "
          f"{REFERENCE_MS['naive 16,384']} ms)")
    del nm_n, sh_n, nm_c, sh_c, lst

    # -- batched Ewald and PME (the 16 x 2,000 case) -----------------------
    systems = ewald_batch_systems(dev)
    nb, na, _ = EWALD_BATCH["cases"][1]
    pos_b, q_b, cells_b, bidx = systems[(nb, na)]
    acc = EWALD_BATCH["accuracy"]
    label = f"batch {nb} x {na:,}"
    params = estimate_ewald_parameters(pos_b, cells_b, bidx, acc)
    rc_b = float(params.real_space_cutoff.max())

    def batch_run(dtype):
        p, qq, cc = pos_b.to(dtype), q_b.to(dtype), cells_b.to(dtype)
        k_b = density_max_neighbors(na, cc[:1], rc_b)
        nm, num, sh = neighbor_list(p, rc_b, cell=cc, pbc=pbc,
                                    batch_idx=bidx, max_neighbors=k_b)
        assert_max_neighbors(nm, num)
        ew = ewald_summation(p, qq, cc, batch_idx=bidx, neighbor_matrix=nm,
                             neighbor_matrix_shifts=sh, compute_forces=True,
                             accuracy=acc)
        pm = particle_mesh_ewald(p, qq, cc, batch_idx=bidx,
                                 neighbor_matrix=nm,
                                 neighbor_matrix_shifts=sh,
                                 compute_forces=True, accuracy=acc)
        return ew, pm, (k_b, int(num.max()), int(num.sum()))

    torch.cuda.reset_peak_memory_stats(dev)
    (ew, pm, nl_info), _ = drive(f"{label} neighbor_list + ewald_summation "
                                 "+ particle_mesh_ewald (f32)",
                                 lambda: batch_run(torch.float32), [])
    peak = torch.cuda.max_memory_allocated(dev)
    for name, (e, f) in (("ewald", ew), ("pme", pm)):
        if not (torch.isfinite(e).all() and torch.isfinite(f).all()):
            raise AssertionError(f"{label} {name}: non-finite")
        check_forces(f"{label} {name}", f.reshape(nb, na, 3))
    ew64, pm64, _ = batch_run(torch.float64)
    phase(f"{label}: alpha {float(params.alpha[0]):.4f}, real-space cutoff "
          f"{rc_b:.3f} A, K {nl_info[0]}, max count {nl_info[1]}, "
          f"{nl_info[2]} pairs, mesh "
          f"{pme.estimate_pme_mesh_dimensions(cells_b, params.alpha, acc)};"
          f" peak memory {peak / 2**20:.1f} MiB")
    check_errors(f"{label} ewald_summation forces f32 vs f64", ew[1],
                 ew64[1], ELEC_BARS["batch_ewald_f32_vs_f64"])
    check_errors(f"{label} particle_mesh_ewald forces f32 vs f64", pm[1],
                 pm64[1], ELEC_BARS["batch_pme_f32_vs_f64"])
    check_errors(f"{label} particle_mesh_ewald vs ewald_summation forces "
                 "(f64)", pm64[1], ew64[1], ELEC_BARS["batch_ewald_vs_pme"])
    del ew64, pm64
    alpha_b = float(params.alpha[0])
    mesh_d = EWALD_BATCH["dense_mesh"]
    e_i, f_i = pme_reciprocal_space(pos_b, q_b, cells_b, alpha_b,
                                    mesh_dimensions=mesh_d, batch_idx=bidx,
                                    compute_forces=True)
    (e_d, f_d), _ = drive(
        f"{label} batch_pme_reciprocal at {mesh_d[0]}^3 (dense engine)",
        lambda: batch_pme_reciprocal(
            pos_b.reshape(nb, na, 3), q_b.reshape(nb, na), cells_b,
            alpha_b, mesh_d, compute_forces=True, engine="dense"),
        dense_keys, forbid=win_keys)
    check_errors(f"{label} pme_reciprocal_space(batch_idx) vs "
                 "batch_pme_reciprocal forces", f_i.reshape(nb, na, 3),
                 f_d, ELEC_BARS["batch_idx_vs_dense"])
    phase(f"{label} pme_reciprocal_space(batch_idx) vs batch_pme_reciprocal"
          f" energies: max |diff| "
          f"{(e_i.reshape(nb, na) - e_d).abs().max().item():.3e}")
    for (b, n_s), (p, qq, cc, bi) in sorted(systems.items()):
        prm = estimate_ewald_parameters(p[:n_s], cc[0], None, acc)
        kv = generate_k_vectors_ewald_summation(
            cc, float(prm.reciprocal_space_cutoff[0]))
        a_arr = torch.full((b,), float(prm.alpha[0]), device=dev)

        def recip():
            return ewald_reciprocal_space(p, qq, cc, kv, a_arr,
                                          batch_idx=bi)

        ms = cuda_time_ms(recip, reps=3)
        dev_ms = device_time_ms(recip, reps=3)
        phase(f"ewald_reciprocal_space energies {b} x {n_s} "
              f"({kv.shape[1]} k-vectors): {ms:.3f} ms (CUDA events, median"
              f" of 3), device {_ms(dev_ms)} (reference H100 "
              f"{REFERENCE_MS.get(f'ewald recip {b} x {n_s:,}')} ms)")


def install_surface_capture():
    """:func:`install_capture` plus the dense kernels as ``spline`` imported
    them (the channel and vector routes)."""
    from nvalchemiops_torch import spline

    cap = install_capture()
    cap.wrap(spline, "separable_spread", lambda *a: "separable_spread")
    cap.wrap(spline, "separable_gather", lambda *a: "separable_gather")
    return cap


def check_equal(label, pairs):
    """Fail unless each ``(name, a, b)`` holds equal tensors."""
    for name, a, b in pairs:
        if not torch.equal(a, b):
            diff = (a.double() - b.double()).abs().max().item()
            raise AssertionError(f"{label}: {name} differ (max {diff:.3e})")


def check_rel(label, got, want, rtol):
    """Fail unless ``max |got - want| <= rtol max |want|``; returns the
    ratio."""
    err = (got.double() - want.double()).abs().max().item()
    scale = want.double().abs().max().item()
    phase(f"{label}: max |diff| / scale {err / scale:.3e} (bar {rtol:g})")
    if not (np.isfinite(err) and err <= rtol * scale):
        raise AssertionError(f"{label}: above its bar")
    return err / scale


def run_surface(dev, full):
    """Phase 14: ``build_atom_grid_auto``, the mesh-tile refresh in an MD
    loop, the channel and vector spline API on both routes, the
    matrix-product DFT, the dense Coulomb and the f32 B-spline weights;
    every kernel call captured is replayed against its plain version."""
    from nvalchemiops_torch import composite, spline
    from nvalchemiops_torch import spline_windowed as sw
    from nvalchemiops_torch.grid import (
        build_atom_grid_auto, grid_coulomb_energy_forces,
    )
    from nvalchemiops_torch.interactions.dispersion.grid_d3 import grid_dftd3
    from nvalchemiops_torch.interactions.electrostatics import (
        batch_dense_coulomb_energy_forces, batch_pme_reciprocal,
        coulomb_energy_forces, dense_coulomb_energy_forces, pme,
    )
    from nvalchemiops_torch.interactions.electrostatics.dense import (
        DENSE_PAIR_CHUNK,
    )
    from nvalchemiops_torch.kernels import separable_spline as ss
    from nvalchemiops_torch.neighborlist import (
        assert_max_neighbors, neighbor_list,
    )

    pos, q, cell, alpha = full["pos"], full["q"], full["cell"], full["alpha"]
    cutoff = full["cutoff"]
    n = pos.shape[0]
    pbc = np.array([True] * 3)
    win_keys = ["windowed_spread", "windowed_gather_grad"]
    dense_keys = ["separable_spread", "separable_gather"]
    replays = []

    # -- 14.1: build_atom_grid_auto ----------------------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = build_atom_grid_auto(pos, cell, pbc, cutoff)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    ncells = math.prod(g.dims)
    slotted = int((g.flat_slot < ncells * g.cap).sum())
    phase(f"build_atom_grid_auto {n} atoms ({cutoff} A): dims {g.dims} "
          f"radius {g.radius} cap {g.cap} counts_max {int(g.counts_max)}, "
          f"{slotted} of {n} atoms slotted; host wall {host_ms:.3f} ms "
          "(first call, synchronized)")
    if slotted != n or int(g.counts_max) > g.cap:
        raise AssertionError("build_atom_grid_auto dropped atoms")
    sweeps = ["window_sweep_cn", "window_sweep_d3_direct",
              "window_sweep_chain", "window_sweep_coulomb"]
    capture = install_surface_capture()
    ((_, f_d3, _), (_, f_c)), _ = drive(
        "auto grid: grid_dftd3 + grid_coulomb_energy_forces (window engine)",
        lambda: (grid_dftd3(g, *full["d3_args"]),
                 grid_coulomb_energy_forces(g, q, cutoff, alpha)),
        sweeps, forbid=off_path(sweeps))
    capture.restore()
    replays.append(("auto grid", capture.calls))
    check_errors("auto grid D3 forces vs phase 4", f_d3, full["f_d3"],
                 ENGINE_BARS["d3"])
    check_errors("auto grid Coulomb forces vs phase 4", f_c, full["f_c"],
                 ENGINE_BARS["coulomb"])
    del g, f_d3, f_c

    # -- 14.2: the MD loop of the mesh-tile refresh ------------------------
    steps, max_step = MD_REFRESH["steps"], MD_REFRESH["max_step"]
    if not torch.equal(cell, torch.diag(torch.diagonal(cell))):
        raise AssertionError("the MD loop moves atoms on an orthorhombic "
                             "cell")
    tile_cap = sw.observed_tile_capacity(pos, cell, FULL_MESH)
    tiles0 = sw.build_mesh_tiles(pos, cell, FULL_MESH, 4, tile_cap)
    if int(tiles0.counts_max) > tile_cap:
        raise AssertionError("MD loop: tile overflow at the build")
    dims_t = torch.tensor(FULL_MESH, dtype=pos.dtype, device=dev)
    nt = [d // tiles0.tile for d in FULL_MESH]
    lin = torch.div(tiles0.flat_slot, tile_cap, rounding_mode="floor").long()
    tile_xyz = torch.stack([lin // (nt[1] * nt[2]), (lin // nt[2]) % nt[1],
                            lin % nt[2]], dim=-1).to(pos.dtype)
    centre = (tile_xyz * tiles0.tile + tiles0.tile / 2) / dims_t
    inv = torch.linalg.inv(cell)
    gen = torch.Generator(device=dev)
    gen.manual_seed(MD_REFRESH["seed"])

    def md_step(p):
        """Every atom up to ``max_step`` toward its tile's centre (per
        axis at most max_step / sqrt(3))."""
        frac = p @ inv
        toward = torch.sign(centre - (frac - torch.floor(frac)))
        u = torch.rand(p.shape, generator=gen, device=dev, dtype=p.dtype)
        return p + toward * u * (max_step / math.sqrt(3.0))

    def md_loop():
        p, tiles = pos, tiles0
        for _ in range(steps):
            p = md_step(p)
            if bool(sw.mesh_tiles_need_rebuild(tiles, p)):
                raise AssertionError("MD loop: the detector asked for a "
                                     "rebuild")
            tiles = sw.refresh_mesh_tiles(tiles, p)
            e_r, f_r, _ = pme._windowed_pme(tiles, q, cell, alpha, 4, True,
                                            False)
            fresh = sw.build_mesh_tiles(p, cell, FULL_MESH, 4, tile_cap)
            e_f, f_f, _ = pme._windowed_pme(fresh, q, cell, alpha, 4, True,
                                            False)
            check_equal("MD loop refreshed vs fresh tiles", [
                (k, getattr(tiles, k), getattr(fresh, k))
                for k in ("smat", "flat_slot", "aid")]
                + [("energies", e_r, e_f), ("forces", f_r, f_f)])
        return p, tiles, f_r

    capture = install_surface_capture()
    (p_md, tiles_md, f_md), _ = drive(
        f"MD loop {steps} steps of <= {max_step} A at {n} atoms, "
        f"{FULL_MESH[0]}^3 (refresh, windowed PME, fresh build)", md_loop,
        win_keys,
        forbid=dense_keys)
    capture.restore()
    replays.append(("MD loop", capture.calls))
    check_forces("MD loop PME on refreshed tiles", f_md)
    moved = (p_md - pos).norm(dim=-1).max().item()
    phase(f"MD loop: every step the detector read False and the refreshed "
          f"tiles (smat, flat_slot, aid), energies and forces equalled a "
          f"fresh build's bit for bit; largest total move {moved:.4f} A")
    ms_refresh = cuda_time_ms(lambda: sw.refresh_mesh_tiles(tiles_md, p_md))
    ms_build = cuda_time_ms(lambda: sw.build_mesh_tiles(
        p_md, cell, FULL_MESH, 4, tile_cap))
    ms_detect = cuda_time_ms(lambda: sw.mesh_tiles_need_rebuild(tiles_md,
                                                                p_md))
    phase(f"MD loop at {n} atoms, {FULL_MESH[0]}^3: refresh_mesh_tiles "
          f"{ms_refresh:.3f}"
          f" ms, build_mesh_tiles {ms_build:.3f} ms, "
          f"mesh_tiles_need_rebuild {ms_detect:.3f} ms (CUDA events, median "
          "of 5 after a warm-up)")
    p_cross = p_md.clone()
    p_cross[0, 0] += cell[0, 0] * tiles0.tile / FULL_MESH[0]
    if not bool(sw.mesh_tiles_need_rebuild(tiles_md, p_cross)):
        raise AssertionError("MD loop: a tile crossing was not detected")
    phase("MD loop: atom 0 moved one tile along x; the detector reads True")
    del tiles0, tiles_md, p_md, p_cross, f_md

    # -- 14.3: channels and vector fields -----------------------------------
    fields = torch.randn((n, 2), generator=gen, device=dev, dtype=pos.dtype)
    vals = torch.cat([q[:, None], fields], dim=1)
    for mesh in CHANNEL_MESHES:
        route = "windowed" if sw.windowed_applicable(mesh, 4) else "dense"
        expect, forbid = ((["windowed_spread"], dense_keys)
                          if route == "windowed" else (dense_keys, win_keys))
        label = f"channels C = 3 at {mesh[0]}^3 ({route} route)"

        def channel_calls(p, v, qq, cc, m=mesh, meshes=None):
            out = spline.spline_spread_channels(p, v, cc, m)
            src = out if meshes is None else meshes
            vfield = src.permute(1, 2, 3, 0).contiguous()
            return (out, spline.spline_gather_channels(p, src, cc),
                    spline.spline_gather_vec3(p, qq, vfield, cc), vfield)

        capture = install_surface_capture()
        (meshes, chan, vec, vfield), counts = drive(
            label, lambda: channel_calls(pos, vals, q, cell), expect,
            forbid=forbid)
        capture.restore()
        replays.append((label, capture.calls))
        if route == "windowed" and counts["windowed_spread"] != 3:
            raise AssertionError(f"{label}: {counts}")
        for c in range(3):
            check_equal(f"{label} channel {c} vs its single-channel call", [
                ("spread", meshes[c], spline.spline_spread(
                    pos, vals[:, c].contiguous(), cell, mesh)),
                ("gather", chan[:, c], spline.spline_gather(
                    pos, meshes[c], cell)),
                ("vec3", vec[:, c], q * spline.spline_gather(
                    pos, vfield[..., c], cell))])
        ref = channel_calls(pos.double(), vals.double(), q.double(),
                            cell.double(), meshes=meshes.double())
        errs = [check_rel(f"{label} {name} f32 vs f64 plain", a, b,
                          CHANNEL_F32_RTOL)
                for name, a, b in zip(("spread", "gather", "vec3"),
                                      (meshes, chan, vec), ref[:3])]
        ms = cuda_time_ms(lambda: channel_calls(pos, vals, q, cell))
        phase(f"{label}: each channel equals its single-channel call bit for "
              f"bit; f32 vs f64 {', '.join(f'{e:.3e}' for e in errs)}; the "
              f"three calls {ms:.3f} ms (CUDA events, median of 5)")
        del meshes, chan, vec, vfield, ref

    # -- 14.4: the matrix-product DFT on the batched PME --------------------
    cfg = PME_BATCH
    pos_b, q_b, cell_b = pme_batch_system(dev)
    label = f"batched PME {cfg['b']} x {cfg['n']} at {cfg['mesh'][0]}^3"

    def batch_pme(mode, p=pos_b, qq=q_b, cc=cell_b):
        return batch_pme_reciprocal(p, qq, cc, cfg["alpha"], cfg["mesh"],
                                    compute_forces=True, fft_mode=mode)

    capture = install_surface_capture()
    (e_m, f_m), _ = drive(f"{label} fft_mode='matmul'",
                          lambda: batch_pme("matmul"), dense_keys,
                          forbid=win_keys)
    capture.restore()
    replays.append((f"{label} matmul", capture.calls))
    e_x, f_x = batch_pme("xla")
    e_64, f_64 = batch_pme("xla", pos_b.double(), q_b.double(),
                           cell_b.double())
    check_errors(f"{label} matmul vs xla forces", f_m, f_x,
                 SURFACE_BARS["matmul_vs_xla"])
    check_errors(f"{label} matmul vs xla energies", e_m, e_x,
                 SURFACE_BARS["matmul_vs_xla"])
    for mode, f in (("matmul", f_m), ("xla", f_x)):
        check_errors(f"{label} {mode} f32 vs f64 plain forces", f, f_64,
                     SURFACE_BARS["pme_f32_vs_f64"])
    times = {mode: cuda_time_ms(lambda m=mode: batch_pme(m))
             for mode in ("matmul", "xla")}
    mesh_q = ss.separable_spread_plain(*pme._stencil(
        pos_b, cell_b.expand(cfg["b"], 3, 3), cfg["mesh"], 4)[:2], q_b,
        cfg["mesh"])
    alphas = torch.full((cfg["b"],), cfg["alpha"], device=dev)
    conv = {mode: device_time_ms(lambda m=mode: pme._potential(
        mesh_q, cell_b.expand(cfg["b"], 3, 3), alphas, cfg["mesh"], 4,
        None, m)) for mode in ("matmul", "xla")}
    phase(f"{label} E+F: fft_mode='matmul' {times['matmul']:.3f} ms, 'xla' "
          f"{times['xla']:.3f} ms (CUDA events, median of 5); the "
          f"convolution alone (Green's function included) device "
          f"{_ms(conv['matmul'])} vs {_ms(conv['xla'])}")
    del e_m, f_m, e_x, e_64, mesh_q

    # -- 14.5: dense Coulomb --------------------------------------------------
    pos_c, cell_c, _, q_c, *_ = composite.build_system()
    f32 = dict(dtype=torch.float32, device=dev)
    (_, f_dc), _ = drive(
        "composite dense_coulomb_energy_forces (1,024 atoms)",
        lambda: dense_coulomb_energy_forces(
            torch.as_tensor(pos_c, **f32), torch.as_tensor(q_c, **f32),
            torch.as_tensor(cell_c, **f32), composite.CUTOFF,
            composite.ALPHA), [])
    ref = composite.load_reference()
    forces = {"coulomb": f_dc.double().cpu().numpy()}
    rel = composite.relative_errors(forces, ref)["coulomb"]
    rms = composite.rms_errors(forces, ref)["coulomb"]
    bar = tuple(BAR_FACTOR * v for v in JAX_F32_BARS["coulomb"])
    phase(f"composite dense Coulomb vs f64 reference: max rel {rel:.3e} (bar "
          f"{bar[0]:.3e}), rms rel {rms:.3e} (bar {bar[1]:.3e})")
    if not (rel <= bar[0] and rms <= bar[1]):
        raise AssertionError("composite dense Coulomb above its bar")
    rc, a_c = DENSE_COULOMB["cutoff"], DENSE_COULOMB["alpha"]
    b, nb = cfg["b"], cfg["n"]
    label = f"batch_dense_coulomb_energy_forces {b} x {nb} ({rc} A)"
    torch.cuda.reset_peak_memory_stats(dev)
    (e_dc, f_dc), _ = drive(label, lambda: batch_dense_coulomb_energy_forces(
        pos_b, q_b, cell_b, rc, a_c), [])
    peak = torch.cuda.max_memory_allocated(dev)
    ms_dense = cuda_time_ms(lambda: batch_dense_coulomb_energy_forces(
        pos_b, q_b, cell_b, rc, a_c), reps=3)
    check_forces(label, f_dc)
    bidx = torch.arange(b, device=dev).repeat_interleave(nb)
    k = density_max_neighbors(nb, cell_b, rc)

    def list_coulomb(p, qq, cc):
        cells = cc.expand(b, 3, 3).contiguous()
        nm, num, sh = neighbor_list(p.reshape(-1, 3), rc, cell=cells,
                                    pbc=pbc, batch_idx=bidx, max_neighbors=k)
        assert_max_neighbors(nm, num)
        e, f = coulomb_energy_forces(p.reshape(-1, 3), qq.reshape(-1), cells,
                                     rc, a_c, neighbor_matrix=nm,
                                     neighbor_matrix_shifts=sh,
                                     batch_idx=bidx)
        return e.reshape(b, nb), f.reshape(b, nb, 3)

    e_l, f_l = list_coulomb(pos_b, q_b, cell_b)
    check_errors(f"{label} forces vs the list Coulomb", f_dc, f_l,
                 SURFACE_BARS["dense_vs_list_coulomb"])
    check_errors(f"{label} energies vs the list Coulomb", e_dc, e_l,
                 SURFACE_BARS["dense_vs_list_coulomb"])
    # in f64 the two differ by the erfc polynomial alone
    f64 = (pos_b.double(), q_b.double(), cell_b.double())
    _, f_d64 = batch_dense_coulomb_energy_forces(*f64, rc, a_c)
    _, f_l64 = list_coulomb(*f64)
    check_errors(f"{label} forces vs the list Coulomb, both f64", f_d64,
                 f_l64, SURFACE_BARS["dense_vs_list_coulomb_f64"])
    check_errors(f"{label} f32 forces vs f64", f_dc, f_d64,
                 SURFACE_BARS["dense_coulomb_f32_vs_f64"])
    del f_d64, f_l64
    phase(f"{label}: {ms_dense:.3f} ms (CUDA events, median of 3), peak "
          f"memory {peak / 2**20:.1f} MiB (torch.cuda.max_memory_allocated; "
          f"passes of {DENSE_PAIR_CHUNK} pair slots), K {k} for the list")
    del e_dc, f_dc, e_l, f_l

    # -- 14.6: fault A2, phase 3's PME errors --------------------------------
    rel_p, rms_p = full["pme_err"]
    phase(f"phase 3 PME vs bench_acc_ref.npz: expanded B-spline forms "
          f"(parent tree) max rel {PARENT_PHASE3_PME[0]:.3e}, rms rel "
          f"{PARENT_PHASE3_PME[1]:.3e}; local forms (this tree) max rel "
          f"{rel_p:.3e}, rms rel {rms_p:.3e}")
    # where phase 8's dense-vs-windowed reading comes from: each engine's
    # f32 spread and forces against the f64 plain path, and the two
    # engines against each other (a reading, no bar)
    cells_b = cell_b.expand(cfg["b"], 3, 3)
    g64, w64 = pme._stencil(pos_b.double(), cells_b.double(), cfg["mesh"],
                            4)[:2]
    mesh_64 = ss.separable_spread_plain(g64, w64, q_b.double(), cfg["mesh"])
    g32, w32 = pme._stencil(pos_b, cells_b, cfg["mesh"], 4)[:2]
    mesh_d = ss.separable_spread(g32, w32, q_b, cfg["mesh"])
    mesh_w = []
    for s_ in range(cfg["b"]):
        cap_s = sw.observed_tile_capacity(pos_b[s_], cell_b, cfg["mesh"])
        mesh_w.append(sw.windowed_spread(sw.build_mesh_tiles(
            pos_b[s_], cell_b, cfg["mesh"], 4, cap_s), q_b[s_]))
    mesh_w = torch.stack(mesh_w)
    _, f_w = batch_pme_reciprocal(pos_b, q_b, cell_b, cfg["alpha"],
                                  cfg["mesh"], compute_forces=True,
                                  engine="windowed")

    def mesh_rel(a, b):
        return ((a.double() - b.double()).abs().max()
                / b.double().abs().max()).item()

    fd, fw, dw = (force_errors(f_x, f_64), force_errors(f_w, f_64),
                  force_errors(f_x, f_w))
    phase(f"batched PME {cfg['b']} x {cfg['n']} at {cfg['mesh'][0]}^3 "
          f"engines in f32 (max rel, rms rel): spread vs f64 dense "
          f"{mesh_rel(mesh_d, mesh_64):.3e}, windowed "
          f"{mesh_rel(mesh_w, mesh_64):.3e}, dense vs windowed "
          f"{mesh_rel(mesh_d, mesh_w):.3e} (max |diff| / max |mesh|); "
          f"forces vs f64 dense {fd[0]:.3e} / {fd[1]:.3e}, windowed "
          f"{fw[0]:.3e} / {fw[1]:.3e}, dense vs windowed {dw[0]:.3e} / "
          f"{dw[1]:.3e}")
    del f_x, f_64, f_w, mesh_64, mesh_d, mesh_w

    # -- 14.7: replays ----------------------------------------------------------
    for label, calls in replays:
        compare_kernels(calls, f"phase 14 {label}")



def energy_error(e, ref):
    """max |e - ref| / max |ref| over systems."""
    e, ref = e.double().reshape(-1), ref.double().reshape(-1)
    return ((e - ref).abs().max() / ref.abs().max()).item()


def frobenius_error(v, ref):
    """||v - ref||_F / ||ref||_F."""
    v, ref = v.double(), ref.double()
    return (torch.linalg.norm(v - ref) / torch.linalg.norm(ref)).item()


def check_bar(name, err, bar):
    phase(f"{name}: {err:.3e} (bar {bar:.3e})")
    if not err <= bar:
        raise AssertionError(f"{name}: above its bar")
    return err


def dftd3_timing(label, fn, reference=None, profile=False):
    """Steady time of ``fn`` (CUDA events, median of 3 after a warm-up, or
    one repeat where the warm-up took more than ``DFTD3_SLOW_S``), its peak
    memory (statistics reset just before one call; also above what was
    allocated before it) and with ``profile`` the idle share."""
    from nvalchemiops_torch.interactions.dispersion import _kernels

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if first > DFTD3_SLOW_S:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ms, how = a.elapsed_time(b), (f"one repeat: the warm-up took "
                                      f"{first:.1f} s")
    else:
        ms, how = cuda_time_ms(fn, reps=3), "median of 3 after a warm-up"
    ref = ("" if reference is None else
           f"; the reference's H100 row {reference[0]} ms, "
           f"{reference[1]} GB")
    phase(f"{label}: {ms:.3f} ms (CUDA events, {how}), peak memory "
          f"{peak / 2**20:.1f} MiB ({(peak - base) / 2**20:.1f} MiB above "
          f"the inputs), D3_PAIR_CHUNK {_kernels.D3_PAIR_CHUNK}{ref}")
    if profile:
        profile_step(label, fn)
    return ms, peak


def run_dftd3(dev, full):
    """Phase 15: ``dftd3`` on the port's neighbour matrices and pair lists
    and the window engine's virial; ``full`` holds phase 4's inputs, grid
    builders and D3 time and phase 6's 21.2 A ``batch_dftd3`` output."""
    from nvalchemiops_torch import composite
    from nvalchemiops_torch.interactions.dispersion import (
        D3Parameters, dftd3, grid_d3,
    )
    from nvalchemiops_torch.interactions.dispersion.d3_data import (
        realistic_test_tables,
    )
    from nvalchemiops_torch.kernels import launch_counts
    from nvalchemiops_torch.neighborlist import (
        assert_max_neighbors, get_neighbor_list_from_neighbor_matrix,
        neighbor_list,
    )

    pbc = np.array([True] * 3)
    no_kernel = list(launch_counts)
    d3_bar = tuple(BAR_FACTOR * v for v in JAX_F32_BARS["d3"])
    a1, a2, s8 = composite.D3_A1, composite.D3_A2, composite.D3_S8
    real = realistic_test_tables(np.float64)

    def matrix(pos, cell, cut, **kw):
        k = density_max_neighbors(pos.shape[0], cell, cut)
        nm, num, sh = neighbor_list(pos, cut, cell=cell, pbc=pbc,
                                    max_neighbors=k, **kw)
        assert_max_neighbors(nm, num)
        return nm, num, sh, k

    def as_list(nm, num, sh):
        nl, ptr, us = get_neighbor_list_from_neighbor_matrix(
            nm, num, sh, fill_value=nm.shape[0])
        return dict(neighbor_list=nl, neighbor_ptr=ptr, unit_shifts=us)

    # -- 15.1: the 1,024-atom composite --------------------------------------
    pos_np, cell_np, numbers, _, rcov, r4r2, cna, c6 = \
        composite.build_system()
    params = D3Parameters(rcov, r4r2, c6, real["cn_ref"], device=dev)
    pos = torch.as_tensor(pos_np, dtype=torch.float32, device=dev)
    cell = torch.as_tensor(cell_np, dtype=torch.float32, device=dev)
    cutoff = composite.CUTOFF
    nm, num, sh, k = matrix(pos, cell, cutoff, method="cell_list")

    def run_c(**fmt):
        return dftd3(pos, numbers, a1, a2, s8, d3_params=params, cell=cell,
                     **fmt)

    fmt_m = dict(neighbor_matrix=nm, neighbor_matrix_shifts=sh)
    (e_m, f_m, _), _ = drive(f"composite dftd3 matrix (K {k}, "
                             f"{int(num.sum())} pairs)", lambda: run_c(
                                 **fmt_m), [], forbid=no_kernel)
    ref = composite.load_reference()
    got = {"d3": f_m.double().cpu().numpy()}
    rel = composite.relative_errors(got, ref)["d3"]
    rms = composite.rms_errors(got, ref)["d3"]
    phase(f"composite dftd3 matrix forces vs f64 reference: max rel "
          f"{rel:.3e} (bar {d3_bar[0]:.3e}), rms rel {rms:.3e} (bar "
          f"{d3_bar[1]:.3e})")
    if not (rel <= d3_bar[0] and rms <= d3_bar[1]):
        raise AssertionError("composite dftd3 above the D3 bar")
    e_l, f_l, _ = run_c(**as_list(nm, num, sh))
    check_errors("composite dftd3 list vs matrix forces", f_l, f_m,
                 DFTD3_BARS["composite_list_vs_matrix"])
    check_bar("composite dftd3 list vs matrix energy", energy_error(e_l, e_m),
              DFTD3_BARS["list_vs_matrix_energy"])
    # phase 3's grid_dftd3 call on the same system
    g_c = composite.build_grid(pos, cell)
    e_g, _, _ = grid_d3.grid_dftd3(
        g_c, *grid_d3.compact_d3_elements(numbers, rcov, r4r2, c6, cna),
        cutoff, a1, a2, s8)
    check_bar(f"composite dftd3 energy {e_m.item():.9e} vs grid_dftd3 "
              f"{e_g.item():.9e}", energy_error(e_m, e_g),
              DFTD3_BARS["composite_energy_vs_grid"])
    del g_c

    # -- 15.2: the window engine's virial at 109,744 atoms -----------------
    pos, cell = full["pos"], full["cell"]
    n = pos.shape[0]
    d3_args = full["d3_args"]
    num_c, rcov_c, r4r2_c, c6_c, cna_c = d3_args[:5]
    zm1, mesh = cna_c.shape
    cn_full = np.broadcast_to(cna_c[:, None, :, None],
                              (zm1, zm1, mesh, mesh)).copy()
    g = full["grid"]()
    expect = ["window_sweep_cn", "window_sweep_d3_direct",
              "window_sweep_chain"]

    def run_v():
        e, f, _, v = grid_d3.grid_dftd3(g, *d3_args, compute_virial=True,
                                        cell=cell)
        return {"d3": f, "energy": e.reshape(1), "virial": v}

    label = f"grid_dftd3(compute_virial=True) {n} atoms"
    out, counts, _ = drive_and_replay(label, run_v, expect)
    with_v = cuda_time_ms(run_v, reps=3)
    without = cuda_time_ms(lambda: grid_d3.grid_dftd3(g, *d3_args), reps=3)
    phase(f"{label}: steady {with_v:.3f} ms; on the same grid without the "
          f"virial {without:.3f} ms, phase 4's D3 stage {full['d3_ms']:.3f}"
          f" ms (CUDA events, median of 3 after a warm-up); launches "
          f"{ {k: counts[k] for k in expect} }")
    pos64, cell64 = pos.double(), cell.double()
    nm, num, sh, k = matrix(pos64, cell64, d3_args[5], method="cell_list")
    _, f64, _, v64 = dftd3(
        pos64, num_c, a1, a2, s8, covalent_radii=rcov_c, r4r2=r4r2_c,
        c6_reference=c6_c, coord_num_ref=cn_full, cell=cell64,
        neighbor_matrix=nm, neighbor_matrix_shifts=sh, compute_virial=True,
        output_dtype=None)
    del nm, sh
    errs = [frobenius_error(out["virial"], v64[0])] + [
        frobenius_error(run_v()["virial"], v64[0])
        for _ in range(VIRIAL_CALLS - 1)]
    phase(f"window virial over {VIRIAL_CALLS} calls: smallest "
          f"{min(errs):.3e} ({k} neighbours a row; virial diagonal "
          f"{[round(x, 9) for x in v64[0].diagonal().tolist()]})")
    check_bar("window virial f32 vs dftd3 f64 virial, median",
              statistics.median(errs), DFTD3_BARS["virial_f32_vs_f64"])
    check_bar("window virial f32 vs dftd3 f64 virial, largest", max(errs),
              DFTD3_BARS["virial_f32_vs_f64_largest"])
    check_errors("window f32 D3 forces vs dftd3 f64", out["d3"], f64,
                 d3_bar)
    del g
    g64 = full["grid64"]()
    v_plain = grid_d3.grid_dftd3(g64, *d3_args, compute_virial=True,
                                 cell=cell64)[3]
    check_bar("window plain path f64 virial vs dftd3 f64 virial "
              "(Frobenius)", frobenius_error(v_plain, v64[0]),
              VIRIAL_F64_RTOL)
    virial64 = v64[0]
    del g64, f64

    # -- 15.3: the reference's flagship row, 85,750 atoms at 21.2 A ---------
    cut = FLAGSHIP_D3["cutoff"]
    pos_np, cell_np, numbers, _, rcov, r4r2, _, c6 = composite.build_system(
        n_rep=FLAGSHIP_D3["n_rep"])
    params = D3Parameters(rcov, r4r2, c6, real["cn_ref"], device=dev)
    pos = torch.as_tensor(pos_np, dtype=torch.float32, device=dev)
    cell = torch.as_tensor(cell_np, dtype=torch.float32, device=dev)
    n = pos.shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nm, num, sh, k = matrix(pos, cell, cut, method="cell_list")
    torch.cuda.synchronize()
    label = f"dftd3 {n} atoms at {cut} A"
    phase(f"{label}: cell list {(time.perf_counter() - t0) * 1e3:.3f} ms "
          f"(host wall, first call), K {k}, max count {int(num.max())}, "
          f"{int(num.sum())} pairs")

    def run_f(p=pos, c=cell, **fmt):
        return dftd3(p, numbers, a1, a2, s8, d3_params=params, cell=c,
                     **(fmt or dict(neighbor_matrix=nm,
                                    neighbor_matrix_shifts=sh)))

    (e32, f32, _), _ = drive(f"{label} matrix", run_f, [], forbid=no_kernel)
    check_forces(label, f32)
    dftd3_timing(f"{label} matrix f32", run_f, REFERENCE_D3["flagship"],
                 profile=True)
    e64, f64, _ = run_f(pos.double(), cell.double(), neighbor_matrix=nm,
                        neighbor_matrix_shifts=sh)
    check_errors(f"{label} f32 vs f64 forces", f32, f64,
                 DFTD3_BARS["flagship_f32_vs_f64"])
    check_bar(f"{label} f32 vs f64 energy ({e64.item():.9e})",
              energy_error(e32, e64), DFTD3_BARS["flagship_energy_f32_vs_f64"])
    del f64
    fmt_l = as_list(nm, num, sh)
    del nm, sh
    e_l, f_l, _ = run_f(**fmt_l)
    check_errors(f"{label} list vs matrix forces", f_l, f32,
                 DFTD3_BARS["flagship_list_vs_matrix"])
    check_bar(f"{label} list vs matrix energy", energy_error(e_l, e32),
              DFTD3_BARS["list_vs_matrix_energy"])
    dftd3_timing(f"{label} list f32", lambda: run_f(**fmt_l))
    del fmt_l, f_l, f32

    # -- 15.4: the reference's batched row, 128 x 2,000 at 21.2 A -----------
    cfg = D3_BATCH
    tables, _, numbers, pos_m, _, _ = d3_batch_system(dev)
    rcov, r4r2, c6, cna = tables
    zm1, mesh = cna.shape
    cn_full = np.broadcast_to(cna[:, None, :, None],
                              (zm1, zm1, mesh, mesh)).copy()
    b, n = numbers.shape
    box, cut = cfg["matched_box"], cfg["matched_cutoff"]
    cells = torch.eye(3, device=dev).expand(b, 3, 3).contiguous() * box
    bidx = torch.arange(b, device=dev).repeat_interleave(n).int()
    pos = pos_m.reshape(-1, 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k = density_max_neighbors(n, cells[0], cut)
    nm, num, sh = neighbor_list(pos, cut, cell=cells, pbc=pbc,
                                batch_idx=bidx, max_neighbors=k)
    assert_max_neighbors(nm, num)
    torch.cuda.synchronize()
    label = f"dftd3 {b} x {n} at {cut} A"
    nl_ms = (time.perf_counter() - t0) * 1e3
    phase(f"{label}: batched neighbour list {nl_ms:.3f} ms (host wall, "
          f"first call), K {k}, max count "
          f"{int(num.max())}, {int(num.sum())} pairs")

    def run_b():
        return dftd3(pos, numbers.reshape(-1), *D3_PARAMS,
                     covalent_radii=rcov, r4r2=r4r2, c6_reference=c6,
                     coord_num_ref=cn_full, batch_idx=bidx, cell=cells,
                     neighbor_matrix=nm, neighbor_matrix_shifts=sh,
                     compute_virial=True)

    (e_b, f_b, _, v_b), _ = drive(f"{label} matrix", run_b, [],
                                  forbid=no_kernel)
    if not (torch.isfinite(e_b).all() and torch.isfinite(v_b).all()):
        raise AssertionError(f"{label}: non-finite energy or virial")
    e_d, f_d = full["batch_21"]
    check_errors(f"{label} forces vs batch_dftd3 (kernel 4)",
                 f_b.reshape(b, n, 3), f_d, DFTD3_BARS["batch_vs_dense"])
    check_bar(f"{label} per-system energies vs batch_dftd3",
              energy_error(e_b, e_d), DFTD3_BARS["batch_energy_vs_dense"])
    phase(f"{label}: virial[0] diagonal "
          f"{[round(x, 9) for x in v_b[0].diagonal().tolist()]}")
    dftd3_timing(f"{label} matrix f32 (virial on)", run_b,
                 REFERENCE_D3["batch"])
    return virial64


def run_xla_routes(dev, full):
    """Phase 16: ``engine="xla"`` on the kernels' routes, the virial where
    the JAX package takes its XLA engine's, the grid's plain offset sweeps
    and the math extras; ``full`` holds phase 4's inputs and outputs, a
    call that rebuilds its grid and phase 15's f64 virial."""
    from nvalchemiops_torch import mathops, stencil
    from nvalchemiops_torch.grid import (
        grid_coordination_numbers, grid_coulomb_energy_forces,
        grid_neighbor_count,
    )
    from nvalchemiops_torch.interactions.dispersion.dense_d3 import (
        batch_dense_dftd3,
    )
    from nvalchemiops_torch.interactions.dispersion.grid_d3 import (
        batch_grid_dftd3, grid_dftd3, grid_dftd3_coulomb,
    )
    from nvalchemiops_torch.kernels import launch_counts
    from nvalchemiops_torch.neighborlist import (
        assert_max_neighbors, neighbor_list,
    )

    bars = XLA_BARS
    pbc = np.array([True] * 3)

    def same_route(label, default, xla):
        """Drive the default call, then the ``engine="xla"`` one: the same
        kernels launched the same number of times, none other."""
        ref, counts = drive(f"{label} (default engine)", default, [])
        ran = [k for k, v in counts.items() if v]
        out, xla_counts = drive(f"{label} engine='xla'", xla, ran,
                                [k for k in launch_counts if k not in ran])
        if xla_counts != counts:
            raise AssertionError(f"{label}: engine='xla' launched "
                                 f"{xla_counts}, the default {counts}")
        return out, ref, ran

    def check_energy(name, e, ref, bar):
        return check_bar(f"{name} (max |diff| / max |ref|)",
                         energy_error(e, ref), bar)

    # -- 16.1: the main path at full width ---------------------------------
    g = full["grid"]()
    n = full["pos"].shape[0]
    d3_args, q, cutoff, alpha = (full["d3_args"], full["q"], full["cutoff"],
                                 full["alpha"])
    label = f"full width {n} atoms"
    window = ["window_sweep_cn", "window_sweep_d3_direct",
              "window_sweep_chain"]
    (e_x, f_x, cn_x), (e_w, f_w, cn_w), ran = same_route(
        f"{label} grid_dftd3", lambda: grid_dftd3(g, *d3_args),
        lambda: grid_dftd3(g, *d3_args, engine="xla"))
    if sorted(ran) != sorted(window):
        raise AssertionError(f"{label} grid_dftd3 ran {ran}, not {window}")
    check_forces(f"{label} xla D3", f_x)
    check_errors(f"{label} xla D3 forces vs the default call", f_x, f_w,
                 bars["d3_forces"])
    check_energy(f"{label} xla D3 energy vs the default call", e_x, e_w,
                 bars["d3_energy"])
    check_energy(f"{label} xla CN vs the default call", cn_x, cn_w,
                 bars["d3_cn"])
    v64 = full["virial64"]
    for how, kw in (("engine='xla', cell", dict(engine="xla",
                                                  cell=full["cell"])),
                    ("engine='block', cell", dict(engine="block",
                                                  cell=full["cell"])),
                    ("engine='pallas', cell", dict(engine="pallas",
                                                   cell=full["cell"])),
                    ("no cell", {})):
        name = f"{label} grid_dftd3(compute_virial=True) [{how}]"
        (_, _, _, v), _ = drive(name, lambda: grid_dftd3(
            g, *d3_args, compute_virial=True, **kw), window,
            [k for k in launch_counts if k not in window])
        bar = (bars["virial_no_cell"] if how == "no cell"
               else DFTD3_BARS["virial_f32_vs_f64_largest"])
        check_bar(f"{name} virial vs dftd3 f64 (Frobenius)",
                  frobenius_error(v, v64), bar)

    (e_cx, f_cx), (e_cw, f_cw), _ = same_route(
        f"{label} grid_coulomb_energy_forces",
        lambda: grid_coulomb_energy_forces(g, q, cutoff, alpha),
        lambda: grid_coulomb_energy_forces(g, q, cutoff, alpha,
                                           engine="xla"))
    check_errors(f"{label} xla Coulomb forces vs the default call", f_cx,
                 f_cw, bars["coulomb_forces"])
    check_energy(f"{label} xla Coulomb energies vs the default call", e_cx,
                 e_cw, bars["coulomb_energies"])

    def fused(**kw):
        return lambda: grid_dftd3_coulomb(
            g, d3_args[0], q, *d3_args[1:], coulomb_cutoff=cutoff,
            alpha=alpha, **kw)

    fx, fw, _ = same_route(f"{label} grid_dftd3_coulomb",
                           fused(engine="window"), fused(engine="xla"))
    check_errors(f"{label} xla fused D3 forces vs the window call", fx[1],
                 fw[1], bars["fused_d3_forces"])
    check_errors(f"{label} xla fused Coulomb forces vs the window call",
                 fx[4], fw[4], bars["fused_coulomb_forces"])
    check_energy(f"{label} xla fused D3 energy vs the window call", fx[0],
                 fw[0], bars["fused_energy"])

    k = density_max_neighbors(n, full["cell"], cutoff)
    nm, num, _ = neighbor_list(full["pos"], cutoff, cell=full["cell"],
                               pbc=pbc, max_neighbors=k, method="cell_list")
    assert_max_neighbors(nm, num)
    del nm
    counts, _ = drive(f"{label} grid_neighbor_count",
                      lambda: grid_neighbor_count(g, cutoff, n), [],
                      list(launch_counts))
    if not torch.equal(counts.to(num.dtype), num):
        raise AssertionError(
            f"{label}: grid_neighbor_count differs from cell_list on "
            f"{int((counts.to(num.dtype) != num).sum())} atoms")
    phase(f"{label}: grid_neighbor_count equals cell_list's counts on every "
          f"atom ({int(num.sum())} pairs, {num.min().item()}-"
          f"{num.max().item()} a row)")
    numbers_c, rcov_c = d3_args[0], d3_args[1]
    rcov_a = torch.as_tensor(np.asarray(rcov_c)[numbers_c],
                             dtype=torch.float32, device=dev)
    cn_g, _ = drive(f"{label} grid_coordination_numbers",
                    lambda: grid_coordination_numbers(g, rcov_a, cutoff),
                    [], list(launch_counts))
    check_energy(f"{label} grid_coordination_numbers vs grid_dftd3 CN",
                 cn_g, cn_w, bars["cn_full_sweep"])
    for name, fn in (("grid_neighbor_count",
                      lambda: grid_neighbor_count(g, cutoff, n)),
                     ("grid_coordination_numbers",
                      lambda: grid_coordination_numbers(g, rcov_a, cutoff))):
        ms = cuda_time_ms(fn, reps=3)
        phase(f"{label} {name}: steady {ms:.3f} ms (CUDA events, median of "
              "3 after a warm-up)")
        profile_step(f"{label} {name}", fn)
    del g

    # -- 16.2: engine="xla" on the batched and stencil routes ---------------
    cfg = D3_BATCH
    tables, _, numbers, pos_m, pos_g, numbers_g = d3_batch_system(dev)
    a1, a2, s8 = D3_PARAMS
    box, cut = cfg["matched_box"], cfg["matched_cutoff"]
    cell_m = torch.eye(3, device=dev) * box

    def dense(**kw):
        return lambda: batch_dense_dftd3(pos_m, numbers, cell_m, cut,
                                         *tables, a1, a2, s8, **kw)

    out, _, _ = same_route(
        f"batch_dense_dftd3 {cfg['b']} x {cfg['n']} at {cut} A", dense(),
        dense(engine="xla"))
    check_forces("batch_dense_dftd3 engine='xla'", out[1])
    gb = D3_GRID
    cell_g = torch.eye(3, device=dev) * gb["box"]

    def grid_branch(**kw):
        return lambda: batch_grid_dftd3(pos_g, numbers_g, cell_g, pbc,
                                        gb["cutoff"], *tables, a1, a2, s8,
                                        **kw)

    out, _, _ = same_route(
        f"batch_grid_dftd3 {gb['b']} x {gb['n']} at {gb['cutoff']} A",
        grid_branch(), grid_branch(engine="xla"))
    check_forces("batch_grid_dftd3 engine='xla'", out[1])
    del pos_m, pos_g

    cfg = HYBRID
    pos_h, cell_h, _, charges, _ = hybrid_system(cfg["n_rep"])

    def on_card(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    pos_h, cell_h, q_h = on_card(pos_h), on_card(cell_h), on_card(charges)
    sg = stencil.build_stencil_auto(pos_h, cell_h, pbc, cfg["cutoff"])
    rcov_h = on_card(np.random.default_rng(16).uniform(0.8, 1.4,
                                                       pos_h.shape[0]))
    decn_h = on_card(np.random.default_rng(17).normal(size=pos_h.shape[0]))
    sweeps = {
        "coulomb": lambda engine: stencil.stencil_coulomb_energy_forces(
            sg, q_h, cfg["cutoff"], cfg["alpha"], engine=engine),
        "cn": lambda engine: (stencil.stencil_coordination_numbers(
            sg, rcov_h, cfg["cutoff"], engine=engine),),
        "chain": lambda engine: (stencil.stencil_cn_chain_forces(
            sg, rcov_h, decn_h, cfg["cutoff"], engine=engine),),
    }
    for body, fn in sweeps.items():
        out, ref, _ = same_route(
            f"crystal {pos_h.shape[0]} atoms stencil {body}",
            lambda: fn(None), lambda: fn("xla"))
        if not all(torch.equal(a, r) for a, r in zip(out, ref)):
            raise AssertionError(f"stencil {body}: engine='xla' differs "
                                 "from the default call's bits")
    phase(f"crystal {pos_h.shape[0]} atoms stencil: engine='xla' gives the "
          "default call's bits in every sweep")
    del sg

    # -- 16.3: the math extras on the card against f64 on the CPU ----------
    pts = np.random.default_rng(18).normal(size=(4096, 3)) * 2.0
    errs = {}
    for name in mathops.__all__:
        if not (name.startswith(("gto", "eval_gto"))
                or "harmonic" in name):
            continue
        fn = getattr(mathops, name)

        def call(p, device):
            if name == "gto_self_overlap":
                return fn(1, 0.7, device=device)
            if name in ("gto_normalization", "gto_integral_l0"):
                return fn(0.7, device=device)
            if name == "gto_gaussian_factor":
                return fn((p * p).sum(-1), 0.7)
            if name.startswith(("gto", "eval_gto")):
                return fn(p, 0.7)
            return fn(p)

        out = call(torch.as_tensor(pts, dtype=torch.float32, device=dev),
                   dev)
        ref = call(torch.as_tensor(pts), "cpu")
        out, ref = ((out, ref) if isinstance(out, tuple)
                    else ((out,), (ref,)))
        for a, r in zip(out, ref):
            if a.device.type != dev.type:
                raise AssertionError(f"{name}: result not on the card")
            scale = r.abs().max().item()
            errs[name] = max(errs.get(name, 0.0), (
                (a.double().cpu() - r).abs().max().item() / scale)
                if scale else 0.0)
    worst = max(errs, key=errs.get)
    check_bar(f"math extras ({len(errs)} functions) f32 on the card vs f64 "
              f"on the CPU, worst {worst}", errs[worst], bars["math_f32"])


# ---------------------------------------------------------------------------
# Phase 17: the multi-rank paths (nvalchemiops_torch.parallel)
# ---------------------------------------------------------------------------


def _scale_error(got, want):
    """max |got - want| / max |want| (0 for two empty arrays)."""
    g, w = got.detach().double().cpu(), want.detach().double().cpu()
    if g.shape != w.shape:
        raise AssertionError(f"shape {tuple(g.shape)} vs {tuple(w.shape)}")
    if not torch.isfinite(g).all():
        raise AssertionError("non-finite values")
    return ((g - w).abs().max() / w.abs().max()).item() if w.numel() else 0.0


def _parallel_calls(parallel, zmesh, bmesh, inp, dev):
    """The phase's calls on this rank: ``{name: fn}`` on the card in f32,
    every rank with the same replicated inputs."""
    from nvalchemiops_torch.grid import build_atom_grid

    pos = torch.as_tensor(inp["pos"], dtype=torch.float32, device=dev)
    cell = torch.as_tensor(inp["cell"], dtype=torch.float32, device=dev)
    q = torch.as_tensor(inp["q"], dtype=torch.float32, device=dev)
    tables = inp["d3_tables"]             # numbers, rcov, r4r2, c6, cna
    numbers, rcov = tables[:2]
    g = build_atom_grid(pos, cell, np.array([True] * 3), *inp["geometry"])
    rcov_a = torch.as_tensor(rcov, dtype=torch.float32, device=dev)[
        torch.as_tensor(numbers, device=dev).long()]
    cutoff, alpha = inp["cutoff"], inp["alpha"]
    a1, a2, s8 = inp["d3_params"]
    bpos, bq, bcell = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                       for a in inp["batch"])
    return {
        "cn": lambda: parallel.domain_dftd3_cn(zmesh, g, rcov_a, cell,
                                               cutoff),
        "coulomb": lambda: parallel.domain_coulomb_energy_forces(
            zmesh, g, q, cell, cutoff, alpha),
        "d3": lambda: parallel.domain_dftd3(zmesh, g, *tables, cutoff, a1,
                                            a2, s8, cell),
        "d3_coulomb": lambda: parallel.domain_dftd3_coulomb(
            zmesh, g, numbers, q, *tables[1:], cutoff, a1, a2, s8, cell,
            alpha=alpha),
        "pme": lambda: parallel.domain_pme_reciprocal(
            zmesh, pos, q, cell, alpha, FULL_MESH,
            tile_capacity=inp["tile_cap"], compute_forces=True),
        "batch_pme": lambda: parallel.sharded_batch_pme_reciprocal(
            bmesh, bpos, bq, bcell, PME_BATCH["alpha"], PME_BATCH["mesh"],
            compute_forces=True),
    }


#: the launch counts each call of phase 17 must show on every rank
PARALLEL_LAUNCHES = {
    "cn": ("window_sweep_cn",),
    "coulomb": ("window_sweep_coulomb",),
    "d3": ("window_sweep_cn", "window_sweep_d3_direct",
           "window_sweep_chain"),
    "d3_coulomb": ("window_sweep_cn", "window_sweep_d3_direct_coulomb",
                   "window_sweep_chain"),
    "pme": ("windowed_spread", "windowed_gather_grad"),
    "batch_pme": ("separable_spread", "separable_gather"),
}


def _parallel_f64_composite(parallel, zmesh):
    """The 1,024-atom composite in f64 on CPU tensors (the kernels as their
    plain versions), on a grid of 6 cells a side (2 bins per cutoff, so
    the z axis splits into slabs of 3 cells at D = 2): every domain call
    and the tile-split PME; rank 0 also returns the single-process calls'
    errors against them."""
    from nvalchemiops_torch.grid import (
        build_atom_grid, estimate_grid_geometry, grid_coulomb_energy_forces,
    )
    from nvalchemiops_torch.interactions.dispersion.grid_d3 import (
        compact_d3_elements, grid_dftd3, grid_dftd3_coulomb,
    )
    from nvalchemiops_torch.interactions.electrostatics.pme import (
        pme_reciprocal_space,
    )
    from nvalchemiops_torch import composite

    f64 = torch.float64
    pos_np, cell_np, numbers, charges, rcov, r4r2, cna, c6 = \
        composite.build_system()
    numbers, rcov, r4r2, c6, cna = compact_d3_elements(numbers, rcov, r4r2,
                                                       c6, cna)
    pos, cell, q = (torch.as_tensor(a, dtype=f64) for a in
                    (pos_np, cell_np, charges))
    pbc = np.array([True] * 3)
    geo = estimate_grid_geometry(cell_np, pbc, composite.CUTOFF,
                                 len(pos_np), bins_per_cutoff=2)
    g = build_atom_grid(pos, cell, pbc, *geo)
    cut, alpha = composite.CUTOFF, composite.ALPHA
    d3 = (numbers, rcov, r4r2, c6, cna, cut, composite.D3_A1,
          composite.D3_A2, composite.D3_S8)
    rcov_a = torch.as_tensor(rcov, dtype=f64)[torch.as_tensor(numbers)
                                              .long()]
    dom = {
        "cn": (parallel.domain_dftd3_cn(zmesh, g, rcov_a, cell, cut),),
        "coulomb": parallel.domain_coulomb_energy_forces(zmesh, g, q, cell,
                                                         cut, alpha),
        "d3": parallel.domain_dftd3(zmesh, g, *d3, cell),
        "d3_coulomb": parallel.domain_dftd3_coulomb(
            zmesh, g, numbers, q, *d3[1:], cell, alpha=alpha),
        "pme": parallel.domain_pme_reciprocal(
            zmesh, pos, q, cell, alpha, composite.MESH,
            compute_forces=True),
    }
    ed3, fd3, cnd3 = grid_dftd3(g, *d3)
    fused = grid_dftd3_coulomb(g, numbers, q, *d3[1:], alpha=alpha,
                               engine="window")
    single = {
        "cn": (cnd3,),
        "coulomb": grid_coulomb_energy_forces(g, q, cut, alpha),
        "d3": (ed3, fd3, cnd3),
        "d3_coulomb": fused,
        "pme": pme_reciprocal_space(pos, q, cell, alpha,
                                    mesh_dimensions=composite.MESH,
                                    compute_forces=True),
    }
    return geo, {k: max(_scale_error(a, b) for a, b in zip(dom[k],
                                                           single[k]))
                 for k in dom}


def _parallel_rank(rank, world, in_path, out_path):
    """Phase 17's rank body: drive the calls once with the launch counts
    reset, check the outputs against phase 4's single-device calls (rank
    0), time each call, and gather every rank's record to rank 0, which
    writes them to ``out_path``."""
    import torch.distributed as dist

    from nvalchemiops_torch import parallel
    from nvalchemiops_torch.kernels import launch_counts, reset_launch_counts
    from nvalchemiops_torch.parallel import _dist

    inp = torch.load(in_path, weights_only=False)
    dev = torch.device(inp["device"])
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    zmesh = parallel.make_z_mesh()
    bmesh = parallel.make_mesh(dp=world, sp=1)
    calls = _parallel_calls(parallel, zmesh, bmesh, inp, dev)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in _dist.ring_stats:
        _dist.ring_stats[k] = 0
    outs, counts = {}, {}
    for name, fn in calls.items():
        reset_launch_counts()
        outs[name] = fn()
        torch.cuda.synchronize()
        counts[name] = {k: v for k, v in launch_counts.items() if v}
    record = {
        "rank": rank, "counts": counts, "ring": dict(_dist.ring_stats),
        "peak_mib": torch.cuda.max_memory_allocated(dev) / 2**20,
        "transport": _dist.transport(zmesh.get_group("z"), dev),
    }
    record["ms"] = {name: cuda_time_ms(fn, reps=3)
                    for name, fn in calls.items()}
    if dist.get_backend() == "gloo":
        record["f64_geometry"], f64 = _parallel_f64_composite(parallel,
                                                              zmesh)
        record["f64_errors"] = f64
    records = [None] * world
    dist.all_gather_object(records, record)
    if rank != 0:
        return
    ref = torch.load(inp["ref_path"], weights_only=False)
    pairs = {
        "cn": [("cn", outs["cn"], ref["cn"])],
        "coulomb": [("energies", outs["coulomb"][0], ref["e_c"]),
                    ("forces", outs["coulomb"][1], ref["f_c"])],
        "d3": [("forces", outs["d3"][1], ref["f_d3"]),
               ("cn", outs["d3"][2], ref["cn"])],
        "d3_coulomb": [("d3 forces", outs["d3_coulomb"][1], ref["f_d3"]),
                       ("cn", outs["d3_coulomb"][2], ref["cn"]),
                       ("coulomb energies", outs["d3_coulomb"][3],
                        ref["e_c"]),
                       ("coulomb forces", outs["d3_coulomb"][4],
                        ref["f_c"])],
        "pme": [("energies", outs["pme"][0], ref["e_p"]),
                ("forces", outs["pme"][1], ref["f_p"])],
        "batch_pme": [("energies", outs["batch_pme"][0], ref["e_b"]),
                      ("forces", outs["batch_pme"][1], ref["f_b"])],
    }
    errors = {f"{k} {label}": _scale_error(a, b.to(dev))
              for k, rows in pairs.items() for label, a, b in rows}
    e_ref = ref["e_d3"].double().item()
    energy = {k: abs(outs[k][0].double().item() - e_ref) / abs(e_ref)
              for k in ("d3", "d3_coulomb")}
    net = {k: check_forces(f"phase 17 {k}", f) for k, f in (
        ("coulomb", outs["coulomb"][1]), ("d3", outs["d3"][1]),
        ("pme", outs["pme"][1]), ("batch_pme", outs["batch_pme"][1]))}
    with open(out_path, "w") as f:
        json.dump({"records": records, "errors": errors, "energy": energy,
                   "net": net}, f)


def run_parallel(dev, full):
    """Phase 17: the multi-rank paths on the card, in two spawned runs
    (``PARALLEL_RUNS``), against phase 4's single-device calls; then the
    MLIP forward in f32 on the card against f64 on the CPU."""
    import tempfile

    from nvalchemiops_torch.interactions.electrostatics.pme import (
        batch_pme_reciprocal,
    )
    from nvalchemiops_torch.parallel._dist import spawn_ranks

    bpos, bq, bcell = pme_batch_system(dev)
    cfg = PME_BATCH
    e_b, f_b = batch_pme_reciprocal(bpos, bq, bcell, cfg["alpha"],
                                    cfg["mesh"], compute_forces=True)
    batch_ms = cuda_time_ms(lambda: batch_pme_reciprocal(
        bpos, bq, bcell, cfg["alpha"], cfg["mesh"], compute_forces=True),
        reps=3)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p17_") as tmp:
        in_path = os.path.join(tmp, "inputs.pt")
        ref_path = os.path.join(tmp, "refs.pt")
        torch.save({k: full[k].detach().cpu() for k in (
            "e_d3", "f_d3", "cn", "e_c", "f_c", "e_p", "f_p")}
            | {"e_b": e_b.cpu(), "f_b": f_b.cpu()}, ref_path)
        torch.save({"pos": full["pos"].cpu().numpy(),
                    "cell": full["cell"].cpu().numpy(),
                    "q": full["q"].cpu().numpy(),
                    "d3_tables": full["d3_args"][:5],
                    "d3_params": full["d3_args"][6:],
                    "cutoff": full["cutoff"], "alpha": full["alpha"],
                    "geometry": full["geometry"],
                    "tile_cap": full["tile_cap"],
                    "batch": tuple(a.cpu().numpy()
                                   for a in (bpos, bq, bcell)),
                    "ref_path": ref_path, "device": str(dev)}, in_path)
        for backend, world in PARALLEL_RUNS:
            out_path = os.path.join(tmp, f"{backend}{world}.json")
            t0 = time.perf_counter()
            spawn_ranks(_parallel_rank, world, backend,
                        args=(in_path, out_path),
                        deadline_s=PARALLEL_DEADLINE_S, threads=0)
            with open(out_path) as f:
                res = json.load(f)
            _report_parallel(f"{world} rank(s) over {backend}", res, full,
                             batch_ms, time.perf_counter() - t0)
    run_mlip(dev)


def _report_parallel(label, res, full, batch_ms, wall_s):
    """Print one run of phase 17 and hold it to its bars."""
    for rec in res["records"]:
        r = rec["rank"]
        ring = rec["ring"]
        per = ring["bytes"] / max(ring["exchanges"], 1)
        phase(f"phase 17 {label}, rank {r}: transport {rec['transport']}, "
              f"{ring['exchanges']} ring exchanges, {per / 2**20:.4f} MiB "
              f"sent per exchange ({ring['bytes'] / 2**20:.3f} MiB in all), "
              f"peak memory {rec['peak_mib']:.1f} MiB")
        phase(f"phase 17 {label}, rank {r} ms (CUDA events, median of 3 "
              "after a warm-up): " + ", ".join(
                  f"{k} {v:.3f}" for k, v in rec["ms"].items()))
        for name, want in PARALLEL_LAUNCHES.items():
            got = rec["counts"][name]
            missing = [k for k in want if not got.get(k)]
            extra = [k for k in got if k not in want
                     and k.startswith(SWEEP_COUNT_PREFIXES)]
            if missing or extra:
                raise AssertionError(
                    f"phase 17 {label} rank {r} {name}: launches {got}; "
                    f"missing {missing}, off the path {extra}")
        if "f64_errors" in rec:
            f64 = rec["f64_errors"]
            phase(f"phase 17 {label}, rank {r}: f64 composite (grid "
                  f"{rec['f64_geometry']}) domain vs single process, max "
                  "|diff| / scale: " + ", ".join(
                      f"{k} {v:.3e}" for k, v in f64.items()))
            bad = {k: v for k, v in f64.items() if v > PARALLEL_F64_RTOL}
            if bad:
                raise AssertionError(f"phase 17 f64 composite: {bad}")
    phase(f"phase 17 {label}: launches per rank " + json.dumps(
        [rec["counts"] for rec in res["records"]]))
    phase(f"phase 17 {label}: phase 4's single-device ms: d3 "
          f"{full['steady']['d3']:.3f}, coulomb "
          f"{full['steady']['coulomb']:.3f}, pme "
          f"{full['steady']['pme']:.3f}; unsharded batch PME "
          f"{batch_ms:.3f}; the run's wall {wall_s:.1f} s")
    phase(f"phase 17 {label} vs single device, max |diff| / scale (bar "
          f"{PARALLEL_RTOL:g}): " + ", ".join(
              f"{k} {v:.3e}" for k, v in res["errors"].items()))
    phase(f"phase 17 {label} D3 total energy rel. diff (bar "
          f"{PARALLEL_ENERGY_RTOL:g}): " + ", ".join(
              f"{k} {v:.3e}" for k, v in res["energy"].items())
          + "; net force / sum|F|: " + ", ".join(
              f"{k} {v:.2e}" for k, v in res["net"].items()))
    bad = {k: v for k, v in res["errors"].items() if v > PARALLEL_RTOL}
    bad.update({k: v for k, v in res["energy"].items()
                if v > PARALLEL_ENERGY_RTOL})
    if bad:
        raise AssertionError(f"phase 17 {label} above its bars: {bad}")


def mlip_batch(b, n, zmax, box, seed=0):
    """``__graft_entry__._make_batch``'s inputs (numpy ``default_rng(0)``,
    6 A boxes): positions, element ids and cells."""
    rng = np.random.default_rng(seed)
    positions = rng.uniform(0, box, (b, n, 3))
    numbers = rng.integers(1, zmax + 1, (b, n))
    return positions, numbers, np.tile(np.eye(3) * box, (b, 1, 1))


def run_mlip(dev):
    """The MLIP forward at ``entry()``'s shapes: f32 on the card against
    f64 on the CPU (``MLIP_BARS``), with ~zero net force per system."""
    from nvalchemiops_torch import parallel

    cfg = MLIP
    pos, numbers, cells = mlip_batch(cfg["b"], cfg["n"], cfg["zmax"],
                                     cfg["box"])
    outs = {}
    for dtype, where in ((torch.float32, dev), (torch.float64, "cpu")):
        params = parallel.init_mlip_params(cfg["zmax"], dtype, device=where)
        tables = parallel.default_d3_tables(cfg["zmax"], dtype=dtype,
                                            device=where)
        args = (params, tables,
                torch.as_tensor(pos, dtype=dtype, device=where),
                torch.as_tensor(numbers, device=where),
                torch.as_tensor(cells, dtype=dtype, device=where),
                cfg["cutoff"])
        outs[where] = parallel.batched_energy_forces(*args)
        if where == dev:
            ms = cuda_time_ms(lambda: parallel.batched_energy_forces(*args),
                              reps=3)
    e32, f32 = outs[dev]
    e64, f64 = outs["cpu"]
    e_err = _scale_error(e32, e64)
    f_err = _scale_error(f32, f64)
    net = check_forces("MLIP f32", f32)
    phase(f"MLIP {cfg['b']} x {cfg['n']} (zmax {cfg['zmax']}, "
          f"{cfg['cutoff']} A) f32 on the card vs f64 on the CPU: energies "
          f"{e_err:.3e} (bar {MLIP_BARS[0]:.3e}), forces max |diff| / scale "
          f"{f_err:.3e} (bar {MLIP_BARS[1]:.3e}); net force / sum|F| "
          f"{net:.2e}; {ms:.3f} ms (CUDA events, median of 3)")
    if e_err > MLIP_BARS[0] or f_err > MLIP_BARS[1]:
        raise AssertionError("MLIP f32 above its bars")


# ---------------------------------------------------------------------------
# Phase 18: the MLIP training step, the entry points, kernel 1 batched
# ---------------------------------------------------------------------------


def _mlip_weights(dtype, dev):
    from nvalchemiops_torch import parallel

    return (parallel.init_mlip_params(TRAIN["zmax"], dtype, device=dev),
            parallel.default_d3_tables(TRAIN["zmax"], dtype=dtype,
                                       device=dev))


def _step_errors(new, loss, ref_new, ref_loss):
    """(loss, relative; new parameters, the largest field error of scale)
    of a step against a reference step."""
    loss_err = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    par_err = max(_scale_error(torch.as_tensor(getattr(new, f)),
                               torch.as_tensor(getattr(ref_new, f)))
                  for f in ref_new._fields)
    return loss_err, par_err


def _train_rank(rank, world, in_path, out_path):
    """Phase 18's rank body: ``sharded_train_step`` on each ``(dp, sp)``
    mesh of this world on entry()'s batch in f32 on cuda:0, timed; rank 0
    writes every rank's new parameters, loss and ms."""
    import torch.distributed as dist

    from nvalchemiops_torch import entry, parallel

    inp = torch.load(in_path, weights_only=False)
    dev = torch.device(inp["device"])
    torch.cuda.set_device(dev)
    params, tables = _mlip_weights(torch.float32, dev)
    b, n, box = TRAIN["shapes"][0]
    batch = entry.make_batch(b, n, TRAIN["zmax"], torch.float32, dev, box)
    record = {}
    for dp, sp in inp["meshes"]:
        mesh = parallel.make_mesh(dp=dp, sp=sp)
        local = parallel.shard_batch(mesh, batch)
        step = parallel.sharded_train_step(mesh, TRAIN["cutoff"])
        new, loss = step(params, tables, local)
        torch.cuda.synchronize()
        record[f"{dp}x{sp}"] = {
            "loss": loss.item(),
            "new": {f: getattr(new, f).cpu().tolist() for f in new._fields},
            "ms": cuda_time_ms(lambda: step(params, tables, local), reps=3),
            "transport": parallel._dist.transport(mesh.get_group("sp"),
                                                  dev)}
    records = [None] * world
    dist.all_gather_object(records, record)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(records, f)


def run_training(dev):
    """Phase 18, the training half: ``train_step`` at both ``TRAIN``
    shapes (f32 on the card against f64 on the CPU, CUDA-event ms, peak
    memory), the sharded step in spawned ranks against the card's
    single-process step, entry()'s forward and ``dryrun_multichip(1)`` on
    NCCL."""
    import tempfile

    from nvalchemiops_torch import entry, parallel
    from nvalchemiops_torch.kernels import launch_counts, reset_launch_counts
    from nvalchemiops_torch.parallel._dist import spawn_ranks

    single = None
    for b, n, box in TRAIN["shapes"]:
        out = {}
        for dtype, where in ((torch.float32, dev), (torch.float64, "cpu")):
            params, tables = _mlip_weights(dtype, where)
            batch = entry.make_batch(b, n, TRAIN["zmax"], dtype, where, box)
            if where == dev:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                reset_launch_counts()
            out[where] = parallel.train_step(params, tables, batch,
                                             TRAIN["cutoff"])
            if where == dev:
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated(dev)
                launched = {k: v for k, v in launch_counts.items() if v}
                ms = cuda_time_ms(lambda: parallel.train_step(
                    params, tables, batch, TRAIN["cutoff"]), reps=3)
                fwd_ms = cuda_time_ms(lambda: parallel.batched_energy_forces(
                    params, tables, *batch[:3], TRAIN["cutoff"]), reps=3)
        (new32, loss32), (new64, loss64) = out[dev], out["cpu"]
        if not (torch.isfinite(loss32) and all(
                torch.isfinite(p).all() for p in new32)):
            raise AssertionError(f"train_step {b} x {n}: non-finite")
        loss_err, par_err = _step_errors(new32, loss32, new64, loss64)
        phase(f"train_step {b} x {n} ({box} A boxes, {TRAIN['cutoff']} A) "
              f"f32 on the card vs f64 on the CPU: loss {loss32.item():.6e} "
              f"rel {loss_err:.3e} (bar {TRAIN_BARS[0]:g}), new parameters "
              f"max |diff| / scale {par_err:.3e} (bar {TRAIN_BARS[1]:g}); "
              f"{ms:.3f} ms a step, forward {fwd_ms:.3f} ms (CUDA events, "
              f"median of 3), peak memory {peak / 2**20:.1f} MiB, kernel "
              f"launches {launched}")
        if loss_err > TRAIN_BARS[0] or par_err > TRAIN_BARS[1]:
            raise AssertionError(f"train_step {b} x {n} above its bars")
        if single is None:
            single = (new32, loss32, ms)
        del out
        torch.cuda.empty_cache()

    new1, loss1, ms1 = single
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p18_") as tmp:
        for backend, world, meshes in SHARDED_RUNS:
            in_path = os.path.join(tmp, f"{backend}.pt")
            out_path = os.path.join(tmp, f"{backend}.json")
            torch.save({"meshes": meshes, "device": str(dev)}, in_path)
            t0 = time.perf_counter()
            spawn_ranks(_train_rank, world, backend, args=(in_path, out_path),
                        deadline_s=SHARDED_DEADLINE_S, threads=0)
            wall = time.perf_counter() - t0
            with open(out_path) as f:
                records = json.load(f)
            bad = {}
            for r, rec in enumerate(records):
                for mesh, res in rec.items():
                    new = parallel.MLIPParams(**{
                        k: torch.tensor(v) for k, v in res["new"].items()})
                    errs = _step_errors(new, res["loss"], new1, loss1)
                    phase(f"sharded_train_step {world} rank(s) over "
                          f"{backend} ({res['transport']}), mesh dp x sp "
                          f"{mesh}, rank {r}: vs the single-process f32 "
                          f"step, loss rel {errs[0]:.3e}, new parameters "
                          f"{errs[1]:.3e} (bars {TRAIN_BARS[0]:g}, "
                          f"{TRAIN_BARS[1]:g}); {res['ms']:.3f} ms a step "
                          f"against {ms1:.3f} single-process (CUDA events, "
                          f"median of 3)")
                    if errs[0] > TRAIN_BARS[0] or errs[1] > TRAIN_BARS[1]:
                        bad[f"{backend} {mesh} rank {r}"] = errs
            phase(f"sharded_train_step over {backend}: the run's wall "
                  f"{wall:.1f} s")
            if bad:
                raise AssertionError(f"sharded_train_step above its bars: "
                                     f"{bad}")

    forward, args = entry.entry()
    e, f = forward(*args)
    torch.cuda.synchronize()
    check_forces("entry() forward", f)
    if not torch.isfinite(e).all() or e.shape != (4,):
        raise AssertionError("entry() forward: bad energies")
    ms = cuda_time_ms(lambda: forward(*args), reps=3)
    t0 = time.perf_counter()
    entry.dryrun_multichip(1)
    phase(f"entry(): forward {tuple(e.shape)} energies, forces "
          f"{tuple(f.shape)} on {e.device}, {ms:.3f} ms (CUDA events, median "
          f"of 3); dryrun_multichip(1) on NCCL (sharded step, domain "
          f"Coulomb and D3, tile-split and batch-split PME, all finite) in "
          f"{time.perf_counter() - t0:.1f} s wall")


def batch_window_loop(pos, numbers, cell, pbc, cutoff, tables, d3_params,
                      cap=None):
    """The per-system loop that ``batch_grid_dftd3`` ran before its batched
    launch: ``grid_dftd3`` (window engine) on each system's part of the
    same batch grid, three kernel-1 launches a system."""
    from nvalchemiops_torch.grid import (
        batch_build_atom_grid, estimate_grid_geometry, system_grid,
    )
    from nvalchemiops_torch.interactions.dispersion.grid_d3 import grid_dftd3

    cells = cell.cpu().numpy()
    dims, radius, cap_est = estimate_grid_geometry(
        cells if cells.ndim == 2 else cells[0], pbc, cutoff, pos.shape[1])
    g = batch_build_atom_grid(pos, cell, pbc, dims, radius,
                              cap_est if cap is None else cap)
    outs = [grid_dftd3(system_grid(g, i), numbers[i], *tables, cutoff,
                       *d3_params, engine="window")
            for i in range(pos.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def cutoff_straddles(forces, ref, pos, box, cut, rel=1e-5):
    """Where the f32 forces differ most from the f64 ones: the atom, and
    its pairs (minimum image in the cubic ``box``) whose f64 r^2 lies
    within ``rel`` of ``cut^2``, with how many of them f32 r^2 puts on the
    other side of the cutoff."""
    err = (forces.double() - ref.double()).abs().amax(dim=-1)
    s, i = divmod(int(err.argmax()), err.shape[1])
    seps = []
    for dt in (torch.float64, torch.float32):
        d = pos[s].to(dt) - pos[s, i].to(dt)
        d = d - box * torch.round(d / box)
        seps.append((d * d).sum(dim=-1))
    cut2 = cut * cut
    near = (seps[0] - cut2).abs() < rel * cut2
    near[i] = False
    flips = near & ((seps[0] < cut2) != (seps[1] < cut2))
    gaps = ", ".join(f"{v:+.2e}" for v in (seps[0][near] - cut2).tolist())
    return (f"largest at system {s} atom {i} ({err[s, i].item():.3e}); its "
            f"pairs within {rel:g} of cut^2 in f64: {int(near.sum())} "
            f"(r^2 - cut^2: {gaps or 'none'}), on the other side in f32: "
            f"{int(flips.sum())}")


def run_batch_window(dev):
    """Phase 18, kernel 1 batched: ``batch_grid_dftd3`` on the grid branch
    (4 x 16,000) and on the 128 x 2,000 batch at 9 A launches kernel 1
    three times a call (one a pass, every system in each) and no
    per-system sweep; each launch replayed against its plain version (with
    bound), the outputs against the per-system loop, both timed.  Returns
    the kernel rows with their launches."""
    from nvalchemiops_torch.grid import (
        batch_build_atom_grid, estimate_grid_geometry,
    )
    from nvalchemiops_torch.interactions.dispersion.grid_d3 import (
        batch_grid_dftd3,
    )

    cfg, gb = D3_BATCH, D3_GRID
    tables, pos, numbers, _, pos_g, numbers_g = d3_batch_system(dev)
    pbc = np.array([True] * 3)
    dims, radius, _ = estimate_grid_geometry(np.eye(3) * gb["box"], pbc,
                                             gb["cutoff"], gb["n"])
    occ = int(batch_build_atom_grid(
        pos_g, torch.eye(3, device=dev) * gb["box"], pbc, dims, radius,
        8).counts_max.max())
    cases = (
        ("grid branch", f"grid branch {gb['b']} x {gb['n']} at "
         f"{gb['cutoff']} A", pos_g, numbers_g, gb["box"], gb["cutoff"],
         int(np.ceil((occ + 2) / 8)) * 8),
        ("128 x 2000", f"{cfg['b']} x {cfg['n']} at {cfg['cutoff']} A", pos,
         numbers, cfg["box"], cfg["cutoff"], None))
    rows = {}
    for case, label, p, z, box, cut, cap in cases:
        cell = torch.eye(3, device=dev) * box
        label = f"batch_grid_dftd3 {label}"

        def run():
            return batch_grid_dftd3(p, z, cell, pbc, cut, *tables,
                                    *D3_PARAMS, cap=cap)

        def loop():
            return batch_window_loop(p, z, cell, pbc, cut, tables, D3_PARAMS,
                                     cap=cap)

        capture = install_capture()
        out, counts = drive(label, run, BATCH_KEYS)
        capture.restore()
        launched = {k: v for k, v in counts.items() if v}
        if launched != {k: 1 for k in BATCH_KEYS}:
            raise AssertionError(f"{label}: launches {launched}, not one "
                                 f"batched launch a pass")
        ref, loop_counts = drive(f"{label}, per-system loop", loop,
                                 BATCH_KEYS)
        errs = [_scale_error(a, r) for a, r in zip(out, ref)]
        check_forces(label, out[1])
        batched_ms = cuda_time_ms(run, reps=3)
        loop_ms = cuda_time_ms(loop, reps=3)
        force_bar = BATCH_WINDOW_FORCE_BARS[case]
        phase(f"{label}: 3 launches a call against "
              f"{sum(loop_counts[k] for k in BATCH_KEYS)} in the loop; vs the "
              f"loop, max |diff| / scale: energies {errs[0]:.3e}, CNs "
              f"{errs[2]:.3e} (bar {BATCH_WINDOW_RTOL:g}), forces "
              f"{errs[1]:.3e} (bar {force_bar:g}); {batched_ms:.3f} ms a "
              f"call against the loop's {loop_ms:.3f} (CUDA events, median "
              f"of 3)")
        if max(errs[0], errs[2]) > BATCH_WINDOW_RTOL or errs[1] > force_bar:
            raise AssertionError(f"{label}: batched vs loop above its bar")
        # both paths against the f64 plain path on the first systems: the
        # batched launch within 1.25x the loop's own f32 error (both drop
        # the same pairs at D3's hard cutoff, where f32 and f64 r^2 differ)
        w = BATCH_WINDOW_WITNESS
        f64 = batch_grid_dftd3(
            p[:w].double(), z[:w], cell.double(), pbc, cut,
            *(t.astype(np.float64) for t in tables), *D3_PARAMS,
            cap=cap)[1]
        loop_err = force_errors(ref[1][:w], f64)
        rms_bar = BAR_FACTOR * JAX_F32_BARS["d3"][1]
        phase(f"{label} per-system loop f32 vs f64 plain (first {w} "
              f"systems): max rel {loop_err[0]:.3e}, rms rel "
              f"{loop_err[1]:.3e} (bar {rms_bar:.3e}); "
              f"{cutoff_straddles(ref[1][:w], f64, p, box, cut)}")
        if loop_err[1] > rms_bar:
            raise AssertionError(f"{label}: per-system loop f32 vs f64 rms "
                                 "above its bar")
        check_errors(f"{label} batched f32 vs f64 plain (first {w} "
                     "systems)", out[1][:w], f64,
                     (BAR_FACTOR * loop_err[0],
                      min(BAR_FACTOR * loop_err[1], rms_bar)))
        del f64
        ctx = {"systems": p.shape[0], "n": p.shape[1], "volume": box ** 3,
               "cutoff": cut, "mesh": tables[3].shape[1]}
        for key, row in compare_kernels(capture.calls, label, ctx).items():
            rows.setdefault(key, (row, counts[count_key_of(key)]))
        profile_step(label, run)
        profile_step(f"{label}, per-system loop", loop)
        del capture, out, ref
        torch.cuda.empty_cache()
    return rows


def replay_batch(calls, label, ctx):
    """Phase 19's replay of its captured launches, each on its whole input
    (a batched grid's every system, so the timed launch's plan): the kernel
    against its plain version on the same inputs (``kernel_vs_plain``), the
    kernel timed with CUDA events (median of 3; device time printed where
    the profiler keeps its events), the plain version with CUDA events on
    one call after the call whose outputs are compared (its batched form
    loops over up to 128 systems, seconds a call), and the bound from
    ``work``, as every other row of these kernels has it.  Returns the rows
    of the kernels line."""
    from nvalchemiops_torch.kernels import chunk_sweep as cs
    from nvalchemiops_torch.kernels import row_sweep as rs
    from nvalchemiops_torch.kernels import window_sweep as ws

    kerns = {"window_sweep": (ws.window_sweep, ws.window_sweep_plain),
             "row_sweep": (rs.row_sweep, rs.row_sweep_plain),
             "chunk_sweep": (cs.chunk_sweep, cs.chunk_sweep_plain)}
    rows = {}
    for key, (args, kwargs) in sorted(calls.items()):
        base = key.split("[")[0]
        kern, plain = kerns[base]
        batched = args[2].dim() == 6
        n_sys = args[2].shape[0] if batched else 1
        ms = cuda_time_ms(lambda: kern(*args, **kwargs), reps=3)
        dev_ms = device_time_ms(lambda: kern(*args, **kwargs), reps=3)
        out_k = kern(*args, **kwargs)
        out_p = plain(*args, **kwargs)
        torch.cuda.synchronize()
        out_k, max_abs, worst_rel = kernel_vs_plain(
            f"{label} {key}", base, out_k, out_p, batched)
        del out_p
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        plain(*args, **kwargs)
        b.record()
        b.synchronize()
        plain_ms = a.elapsed_time(b)
        nbytes, flops = work(key, args, kwargs, tuple(
            t.transpose(0, 1) for t in out_k) if batched else out_k,
            dict(ctx, systems=n_sys))
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FP32_PER_S * 1e3
        rows[key] = {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "library_ms": None}
        phase(f"{label} {key} on {n_sys} systems: kernel {ms:.3f} ms (CUDA "
              f"events, median of 3), device {_ms(dev_ms)}; plain "
              f"{plain_ms:.3f} ms (CUDA events, one call); max_abs_err "
              f"{max_abs:.3e} (rel {worst_rel:.2e}); bound "
              f"{rows[key]['bound_ms']:.4f} ms ({rows[key]['bound_by']}: "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        del out_k
    return rows


def own_split_probe(calls, label):
    """Kernel 1 at one block a cell (the dry run's one cell: one SM busy)
    against its own slots split over ``OWN_SPLIT`` blocks (the plan's third
    grid axis): the time of each, and the split's output against the
    whole cell's."""
    from nvalchemiops_torch.kernels import window_sweep as ws

    for key, (args, kwargs) in sorted(calls.items()):
        body, radius, own, cand, params = args[:5]
        cap = own.shape[-1]
        slots, _ = ws.window_plan(body, radius, cap, cand.shape[-5], params)
        default = ws.window_plan(body, radius, cap, cand.shape[-5], params,
                                 1, torch.cuda.get_device_properties(
                                     own.device).multi_processor_count)
        split = (slots, -(-cap // OWN_SPLIT))
        whole = ws.window_sweep(*args, plan=(slots, cap), **kwargs)
        parts = ws.window_sweep(*args, plan=split, **kwargs)
        # planes that are zero in both (the dry run's dE/dCN underflows:
        # every atom has ~1,600 neighbours) agree
        err = max((a - b).abs().max().item() / max(b.abs().max().item(),
                                                    1e-30)
                  for a, b in zip(parts, whole))
        t_whole = cuda_time_ms(lambda: ws.window_sweep(
            *args, plan=(slots, cap), **kwargs), reps=3)
        t_split = cuda_time_ms(lambda: ws.window_sweep(
            *args, plan=split, **kwargs), reps=3)
        phase(f"{label} {key}: one block a cell {t_whole:.4f} ms, own slots "
              f"over {OWN_SPLIT} blocks ({split[1]} each) {t_split:.4f} ms "
              f"(CUDA events, median of 3), outputs {err:.2e} of scale "
              f"apart; the default plan {default} (slots, own slots a "
              "block)")
        if err > KERNEL_RTOL:
            raise AssertionError(f"{label} {key}: split own slots disagree")


def dryrun_system(dev, dtype=torch.float32):
    """The JAX dry run's D3 system (``__graft_entry__.py``, as
    ``entry._dryrun_domain_decomposition`` draws it at n = 1): 400 atoms in
    a 4 A box from ``default_rng(1)``, charges, then element ids and
    zmax-4 random tables."""
    rng = np.random.default_rng(1)
    pos = rng.uniform(0, 4.0, (400, 3))
    rng.normal(size=400)                       # the charges
    numbers = rng.integers(1, 5, 400).astype(np.int32)
    rcov = np.r_[0.0, rng.uniform(0.6, 1.4, 4)]
    r4r2 = np.r_[0.0, rng.uniform(2.0, 6.0, 4)]
    cna = np.vstack([np.zeros(5), np.cumsum(rng.uniform(0.3, 1.0, (4, 5)),
                                            1)])
    c6 = rng.uniform(5.0, 40.0, (5, 5, 5, 5))
    c6[0] = 0.0
    c6[:, 0] = 0.0
    c6 = 0.5 * (c6 + np.swapaxes(np.swapaxes(c6, 0, 1), 2, 3))
    return (torch.as_tensor(pos, dtype=dtype, device=dev), numbers,
            (rcov, r4r2, c6, cna))


def run_overflow(dev):
    """Phase 19: kernels 1, 7 and 8 on grids whose window overflows shared
    memory, kernels 7 and 8 batched, and the f64 and device routes.
    Returns the kernel rows of the batched cells with their launches."""
    from nvalchemiops_torch import composite
    from nvalchemiops_torch.grid import (
        batch_build_atom_grid, build_atom_grid, estimate_grid_geometry,
        system_grid,
    )
    from nvalchemiops_torch.interactions.dispersion import dftd3
    from nvalchemiops_torch.interactions.dispersion.dense_d3 import (
        batch_dftd3, dense_dftd3,
    )
    from nvalchemiops_torch.interactions.dispersion.grid_d3 import (
        batch_grid_dftd3, compact_d3_elements, grid_dftd3,
    )
    from nvalchemiops_torch.interactions.electrostatics.pme import (
        pme_reciprocal_space,
    )
    from nvalchemiops_torch.kernels import launch_counts, reset_launch_counts
    from nvalchemiops_torch.neighborlist import (
        assert_max_neighbors, neighbor_list,
    )

    t_phase = time.perf_counter()
    pbc = np.array([True] * 3)
    a1, a2, s8 = D3_PARAMS
    d3_bar = tuple(BAR_FACTOR * v for v in JAX_F32_BARS["d3"])
    tables, pos9, numbers, pos_m, pos_g, numbers_g = d3_batch_system(dev)
    tables64 = tuple(t.astype(np.float64) for t in tables)
    cfg = D3_BATCH
    rows = {}

    # -- 19a: the overflow cell, 128 x 2,000 at 21.2 A (dims 1^3) ----------
    box, cut = cfg["matched_box"], cfg["matched_cutoff"]
    cell = torch.eye(3, device=dev) * box
    dims, radius, cap = estimate_grid_geometry(np.eye(3) * box, pbc, cut,
                                               cfg["n"])
    w = OVERFLOW_WITNESS
    f64 = batch_dftd3(pos_m[:w].double(), numbers[:w], cell.double(), pbc,
                      cut, *tables64, a1, a2, s8)[1]
    reset_launch_counts()
    f_dense = batch_dftd3(pos_m[:w], numbers[:w], cell, pbc, cut, *tables,
                          a1, a2, s8)[1]
    if not launch_counts["dense_pairs_direct"]:
        raise AssertionError("19a: kernel 4 did not run the f32 base call")
    base = force_errors(f_dense, f64)
    bar = (BAR_FACTOR * base[0], BAR_FACTOR * base[1])
    phase(f"19a kernel 4 (batch_dftd3, f32) vs its plain version in f64 on "
          f"the card (first {w} systems): max rel {base[0]:.3e}, rms rel "
          f"{base[1]:.3e}; grid geometry dims {dims} radius {radius} cap "
          f"{cap}")
    ctx = {"systems": cfg["b"], "n": cfg["n"], "volume": box ** 3,
           "cutoff": cut, "mesh": tables[3].shape[1]}
    for engine, kernel in OVERFLOW_ENGINES.items():
        keys = [f"{kernel}_{b}" for b in ("cn", "d3_direct", "chain")]
        label = (f"19a batch_grid_dftd3(engine={engine!r}) {cfg['b']} x "
                 f"{cfg['n']} at {cut} A (cap {cap})")

        def run(engine=engine):
            return batch_grid_dftd3(pos_m, numbers, cell, pbc, cut, *tables,
                                    a1, a2, s8, engine=engine)

        capture = install_capture()
        out, counts = drive(label, run, keys)
        capture.restore()
        launched = {k: v for k, v in counts.items() if v}
        if launched != {k: 1 for k in keys}:
            raise AssertionError(f"{label}: launches {launched}, not 3")
        check_forces(label, out[1])
        check_errors(f"{label} f32 vs kernel 4's plain version in f64 "
                     f"(first {w} systems; bar 1.25x kernel 4's own)",
                     out[1][:w], f64, bar)
        del out
        ms = cuda_time_ms(run, reps=3)
        dev_ms = device_time_ms(run, reps=3)
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        phase(f"{label}: {ms:.3f} ms a call (CUDA events, median of 3), "
              f"device {_ms(dev_ms)}, peak {peak:.1f} MiB, 3 launches")
        for key, row in replay_batch(capture.calls, label, ctx).items():
            rows.setdefault(f"{key} cap {cap}", (key, row, 1))
        del capture
        torch.cuda.empty_cache()
    del f64, f_dense

    # -- 19b: the dry run's 400 atoms at cap 1,336 (dims 1^3) --------------
    pos_d, num_d, tab_d = dryrun_system(dev)
    box_d, cut_d = 4.0, 4.0
    cell_d = torch.eye(3, device=dev) * box_d
    dims_d, radius_d, cap_d = estimate_grid_geometry(
        np.eye(3) * box_d, pbc, cut_d, 400, target_occupancy=0.3)
    g_d = build_atom_grid(pos_d, cell_d, pbc, dims_d, radius_d, cap_d)
    pos64, cell64 = pos_d.double(), cell_d.double()
    k = density_max_neighbors(400, cell64, cut_d)
    nm, num, sh = neighbor_list(pos64, cut_d, cell=cell64, pbc=pbc,
                                max_neighbors=k, method="cell_list")
    assert_max_neighbors(nm, num)
    rcov_d, r4r2_d, c6_d, cna_d = tab_d
    cn_full = np.broadcast_to(cna_d[:, None, :, None], (5, 5, 5, 5)).copy()
    reset_launch_counts()
    _, f_ref, _ = dftd3(pos64, num_d, 0.42, 4.1, 1.7, covalent_radii=rcov_d,
                        r4r2=r4r2_d, c6_reference=c6_d,
                        coord_num_ref=cn_full, cell=cell64,
                        neighbor_matrix=nm, neighbor_matrix_shifts=sh,
                        output_dtype=None)
    if any(launch_counts.values()):
        raise AssertionError("19b: the f64 dftd3 launched a kernel")
    phase(f"19b dry-run grid: dims {dims_d} radius {radius_d} cap {cap_d}, "
          f"occupancy {int(g_d.counts_max)}; f64 dftd3 witness over {k} "
          f"neighbours a row, {int(num.sum())} pairs")
    del nm, sh
    for engine, kernel in OVERFLOW_ENGINES.items():
        keys = [f"{kernel}_{b}" for b in ("cn", "d3_direct", "chain")]
        label = f"19b grid_dftd3(engine={engine!r}) dry run cap {cap_d}"

        def run(engine=engine):
            return grid_dftd3(g_d, num_d, *tab_d, cut_d, 0.42, 4.1, 1.7,
                              engine=engine)

        capture = install_capture()
        out, counts = drive(label, run, keys)
        capture.restore()
        if {k: v for k, v in counts.items() if v} != {k: 1 for k in keys}:
            raise AssertionError(f"{label}: launches {counts}")
        check_errors(f"{label} f32 vs dftd3 in f64 on the card", out[1],
                     f_ref, d3_bar)
        dev_ms = device_time_ms(run, reps=3)
        phase(f"{label}: {cuda_time_ms(run, reps=3):.3f} ms a call (CUDA "
              f"events, median of 3), device {_ms(dev_ms)}")
        dctx = {"systems": 1, "n": 400, "volume": box_d ** 3,
                "cutoff": cut_d, "mesh": 5}
        for key, row in replay_batch(capture.calls, label, dctx).items():
            rows.setdefault(f"{key} cap {cap_d}", (key, row, 1))
        if engine == "window":
            own_split_probe(capture.calls, label)
    del g_d

    # -- 19c: kernels 7 and 8 batched: grid branch and 128 x 2,000 at 9 A --
    gb = D3_GRID
    dims_g, radius_g, _ = estimate_grid_geometry(np.eye(3) * gb["box"], pbc,
                                                 gb["cutoff"], gb["n"])
    occ = int(batch_build_atom_grid(
        pos_g, torch.eye(3, device=dev) * gb["box"], pbc, dims_g, radius_g,
        8).counts_max.max())
    cases = (("grid branch", pos_g, numbers_g, gb["box"], gb["cutoff"],
              int(np.ceil((occ + 2) / 8)) * 8),
             ("128 x 2000", pos9, numbers, cfg["box"], cfg["cutoff"], None))
    names = {"grid branch": "grid branch ", "128 x 2000": ""}
    for case, p, z, box_c, cut_c, cap_c in cases:
        cell_c = torch.eye(3, device=dev) * box_c
        dims_c, radius_c, cap_est = estimate_grid_geometry(
            np.eye(3) * box_c, pbc, cut_c, p.shape[1])
        cap_c = cap_est if cap_c is None else cap_c
        window_out = batch_grid_dftd3(p, z, cell_c, pbc, cut_c, *tables, a1,
                                      a2, s8, cap=cap_c)
        window_ms = cuda_time_ms(lambda: batch_grid_dftd3(
            p, z, cell_c, pbc, cut_c, *tables, a1, a2, s8, cap=cap_c), reps=3)
        g_c = batch_build_atom_grid(p, cell_c, pbc, dims_c, radius_c, cap_c)
        cctx = {"systems": p.shape[0], "n": p.shape[1], "volume": box_c ** 3,
                "cutoff": cut_c, "mesh": tables[3].shape[1]}
        for engine in ("block", "pallas"):
            kernel = OVERFLOW_ENGINES[engine]
            keys = [f"{kernel}_{b}" for b in ("cn", "d3_direct", "chain")]
            label = (f"19c batch_grid_dftd3(engine={engine!r}) {names[case]}"
                     f"{p.shape[0]} x {p.shape[1]} at {cut_c} A (cap {cap_c})")

            def run(engine=engine):
                return batch_grid_dftd3(p, z, cell_c, pbc, cut_c, *tables, a1,
                                        a2, s8, cap=cap_c, engine=engine)

            def loop(engine=engine):
                outs = [grid_dftd3(system_grid(g_c, i), z[i], *tables, cut_c,
                                   a1, a2, s8, engine=engine)
                        for i in range(p.shape[0])]
                return tuple(torch.stack(o) for o in zip(*outs))

            capture = install_capture()
            out, counts = drive(label, run, keys)
            capture.restore()
            if {k: v for k, v in counts.items() if v} != {k: 1 for k in keys}:
                raise AssertionError(f"{label}: launches {counts}")
            ref, loop_counts = drive(f"{label}, per-system loop", loop, keys)
            check_forces(label, out[1])
            for what, want in (("the per-system loop", ref),
                               ("kernel 1 batched", window_out)):
                errs = [_scale_error(a, r) for a, r in zip(out, want)]
                fbar = BATCH_WINDOW_FORCE_BARS[case]
                phase(f"{label} vs {what}: max |diff| / scale energies "
                      f"{errs[0]:.3e}, CNs {errs[2]:.3e} (bar "
                      f"{BATCH_WINDOW_RTOL:g}), forces {errs[1]:.3e} (bar "
                      f"{fbar:g})")
                if max(errs[0], errs[2]) > BATCH_WINDOW_RTOL or \
                        errs[1] > fbar:
                    raise AssertionError(f"{label} vs {what}: above its bar")
            ms = cuda_time_ms(run, reps=3)
            loop_ms = cuda_time_ms(loop, reps=3)
            dev_ms = device_time_ms(run, reps=3)
            loop_dev = device_time_ms(loop, reps=1)
            phase(f"{label}: {ms:.3f} ms a call, device {_ms(dev_ms)}, 3 "
                  f"launches; the per-system loop {loop_ms:.3f} ms, device "
                  f"{_ms(loop_dev)}, "
                  f"{sum(loop_counts[k] for k in keys)} launches; kernel 1 "
                  f"batched {window_ms:.3f} ms (CUDA events, median of 3)")
            del out, ref
            for key, row in replay_batch(capture.calls, label,
                                         cctx).items():
                rows.setdefault(f"{key} batched", (key, row, 1))
            del capture
        del window_out, g_c
        torch.cuda.empty_cache()

    # -- 19d: f64 on the card takes the plain versions; other cards --------
    pos_np, cell_np, num_s, q_np, rcov, r4r2, cna, c6 = \
        composite.build_system()
    d3_c = compact_d3_elements(num_s, rcov, r4r2, c6, cna)

    def routes(device, dtype):
        pos_t = torch.as_tensor(pos_np, dtype=dtype, device=device)
        cell_t = torch.as_tensor(cell_np, dtype=dtype, device=device)
        q_t = torch.as_tensor(q_np, dtype=dtype, device=device)
        g = composite.build_grid(pos_t, cell_t)
        return {
            "grid_dftd3": lambda: grid_dftd3(g, *d3_c, composite.CUTOFF,
                                             composite.D3_A1,
                                             composite.D3_A2,
                                             composite.D3_S8),
            "dense_dftd3": lambda: dense_dftd3(
                pos_t, d3_c[0], cell_np, composite.CUTOFF, *d3_c[1:],
                composite.D3_A1, composite.D3_A2, composite.D3_S8),
            "pme_reciprocal_space": lambda: pme_reciprocal_space(
                pos_t, q_t, cell_t, composite.ALPHA,
                mesh_dimensions=(32, 32, 32), compute_forces=True),
        }

    cpu = routes("cpu", torch.float64)
    card = routes(dev, torch.float64)
    card32 = routes(dev, torch.float32)
    for name in cpu:
        want = cpu[name]()
        reset_launch_counts()
        got = card[name]()
        torch.cuda.synchronize()
        if any(launch_counts.values()):
            raise AssertionError(f"19d f64 {name} launched {launch_counts}")
        err = max(_scale_error(a, b) for a, b in zip(got, want))
        reset_launch_counts()
        card32[name]()
        torch.cuda.synchronize()
        launched = sorted(k for k, v in launch_counts.items() if v)
        phase(f"19d {name} f64 on the card vs the CPU: max |diff| / scale "
              f"{err:.3e} (bar {F64_ROUTE_RTOL:g}), 0 launches; in f32 it "
              f"launches {launched}")
        if not (err <= F64_ROUTE_RTOL and launched):
            raise AssertionError(f"19d {name}: f64 route or f32 launches "
                                 "wrong")
    if torch.cuda.device_count() > 1:
        dev1 = torch.device("cuda", 1)
        out1 = routes(dev1, torch.float32)["grid_dftd3"]()
        out0 = card32["grid_dftd3"]()
        err = _scale_error(out1[1], out0[1].to(dev1))
        phase(f"19d grid_dftd3 on {dev1} vs {dev}: forces {err:.3e}")
        if out1[1].device != dev1 or err > KERNEL_RTOL:
            raise AssertionError("19d: the kernels on cuda:1 disagree")
    else:
        phase("19d a kernel call on cuda:1: skipped, this machine has "
              f"{torch.cuda.device_count()} CUDA device")
    phase(f"phase 19: {time.perf_counter() - t_phase:.1f} s")
    return rows


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
    d3_calls, d3_counts, d3_ctx, batch_21 = run_batched_d3(dev)

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
    for calls, label in ((pme_calls, "batched PME"),
                         (fb_calls, "PME 128^3 fallback"),
                         (comp_calls, "composite PME (B = 1)")):
        check_deterministic(calls, f"{label} dense gather",
                            "separable_gather")
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

    # -- phase 13: neighbor lists and list/matrix electrostatics -----------
    run_neighbor_electrostatics(dev, {
        "pos": pos, "q": q, "cell": cell, "e_c": e_c, "f_c": f_c,
        "grid": lambda: build_atom_grid(pos, cell, pbc, dims, radius, gcap,
                                        origin=origin)})

    # -- phase 14: the spline, PME and electrostatics surface -------------
    run_surface(dev, {
        "pos": pos, "q": q, "cell": cell, "alpha": alpha, "cutoff": cutoff,
        "d3_args": (numbers, rcov, r4r2, c6, cna, cutoff, composite.D3_A1,
                    composite.D3_A2, composite.D3_S8),
        "f_d3": f_d3, "f_c": f_c, "pme_err": (rel["pme"], rms["pme"])})

    # -- phase 15: dftd3 and the window engine's virial --------------------
    virial64 = run_dftd3(dev, {
        "pos": pos, "cell": cell, "d3_ms": steady["d3"],
        "d3_args": (numbers, rcov, r4r2, c6, cna, cutoff, composite.D3_A1,
                    composite.D3_A2, composite.D3_S8),
        "grid": lambda: build_atom_grid(pos, cell, pbc, dims, radius, gcap,
                                        origin=origin),
        "grid64": lambda: build_atom_grid(pos.double(), cell.double(), pbc,
                                          dims, radius, gcap, origin=origin),
        "batch_21": batch_21})

    # -- phase 16: engine="xla", the grid's offset sweeps, the math extras -
    run_xla_routes(dev, {
        "pos": pos, "cell": cell, "q": q, "alpha": alpha, "cutoff": cutoff,
        "d3_args": (numbers, rcov, r4r2, c6, cna, cutoff, composite.D3_A1,
                    composite.D3_A2, composite.D3_S8),
        "grid": lambda: build_atom_grid(pos, cell, pbc, dims, radius, gcap,
                                        origin=origin),
        "virial64": virial64})

    # -- phase 18, kernel 1 batched: before phase 17, because in two runs
    # every profiler run of device_time_ms after the spawned ranks of
    # phases 17 and 18 lost its device events (PERF.md section 7) ---------
    rows18 = run_batch_window(dev)

    # -- phase 19: overflowing windows, kernels 7 and 8 batched, the f64 and
    # device routes; before phase 17 for the same reason -------------------
    rows19 = run_overflow(dev)

    # -- phase 17: the multi-rank paths and the MLIP forward ---------------
    run_parallel(dev, {
        "pos": pos, "cell": cell, "q": q, "alpha": alpha, "cutoff": cutoff,
        "d3_args": (numbers, rcov, r4r2, c6, cna, cutoff, composite.D3_A1,
                    composite.D3_A2, composite.D3_S8),
        "geometry": (dims, radius, gcap, origin), "tile_cap": tile_cap,
        "steady": steady, "e_d3": e_d3, "f_d3": f_d3, "cn": cn, "e_c": e_c,
        "f_c": f_c, "e_p": e_p, "f_p": f_p})

    # -- phase 18: the training step and the entry points -------------------
    run_training(dev)

    kernels = []
    for rows, counts in ((full_rows, main_counts), (d3_rows, d3_counts),
                         (pme_rows, pme_counts)):
        for key, row in sorted(rows.items()):
            source, replaces = KERNEL_SOURCES[key.split("[")[0]]
            kernels.append({"name": key, "route": "cuda", "source": source,
                            "replaces": replaces,
                            "launches": counts[count_key_of(key)], **row})
    listed = {k["name"] for k in kernels}
    for table in (rows11, rows12, rows18):
        for key, (row, launches) in sorted(table.items()):
            if key in listed:
                continue
            listed.add(key)
            source, replaces = KERNEL_SOURCES[key.split("[")[0]]
            kernels.append({"name": key, "route": "cuda", "source": source,
                            "replaces": replaces, "launches": launches,
                            **row})
    for name, (key, row, launches) in sorted(rows19.items()):
        source, replaces = KERNEL_SOURCES[key.split("[")[0]]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches, **row})
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

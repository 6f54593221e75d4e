# SPDX-License-Identifier: Apache-2.0
"""Device time of the redesigned kernels on the card, body by body.

Times, on the 109,744-atom CsCl main path of ``chip_smoke.py`` (16^3
cells, radius 1, cap 40, 9.6 A, 128^3 mesh): kernel 1 (``window_sweep``:
CN, D3 direct, chain, Coulomb and the fused D3 + Coulomb body, separate
and combined), kernel 8 (``chunk_sweep``: the same five bodies of the
block engines, the fused one with separate force channels), kernel 7
(``row_sweep``: CN, D3 direct and chain of ``grid_dftd3(engine="pallas")``)
and kernel 2 (``windowed_gather_grad``, W = 12); kernel 2 again on the W =
20 windows of the 8 x 2,000-atom windowed PME batch at 64^3; kernel 4
(``dense_pairs``: CN, direct, chain) on the batched D3 systems of
``chip_smoke.d3_batch_system`` (128 x 2,000 atoms at 21.2 A in 41.2 A
boxes, 4 image combos, and at 9 A in 27 A boxes, minimum image); and
kernel 9 (``stencil_sweep``: CN and chain of the hybrid D3 engine,
Coulomb of ``stencil_coulomb_energy_forces``) on the 110,592-atom crystal
of ``chip_smoke.hybrid_system`` (48^3 voxels, radius 3, 9 A).  Each
kernel call is captured from the public entry points, then replayed
``--reps`` times under ``torch.profiler`` (``chip_smoke.device_time_ms``:
the kernel sum per call, the wrapper's memsets included).
``--profiler-check N`` first times one call N times and reports the
profiler runs that lost their device events.  ``--engine-errors`` also
prints the block engines' f32 forces against the window engine's on the
main path (max and RMS relative, as ``chip_smoke.py``'s cross-engine bars
read them): the numerics of a kernel 8 change, parent against change.
``--segments 2,4`` also times kernel 9 with each of those own voxels a
thread for every body (``kernels.stencil_sweep.PLAN``; the change tree
only).  Kernel 6 (``separable_gather``) is timed on the batched dense PME
(64 x 2,000 atoms at 32^3), the 128^3 tile-overflow fallback of the main
path (tile capacity 1) and the 1,024-atom composite on the dense engine
(B = 1, 32^3); ``--gather-paths`` also times it on every path of
``kernels.separable_spline.gather_plan`` (staged; L2 with one lane an atom
or one a stencil row) with the batched call cut to 1, 4, 16, 32 and 64
systems (the change tree only).

Kernel 1 is also timed at the large caps that stage its windows in
groups (:func:`cell_calls`): the 524,288-atom CsCl crystal at the D3
cutoff of 21.2 A (radius (1, 1, 3), cap 128; CN, D3 direct, chain, and
Coulomb at 9.6 A on the same grid), 16 x 16,000 atoms in 82.4 A boxes at
21.2 A (radius 1, cap 904, 432 cells) and the 128 x 2,000-atom batched D3
at 9 A (radius 1, cap 120, 3,456 cells).

``--main-path`` times the main path's kernels only (kernels 1, 7, 8 and
2 above, and kernel 1 at the large caps), and ``--walls N`` first prints
the host wall time of the main path's public calls, as phase 4 of
``chip_smoke.py`` makes them (grid
build, ``grid_dftd3`` on the window, block and pallas engines,
``grid_coulomb_energy_forces``, ``pme_reciprocal_space``): the median of N
calls after a warm-up, each from a synchronized card to the end of a
synchronize, beside its CUDA-event time and its kernel launches; and,
where the tree has it, the host cost of one entry into
``kernels.build.on_device`` (the launch context of every wrapper).

``--tree DIR`` imports ``nvalchemiops_torch`` from another checkout (for
instance the parent commit, unpacked with ``git archive`` into a directory
that ``.gitignore`` lists), whose kernels build into that checkout's own
``build/``; run once per tree in one chip call, in the order parent,
change, change, parent, to compare two versions on one card.  Prints the
card's name and power limit, then one JSON object per kernel body.  Needs a
CUDA device.  Usage: ``python3 pair_sweep_times.py [--tree DIR] [--reps N]``.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def record(module, name, key_of, calls):
    """Wrap ``module.name`` to record its first call per ``key_of``; returns
    the undo function."""
    orig = getattr(module, name)

    def wrapper(*args, **kwargs):
        calls.setdefault(key_of(*args), (orig, args, kwargs))
        return orig(*args, **kwargs)

    setattr(module, name, wrapper)
    return lambda: setattr(module, name, orig)


def window_key(body, radius, own, cand, params, *rest):
    combined = body == "d3_direct_coulomb" and params.combine_forces
    return f"window_sweep[{body}{'+combine' if combined else ''}]"


def main_path_calls(dev):
    """Kernel 1's, kernel 8's and kernel 7's calls on the 109,744-atom main
    path (with the fused D3 + Coulomb engines, whose Coulomb cutoff is the
    D3 cutoff) and kernel 2's call of its PME force evaluation; also the
    block engines' f32 forces against the window engine's, as (max rel,
    RMS rel)."""
    from nvalchemiops_torch import composite, grid, spline_windowed
    from nvalchemiops_torch.interactions.dispersion import grid_d3
    from nvalchemiops_torch.interactions.electrostatics import pme

    (pos_np, cell_np, numbers, charges, rcov, r4r2, cna,
     c6) = composite.build_system(chip_smoke.FULL_N_REP)
    numbers, rcov, r4r2, c6, cna = grid_d3.compact_d3_elements(
        numbers, rcov, r4r2, c6, cna)
    pos = torch.as_tensor(pos_np, dtype=torch.float32, device=dev)
    cell = torch.as_tensor(cell_np, dtype=torch.float32, device=dev)
    q = torch.as_tensor(charges, dtype=torch.float32, device=dev)
    pbc = np.array([True] * 3)
    cutoff, alpha = composite.CUTOFF, composite.ALPHA
    dims, radius, cap, origin = grid.choose_grid_geometry(pos, cell, pbc,
                                                          cutoff)
    g = grid.build_atom_grid(pos, cell, pbc, dims, radius, cap, origin=origin)
    d3 = (numbers, rcov, r4r2, c6, cna, cutoff, composite.D3_A1,
          composite.D3_A2, composite.D3_S8)
    calls = {}
    undo = [record(m, "window_sweep", window_key, calls)
            for m in (grid, grid_d3)]
    undo += [record(m, "chunk_sweep",
                    lambda body, *a: f"chunk_sweep[{body}]", calls)
             for m in (grid, grid_d3)]
    undo.append(record(spline_windowed, "gather_grad_planes", gather_key,
                       calls))
    undo.append(record(grid_d3, "row_sweep",
                       lambda body, *a: f"row_sweep[{body}]", calls))
    try:
        _, f_d3, _ = grid_d3.grid_dftd3(g, *d3)
        grid_d3.grid_dftd3(g, *d3, engine="pallas")
        _, f_c = grid.grid_coulomb_energy_forces(g, q, cutoff, alpha)
        for combine in (False, True):
            grid_d3.grid_dftd3_coulomb(
                g, numbers, q, *d3[1:], coulomb_cutoff=cutoff, alpha=alpha,
                combine_forces=combine, engine="window")
        _, b_d3, _ = grid_d3.grid_dftd3(g, *d3, engine="block")
        _, b_c = grid.grid_coulomb_energy_forces(g, q, cutoff, alpha,
                                                 engine="block")
        _, bf_d3, _, _, bf_c = grid_d3.grid_dftd3_coulomb(
            g, numbers, q, *d3[1:], coulomb_cutoff=cutoff, alpha=alpha,
            engine="block")
        pme.pme_reciprocal_space(
            pos, q, cell, alpha, mesh_dimensions=chip_smoke.FULL_MESH,
            compute_forces=True,
            tile_capacity=spline_windowed.observed_tile_capacity(
                pos, cell, chip_smoke.FULL_MESH))
    finally:
        for u in undo:
            u()
    torch.cuda.synchronize()
    label = (f"{pos.shape[0]} atoms, dims {tuple(dims)}, radius "
             f"{tuple(radius)}, cap {cap}, counts_max {int(g.counts_max)}")
    errors = {name: chip_smoke.force_errors(f, ref) for name, f, ref in (
        ("grid_dftd3 block d3", b_d3, f_d3),
        ("grid_coulomb_energy_forces block", b_c, f_c),
        ("grid_dftd3_coulomb block d3", bf_d3, f_d3),
        ("grid_dftd3_coulomb block coulomb", bf_c, f_c))}
    return calls, label, errors


def main_path_walls(dev, reps, tree):
    """Host wall ms of the main path's public calls (median of ``reps``
    after a warm-up, synchronized before and after each), their CUDA-event
    ms and kernel launches a call; then the host us of one entry into
    ``on_device`` (mean of 100,000), where the tree has it."""
    import statistics
    import time

    from nvalchemiops_torch import composite, grid, kernels
    from nvalchemiops_torch.interactions.dispersion import grid_d3
    from nvalchemiops_torch.interactions.electrostatics import pme
    from nvalchemiops_torch.spline_windowed import observed_tile_capacity

    (pos_np, cell_np, numbers, charges, rcov, r4r2, cna,
     c6) = composite.build_system(chip_smoke.FULL_N_REP)
    numbers, rcov, r4r2, c6, cna = grid_d3.compact_d3_elements(
        numbers, rcov, r4r2, c6, cna)
    pos = torch.as_tensor(pos_np, dtype=torch.float32, device=dev)
    cell = torch.as_tensor(cell_np, dtype=torch.float32, device=dev)
    q = torch.as_tensor(charges, dtype=torch.float32, device=dev)
    pbc = np.array([True] * 3)
    cutoff, alpha = composite.CUTOFF, composite.ALPHA
    dims, radius, cap, origin = grid.choose_grid_geometry(pos, cell, pbc,
                                                          cutoff)
    g = grid.build_atom_grid(pos, cell, pbc, dims, radius, cap, origin=origin)
    d3 = (numbers, rcov, r4r2, c6, cna, cutoff, composite.D3_A1,
          composite.D3_A2, composite.D3_S8)
    tile_cap = observed_tile_capacity(pos, cell, chip_smoke.FULL_MESH)
    calls = {
        "grid_build": lambda: grid.build_atom_grid(pos, cell, pbc, dims,
                                                   radius, cap,
                                                   origin=origin),
        "grid_dftd3 window": lambda: grid_d3.grid_dftd3(g, *d3),
        "grid_dftd3 block": lambda: grid_d3.grid_dftd3(g, *d3,
                                                       engine="block"),
        "grid_dftd3 pallas": lambda: grid_d3.grid_dftd3(g, *d3,
                                                        engine="pallas"),
        "grid_coulomb_energy_forces": lambda: grid.grid_coulomb_energy_forces(
            g, q, cutoff, alpha),
        "pme_reciprocal_space": lambda: pme.pme_reciprocal_space(
            pos, q, cell, alpha, mesh_dimensions=chip_smoke.FULL_MESH,
            compute_forces=True, tile_capacity=tile_cap),
    }
    for name, fn in calls.items():
        before = sum(kernels.launches().values())
        fn()
        torch.cuda.synchronize()
        launches = sum(kernels.launches().values()) - before
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        print(json.dumps({
            "tree": tree, "call": name, "wall_ms": statistics.median(walls),
            "wall_ms_min": min(walls), "reps": reps,
            "event_ms": chip_smoke.cuda_time_ms(fn, reps=reps),
            "launches": launches}), flush=True)
    from nvalchemiops_torch.kernels import build

    if hasattr(build, "on_device") and pos.is_cuda:
        n = 100000
        with build.on_device(pos):
            pass
        t0 = time.perf_counter()
        for _ in range(n):
            with build.on_device(pos):
                pass
        us = (time.perf_counter() - t0) / n * 1e6
        print(json.dumps({"tree": tree, "on_device_us": us}), flush=True)


#: the large-cap shapes of kernel 1: the CsCl crystal (2 x 64^3 atoms,
#: D3 at 21.2 A, Coulomb at 9.6 A on its grid) and 16 x 16,000 atoms
#: uniform in 82.4 A boxes at 21.2 A (numpy seed 5, zmax-16 tables)
LARGE_CRYSTAL = dict(n_rep=64, cutoff=21.2, coulomb_cutoff=9.6, alpha=0.35)
LARGE_BATCH = dict(b=16, n=16000, box=82.4, cutoff=21.2, seed=5)


def cell_calls(dev):
    """Kernel 1's calls at the large caps: the 524,288-atom crystal's CN,
    D3 direct, chain and Coulomb passes on its grid at 21.2 A (radius (1,
    1, 3), cap 128), and ``batch_grid_dftd3``'s CN, D3 direct and chain
    passes with the system axis on 16 x 16,000 atoms at 21.2 A (radius 1,
    cap 904) and on ``chip_smoke.d3_batch_system``'s 128 x 2,000 atoms at
    9 A (radius 1, cap 120).  Returns ``(calls, labels)``, keys
    ``window_sweep[<body>] <shape>``."""
    from nvalchemiops_torch import composite, grid
    from nvalchemiops_torch.interactions.dispersion import grid_d3

    pbc = np.array([True] * 3)
    cfg = LARGE_CRYSTAL
    (pos_np, cell_np, numbers, charges, rcov, r4r2, cna,
     c6) = composite.build_system(cfg["n_rep"])
    numbers, rcov, r4r2, c6, cna = grid_d3.compact_d3_elements(
        numbers, rcov, r4r2, c6, cna)
    pos = torch.as_tensor(pos_np, dtype=torch.float32, device=dev)
    cell = torch.as_tensor(cell_np, dtype=torch.float32, device=dev)
    q = torch.as_tensor(charges, dtype=torch.float32, device=dev)
    dims, radius, cap, origin = grid.choose_grid_geometry(pos, cell, pbc,
                                                          cfg["cutoff"])
    observed = int(grid.build_atom_grid(pos, cell, pbc, dims, radius, cap,
                                        origin=origin).counts_max)
    g = grid.build_atom_grid(pos, cell, pbc, dims, radius,
                             max(cap, grid._capacity_of(observed)),
                             origin=origin)

    def crystal():
        grid_d3.grid_dftd3(g, numbers, rcov, r4r2, c6, cna, cfg["cutoff"],
                           composite.D3_A1, composite.D3_A2,
                           composite.D3_S8)
        grid.grid_coulomb_energy_forces(g, q, cfg["coulomb_cutoff"],
                                        cfg["alpha"])

    tables, pos9, numbers9, *_ = chip_smoke.d3_batch_system(dev)
    big = LARGE_BATCH
    rng = np.random.default_rng(big["seed"])
    pos_b = torch.as_tensor(
        rng.uniform(0, big["box"], (big["b"], big["n"], 3)),
        dtype=torch.float32, device=dev)
    numbers_b = rng.integers(1, tables[0].shape[0],
                             (big["b"], big["n"])).astype(np.int32)

    def batch(p, z, box, cutoff):
        return lambda: grid_d3.batch_grid_dftd3(
            p, z, torch.eye(3, device=dev) * box, pbc, cutoff, *tables,
            *chip_smoke.D3_PARAMS)

    b9 = chip_smoke.D3_BATCH
    shapes = (
        (f"crystal {pos.shape[0]}", crystal),
        (f"batch {big['b']} x {big['n']}",
         batch(pos_b, numbers_b, big["box"], big["cutoff"])),
        (f"batch {b9['b']} x {b9['n']} at {b9['cutoff']} A",
         batch(pos9, numbers9, b9["box"], b9["cutoff"])))
    calls, labels = {}, {}
    for name, run in shapes:
        found = {}
        undo = [record(m, "window_sweep", window_key, found)
                for m in (grid, grid_d3)]
        try:
            run()
        finally:
            for u in undo:
                u()
        for key, (fn, a, kw) in found.items():
            own = a[2]
            systems = own.shape[0] if own.dim() == 6 else 1
            calls[f"{key} {name}"] = (fn, a, kw)
            labels[f"{key} {name}"] = (
                f"{systems} x {tuple(own.shape[-4:-1])} cells, radius "
                f"{tuple(a[1])}, cap {own.shape[-1]}")
    torch.cuda.synchronize()
    return calls, labels


def gather_key(smat, win, w_win):
    return f"windowed_gather_grad W={w_win}"


def windowed_batch_calls(dev):
    """Kernel 2's call on the W = 20 windows of the 8 x 2,000-atom windowed
    PME batch at 64^3 (tiles of 16), the first systems of
    ``chip_smoke.pme_batch_system``."""
    from nvalchemiops_torch import spline_windowed
    from nvalchemiops_torch.interactions.electrostatics import pme

    pos, q, cell = chip_smoke.pme_batch_system(dev)
    b = chip_smoke.PME_WINDOWED["b"]
    calls = {}
    undo = record(spline_windowed, "gather_grad_planes", gather_key, calls)
    try:
        pme.batch_pme_reciprocal(pos[:b], q[:b], cell,
                                 chip_smoke.PME_BATCH["alpha"],
                                 chip_smoke.PME_WINDOWED["mesh"],
                                 compute_forces=True, engine="windowed")
    finally:
        undo()
    torch.cuda.synchronize()
    return calls


def crystal_calls(dev):
    """Kernel 9's calls on the 110,592-atom crystal (``chip_smoke.
    run_stencil``'s system): CN and chain of ``grid_dftd3(stencil=...)``,
    Coulomb of ``stencil_coulomb_energy_forces``."""
    from nvalchemiops_torch import composite, stencil
    from nvalchemiops_torch.interactions.dispersion import grid_d3

    cfg = chip_smoke.HYBRID
    pos, cell, numbers, charges, tables = chip_smoke.hybrid_system(
        cfg["n_rep"])

    def on_card(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    pos, cell, q = on_card(pos), on_card(cell), on_card(charges)
    tables = tuple(on_card(t) for t in tables)
    cutoff = cfg["cutoff"]
    g = composite.build_grid(pos, cell, cutoff)
    sg = stencil.build_stencil_auto(pos, cell, np.array([True] * 3), cutoff)
    calls = {}
    undo = record(stencil, "stencil_sweep",
                  lambda body, *a: f"stencil_sweep[{body}]", calls)
    try:
        grid_d3.grid_dftd3(g, numbers, *tables, cutoff,
                           *chip_smoke.D3_PARAMS, stencil=sg)
        stencil.stencil_coulomb_energy_forces(sg, q, cutoff, cfg["alpha"])
    finally:
        undo()
    torch.cuda.synchronize()
    return calls, (f"{pos.shape[0]} atoms, stencil {tuple(sg.dims)} radius "
                   f"{tuple(sg.radius)}")


def gather_calls(dev):
    """Kernel 6's calls: the batched dense PME of
    ``chip_smoke.pme_batch_system`` (64 x 2,000 atoms at 32^3), the 128^3
    tile-overflow fallback of the 109,744-atom main path (tile capacity 1)
    and the 1,024-atom composite on the dense engine (B = 1, 32^3)."""
    from nvalchemiops_torch import composite
    from nvalchemiops_torch.interactions.electrostatics import pme

    cfg = chip_smoke.PME_BATCH
    pos, q, cell = chip_smoke.pme_batch_system(dev)
    (pos_f, cell_f, _, q_f, *_) = composite.build_system(
        chip_smoke.FULL_N_REP)
    pos_c, cell_c, _, q_c, *_ = composite.build_system()

    def on_card(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    runs = (
        lambda: pme.batch_pme_reciprocal(pos, q, cell, cfg["alpha"],
                                         cfg["mesh"], compute_forces=True),
        lambda: pme.pme_reciprocal_space(
            on_card(pos_f), on_card(q_f), on_card(cell_f), composite.ALPHA,
            mesh_dimensions=chip_smoke.FULL_MESH, compute_forces=True,
            tile_capacity=1),
        lambda: pme.batch_pme_reciprocal(
            on_card(pos_c)[None], on_card(q_c)[None], on_card(cell_c),
            composite.ALPHA, composite.MESH, compute_forces=True,
            engine="dense"))
    calls = {}
    undo = record(pme, "separable_gather",
                  lambda *a: chip_smoke.parent_key("separable_gather", a,
                                                   None), calls)
    try:
        for run in runs:
            run()
    finally:
        undo()
    torch.cuda.synchronize()
    return calls


def gather_paths(calls, reps):
    """Kernel 6 under each path the plan can take (staged; L2 with one lane
    an atom and with one lane a stencil row) on the captured batched PME
    gather cut to its first B systems, on the composite's and on the
    128^3 fallback's: the measurement behind ``gather_plan``."""
    import dataclasses

    from nvalchemiops_torch.kernels import separable_spline as ss

    cases = []
    for key, (fn, a, kw) in sorted(calls.items()):
        mesh, gidx, w, dw = a
        systems = (1, 4, 16, 32, 64) if mesh.shape[0] > 1 else (1,)
        cases += [(b, mesh[:b], gidx[:b], w[:b], dw[:b]) for b in systems]
    plan_of = ss.gather_plan
    try:
        for b, mesh, gidx, w, dw in cases:
            dims, (n, order) = tuple(mesh.shape[1:]), (w.shape[1], w.shape[3])
            want = ss.separable_gather_plain(mesh, gidx, w, dw)
            plans = [("l2", dataclasses.replace(
                plan_of(dims, order, b, n, staged=False), lanes=lanes))
                for lanes in (1, ss.row_lanes(order))]
            try:
                plans.insert(0, ("staged", plan_of(dims, order, b, n,
                                                   staged=True)))
            except ValueError:
                pass
            chosen = plan_of(dims, order, b, n)
            for path, plan in plans:
                ss.gather_plan = lambda *a_, _p=plan, **k: _p
                got = ss.separable_gather(mesh, gidx, w, dw)
                torch.cuda.synchronize()
                err = max(((g.double() - x.double()).abs().max()
                           / x.double().abs().max()).item()
                          for g, x in zip(got, want))
                if not err <= chip_smoke.KERNEL_RTOL:
                    raise AssertionError(f"gather {path} {plan}: rel err "
                                         f"{err:.3e}")
                ms = chip_smoke.device_time_ms(
                    lambda: ss.separable_gather(mesh, gidx, w, dw),
                    reps=reps)
                print(json.dumps({
                    "kernel": "separable_gather",
                    "shape": f"{b} x {n}, mesh {'x'.join(map(str, dims))}",
                    "path": path, "lanes": plan.lanes,
                    "slices": plan.slices, "planned": plan == chosen,
                    "device_ms": ms, "max_rel_err": err, "reps": reps}),
                    flush=True)
    finally:
        ss.gather_plan = plan_of


def dense_calls(dev):
    """Kernel 4's calls on the 128 x 2,000-atom batches at 21.2 A and 9 A."""
    from nvalchemiops_torch.interactions.dispersion import dense_d3

    cfg = chip_smoke.D3_BATCH
    tables, pos9, numbers, pos_m, _, _ = chip_smoke.d3_batch_system(dev)
    pbc = np.array([True] * 3)
    out = {}
    for tag, pos, box, cut in (
            (f"{cfg['matched_cutoff']} A", pos_m, cfg["matched_box"],
             cfg["matched_cutoff"]),
            (f"{cfg['cutoff']} A", pos9, cfg["box"], cfg["cutoff"])):
        calls = {}
        undo = record(dense_d3, "dense_pairs",
                      lambda body, *a, _t=tag: f"dense_pairs[{body}] {_t}",
                      calls)
        try:
            dense_d3.batch_dftd3(pos, numbers, torch.eye(3, device=dev) * box,
                                 pbc, cut, *tables, *chip_smoke.D3_PARAMS)
        finally:
            undo()
        out.update(calls)
    torch.cuda.synchronize()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT,
                    help="checkout whose nvalchemiops_torch is timed")
    ap.add_argument("--reps", type=int, default=20,
                    help="calls per profiler run")
    ap.add_argument("--engine-errors", action="store_true",
                    help="print the block engines' forces against the "
                         "window engine's")
    ap.add_argument("--segments", default="",
                    help="comma-separated own voxels a thread for kernel 9 "
                         "timings, every body (change tree only)")
    ap.add_argument("--gather-paths", action="store_true",
                    help="time kernel 6 on every path at several batch "
                         "sizes (change tree only)")
    ap.add_argument("--main-path", action="store_true",
                    help="time only the main path's kernels")
    ap.add_argument("--walls", type=int, default=0, metavar="N",
                    help="first print the host wall time of the main "
                         "path's public calls, median of N")
    ap.add_argument("--profiler-check", type=int, default=0, metavar="N",
                    help="first time one call N times and count the "
                         "profiler runs that lost their device events")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("pair_sweep_times.py needs a CUDA device")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import nvalchemiops_torch
    from nvalchemiops_torch.kernels.build import build_library

    pkg = os.path.dirname(os.path.abspath(nvalchemiops_torch.__file__))
    if pkg != os.path.join(tree, "nvalchemiops_torch"):
        raise RuntimeError(f"imported {pkg}, not the package of {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    build_library()
    dev = torch.device("cuda", 0)
    print(card, flush=True)
    if args.walls:
        main_path_walls(dev, args.walls, tree)
    main, label, engine_errors = main_path_calls(dev)
    if args.engine_errors:
        print(json.dumps({"tree": tree, "engine_errors": engine_errors}),
              flush=True)
    if args.main_path:
        batch, crystal, crystal_label, gathers, dense = {}, {}, "", {}, {}
    else:
        batch = windowed_batch_calls(dev)
        crystal, crystal_label = crystal_calls(dev)
        gathers = gather_calls(dev)
        dense = dense_calls(dev)
    cells, cell_labels = cell_calls(dev)
    calls = {**main, **batch, **dense, **crystal, **gathers, **cells}
    if args.profiler_check:
        fn, a, kw = calls["windowed_gather_grad W=12"]
        lost = len(chip_smoke.LOST_PROFILES)
        for _ in range(args.profiler_check):
            chip_smoke.device_time_ms(lambda: fn(*a, **kw), reps=args.reps)
        print(json.dumps({"tree": tree, "profiler_check": {
            "runs": args.profiler_check,
            "lost": chip_smoke.LOST_PROFILES[lost:]}}), flush=True)
    for key, (fn, a, kw) in sorted(calls.items()):
        ms = chip_smoke.device_time_ms(lambda: fn(*a, **kw), reps=args.reps)
        shape = (cell_labels[key] if key in cells
                 else "8 x 2,000 atoms, 64^3, W = 20" if key in batch
                 else "128 x 2,000" if key.startswith("dense")
                 else crystal_label if key in crystal
                 else key.split(" ", 1)[1] if key in gathers else label)
        print(json.dumps({"tree": tree, "kernel": key, "device_ms": ms,
                          "reps": args.reps, "shape": shape}), flush=True)
    if args.segments:
        from nvalchemiops_torch.kernels import stencil_sweep

        default = dict(stencil_sweep.PLAN)
        try:
            for tz in (int(t) for t in args.segments.split(",")):
                stencil_sweep.PLAN = {b: (tz, w) for b, (_, w)
                                      in default.items()}
                for key, (fn, a, kw) in sorted(crystal.items()):
                    ms = chip_smoke.device_time_ms(lambda: fn(*a, **kw),
                                                   reps=args.reps)
                    print(json.dumps({"tree": tree, "kernel": key,
                                      "segment": tz, "device_ms": ms,
                                      "reps": args.reps,
                                      "shape": crystal_label}), flush=True)
        finally:
            stencil_sweep.PLAN = default
    if args.gather_paths:
        gather_paths(gathers, args.reps)
    print(json.dumps({"tree": tree,
                      "lost_profiles": chip_smoke.LOST_PROFILES}), flush=True)


if __name__ == "__main__":
    main()

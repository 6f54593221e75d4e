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
only).

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
    main, label, engine_errors = main_path_calls(dev)
    if args.engine_errors:
        print(json.dumps({"tree": tree, "engine_errors": engine_errors}),
              flush=True)
    batch = windowed_batch_calls(dev)
    crystal, crystal_label = crystal_calls(dev)
    calls = {**main, **batch, **dense_calls(dev), **crystal}
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
        shape = ("8 x 2,000 atoms, 64^3, W = 20" if key in batch
                 else "128 x 2,000" if key.startswith("dense")
                 else crystal_label if key in crystal else label)
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
    print(json.dumps({"tree": tree,
                      "lost_profiles": chip_smoke.LOST_PROFILES}), flush=True)


if __name__ == "__main__":
    main()

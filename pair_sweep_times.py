# SPDX-License-Identifier: Apache-2.0
"""Device time of every body of the two main pair sweeps on the card.

Times kernel 1 (``window_sweep``: CN, D3 direct, chain, Coulomb and the
fused D3 + Coulomb body, separate and combined) on the 109,744-atom CsCl
main path of ``chip_smoke.py`` (16^3 cells, radius 1, cap 40, 9.6 A), and
kernel 4 (``dense_pairs``: CN, direct, chain) on the batched D3 systems of
``chip_smoke.d3_batch_system`` (128 x 2,000 atoms at 21.2 A in 41.2 A
boxes, 4 image combos, and at 9 A in 27 A boxes, minimum image).  Each
kernel call is captured from the public entry points, then replayed
``--reps`` times under ``torch.profiler`` (``chip_smoke.device_time_ms``:
the kernel sum per call, the wrapper's memsets included).

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
    """Kernel 1's calls on the 109,744-atom main path (and its fused
    D3 + Coulomb engine, whose Coulomb cutoff is the D3 cutoff)."""
    from nvalchemiops_torch import composite, grid
    from nvalchemiops_torch.interactions.dispersion import grid_d3

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
    try:
        grid_d3.grid_dftd3(g, *d3)
        grid.grid_coulomb_energy_forces(g, q, cutoff, alpha)
        for combine in (False, True):
            grid_d3.grid_dftd3_coulomb(
                g, numbers, q, *d3[1:], coulomb_cutoff=cutoff, alpha=alpha,
                combine_forces=combine, engine="window")
    finally:
        for u in undo:
            u()
    torch.cuda.synchronize()
    label = (f"{pos.shape[0]} atoms, dims {tuple(dims)}, radius "
             f"{tuple(radius)}, cap {cap}, counts_max {int(g.counts_max)}")
    return calls, label


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
    k1, label = main_path_calls(dev)
    calls = {**k1, **dense_calls(dev)}
    for key, (fn, a, kw) in sorted(calls.items()):
        ms = chip_smoke.device_time_ms(lambda: fn(*a, **kw), reps=args.reps)
        print(json.dumps({"tree": tree, "kernel": key, "device_ms": ms,
                          "reps": args.reps,
                          "shape": label if key.startswith("window")
                          else "128 x 2,000"}), flush=True)


if __name__ == "__main__":
    main()

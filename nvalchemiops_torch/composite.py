# SPDX-License-Identifier: Apache-2.0
"""The composite force field on a CsCl supercell: grid -> DFT-D3(BJ) ->
erfc real-space Coulomb -> PME reciprocal space.

Counterpart of ``benchmarks/composite_accuracy.py``.  :func:`build_system`
is numpy-only and reproduces the JAX one bit for bit (same
``default_rng(seed)`` draws, tables and reference-CN grid), so the port's
forces compare directly with the committed f64 reference
``benchmarks/data/bench_acc_ref.npz`` (1,024 atoms, ``n_rep = 8``), which
:func:`load_reference` reads; :func:`relative_errors` and
:func:`rms_errors` are the accuracy metrics of that comparison.
:func:`compute_forces` runs the stages through the public entry points the
same way ``composite_accuracy.compute_forces`` does.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from nvalchemiops_torch.grid import (
    build_atom_grid,
    choose_grid_origin,
    estimate_grid_geometry,
    grid_coulomb_energy_forces,
)
from nvalchemiops_torch.interactions.dispersion.d3_data import (
    realistic_test_tables,
)
from nvalchemiops_torch.interactions.dispersion.grid_d3 import (
    compact_d3_elements,
    element_cn_ref,
    grid_dftd3,
)
from nvalchemiops_torch.interactions.electrostatics.pme import (
    pme_reciprocal_space,
)
from nvalchemiops_torch.spline_windowed import observed_tile_capacity

__all__ = ["N_REP", "A_LAT", "CUTOFF", "ALPHA", "MESH", "D3_A1", "D3_A2",
           "D3_S8", "REF_PATH", "REF_VERSION", "build_system", "build_grid",
           "compute_forces", "load_reference", "relative_errors",
           "rms_errors"]

N_REP = 8          # 1,024 atoms: the committed f64 reference's system
A_LAT = 4.123      # CsCl conventional lattice constant, Angstrom
CUTOFF = 9.6
ALPHA = 0.35
MESH = (32, 32, 32)

_AUTOANG = 0.52917726
# PBE-D3(BJ) damping parameters in the benchmark's Angstrom unit
D3_A1 = 0.4289
D3_A2 = 4.4407 * _AUTOANG
D3_S8 = 0.7875

#: the committed f64 reference forces of the composite, and the version key
#: it was written with
REF_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "benchmarks", "data", "bench_acc_ref.npz")
REF_VERSION = (f"cscl-v5-realtables:n_rep={N_REP}:cutoff={CUTOFF}:"
               f"alpha={ALPHA}:mesh={MESH}")


def build_system(n_rep=N_REP, seed=0):
    """CsCl (B2) supercell + the realistic Cs/Cl D3 tables (numpy).

    Returns ``(pos, cell, numbers, charges, rcov, r4r2, cna, c6)``: two
    species (Cs 55 / Cl 17) on interpenetrating simple-cubic lattices,
    jittered by U(-0.1, 0.1) Angstrom, with +-1 formal charges; tables in
    Angstrom units (energies in Hartree).
    """
    rng = np.random.default_rng(seed)
    gpts = np.stack(
        np.meshgrid(*([np.arange(n_rep)] * 3), indexing="ij"), -1
    ).reshape(-1, 3) * A_LAT
    pos = np.concatenate([gpts, gpts + 0.5 * A_LAT], axis=0)
    pos = pos + rng.uniform(-0.1, 0.1, pos.shape)
    n = pos.shape[0]
    cell = np.eye(3) * (n_rep * A_LAT)
    numbers = np.r_[np.full(n // 2, 55), np.full(n // 2, 17)].astype(np.int32)
    charges = np.r_[np.ones(n // 2), -np.ones(n // 2)]

    tables = realistic_test_tables(np.float64)
    rcov = tables["rcov"] * _AUTOANG
    r4r2 = tables["r4r2"] * _AUTOANG
    c6 = tables["c6ab"] * _AUTOANG**6
    cna = np.asarray(element_cn_ref(tables["cn_ref"]))
    return pos, cell, numbers, charges, rcov, r4r2, cna, c6


def build_grid(pos, cell, cutoff=CUTOFF):
    """The periodic halo grid as the composite builds it: geometry at
    target occupancy 0.75, the best half-bin origin, and a capacity of the
    observed occupancy plus headroom, rounded up to a multiple of 8."""
    pbc = np.array([True] * 3)
    dims, radius, cap = estimate_grid_geometry(
        cell, pbc, cutoff, pos.shape[0], target_occupancy=0.75)
    origin_np, observed = choose_grid_origin(pos, cell, pbc, dims)
    origin = origin_np if origin_np.any() else None
    cap = max(int(np.ceil((observed + 1) / 8)) * 8,
              int(np.ceil(observed * 1.02 / 8)) * 8)
    return build_atom_grid(pos, cell, pbc, dims, radius, cap, origin=origin)


def compute_forces(dtype=torch.float32, device="cuda", n_rep=N_REP,
                   cutoff=CUTOFF, alpha=ALPHA, mesh=MESH):
    """Per-stage force arrays ``{d3, coulomb, pme}`` (numpy f64) for the
    composite, computed in ``dtype`` on ``device`` (the card unless the
    caller asks for the CPU)."""
    pos_np, cell_np, numbers, charges, rcov, r4r2, cna, c6 = build_system(
        n_rep)
    numbers, rcov, r4r2, c6, cna = compact_d3_elements(numbers, rcov, r4r2,
                                                       c6, cna)
    pos = torch.as_tensor(pos_np, dtype=dtype, device=device)
    cell = torch.as_tensor(cell_np, dtype=dtype, device=device)
    q = torch.as_tensor(charges, dtype=dtype, device=device)
    g = build_grid(pos, cell, cutoff)

    _, f_d3, _ = grid_dftd3(g, numbers, rcov, r4r2, c6, cna, cutoff,
                            D3_A1, D3_A2, D3_S8)
    _, f_c = grid_coulomb_energy_forces(g, q, cutoff, alpha)
    tile_cap = observed_tile_capacity(pos, cell, mesh)
    _, f_p = pme_reciprocal_space(pos, q, cell, alpha, mesh_dimensions=mesh,
                                  compute_forces=True,
                                  tile_capacity=tile_cap)
    return {k: v.detach().cpu().numpy().astype(np.float64)
            for k, v in (("d3", f_d3), ("coulomb", f_c), ("pme", f_p))}


def load_reference():
    """The committed f64 reference forces (an ``npz`` with ``d3``,
    ``coulomb`` and ``pme``), or None when the file is missing or was
    written for other composite parameters."""
    try:
        ref = np.load(REF_PATH)
    except OSError:
        return None
    return ref if str(ref["version"]) == REF_VERSION else None


def relative_errors(forces, ref):
    """``max |f - f_ref| / max |f_ref|`` per stage.  The f32 D3 value has a
    conditioning floor (CN rounding amplified through dC6/dCN on weak-force
    atoms), so it is compared against the reference engine's own f32
    error, not an absolute bar."""
    return {k: float(np.abs(f - ref[k]).max() / np.abs(ref[k]).max())
            for k, f in forces.items()}


def rms_errors(forces, ref):
    """``RMS |f - f_ref| / RMS |f_ref|`` per stage."""
    return {k: float(np.sqrt(((f - ref[k]) ** 2).mean())
                     / np.sqrt((np.asarray(ref[k]) ** 2).mean()))
            for k, f in forces.items()}

# SPDX-License-Identifier: Apache-2.0
"""The MD force step on one periodic crystal: four public entry points of
the port a call, in the order an MD code runs them,

1. ``grid.build_atom_grid``,
2. ``grid_d3.grid_dftd3`` (default engine: energies, forces, CNs),
3. ``grid.grid_coulomb_energy_forces`` (erfc real space),
4. ``pme.pme_reciprocal_space(compute_forces=True, tile_capacity=...)``.

Set-up chooses the grid geometry and the PME tile capacity once, over
every position set the run will use, as an MD code does at its start.

Its traffic mix (``workloads/<traffic>.json``): ``position_sets`` copies
of the configuration's lattice, each atom moved by U(-``jitter``,
``jitter``) Angstrom per axis, drawn on the device; call ``c`` takes set
``c mod position_sets``, so no call sees the positions of the call before
it, as in MD.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_port.compare import max_rel
from bench_port.reference.coulomb import coulomb
from bench_port.reference.d3 import dftd3
from bench_port.reference.neighbors import ordered_pairs
from bench_port.reference.pme import pme_reciprocal
from bench_port.traffic import Traffic, device_rng

STAGES = ("grid_build", "d3", "coulomb", "pme")
OUTPUTS = ("d3_energy", "d3_forces", "d3_cn", "coulomb_energies",
           "coulomb_forces", "pme_energies", "pme_forces")


def lattice(config):
    """``(sites [n, 3], numbers [n], charges [n], cell [3, 3])`` of the
    configuration's CsCl (B2) supercell: the first species on the
    simple-cubic sites, the second on the cube centres."""
    lat = config["lattice"]
    if lat["kind"] != "CsCl":
        raise ValueError(f"unknown lattice {lat['kind']!r}")
    n_rep, a = int(lat["n_rep"]), float(lat["a"])
    g = np.stack(np.meshgrid(*([np.arange(n_rep)] * 3), indexing="ij"),
                 -1).reshape(-1, 3) * a
    sites = np.concatenate([g, g + 0.5 * a])
    first, second = config["species"]
    half = g.shape[0]
    numbers = np.r_[np.full(half, first["number"]),
                    np.full(half, second["number"])].astype(np.int32)
    charges = np.r_[np.full(half, first["charge"]),
                    np.full(half, second["charge"])]
    return sites, numbers, charges, np.eye(3) * (n_rep * a)


def make_traffic(config, mix, seed: int, device) -> Traffic:
    """The jittered position sets of the mix ``mix``."""
    sites, numbers, charges, cell = lattice(config)
    sets = int(mix["position_sets"])
    base = torch.as_tensor(sites, dtype=torch.float32, device=device)
    noise = torch.rand((sets,) + tuple(base.shape),
                       generator=device_rng(seed, 0, device), device=device,
                       dtype=torch.float32)
    pos = base + (2.0 * noise - 1.0) * float(mix["jitter"])
    return Traffic(list(pos.unbind(0)), [numbers] * sets, cell,
                   torch.as_tensor(charges, dtype=torch.float32,
                                   device=device), 1, len(numbers))


class Cell:
    """Set-up, the timed call, and the reference of one run."""

    def __init__(self, config, traffic, device, seed: int):
        from nvalchemiops_torch.grid import (
            _capacity_of, build_atom_grid, choose_grid_geometry,
        )
        from nvalchemiops_torch.spline_windowed import observed_tile_capacity

        self.config, self.traffic, self.device = config, traffic, device
        d3 = config["d3"]
        self.tables = tuple(np.asarray(d3[k], dtype=np.float64)
                            for k in ("rcov", "r4r2", "c6ab", "cn_ref"))
        self.d3 = {k: float(d3[k]) for k in ("cutoff", "a1", "a2", "s6", "s8",
                                              "k1", "k3")}
        self.coul = {k: float(v) for k, v in config["coulomb"].items()}
        pme = config["pme"]
        self.alpha = float(pme["alpha"])
        self.mesh = tuple(int(m) for m in pme["mesh"])
        self.order = int(pme["order"])
        self.pbc = np.asarray(config["pbc"], dtype=bool)
        self.cell_t = torch.as_tensor(traffic.cell, dtype=torch.float32,
                                      device=device)
        self.numbers = traffic.numbers[0]
        sets = traffic.positions
        dims, radius, cap, origin = choose_grid_geometry(
            sets[0], self.cell_t, self.pbc, self.d3["cutoff"])
        observed = max(int(build_atom_grid(p, self.cell_t, self.pbc, dims,
                                           radius, cap, origin=origin
                                           ).counts_max) for p in sets)
        self.geometry = (dims, radius, max(cap, _capacity_of(observed)),
                         origin)
        self.tile_cap = max(observed_tile_capacity(p, self.cell_t, self.mesh,
                                                   spline_order=self.order)
                            for p in sets)

    @property
    def atoms_per_call(self) -> int:
        return self.traffic.atoms_per_call

    def describe(self) -> str:
        dims, radius, cap, origin = self.geometry
        return (f"grid dims {dims} radius {radius} cap {cap} origin "
                f"{None if origin is None else list(origin)}; PME mesh "
                f"{self.mesh} tile capacity {self.tile_cap}")

    def call(self, c: int, mark=None):
        """Call ``c`` on position set ``c mod K``; ``mark(stage)`` at each
        stage's start and ``mark(None)`` at the end."""
        from nvalchemiops_torch.grid import (
            build_atom_grid, grid_coulomb_energy_forces,
        )
        from nvalchemiops_torch.interactions.dispersion.grid_d3 import (
            grid_dftd3,
        )
        from nvalchemiops_torch.interactions.electrostatics.pme import (
            pme_reciprocal_space,
        )

        mark = mark or (lambda stage: None)
        pos = self.traffic.positions[c % len(self.traffic.positions)]
        dims, radius, cap, origin = self.geometry
        d3 = self.d3
        mark("grid_build")
        g = build_atom_grid(pos, self.cell_t, self.pbc, dims, radius, cap,
                            origin=origin)
        mark("d3")
        e, f, cn = grid_dftd3(g, self.numbers, *self.tables, d3["cutoff"],
                              d3["a1"], d3["a2"], d3["s8"], s6=d3["s6"],
                              k1=d3["k1"], k3=d3["k3"])
        mark("coulomb")
        ec, fc = grid_coulomb_energy_forces(g, self.traffic.charges,
                                            self.coul["cutoff"],
                                            self.coul["alpha"])
        mark("pme")
        ep, fp = pme_reciprocal_space(pos, self.traffic.charges, self.cell_t,
                                      self.alpha, mesh_dimensions=self.mesh,
                                      spline_order=self.order,
                                      compute_forces=True,
                                      tile_capacity=self.tile_cap)
        mark(None)
        return dict(zip(OUTPUTS, (e, f, cn, ec, fc, ep, fp)))

    def roofline_context(self) -> dict:
        return {"systems": 1, "atoms": self.atoms_per_call,
                "volume": float(np.prod(np.diag(self.traffic.cell))),
                "cutoff": self.d3["cutoff"],
                "coulomb_cutoff": self.coul["cutoff"],
                "mesh": int(self.tables[3].shape[1]),
                "pme_atoms": self.atoms_per_call, "order": self.order}

    @staticmethod
    def draw_sample(rng, check):
        """Every atom of the sampled call is compared."""
        return None

    def reference(self, c: int, sample, dtype=torch.float64,
                  acc=torch.float64):
        """The outputs of call ``c`` by the plain reference."""
        device = self.device
        pos = self.traffic.positions[c % len(self.traffic.positions)].to(
            device, torch.float64)
        q = self.traffic.charges.to(torch.float64)
        cell = torch.as_tensor(self.traffic.cell, dtype=torch.float64)
        n = pos.shape[0]
        pairs = ordered_pairs(pos, cell, self.d3["cutoff"])
        e, f, cn = dftd3(pairs, self.numbers, n, *self.tables, self.d3,
                         dtype=dtype, acc=acc)
        if self.coul["cutoff"] != self.d3["cutoff"]:
            pairs = ordered_pairs(pos, cell, self.coul["cutoff"])
        ec, fc = coulomb(pairs, q, n, self.coul["alpha"], dtype=dtype,
                         acc=acc)
        del pairs
        ep, fp = pme_reciprocal(pos, q, cell, self.alpha, self.mesh,
                                self.order, dtype=dtype, acc=acc)
        return dict(zip(OUTPUTS, (e, f, cn, ec, fc, ep, fp)))

    @staticmethod
    def select(out, sample):
        """Every output of the call is compared."""
        return out

    @staticmethod
    def compare(out, ref) -> dict:
        """Each output's largest error over the reference's largest
        magnitude."""
        return {k: max_rel(out[k], ref[k]) for k in OUTPUTS}

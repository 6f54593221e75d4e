# SPDX-License-Identifier: Apache-2.0
"""A batch of periodic systems through one ``dense_d3.batch_dftd3(engine=
"auto")`` call a step, as an ML training loop calls it: energies, forces
and CNs per system.  The router picks the dense engine (kernel 4) or the
batched grid (kernel 1 with a system axis) from the batch's sizes.

The D3 tables are drawn from the run's seed as the library's own batched
benchmark draws them: ``zmax`` elements, ``mesh`` references each, C6
symmetric under the swap of the two atoms.

Its traffic mix (``workloads/<traffic>.json``): ``position_sets`` batches
of ``systems`` x ``atoms`` positions uniform in cubic boxes of edge
``box`` (drawn on the device), and element numbers uniform in
1..``zmax`` of the configuration.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_port.compare import max_rel
from bench_port.reference.d3 import dftd3
from bench_port.reference.neighbors import ordered_pairs
from bench_port.traffic import Traffic, device_rng, numpy_rng

STAGES = ("d3",)
OUTPUTS = ("d3_energy", "d3_forces", "d3_cn")


def draw_tables(config, seed: int):
    """``(rcov, r4r2, c6ab, cn_ref)`` (float32 numpy; row 0 is padding)."""
    d3 = config["d3"]
    t = d3["tables"]
    zmax, mesh = int(d3["zmax"]), int(d3["mesh"])
    rng = numpy_rng(seed, 2)
    rcov = np.r_[0.0, rng.uniform(*t["rcov"], zmax)]
    r4r2 = np.r_[0.0, rng.uniform(*t["r4r2"], zmax)]
    cn_ref = np.vstack([np.zeros(mesh), np.cumsum(
        rng.uniform(*t["cn_ref_step"], (zmax, mesh)), 1)])
    c6 = rng.uniform(*t["c6ab"], (zmax + 1, zmax + 1, mesh, mesh))
    c6[0] = 0.0
    c6[:, 0] = 0.0
    c6 = 0.5 * (c6 + np.swapaxes(np.swapaxes(c6, 0, 1), 2, 3))
    return tuple(np.asarray(a, np.float32) for a in (rcov, r4r2, c6, cn_ref))


def make_traffic(config, mix, seed: int, device) -> Traffic:
    """The uniform batches of the mix ``mix``."""
    sets = int(mix["position_sets"])
    b, n, box = int(mix["systems"]), int(mix["atoms"]), float(mix["box"])
    pos = torch.rand((sets, b, n, 3), generator=device_rng(seed, 0, device),
                     device=device, dtype=torch.float32) * box
    rng = numpy_rng(seed, 1)
    zmax = int(config["d3"]["zmax"])
    numbers = [rng.integers(1, zmax + 1, (b, n)).astype(np.int32)
               for _ in range(sets)]
    return Traffic(list(pos.unbind(0)), numbers, np.eye(3) * box, None, b, n)


class Cell:
    """Set-up, the timed call, and the reference of one run."""

    def __init__(self, config, traffic, device, seed: int):
        self.config, self.traffic, self.device = config, traffic, device
        d3 = config["d3"]
        self.d3 = {k: float(d3[k]) for k in ("cutoff", "a1", "a2", "s6", "s8",
                                              "k1", "k3")}
        self.tables = draw_tables(config, seed)
        self.pbc = np.asarray(config["pbc"], dtype=bool)

    @property
    def atoms_per_call(self) -> int:
        return self.traffic.atoms_per_call

    def describe(self) -> str:
        from nvalchemiops_torch.interactions.dispersion.dense_d3 import (
            batch_route,
        )
        t = self.traffic
        return (f"{t.systems} x {t.atoms} atoms, box {t.cell[0, 0]}, route "
                f"{batch_route(t.cell, self.pbc, self.d3['cutoff'], t.atoms)}")

    def call(self, c: int, mark=None):
        """Call ``c`` on batch ``c mod K``."""
        from nvalchemiops_torch.interactions.dispersion.dense_d3 import (
            batch_dftd3,
        )

        mark = mark or (lambda stage: None)
        k = c % len(self.traffic.positions)
        d3 = self.d3
        mark("d3")
        e, f, cn = batch_dftd3(self.traffic.positions[k],
                               self.traffic.numbers[k], self.traffic.cell,
                               self.pbc, d3["cutoff"], *self.tables,
                               d3["a1"], d3["a2"], d3["s8"], s6=d3["s6"],
                               k1=d3["k1"], k3=d3["k3"], engine="auto")
        mark(None)
        return dict(zip(OUTPUTS, (e, f, cn)))

    def roofline_context(self) -> dict:
        t = self.traffic
        return {"systems": t.systems, "atoms": t.atoms,
                "volume": float(np.prod(np.diag(t.cell))),
                "cutoff": self.d3["cutoff"], "coulomb_cutoff": None,
                "mesh": int(self.tables[3].shape[1])}

    def draw_sample(self, rng, check):
        """``check["sample_systems"]`` systems of the batch, drawn from the
        seed."""
        return sorted(int(s) for s in rng.choice(
            self.traffic.systems, size=int(check["sample_systems"]),
            replace=False))

    def reference(self, c: int, systems, dtype=torch.float64,
                  acc=torch.float64):
        """The outputs of call ``c`` for ``systems`` (indices into the
        batch) by the plain reference."""
        k = c % len(self.traffic.positions)
        cell = torch.as_tensor(self.traffic.cell, dtype=torch.float64)
        out = {name: [] for name in OUTPUTS}
        for s in systems:
            pos = self.traffic.positions[k][s].to(self.device, torch.float64)
            numbers = self.traffic.numbers[k][s]
            pairs = ordered_pairs(pos, cell, self.d3["cutoff"])
            for name, v in zip(OUTPUTS, dftd3(
                    pairs, numbers, pos.shape[0], *self.tables, self.d3,
                    dtype=dtype, acc=acc)):
                out[name].append(v)
            del pairs
        return {name: torch.stack(v) for name, v in out.items()}

    @staticmethod
    def select(out, systems):
        """The sampled systems' outputs of a call."""
        idx = torch.as_tensor(np.asarray(systems), dtype=torch.long)
        return {k: v[idx.to(v.device)] for k, v in out.items()}

    @staticmethod
    def compare(out, ref) -> dict:
        """Each output's largest error over the reference's largest
        magnitude, system by system, the worst of the sampled systems."""
        return {name: max(max_rel(o, r) for o, r in zip(out[name], ref[name]))
                for name in OUTPUTS}

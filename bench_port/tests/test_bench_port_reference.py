# SPDX-License-Identifier: Apache-2.0
"""The plain reference against the port's plain path in float64 on the
CPU: the two are written apart, from the same formulas, and agree to
rounding (Coulomb to the port's erfc polynomial, 1.5e-7 absolute)."""

import numpy as np
import pytest
import torch

from bench_port.harness import Layout
from bench_port.reference.coulomb import coulomb
from bench_port.reference.d3 import dftd3
from bench_port.reference.neighbors import ordered_pairs
from bench_port.reference.pme import bspline_weights, pme_reciprocal
from bench_port.systems import cscl_md
from bench_port.systems.d3_batch import draw_tables


def _rel(a, b):
    a, b = (torch.as_tensor(v).detach().double() for v in (a, b))
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module")
def crystal():
    cfg = Layout().json("configs", "cscl-md")
    cfg["lattice"]["n_rep"] = 6
    cfg["d3"]["cutoff"] = 9.6          # under half the 24.7 A box
    t = cscl_md.make_traffic(cfg, {"position_sets": 1, "jitter": 0.1}, 11,
                             "cpu")
    pos = t.positions[0].double()
    d3 = cfg["d3"]
    tables = tuple(np.asarray(d3[k]) for k in ("rcov", "r4r2", "c6ab",
                                                 "cn_ref"))
    return cfg, t, pos, tables


def test_neighbors_against_brute_force():
    rng = np.random.default_rng(1)
    box, cut = 9.0, 5.0
    pos = torch.tensor(rng.uniform(0, box, (60, 3)))
    i, j, d = ordered_pairs(pos, torch.eye(3) * box, cut)
    got = sorted(zip(i.tolist(), j.tolist(), np.round(d.numpy(), 9).tolist()))
    want = []
    for a in range(60):
        for b in range(60):
            for s in np.ndindex(3, 3, 3):
                v = pos[b].numpy() + (np.array(s) - 1) * box - pos[a].numpy()
                r = np.sqrt((v ** 2).sum())
                if 0 < r < cut:
                    want.append((a, b, np.round(v, 9).tolist()))
    assert got == sorted(want)


def test_bspline_weights_closed_form():
    t = torch.linspace(0, 0.999, 17, dtype=torch.float64)
    w = bspline_weights(t, 4)
    ref = torch.stack([t ** 3, -3 * t ** 3 + 3 * t ** 2 + 3 * t + 1,
                       3 * t ** 3 - 6 * t ** 2 + 4, (1 - t) ** 3], -1) / 6
    assert torch.allclose(w, ref, atol=1e-15)


def test_crystal_against_the_port_f64(crystal):
    from nvalchemiops_torch.grid import build_atom_grid_auto
    from nvalchemiops_torch.grid import grid_coulomb_energy_forces
    from nvalchemiops_torch.interactions.dispersion.grid_d3 import grid_dftd3
    from nvalchemiops_torch.interactions.electrostatics.pme import (
        pme_reciprocal_space,
    )

    cfg, t, pos, tables = crystal
    d3 = {k: float(v) for k, v in cfg["d3"].items()
          if k in ("cutoff", "a1", "a2", "s6", "s8", "k1", "k3")}
    cell = torch.tensor(t.cell)
    q = t.charges.double()
    g = build_atom_grid_auto(pos, cell, np.array([True] * 3), d3["cutoff"])
    e, f, cn = grid_dftd3(g, t.numbers[0], *tables, d3["cutoff"], d3["a1"],
                          d3["a2"], d3["s8"])
    ec, fc = grid_coulomb_energy_forces(g, q, 9.6, 0.35)
    ep, fp = pme_reciprocal_space(pos, q, cell, 0.35,
                                  mesh_dimensions=(16, 16, 16),
                                  compute_forces=True)
    pairs = ordered_pairs(pos, cell, d3["cutoff"])
    E, F, CN = dftd3(pairs, t.numbers[0], len(pos), *tables, d3)
    Ec, Fc = coulomb(pairs, q, len(pos), 0.35)
    Ep, Fp = pme_reciprocal(pos, q, cell, 0.35, (16, 16, 16))
    assert _rel(e, E) < 1e-12 and _rel(f, F) < 1e-12 and _rel(cn, CN) < 1e-12
    assert _rel(ec, Ec) < 2e-6 and _rel(fc, Fc) < 2e-6
    assert _rel(ep, Ep) < 1e-12 and _rel(fp, Fp) < 1e-12


def test_dense_batch_against_the_port_f64():
    from nvalchemiops_torch.interactions.dispersion.dense_d3 import (
        batch_dftd3,
    )

    cfg = Layout().json("configs", "d3-batch")
    tables = draw_tables(cfg, 4)
    rng = np.random.default_rng(2)
    b, n, box, cut = 3, 80, 10.0, 7.5           # cutoff > box / 2: images
    pos = torch.tensor(rng.uniform(0, box, (b, n, 3)))
    numbers = rng.integers(1, 17, (b, n)).astype(np.int32)
    d = cfg["d3"]
    e, f, cn = batch_dftd3(pos, numbers, np.eye(3) * box, np.array([True] * 3),
                           cut, *tables, d["a1"], d["a2"], d["s8"])
    params = dict(d, cutoff=cut)
    for s in range(b):
        pairs = ordered_pairs(pos[s], torch.eye(3) * box, cut)
        E, F, CN = dftd3(pairs, numbers[s], n, *tables, params)
        assert _rel(e[s], E) < 1e-11 and _rel(f[s], F) < 1e-11
        assert _rel(cn[s], CN) < 1e-12

# SPDX-License-Identifier: Apache-2.0
"""The roofline work counts: kernel 4's bound counts the pairs within the
cutoff, as kernel 1's does, and equals it on the same systems."""

import math

import numpy as np
import pytest
import torch

from bench_port.systems.d3_batch import draw_tables
from bench_port.harness import Layout
from bench_port.work import pair_flops, pairs_in_cutoff

CFG = {"d3": {"zmax": 4, "mesh": 5, "tables": {
    "rcov": [0.6, 1.2], "r4r2": [2.0, 5.0], "cn_ref_step": [0.3, 1.0],
    "c6ab": [5.0, 40.0]}}}


def _capture(monkeypatch, module, name, sink):
    orig = getattr(module, name)

    def wrapper(*args, **kwargs):
        out = orig(*args, **kwargs)
        sink.append((args, kwargs, out))
        return out

    monkeypatch.setattr(module, name, wrapper)


@pytest.fixture(scope="module")
def roofline():
    return Layout().modules("roofline")


def _batch(b, n, box, seed=3):
    rng = np.random.default_rng(seed)
    pos = torch.tensor(rng.uniform(0, box, (b, n, 3)), dtype=torch.float32)
    numbers = rng.integers(1, 5, (b, n)).astype(np.int32)
    return pos, numbers


def _ctx(b, n, box, cutoff):
    return {"systems": b, "atoms": n, "volume": box ** 3, "cutoff": cutoff,
            "coulomb_cutoff": None, "mesh": 5}


def test_dense_bound_equals_grid_bound_on_the_same_systems(monkeypatch,
                                                          roofline):
    from nvalchemiops_torch.interactions.dispersion import dense_d3, grid_d3

    b, n, box, cutoff = 2, 300, 21.0, 6.0
    pos, numbers = _batch(b, n, box)
    tables = draw_tables(CFG, 5)
    dense, grid = [], []
    _capture(monkeypatch, dense_d3, "dense_pairs", dense)
    _capture(monkeypatch, grid_d3, "window_sweep", grid)
    args = (pos, numbers, np.eye(3) * box, np.array([True] * 3), cutoff,
            *tables, 0.4, 4.2, 1.8)
    dense_d3.batch_dftd3(*args, engine="dense")
    grid_d3.batch_grid_dftd3(*args)
    ctx = _ctx(b, n, box, cutoff)
    fd = {a[0]: roofline["dense_pairs"].work(a, k, o, ctx)[1]
          for a, k, o in dense}
    fg = {a[0]: roofline["window_sweep"].work(a, k, o, ctx)[1]
          for a, k, o in grid}
    assert set(fd) == {"cn", "direct", "chain"}
    assert set(fg) == {"cn", "d3_direct", "chain"}
    assert fd["cn"] == fg["cn"]
    assert fd["direct"] == fg["d3_direct"]
    assert fd["chain"] == fg["chain"]
    pairs = pairs_in_cutoff(b, n, box ** 3, cutoff)
    assert fd["cn"] == pair_flops("cn", pairs, 5)


def test_dense_bound_ignores_the_slots_the_sweep_visits(roofline):
    # padding rows and image combos are slots kernel 4 visits, not work of
    # the function: the operations stay those of the pairs in the cutoff
    ctx = _ctx(4, 100, 15.0, 5.0)
    lw = torch.zeros(4, 128, 10)
    small = roofline["dense_pairs"].work(
        ("direct", torch.zeros(4, 128, 15), torch.zeros(4, 9), [(0, 0, 0)],
         None, lw), {}, torch.zeros(4, 4, 128), ctx)
    wide = roofline["dense_pairs"].work(
        ("direct", torch.zeros(4, 256, 15), torch.zeros(4, 9),
         [(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 1)], None,
         torch.zeros(4, 256, 10)), {}, torch.zeros(4, 4, 256), ctx)
    assert small[1] == wide[1]
    expect = 4 * 100 * 100 * (4 * math.pi / 3) * 5.0 ** 3 / (2 * 15.0 ** 3)
    assert small[1] == pytest.approx(expect * (8 + 35 + 30))
    # bytes: each input read once, each output written once
    assert small[0] == 4 * (4 * 128 * 15 + 4 * 9 + 4 * 128 * 10
                            + 4 * 4 * 128)


def test_pairs_in_cutoff_counts_the_pairs_of_uniform_systems():
    rng = np.random.default_rng(0)
    box, n, cutoff = 20.0, 2000, 4.0
    p = rng.uniform(0, box, (n, 3))
    d = p[:, None] - p[None]
    d -= box * np.round(d / box)
    r = np.sqrt((d ** 2).sum(-1))
    counted = ((r < cutoff).sum() - n) / 2
    assert pairs_in_cutoff(1, n, box ** 3, cutoff) == pytest.approx(
        counted, rel=0.03)

# SPDX-License-Identifier: Apache-2.0
"""CUDA kernels of the PyTorch port against their plain versions, on the
card, and the plain-torch entry points (neighbor lists, Coulomb, Ewald,
PME) on the card against the same calls on CPU tensors.  Every test here
needs a CUDA device and skips without one.

This file imports neither JAX nor the test helpers that do, so it also
runs where JAX is not installed:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py``.
"""

import json

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

# f32 kernel vs plain: max |kernel - plain| <= 1e-5 x max |plain| per output
# (different summation orders; the pair sweep's j-side atomics sum in a
# run-dependent order)
RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _close(a, b):
    a, b = a.double(), b.double()
    err = (a - b).abs().max().item()
    scale = b.abs().max().item()
    assert np.isfinite(err) and err <= RTOL * scale, (err, scale)


def _captured_calls(device, n_rep, cutoff):
    """Kernel wrapper calls of the composite's main path, recorded."""
    from nvalchemiops_torch import composite, grid, spline_windowed
    from nvalchemiops_torch.interactions.dispersion import grid_d3

    calls = {}
    undo = []

    def wrap(module, name, key_of):
        orig = getattr(module, name)

        def wrapper(*args, **kwargs):
            calls.setdefault(key_of(*args), (args, kwargs))
            return orig(*args, **kwargs)

        setattr(module, name, wrapper)
        undo.append((module, name, orig))

    for mod in (grid, grid_d3):
        wrap(mod, "window_sweep", lambda body, *a: body)
    wrap(spline_windowed, "spread_windows", lambda *a: "spread")
    wrap(spline_windowed, "gather_grad_planes", lambda *a: "gather")
    try:
        composite.compute_forces(torch.float32, device, n_rep=n_rep,
                                 cutoff=cutoff)
    finally:
        for module, name, orig in reversed(undo):
            setattr(module, name, orig)
    return calls


@pytest.mark.parametrize("n_rep,cutoff", [(8, 9.6), (6, 5.0)])
def test_kernels_match_plain_on_main_path_inputs(cuda, n_rep, cutoff):
    from nvalchemiops_torch.kernels import launch_counts
    from nvalchemiops_torch.kernels import window_sweep as ws
    from nvalchemiops_torch.kernels import windowed_gather as wg

    calls = _captured_calls(cuda, n_rep, cutoff)
    assert sorted(calls) == ["chain", "cn", "coulomb", "d3_direct",
                             "gather", "spread"]
    pairs = {"spread": (wg.spread_windows, wg.spread_windows_plain),
             "gather": (wg.gather_grad_planes, wg.gather_grad_planes_plain)}
    for key, (args, kwargs) in calls.items():
        kern, plain = pairs.get(key, (ws.window_sweep, ws.window_sweep_plain))
        count_key = {"spread": "windowed_spread",
                     "gather": "windowed_gather_grad"}.get(
                         key, f"window_sweep_{key}")
        before = launch_counts[count_key]
        out_k = kern(*args, **kwargs)
        assert launch_counts[count_key] == before + 1
        out_p = plain(*args, **kwargs)
        torch.cuda.synchronize()
        if isinstance(out_k, torch.Tensor):
            out_k, out_p = (out_k,), (out_p,)
        for a, b in zip(out_k, out_p):
            if a.dim() == 5:                 # stacked planes: per feature
                for fa, fb in zip(a, b):
                    _close(fa, fb)
            else:
                _close(a, b)


def test_d3_direct_kernel_with_live_cn_derivatives(cuda):
    """Random positions and synthetic tables keep CN off saturation, so the
    dE/dCN outputs (own dei, j-side dej) are exercised at full size."""
    from nvalchemiops_torch import grid
    from nvalchemiops_torch.interactions.dispersion import grid_d3
    from nvalchemiops_torch.kernels import window_sweep as ws

    rng = np.random.default_rng(4)
    zmax = 4
    rcov = np.concatenate([[0.0], rng.uniform(0.6, 1.4, zmax)])
    r4r2 = np.concatenate([[0.0], rng.uniform(2.0, 6.0, zmax)])
    cna = np.concatenate([np.zeros((1, 5)),
                          np.cumsum(rng.uniform(0.3, 1.0, (zmax, 5)), 1)])
    c6 = rng.uniform(5.0, 40.0, (zmax + 1, zmax + 1, 5, 5))
    c6[0] = 0.0
    c6[:, 0] = 0.0
    c6 = 0.5 * (c6 + np.swapaxes(np.swapaxes(c6, 0, 1), 2, 3))
    n, box, cutoff = 4000, 30.0, 4.5
    pos = torch.as_tensor(rng.uniform(0, box, (n, 3)), dtype=torch.float32,
                          device=cuda)
    cell = torch.eye(3, device=cuda) * box
    numbers = rng.integers(1, zmax + 1, n).astype(np.int32)
    dims, radius, cap = grid.estimate_grid_geometry(cell, [True] * 3,
                                                    cutoff, n, 0.6)
    g = grid.build_atom_grid(pos, cell, [True] * 3, dims, radius, cap)
    seen = {}
    orig = grid_d3.window_sweep

    def record(body, *args, **kwargs):
        seen.setdefault(body, (args, kwargs))
        return orig(body, *args, **kwargs)

    grid_d3.window_sweep = record
    try:
        grid_d3.grid_dftd3(g, numbers, rcov, r4r2, c6, cna, cutoff, 0.42,
                           4.1, 1.7)
    finally:
        grid_d3.window_sweep = orig
    args, kwargs = seen["d3_direct"]
    out_k = ws.window_sweep("d3_direct", *args, **kwargs)
    out_p = ws.window_sweep_plain("d3_direct", *args, **kwargs)
    assert out_p[0][4].abs().max() > 1e-6          # dE/dCN is live
    for a, b in zip(out_k, out_p):
        for fa, fb in zip(a, b):
            _close(fa, fb)


def test_wrappers_run_float64_on_cuda_plain(cuda):
    """A float64 CUDA tensor takes the plain version on the card: the
    wrapper launches nothing and returns the plain version's result on the
    card (the kernels are float32)."""
    from nvalchemiops_torch.kernels import launch_counts, reset_launch_counts
    from nvalchemiops_torch.kernels import window_sweep as ws
    from nvalchemiops_torch.kernels import windowed_gather as wg

    rng = np.random.default_rng(5)
    cand = torch.as_tensor(rng.uniform(0.0, 6.0, (4, 4, 4, 4, 8)),
                           device=cuda)
    own = cand[:, 1:3, 1:3, 1:3].contiguous()
    params = ws.SweepParams(cutoff=3.0)
    smat = torch.as_tensor(rng.normal(size=(8, 16, 72)), device=cuda)
    q_t = torch.as_tensor(rng.normal(size=(8, 16)), device=cuda)
    reset_launch_counts()
    got = ws.window_sweep("cn", (1, 1, 1), own, cand, params)
    spread = wg.spread_windows(smat, q_t, 12)
    assert not any(launch_counts.values()), launch_counts
    want = ws.window_sweep_plain("cn", (1, 1, 1), own, cand, params)
    assert all(t.device.type == "cuda" and t.dtype == torch.float64
               for t in (*got, spread))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(spread, wg.spread_windows_plain(smat, q_t, 12))


def test_composite_accuracy_on_card(cuda):
    """The f32 composite on the card within 1.25x of the JAX package's
    recorded f32 errors against the committed f64 reference."""
    from nvalchemiops_torch.composite import (
        compute_forces, load_reference, relative_errors, rms_errors,
    )

    bars = {"d3": (7.54e-4, 7.21e-4), "coulomb": (1.82e-5, 1.69e-5),
            "pme": (7.51e-5, 9.13e-5)}
    forces = compute_forces(torch.float32, cuda)
    ref = load_reference()
    rel, rms = relative_errors(forces, ref), rms_errors(forces, ref)
    for k, (bar_max, bar_rms) in bars.items():
        assert rel[k] <= 1.25 * bar_max, (k, rel[k])
        assert rms[k] <= 1.25 * bar_rms, (k, rms[k])


def _d3_tables(rng, zmax=4):
    rcov = np.concatenate([[0.0], rng.uniform(0.6, 1.4, zmax)])
    r4r2 = np.concatenate([[0.0], rng.uniform(2.0, 6.0, zmax)])
    cna = np.concatenate([np.zeros((1, 5)),
                          np.cumsum(rng.uniform(0.3, 1.0, (zmax, 5)), 1)])
    c6 = rng.uniform(5.0, 40.0, (zmax + 1, zmax + 1, 5, 5))
    c6[0] = 0.0
    c6[:, 0] = 0.0
    c6 = 0.5 * (c6 + np.swapaxes(np.swapaxes(c6, 0, 1), 2, 3))
    return rcov, r4r2, c6, cna


@pytest.mark.parametrize("box,cutoff", [(16.0, 8.5), (14.0, 5.0)])
def test_dense_pairs_kernel_matches_plain(cuda, box, cutoff):
    """Every body of the dense sweep on a batch with padding atoms, with
    image combos (16 A / 8.5 A) and minimum image (14 A / 5 A)."""
    from nvalchemiops_torch.interactions.dispersion import dense_d3
    from nvalchemiops_torch.kernels import dense_pairs as ds

    rng = np.random.default_rng(7)
    b, n = 3, 300
    tab = _d3_tables(rng)
    pos = torch.as_tensor(rng.uniform(0, box, (b, n, 3)),
                          dtype=torch.float32, device=cuda)
    numbers = rng.integers(1, 5, (b, n)).astype(np.int32)
    numbers[:, -9:] = 0
    seen = {}
    orig = dense_d3.dense_pairs

    def record(body, *args, **kwargs):
        seen.setdefault(body, (args, kwargs))
        return orig(body, *args, **kwargs)

    dense_d3.dense_pairs = record
    try:
        e, f, cn = dense_d3.batch_dense_dftd3(
            pos, numbers, torch.eye(3, device=cuda) * box, cutoff, *tab,
            0.42, 4.1, 1.7)
    finally:
        dense_d3.dense_pairs = orig
    assert sorted(seen) == ["chain", "cn", "direct"]
    assert torch.isfinite(f).all() and float(f[:, -9:].abs().max()) == 0.0
    for body, (args, kwargs) in seen.items():
        out_k = ds.dense_pairs(body, *args, **kwargs)
        out_p = ds.dense_pairs_plain(body, *args, **kwargs)
        for a, p in zip(out_k, out_p):
            _close(a, p)


def test_separable_kernels_match_plain(cuda):
    from nvalchemiops_torch import spline
    from nvalchemiops_torch.kernels import separable_spline as ss

    rng = np.random.default_rng(8)
    b, n, mesh = 3, 2000, (32, 24, 40)
    pos = torch.as_tensor(rng.uniform(-1, 28, (b, n, 3)),
                          dtype=torch.float32, device=cuda)
    cells = torch.as_tensor(np.stack([np.eye(3) * (27.0 + i)
                                      for i in range(b)]),
                            dtype=torch.float32, device=cuda)
    q = torch.as_tensor(rng.normal(size=(b, n)), dtype=torch.float32,
                        device=cuda)
    gidx, w, dw, _ = spline._stencil(pos, cells, mesh, 4)
    _close(ss.separable_spread(gidx, w, q, mesh),
           ss.separable_spread_plain(gidx, w, q, mesh))
    pot = torch.as_tensor(rng.normal(size=(b,) + mesh), dtype=torch.float32,
                          device=cuda)
    val_k, grad_k = ss.separable_gather(pot, gidx, w, dw)
    val_p, grad_p = ss.separable_gather_plain(pot, gidx, w, dw)
    _close(val_k, val_p)
    for d in range(3):
        _close(grad_k[..., d], grad_p[..., d])
    _close(ss.separable_gather(pot, gidx, w), val_p)


def _seam_positions(rng, b, n, box):
    """Random atoms in a cubic box, the first four on the periodic seam of
    every axis and on mesh points (theta = 0)."""
    pos = rng.uniform(0.0, box, (b, n, 3))
    pos[:, :4] = [[0.0, 0.0, 0.0], [box - 1e-3] * 3,
                  [1e-3, box - 1e-3, 0.0], [box * 0.5, box - 1e-3, 1e-3]]
    return pos


def _seam_stencil(cuda, seed, b, n, mesh, order, box=27.0):
    """Stencils of :func:`_seam_positions` and random charges."""
    from nvalchemiops_torch import spline

    rng = np.random.default_rng(seed)
    pos = _seam_positions(rng, b, n, box)
    cells = torch.eye(3, device=cuda).expand(b, 3, 3) * box
    gidx, w, _, _ = spline._stencil(
        torch.as_tensor(pos, dtype=torch.float32, device=cuda), cells, mesh,
        order)
    q = torch.as_tensor(rng.normal(size=(b, n)), dtype=torch.float32,
                        device=cuda)
    return gidx, w, q


@pytest.mark.parametrize("order", [1, 2, 3, 4])
@pytest.mark.parametrize("mesh,b,n", [
    ((32, 32, 32), 64, 2000),          # the batched PME
    ((32, 32, 32), 1, 1024),           # the composite on the dense engine
    ((24, 32, 40), 1, 3000),
    ((64, 64, 64), 1, 40_000),
    ((128, 128, 128), 1, 109_744),     # the 128^3 fallback
])
def test_dense_spread_kernel_matches_plain(cuda, order, mesh, b, n):
    """Kernel 5 writes every mesh point (the output memory is poisoned
    with NaN first), agrees with its plain version, seams included, and
    gives the same bits twice (it sums in fixed point)."""
    from nvalchemiops_torch.kernels import launch_counts
    from nvalchemiops_torch.kernels import separable_spline as ss

    gidx, w, q = _seam_stencil(cuda, 30 + order, b, n, mesh, order)
    poison = torch.full((b,) + mesh, float("nan"), device=cuda)
    del poison
    before = launch_counts["separable_spread"]
    got = ss.separable_spread(gidx, w, q, mesh)
    assert launch_counts["separable_spread"] == before + 1
    again = ss.separable_spread(gidx, w, q, mesh)
    want = ss.separable_spread_plain(gidx, w, q, mesh)
    torch.cuda.synchronize()
    _close(got, want)
    assert torch.equal(got, again)


def _gather_case(cuda, seed, b, n, mesh, order, box=27.0):
    """Seam stencils with derivative weights, a random mesh on the card."""
    from nvalchemiops_torch import spline

    rng = np.random.default_rng(seed)
    pos = _seam_positions(rng, b, n, box)
    cells = torch.eye(3, device=cuda).expand(b, 3, 3) * box
    gidx, w, dw, _ = spline._stencil(
        torch.as_tensor(pos, dtype=torch.float32, device=cuda), cells, mesh,
        order)
    pot = torch.as_tensor(rng.normal(size=(b,) + mesh), dtype=torch.float32,
                          device=cuda)
    return pot, gidx, w, dw


def _forced_gather_plan(ss, path, mesh, order, b, n):
    """The plan of ``path``: "staged", or "l2 row" / "l2 atom" (one lane a
    stencil row or one an atom)."""
    import dataclasses

    plan = ss.gather_plan(mesh, order, b, n, staged=path == "staged")
    if path == "staged":
        return plan
    lanes = ss.row_lanes(order) if path == "l2 row" else 1
    return dataclasses.replace(plan, lanes=lanes,
                               atoms_per_block=plan.threads // lanes)


@pytest.mark.parametrize("order", [1, 2, 3, 4])
@pytest.mark.parametrize("path,mesh,b,n", [
    ("staged", (32, 32, 32), 64, 2000),      # the batched PME, as planned
    ("staged", (32, 32, 32), 1, 1024),       # the composite, forced staged
    ("staged", (32, 32, 32), 200, 1100),     # one slice, two passes
    ("staged", (24, 32, 40), 64, 2000),
    ("l2 row", (32, 32, 32), 1, 1024),       # the composite, as planned
    ("l2 atom", (32, 32, 32), 1, 1024),
    ("l2 atom", (128, 128, 128), 1, 109_744),  # the 128^3 fallback
    ("l2 row", (64, 64, 64), 8, 2000),
])
def test_dense_gather_kernel_matches_plain(cuda, monkeypatch, order, path,
                                           mesh, b, n):
    """Kernel 6 on each path agrees with its plain version, value and
    gradients, seams included (132 slices of 8 atoms at B = 1: ragged and
    empty slices; 1,100 atoms a block at B = 200: two passes), and gives
    the same bits twice."""
    from nvalchemiops_torch.kernels import launch_counts
    from nvalchemiops_torch.kernels import separable_spline as ss

    plan = _forced_gather_plan(ss, path, mesh, order, b, n)
    monkeypatch.setattr(ss, "gather_plan", lambda *a, **k: plan)
    pot, gidx, w, dw = _gather_case(cuda, 40 + order, b, n, mesh, order)
    before = launch_counts["separable_gather"]
    val, grad = ss.separable_gather(pot, gidx, w, dw)
    assert launch_counts["separable_gather"] == before + 1
    val2, grad2 = ss.separable_gather(pot, gidx, w, dw)
    only = ss.separable_gather(pot, gidx, w)
    want_v, want_g = ss.separable_gather_plain(pot, gidx, w, dw)
    torch.cuda.synchronize()
    _close(val, want_v)
    for d in range(3):
        _close(grad[..., d], want_g[..., d])
    assert torch.equal(val, val2) and torch.equal(grad, grad2)
    assert torch.equal(only, val)


@pytest.mark.parametrize("order", [2, 4])
def test_dense_gather_paths_give_equal_bits(cuda, monkeypatch, order):
    """The staged path and the L2 path at one lane an atom sum each atom
    in the same order."""
    from nvalchemiops_torch.kernels import separable_spline as ss

    mesh, b, n = (32, 32, 32), 16, 2000
    pot, gidx, w, dw = _gather_case(cuda, 50 + order, b, n, mesh, order)
    outs = []
    for path in ("staged", "l2 atom"):
        plan = _forced_gather_plan(ss, path, mesh, order, b, n)
        monkeypatch.setattr(ss, "gather_plan", lambda *a, _p=plan, **k: _p)
        outs.append(ss.separable_gather(pot, gidx, w, dw))
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("tile", [4, 8, 16])
def test_windowed_spread_kernel_cases(cuda, tile):
    """Kernel 3 at W = 8, 12 and 20: caps that are no multiple of 32 (one
    above the kernel's 64-slot stage), empty slots and empty tiles, rows
    whose band ends in an exact zero weight (atoms on mesh points), a
    zero charge and one dense row; two launches give equal bits."""
    from nvalchemiops_torch import spline_windowed
    from nvalchemiops_torch.kernels import windowed_gather as wg

    rng = np.random.default_rng(20 + tile)
    mesh = (2 * tile, 2 * tile, 4 * tile)
    box, n = 9.0, 600
    pos = rng.uniform(0.0, box, (n, 3))
    pos[:n // 2] = rng.integers(0, mesh[0], (n // 2, 3)) * (
        box / np.array(mesh))
    pos[:, 2] *= 0.6                     # the upper z tiles stay empty
    cell = torch.eye(3, device=cuda) * box
    q = torch.as_tensor(rng.normal(size=n), dtype=torch.float32, device=cuda)
    q[1] = 0.0
    for cap in (45, 77):
        tiles = spline_windowed.build_mesh_tiles(
            torch.as_tensor(pos, dtype=torch.float32, device=cuda), cell,
            mesh, 4, cap=cap, tile=tile)
        w_win = tiles.w_win
        assert w_win == tile + 4
        smat = tiles.smat.clone()
        smat[0, 0, :3 * w_win] = torch.as_tensor(
            rng.uniform(0.1, 1.0, 3 * w_win), dtype=torch.float32,
            device=cuda)
        padded = torch.cat([q, q.new_zeros(1)])
        q_t = padded[tiles.aid.long()].reshape(smat.shape[0], cap)
        q_t[0, 0] = 1.5
        assert bool((q_t == 0).all(-1).any())          # empty tiles
        got = wg.spread_windows(smat, q_t, w_win)
        again = wg.spread_windows(smat, q_t, w_win)
        want = wg.spread_windows_plain(smat, q_t, w_win)
        torch.cuda.synchronize()
        _close(got, want)
        assert torch.equal(got, again)


def test_batched_d3_dense_agrees_with_grid_on_card(cuda):
    """f32 on the card: the dense engine (kernel 4) and the grid engine
    (kernel 1) agree within the composite's D3 bar."""
    from nvalchemiops_torch.interactions.dispersion import (
        batch_dense_dftd3, batch_grid_dftd3,
    )

    rng = np.random.default_rng(9)
    tab = _d3_tables(rng)
    b, n, box, cutoff = 2, 1500, 24.0, 7.0
    pos = torch.as_tensor(rng.uniform(0, box, (b, n, 3)),
                          dtype=torch.float32, device=cuda)
    numbers = rng.integers(1, 5, (b, n)).astype(np.int32)
    cell = torch.eye(3, device=cuda) * box
    _, f_d, _ = batch_dense_dftd3(pos, numbers, cell, cutoff, *tab, 0.42,
                                  4.1, 1.7)
    _, f_g, _ = batch_grid_dftd3(pos, numbers, cell, [True] * 3, cutoff,
                                 *tab, 0.42, 4.1, 1.7)
    err = (f_d.double() - f_g.double()).abs().max().item()
    assert err <= 9.425e-4 * f_g.double().abs().max().item(), err


def test_windowed_kernels_match_plain_at_tile_16(cuda):
    """The batched windowed engine's 16-point tiles run the W = 20 builds
    of the windowed spread and gather; each against its plain version."""
    from nvalchemiops_torch import spline_windowed
    from nvalchemiops_torch.interactions.electrostatics import (
        batch_pme_reciprocal,
    )
    from nvalchemiops_torch.kernels import windowed_gather as wg

    rng = np.random.default_rng(10)
    b, n, box = 2, 1000, 20.0
    pos = torch.as_tensor(rng.uniform(0, box, (b, n, 3)), dtype=torch.float32,
                          device=cuda)
    q = torch.as_tensor(rng.normal(size=(b, n)), dtype=torch.float32,
                        device=cuda)
    seen = {}
    undo = []
    for name in ("spread_windows", "gather_grad_planes"):
        orig = getattr(spline_windowed, name)

        def record(*args, _name=name, _orig=orig, **kwargs):
            seen.setdefault(_name, (args, kwargs))
            return _orig(*args, **kwargs)

        setattr(spline_windowed, name, record)
        undo.append((name, orig))
    try:
        batch_pme_reciprocal(pos, q, torch.eye(3, device=cuda) * box, 0.35,
                             (32, 32, 32), compute_forces=True,
                             engine="windowed")
    finally:
        for name, orig in undo:
            setattr(spline_windowed, name, orig)
    assert sorted(seen) == ["gather_grad_planes", "spread_windows"]
    for name, (args, kwargs) in seen.items():
        assert args[-1] == 20
        out_k = getattr(wg, name)(*args, **kwargs)
        out_p = getattr(wg, f"{name}_plain")(*args, **kwargs)
        if isinstance(out_k, torch.Tensor):
            out_k, out_p = (out_k,), (out_p,)
        for a, p in zip(out_k, out_p):
            _close(a, p)


def _record(modules_names, fn):
    """Run ``fn`` with the named kernel wrappers recording their first call
    per body; returns ``{(name, body): (args, kwargs)}``."""
    seen = {}
    undo = []
    for module, name in modules_names:
        orig = getattr(module, name)

        def record(body, *args, _name=name, _orig=orig, **kwargs):
            seen.setdefault((_name, body), (args, kwargs))
            return _orig(body, *args, **kwargs)

        setattr(module, name, record)
        undo.append((module, name, orig))
    try:
        fn()
    finally:
        for module, name, orig in reversed(undo):
            setattr(module, name, orig)
    return seen


def _replay(seen):
    """Each recorded call through the kernel and its plain version."""
    from nvalchemiops_torch.kernels import chunk_sweep as cs
    from nvalchemiops_torch.kernels import launch_counts
    from nvalchemiops_torch.kernels import row_sweep as rs
    from nvalchemiops_torch.kernels import stencil_sweep as st
    from nvalchemiops_torch.kernels import window_sweep as ws

    pairs = {"window_sweep": (ws.window_sweep, ws.window_sweep_plain),
             "row_sweep": (rs.row_sweep, rs.row_sweep_plain),
             "chunk_sweep": (cs.chunk_sweep, cs.chunk_sweep_plain),
             "stencil_sweep": (st.stencil_sweep, st.stencil_sweep_plain)}
    for (name, body), (args, kwargs) in seen.items():
        kern, plain = pairs[name]
        before = launch_counts[f"{name}_{body}"]
        out_k = kern(body, *args, **kwargs)
        assert launch_counts[f"{name}_{body}"] == before + 1
        out_p = plain(body, *args, **kwargs)
        torch.cuda.synchronize()
        if isinstance(out_k, torch.Tensor):
            out_k, out_p = (out_k,), (out_p,)
        for a, b in zip(out_k, out_p):
            for fa, fb in zip(a, b):            # per output plane
                _close(fa, fb)


def _grid_case(cuda, seed, zmax, n=3000, box=26.0, cutoff=5.0):
    from nvalchemiops_torch import grid

    rng = np.random.default_rng(seed)
    tab = _d3_tables(rng, zmax)
    pos = torch.as_tensor(rng.uniform(0, box, (n, 3)), dtype=torch.float32,
                          device=cuda)
    cell = torch.eye(3, device=cuda) * box
    numbers = rng.integers(1, zmax + 1, n).astype(np.int32)
    numbers[:7] = 0                             # padding atoms are parked
    q = torch.as_tensor(rng.normal(size=n), dtype=torch.float32, device=cuda)
    dims, radius, cap = grid.estimate_grid_geometry(cell, [True] * 3, cutoff,
                                                    n, 0.6)
    g = grid.build_atom_grid(pos, cell, [True] * 3, dims, radius, cap)
    return g, numbers, q, tab, cutoff


@pytest.mark.parametrize("zmax", [4, 16])
def test_zm_wide_kernels_match_plain(cuda, zmax):
    """Kernels 7 and 8 on every body (the super-chunk sweep at the card's
    G and at G = 1), at zm = 25 and zm = 85."""
    from nvalchemiops_torch import grid
    from nvalchemiops_torch.interactions.dispersion import grid_d3

    g, numbers, q, tab, cutoff = _grid_case(cuda, 11, zmax)

    def run():
        grid_d3.grid_dftd3(g, numbers, *tab, cutoff, 0.42, 4.1, 1.7,
                           engine="pallas")
        grid_d3.grid_dftd3(g, numbers, *tab, cutoff, 0.42, 4.1, 1.7,
                           engine="block")
        grid_d3.grid_dftd3_coulomb(g, numbers, q, *tab, cutoff, 0.42, 4.1,
                                   1.7, coulomb_cutoff=0.8 * cutoff,
                                   alpha=0.35)
        grid.grid_coulomb_energy_forces(g, q, cutoff, 0.35, engine="block")

    seen = _record([(grid_d3, "row_sweep"), (grid_d3, "chunk_sweep"),
                    (grid, "chunk_sweep")], run)
    assert sorted(seen) == sorted(
        [("row_sweep", b) for b in ("cn", "d3_direct", "chain")]
        + [("chunk_sweep", b) for b in ("cn", "d3_direct", "chain",
                                        "coulomb", "d3_direct_coulomb")])
    _replay(seen)
    args, kwargs = seen[("chunk_sweep", "d3_direct_coulomb")]
    _replay({("chunk_sweep", "d3_direct_coulomb"):
             (args[:4] + (1,) + args[5:], kwargs)})


def test_fused_window_body_matches_plain(cuda):
    """Kernel 1's fused D3 + Coulomb body, separate and combined."""
    from nvalchemiops_torch.interactions.dispersion import grid_d3

    g, numbers, q, tab, cutoff = _grid_case(cuda, 12, 4)
    for combine in (False, True):
        seen = _record([(grid_d3, "window_sweep")], lambda: (
            grid_d3.grid_dftd3_coulomb(
                g, numbers, q, *tab, cutoff, 0.42, 4.1, 1.7,
                coulomb_cutoff=0.8 * cutoff, alpha=0.35, engine="window",
                combine_forces=combine)))
        assert ("window_sweep", "d3_direct_coulomb") in seen
        _replay({k: v for k, v in seen.items()
                 if k[1] == "d3_direct_coulomb"})


def test_stencil_kernel_matches_plain(cuda):
    """Kernel 9 on its three bodies, on a jittered simple-cubic crystal,
    through the stencil functions and the hybrid D3 engine."""
    from nvalchemiops_torch import grid, stencil
    from nvalchemiops_torch.interactions.dispersion import grid_d3

    rng = np.random.default_rng(0)
    n_rep, a = 14, 3.0
    lat = np.stack(np.meshgrid(*([np.arange(n_rep)] * 3), indexing="ij"),
                   -1).reshape(-1, 3) * a
    pos = torch.as_tensor(lat + rng.uniform(-0.2, 0.2, lat.shape),
                          dtype=torch.float32, device=cuda)
    cell = torch.eye(3, device=cuda) * (n_rep * a)
    n = pos.shape[0]
    tab = _d3_tables(rng, 4)
    numbers = rng.integers(1, 5, n).astype(np.int32)
    q = torch.as_tensor(rng.normal(size=n), dtype=torch.float32, device=cuda)
    cutoff = 7.0
    sg = stencil.build_stencil_auto(pos, cell, [True] * 3, cutoff)
    assert sg is not None and int(sg.counts_max) == 1
    dims, radius, cap, origin = grid.choose_grid_geometry(pos, cell,
                                                          [True] * 3, cutoff)
    g = grid.build_atom_grid(pos, cell, [True] * 3, dims, radius, cap,
                             origin=origin)

    def run():
        stencil.stencil_coulomb_energy_forces(sg, q, cutoff, 0.35)
        grid_d3.grid_dftd3(g, numbers, *tab, cutoff, 0.42, 4.1, 1.7,
                           stencil=sg)

    seen = _record([(stencil, "stencil_sweep")], run)
    assert sorted(b for _, b in seen) == ["chain", "cn", "coulomb"]
    _replay(seen)


def _dense_calls(cuda, seed, b, n, cell, cutoff, dead=0, zmax=4):
    """The three dense sweep calls of ``batch_dense_dftd3`` on the card
    (``dead`` element-0 atoms at random places, padding to the tile;
    ``zmax`` elements in the tables)."""
    from nvalchemiops_torch.interactions.dispersion import dense_d3

    rng = np.random.default_rng(seed)
    tab = _d3_tables(rng, zmax)
    cell = torch.as_tensor(cell, dtype=torch.float32, device=cuda)
    frac = torch.as_tensor(rng.uniform(0, 1, (b, n, 3)), dtype=torch.float32,
                           device=cuda)
    pos = frac @ cell
    numbers = rng.integers(1, zmax + 1, (b, n)).astype(np.int32)
    if dead:
        numbers[:, rng.choice(n, dead, replace=False)] = 0
    seen = _record([(dense_d3, "dense_pairs")], lambda: (
        dense_d3.batch_dense_dftd3(pos, numbers, cell, cutoff, *tab, 0.42,
                                   4.1, 1.7)))
    assert sorted(body for _, body in seen) == ["chain", "cn", "direct"]
    return seen


_TRICLINIC = [[12.0, 0.0, 0.0], [3.0, 11.0, 0.0], [1.5, 2.0, 10.5]]


@pytest.mark.parametrize("seed,b,n,cell,cutoff,dead,zmax", [
    (21, 3, 300, np.eye(3) * 16.0, 5.0, 7, 4),     # padded tile, dead atoms
    (22, 2, 100, np.eye(3) * 30.0, 0.05, 0, 4),    # no pair in range
    (23, 2, 70, np.eye(3) * 4.0, 3.6, 3, 4),       # every pair, 8 combos
    (24, 2, 200, _TRICLINIC, 6.0, 2, 4),           # triclinic cell
    (25, 4, 2000, np.eye(3) * 41.2, 21.2, 0, 16),  # the 21.2 A batch shape
    (26, 4, 2000, np.eye(3) * 27.0, 9.0, 0, 16),   # the 9 A batch shape
    (27, 2, 300, np.eye(3) * 16.0, 5.0, 0, 80),    # i rows too wide to stage
], ids=["padded", "none-in-range", "all-in-range", "triclinic", "21.2A",
        "9A", "wide-rows"])
def test_distance_first_dense_kernel_matches_plain(cuda, seed, b, n, cell,
                                                   cutoff, dead, zmax):
    """Kernel 4 against its plain version, every body: the tile and combo
    cases of its distance test and queue, the batch shapes, and zm = 405,
    whose direct-body i rows do not fit in shared memory beside the block's
    other buffers (read through L1)."""
    from nvalchemiops_torch.kernels import dense_pairs as ds
    from nvalchemiops_torch.kernels import launch_counts

    seen = _dense_calls(cuda, seed, b, n, cell, cutoff, dead, zmax)
    if cutoff == 3.6:
        assert len(seen[("dense_pairs", "cn")][0][2]) == 8
    for (_, body), (args, kwargs) in seen.items():
        before = launch_counts[f"dense_pairs_{body}"]
        out_k = ds.dense_pairs(body, *args, **kwargs)
        assert launch_counts[f"dense_pairs_{body}"] == before + 1
        out_p = ds.dense_pairs_plain(body, *args, **kwargs)
        torch.cuda.synchronize()
        for a, p in zip(out_k, out_p):
            _close(a, p)
        if cutoff == 0.05:
            assert not out_k.any()


def _window_case(cuda, seed, n, box, cutoff, geometry=None,
                 half_empty=False, full_cell=False):
    """A random system on the card in a halo grid with no atom past a
    cell's capacity: atoms in half the box (empty cells), the cap equal to
    the largest occupancy (a full cell), or ``geometry = (dims, radius,
    cap)`` given (the cap raised to the occupancy where it is smaller)."""
    from nvalchemiops_torch import grid

    rng = np.random.default_rng(seed)
    tab = _d3_tables(rng)
    lo = rng.uniform(0, box, (n, 3))
    if half_empty:
        lo[:, 0] *= 0.5
    pos = torch.as_tensor(lo, dtype=torch.float32, device=cuda)
    cell = torch.eye(3, device=cuda) * box
    numbers = rng.integers(1, 5, n).astype(np.int32)
    q = torch.as_tensor(rng.normal(size=n), dtype=torch.float32, device=cuda)
    dims, radius, cap = geometry or grid.estimate_grid_geometry(
        cell, [True] * 3, cutoff, n, 0.6)
    probe = grid.build_atom_grid(pos, cell, [True] * 3, dims, radius, cap)
    most = int(probe.counts_max)
    cap = most if full_cell else max(cap, most)
    g = grid.build_atom_grid(pos, cell, [True] * 3, dims, radius, cap)
    return g, numbers, q, tab


@pytest.mark.parametrize("case", ["full cell, ccutoff below",
                                  "empty cells, ccutoff above",
                                  "staged window groups"])
def test_distance_first_window_kernel_matches_plain(cuda, case):
    """Kernel 1 against its plain version on every body it launches (CN,
    D3 direct, chain, Coulomb, the fused body separate and combined): a
    full cell, empty cells, a Coulomb cutoff below and above the D3
    cutoff, and windows too large for shared memory at once (radius 2,
    cap 64: the D3 bodies stage them in groups)."""
    from nvalchemiops_torch import grid
    from nvalchemiops_torch.interactions.dispersion import grid_d3
    from nvalchemiops_torch.kernels import window_sweep as ws

    if case.startswith("full"):
        cutoff, ccutoff = 5.0, 4.0
        g, numbers, q, tab = _window_case(cuda, 31, 3000, 26.0, cutoff,
                                          full_cell=True)
    elif case.startswith("empty"):
        cutoff, ccutoff = 4.0, 5.0
        g, numbers, q, tab = _window_case(cuda, 32, 2000, 26.0, ccutoff,
                                          half_empty=True)
    else:
        cutoff, ccutoff = 7.0, 6.0
        g, numbers, q, tab = _window_case(cuda, 33, 4000, 24.0, cutoff,
                                          geometry=((6, 6, 6), (2, 2, 2), 64))
        assert g.cap == 64 and g.radius == (2, 2, 2)
    n_cells = int(np.prod(g.dims))
    counts = torch.bincount(g.flat_slot.long() // g.cap,
                            minlength=n_cells)[:n_cells]
    if case.startswith("full"):
        assert int(counts.max()) == g.cap
    if case.startswith("empty"):
        assert int((counts == 0).sum()) > 0

    seen = {}

    def run():
        grid_d3.grid_dftd3(g, numbers, *tab, cutoff, 0.42, 4.1, 1.7)
        grid.grid_coulomb_energy_forces(g, q, cutoff, 0.35)
        for combine in (False, True):
            grid_d3.grid_dftd3_coulomb(
                g, numbers, q, *tab, cutoff, 0.42, 4.1, 1.7,
                coulomb_cutoff=ccutoff, alpha=0.35, engine="window",
                combine_forces=combine)

    def record(orig):
        def wrapper(body, *args, **kwargs):
            fused = body == "d3_direct_coulomb"
            seen.setdefault((body, fused and args[3].combine_forces),
                            (args, kwargs))
            return orig(body, *args, **kwargs)
        return wrapper

    undo = [(m, m.window_sweep) for m in (grid_d3, grid)]
    for m, orig in undo:
        m.window_sweep = record(orig)
    try:
        run()
    finally:
        for m, orig in undo:
            m.window_sweep = orig
    assert sorted(seen) == [("chain", False), ("cn", False),
                            ("coulomb", False), ("d3_direct", False),
                            ("d3_direct_coulomb", False),
                            ("d3_direct_coulomb", True)]
    for (body, _), (args, kwargs) in seen.items():
        out_k = ws.window_sweep(body, *args, **kwargs)
        out_p = ws.window_sweep_plain(body, *args, **kwargs)
        torch.cuda.synchronize()
        for a, b in zip(out_k, out_p):
            for fa, fb in zip(a, b):            # per output plane
                _close(fa, fb)


@pytest.mark.parametrize("order", [1, 2, 3, 4])
@pytest.mark.parametrize("tile,mesh", [(4, (8, 8, 16)), (8, (16, 16, 32)),
                                       (16, (32, 32, 64)),
                                       (8, (64, 64, 64))])
def test_band_gather_kernel_cases(cuda, tile, mesh, order):
    """Kernel 2 at W = 8, 12 and 20, orders 1-4: few tiles (a tile's slots
    split over several blocks) and 512 tiles (whole tiles a block), padded
    and empty slots, the upper z tiles empty, atoms on mesh points; for
    order 4 also synthetic rows with bands at the window's edges, wider
    than four columns and dense.  Against the plain version; two launches
    give equal bits."""
    from nvalchemiops_torch import spline_windowed
    from nvalchemiops_torch.kernels import launch_counts
    from nvalchemiops_torch.kernels import windowed_gather as wg

    rng = np.random.default_rng(40 + tile + order)
    box, n = 9.0, 4 * int(np.prod(mesh)) // tile ** 2
    pos = rng.uniform(0.0, box, (n, 3))
    pos[:n // 8] = rng.integers(0, mesh[0], (n // 8, 3)) * (
        box / np.array(mesh))
    pos[:, 2] *= 0.6
    cell = torch.eye(3, device=cuda) * box
    pos_t = torch.as_tensor(pos, dtype=torch.float32, device=cuda)
    probe = spline_windowed.build_mesh_tiles(pos_t, cell, mesh, order, cap=8,
                                             tile=tile)
    cap = int(probe.counts_max) + 5
    tiles = spline_windowed.build_mesh_tiles(pos_t, cell, mesh, order,
                                             cap=cap, tile=tile)
    w = tiles.w_win
    smat = tiles.smat.clone()
    if order == 4:
        rows = smat.view(smat.shape[0], cap, 6, w)
        vals = torch.as_tensor(rng.uniform(0.1, 1.0, (6, w)),
                               dtype=torch.float32, device=cuda)
        rows[0, 0] = 0.0
        rows[0, 0, :, w - 2:] = vals[:, :2]          # band at the right edge
        rows[0, 1] = 0.0
        rows[0, 1, :, :3] = vals[:, :3]              # and at the left
        rows[1, 0] = 0.0
        rows[1, 0, :, 1:7] = vals[:, 1:7]            # six columns wide
        rows[1, 1] = vals - 0.5                      # dense
    win = torch.as_tensor(rng.normal(size=(smat.shape[0], w, w * w)),
                          dtype=torch.float32, device=cuda)
    assert bool((smat == 0).all(-1).any())           # empty slots
    before = launch_counts["windowed_gather_grad"]
    got = wg.gather_grad_planes(smat, win, w)
    again = wg.gather_grad_planes(smat, win, w)
    assert launch_counts["windowed_gather_grad"] == before + 2
    want = wg.gather_grad_planes_plain(smat, win, w)
    torch.cuda.synchronize()
    for a, b, p in zip(got, again, want):
        _close(a, p)
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["full cell, ccutoff below",
                                  "empty cells, ccutoff above",
                                  "G = 1 and one chunk a row"])
def test_distance_first_chunk_kernel_matches_plain(cuda, case):
    """Kernel 8 against its plain version on its five bodies (CN, D3
    direct, chain, the fused body, Coulomb): a full cell, empty cells, a
    Coulomb cutoff below and above the D3 cutoff, G above 1 (the card's
    pick), G = 1 and G = cx."""
    from nvalchemiops_torch import grid
    from nvalchemiops_torch.interactions.dispersion import grid_d3

    if case.startswith("empty"):
        cutoff, ccutoff = 4.0, 5.0
        g, numbers, q, tab = _window_case(cuda, 36, 2000, 26.0, ccutoff,
                                          half_empty=True)
    else:
        cutoff, ccutoff = 5.0, 4.0
        g, numbers, q, tab = _window_case(cuda, 35, 3000, 26.0, cutoff,
                                          full_cell=True)

    def run():
        grid_d3.grid_dftd3(g, numbers, *tab, cutoff, 0.42, 4.1, 1.7,
                           engine="block")
        grid_d3.grid_dftd3_coulomb(g, numbers, q, *tab, cutoff, 0.42, 4.1,
                                   1.7, coulomb_cutoff=ccutoff, alpha=0.35)
        grid.grid_coulomb_energy_forces(g, q, cutoff, 0.35, engine="block")

    seen = _record([(grid_d3, "chunk_sweep"), (grid, "chunk_sweep")], run)
    assert sorted(seen) == [("chunk_sweep", b) for b in (
        "chain", "cn", "coulomb", "d3_direct", "d3_direct_coulomb")]
    if case.startswith("full"):
        assert max(args[4] for args, _ in seen.values()) > 1
    if not case.startswith("G"):
        _replay(seen)
        return
    for width in (1, g.dims[2]):
        _replay({k: (args[:4] + (width,) + args[5:], kwargs)
                 for k, (args, kwargs) in seen.items()})


@pytest.mark.parametrize("case", ["full cell", "empty cells",
                                  "zmax-16 tables in groups", "main path"])
def test_row_kernel_matches_plain(cuda, case):
    """Kernel 7 against its plain version on its three bodies: a full cell,
    empty cells (parked own slots skipped), zmax-16 tables (zm = 85) whose
    rows are staged in groups of cells, and the 109,744-atom main path
    (16 cells a row, cap 40, zm = 15: whole rows staged)."""
    from nvalchemiops_torch import composite, grid
    from nvalchemiops_torch.interactions.dispersion import grid_d3
    from nvalchemiops_torch.kernels import row_sweep as rs

    if case == "main path":
        (pos, cell, numbers, _, rcov, r4r2, cna,
         c6) = composite.build_system(38)
        numbers, *tab = grid_d3.compact_d3_elements(numbers, rcov, r4r2, c6,
                                                    cna)
        pos = torch.as_tensor(pos, dtype=torch.float32, device=cuda)
        cell = torch.as_tensor(cell, dtype=torch.float32, device=cuda)
        cutoff = composite.CUTOFF
        dims, radius, cap, origin = grid.choose_grid_geometry(
            pos, cell, np.array([True] * 3), cutoff)
        g = grid.build_atom_grid(pos, cell, [True] * 3, dims, radius, cap,
                                 origin=origin)
        assert g.dims == (16, 16, 16) and g.cap == 40
        params = (composite.D3_A1, composite.D3_A2, composite.D3_S8)
    elif case.startswith("zmax"):
        g, numbers, _, tab, cutoff = _grid_case(cuda, 14, 16)
        params = (0.42, 4.1, 1.7)
    else:
        cutoff = 5.0
        g, numbers, _, tab = _window_case(
            cuda, 37 if case == "full cell" else 38, 3000, 26.0, cutoff,
            full_cell=case == "full cell", half_empty=case == "empty cells")
        params = (0.42, 4.1, 1.7)
    seen = _record([(grid_d3, "row_sweep")], lambda: grid_d3.grid_dftd3(
        g, numbers, *tab, cutoff, *params, engine="pallas"))
    assert sorted(seen) == [("row_sweep", b)
                            for b in ("chain", "cn", "d3_direct")]
    assert rs.skips_parked(g.dims, g.radius)
    args, kwargs = seen[("row_sweep", "d3_direct")]
    nf = kwargs["lf"].shape[-1]
    g_cells = rs.row_group_cells("d3_direct", g.dims[2], g.cap, g.radius[2],
                                 nf)
    if case.startswith("zmax"):
        assert nf == 170 and g_cells < g.dims[2]
    if case == "main path":
        assert g_cells == g.dims[2]
    _replay(seen)


@pytest.mark.parametrize("counts,radius,cutoff", [
    ((7, 5, 7), (1, 1, 1), 2.9), ((9, 8, 11), (3, 3, 3), 8.5)])
def test_stencil_kernel_segments_match_plain(cuda, counts, radius, cutoff):
    """Kernel 9 on its three bodies against its plain version, with Cz not
    a multiple of the segment (a ragged last segment) at radius 1 and 3;
    two launches give equal bits."""
    from nvalchemiops_torch import stencil
    from nvalchemiops_torch.kernels import stencil_sweep as st

    rng = np.random.default_rng(sum(counts))
    nx, ny, nz = counts
    lat = np.stack(np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                               indexing="ij"), -1).reshape(-1, 3)
    pos = torch.as_tensor((lat + 0.5) * 3.0
                          + rng.uniform(-0.2, 0.2, lat.shape),
                          dtype=torch.float32, device=cuda)
    cell = torch.diag(torch.tensor([nx * 3.0, ny * 3.0, nz * 3.0],
                                   device=cuda))
    sg = stencil.build_stencil_grid(pos, cell, [True] * 3, (nz, ny, nx),
                                    radius)
    assert int(sg.counts_max) == 1
    assert all(nz % segment for segment, _ in st.PLAN.values())
    n = pos.shape[0]
    rcov, decn, q = (torch.as_tensor(v, dtype=torch.float32, device=cuda)
                     for v in (rng.uniform(0.6, 1.4, n), rng.normal(size=n),
                               rng.normal(size=n)))

    def run():
        stencil.stencil_coordination_numbers(sg, rcov, cutoff)
        stencil.stencil_cn_chain_forces(sg, rcov, decn, cutoff)
        stencil.stencil_coulomb_energy_forces(sg, q, cutoff, 0.35)

    seen = _record([(stencil, "stencil_sweep")], run)
    assert sorted(b for _, b in seen) == ["chain", "cn", "coulomb"]
    _replay(seen)
    for (_, body), (args, kwargs) in seen.items():
        first = st.stencil_sweep(body, *args, **kwargs)
        second = st.stencil_sweep(body, *args, **kwargs)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


def _crystal(n_rep, seed=5, a=3.0, jitter=0.1):
    """Simple-cubic crystal jittered by +-``jitter``: at a 3.6 A cutoff no
    pair lies within 0.25 A of it (shells at 3.0 and 4.24 A)."""
    rng = np.random.default_rng(seed)
    pts = np.stack(np.meshgrid(*([np.arange(n_rep)] * 3), indexing="ij"),
                   -1).reshape(-1, 3) * a
    pos = pts + rng.uniform(-jitter, jitter, pts.shape)
    return pos, np.eye(3) * n_rep * a


def _row_keys(nm, sh, fill):
    code = ((sh[..., 0] + 1) * 9 + (sh[..., 1] + 1) * 3 + sh[..., 2] + 1)
    keys = torch.where(nm != fill, nm.long() * 27 + code.long(),
                       torch.full((), 2 ** 62, device=nm.device))
    return keys.sort(dim=1).values.cpu()


@pytest.mark.parametrize("method", ["naive", "cell_list", "batch_naive",
                                    "batch_cell_list"])
@pytest.mark.parametrize("half_fill", [False, True])
def test_neighbor_lists_on_card_match_cpu(cuda, method, half_fill):
    """Neighbor rows (as sets) and counts on the card equal the same entry
    point's on CPU tensors, f64, no pair near the cutoff."""
    from nvalchemiops_torch.neighborlist import neighbor_list

    pos, cell = _crystal(6)
    n = pos.shape[0]
    kw = dict(method=method, half_fill=half_fill, max_neighbors=32,
              pbc=np.array([True] * 3))
    if method.startswith("batch"):
        pos = np.concatenate([pos, pos[::-1] + 0.05])
        cell = np.stack([cell, cell])
        kw["batch_idx"] = torch.arange(2).repeat_interleave(n)
        kw["pbc"] = np.array([[True] * 3] * 2)
    outs = []
    for dev in ("cpu", cuda):
        args = dict(kw)
        if "batch_idx" in args:
            args["batch_idx"] = args["batch_idx"].to(dev)
        nm, num, sh = neighbor_list(
            torch.as_tensor(pos, device=dev), 3.6,
            cell=torch.as_tensor(cell, device=dev), **args)
        assert nm.device.type == torch.device(dev).type
        outs.append((num.cpu(), _row_keys(nm, sh, pos.shape[0])))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    # 6 neighbors each within 3.6 A; half_fill keeps each pair once
    assert int(outs[0][0].sum()) == (3 if half_fill else 6) * pos.shape[0]


def _elec_inputs(device, dtype=torch.float64):
    from nvalchemiops_torch.neighborlist import neighbor_list

    rng = np.random.default_rng(8)
    pos, cell = _crystal(6, seed=8)
    q = rng.normal(size=pos.shape[0])
    q -= q.mean()
    t = [torch.as_tensor(a, dtype=dtype, device=device)
         for a in (pos, q, cell)]
    nm, num, sh = neighbor_list(t[0], 6.0, cell=t[2],
                                pbc=np.array([True] * 3), max_neighbors=128)
    lst = neighbor_list(t[0], 6.0, cell=t[2], pbc=np.array([True] * 3),
                        max_neighbors=128, return_neighbor_list=True)
    return t, dict(neighbor_matrix=nm, neighbor_matrix_shifts=sh), dict(
        neighbor_list=lst[0], neighbor_ptr=lst[1], neighbor_shifts=lst[2])


def _close_cpu(out, ref, rtol=1e-5):
    out = out if isinstance(out, tuple) else (out,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(out) == len(ref)
    for a, b in zip(out, ref):
        assert a.device.type == "cuda"
        a, b = a.double().cpu(), b.double().cpu()
        err = (a - b).abs().max().item()
        assert err <= rtol * b.abs().max().item(), (err, b.abs().max())


@pytest.mark.parametrize("entry", ["coulomb_matrix", "coulomb_list",
                                   "ewald_summation", "particle_mesh_ewald",
                                   "pme_batch_idx"])
def test_electrostatics_on_card_match_cpu(cuda, entry):
    """Coulomb, Ewald and PME energies and forces on the card against the
    same entry point on CPU tensors, f64, at 1e-5 of scale; the
    single-system PME runs its f32 kernels on the card (the kernels take
    f32 only) against f64 on the CPU."""
    from nvalchemiops_torch.interactions import electrostatics as te

    def run(device, dtype=torch.float64):
        (pos, q, cell), matrix, listed = _elec_inputs(device, dtype)
        if entry == "coulomb_matrix":
            return te.coulomb_energy_forces(pos, q, cell, 6.0, 0.3, **matrix)
        if entry == "coulomb_list":
            return te.coulomb_energy_forces(pos, q, cell, 6.0, 0.0, **listed)
        if entry == "ewald_summation":
            return te.ewald_summation(pos, q, cell, **matrix,
                                      compute_forces=True, accuracy=1e-5)
        if entry == "particle_mesh_ewald":
            return te.particle_mesh_ewald(pos, q, cell, 0.4,
                                          mesh_dimensions=(32, 32, 32),
                                          **matrix, compute_forces=True)
        n = pos.shape[0]
        bidx = torch.arange(n, device=device) * 2 // n
        cells = torch.stack([cell, cell])
        return te.pme_reciprocal_space(pos, q, cells, 0.4, (32, 32, 32),
                                       batch_idx=bidx, compute_forces=True)

    ref = run("cpu")
    if entry == "particle_mesh_ewald":
        _close_cpu(run(cuda, torch.float32), ref)
    else:
        _close_cpu(run(cuda), ref)


def _route_inputs(route, device, dtype):
    """One system the windows take, one crowding a tile past its capacity,
    one on a mesh the windows reject, three concatenated systems; with
    channel values ``[N, 3]``, charges, channel and vector meshes."""
    rng = np.random.default_rng(70)
    cell = np.eye(3) * 10.0
    cell[0, 1], cell[1, 2] = 0.5, -0.3
    mesh, bidx, n_sys = (16, 16, 16), None, 1
    if route == "overflow":
        pos = rng.uniform(0.5, 4.5, (60, 3))
        cell = np.eye(3) * 10.0
    elif route == "batch_idx":
        cell = np.stack([cell * s for s in (0.9, 1.0, 1.1)])
        pos = np.concatenate([rng.uniform(0, 1, (30, 3)) @ c for c in cell])
        bidx = torch.arange(90, device=device) // 30
        n_sys = 3
    else:
        pos = rng.uniform(0, 1, (100, 3)) @ cell
        if route == "rejected":
            mesh = (15, 16, 16)
    n = pos.shape[0]
    lead = (n_sys,) if bidx is not None else ()

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return (t(pos), t(cell), bidx, mesh, t(rng.normal(size=(n, 3))),
            t(rng.normal(size=n)), t(rng.normal(size=lead + (3,) + mesh)),
            t(rng.normal(size=lead + mesh + (3,))))


@pytest.mark.parametrize("route", ["windowed", "overflow", "rejected",
                                   "batch_idx"])
def test_channel_api_on_card_matches_cpu(cuda, route):
    """Channel spread, channel gather and vector gather in f32 on the card
    (kernel 3 on the windowed route, kernels 5 and 6 on the dense one)
    against f64 on CPU tensors at 1e-5 of scale; each channel equals its
    single-channel call bit for bit where a kernel spreads it (in a fixed
    order), and within 1e-6 of scale on the ``batch_idx`` route, whose
    ``index_add_`` adds on the card in a run-dependent order."""
    from nvalchemiops_torch import spline
    from nvalchemiops_torch.kernels import launch_counts, reset_launch_counts

    def run(device, dtype):
        pos, cell, bidx, mesh, vals, q, cmesh, vmesh = _route_inputs(
            route, device, dtype)
        if bidx is not None and device == "cpu":
            bidx = bidx.cpu()
        return (spline.spline_spread_channels(pos, vals, cell, mesh, 4, bidx),
                spline.spline_gather_channels(pos, cmesh, cell, 4, bidx),
                spline.spline_gather_vec3(pos, q, vmesh, cell, 4, bidx))

    reset_launch_counts()
    out = run(cuda, torch.float32)
    torch.cuda.synchronize()
    want = {"windowed": ["windowed_spread"],
            "overflow": ["separable_spread", "separable_gather"],
            "rejected": ["separable_spread", "separable_gather"],
            "batch_idx": []}[route]
    assert all(launch_counts[k] >= 3 for k in want), launch_counts
    _close_cpu(out, run("cpu", torch.float64))
    pos, cell, bidx, mesh, vals, q, cmesh, vmesh = _route_inputs(
        route, cuda, torch.float32)
    cax = 1 if bidx is not None else 0
    for c in range(3):
        one = spline.spline_spread(pos, vals[:, c].contiguous(), cell, mesh,
                                   4, bidx)
        if bidx is None:
            assert torch.equal(out[0].select(cax, c), one)
        else:
            err = (out[0].select(cax, c) - one).abs().max().item()
            assert err <= 1e-6 * one.abs().max().item(), err
        assert torch.equal(out[1][:, c], spline.spline_gather(
            pos, cmesh.select(cax, c), cell, 4, bidx))


def test_refreshed_tiles_equal_a_fresh_build_on_card(cuda):
    """After a move that keeps every atom in its tile the detector reads
    False (a 0-d bool on the card), and the refreshed tiles, their spread
    and their gather equal a fresh build's bit for bit; a tile crossing
    reads True."""
    from nvalchemiops_torch import spline_windowed as sw

    rng = np.random.default_rng(71)
    box, mesh = 12.0, (16, 16, 16)
    pos = torch.as_tensor(rng.uniform(0, box, (400, 3)), dtype=torch.float32,
                          device=cuda)
    cell = torch.eye(3, device=cuda) * box
    cap = sw.mesh_tile_capacity(400, mesh)
    tiles = sw.build_mesh_tiles(pos, cell, mesh, 4, cap)
    inside = (pos * mesh[0] / box) % 8.0
    safe = ((inside > 0.2) & (inside < 7.3)).all(dim=1, keepdim=True)
    pos2 = pos + torch.where(safe, 1e-3, 0.0)
    flag = sw.mesh_tiles_need_rebuild(tiles, pos2)
    assert flag.device.type == "cuda" and flag.dim() == 0
    assert not bool(flag)
    refreshed = sw.refresh_mesh_tiles(tiles, pos2)
    fresh = sw.build_mesh_tiles(pos2, cell, mesh, 4, cap)
    for f in ("smat", "flat_slot", "aid"):
        assert torch.equal(getattr(refreshed, f), getattr(fresh, f)), f
    q = torch.as_tensor(rng.normal(size=400), dtype=torch.float32,
                        device=cuda)
    phi = torch.as_tensor(rng.normal(size=mesh), dtype=torch.float32,
                          device=cuda)
    assert torch.equal(sw.windowed_spread(refreshed, q),
                       sw.windowed_spread(fresh, q))
    for a, b in zip(sw.windowed_gather(refreshed, phi, True),
                    sw.windowed_gather(fresh, phi, True)):
        assert torch.equal(a, b)
    pos3 = pos.clone()
    pos3[7] = (pos3[7] + box / 2.0) % box
    assert bool(sw.mesh_tiles_need_rebuild(tiles, pos3))


@pytest.mark.parametrize("engine", ["dense", "windowed"])
def test_matmul_fft_mode_on_card_matches_torch_fft(cuda, engine):
    """``batch_pme_reciprocal(fft_mode="matmul")`` against ``"xla"`` on the
    card in f32 (TF32 off), and against f64 on CPU tensors."""
    from nvalchemiops_torch.interactions.electrostatics import pme

    rng = np.random.default_rng(72)
    pos = rng.uniform(0, 16.0, (4, 300, 3))
    q = rng.normal(size=(4, 300))

    def run(device, dtype, mode):
        return pme.batch_pme_reciprocal(
            torch.as_tensor(pos, dtype=dtype, device=device),
            torch.as_tensor(q, dtype=dtype, device=device),
            torch.eye(3, dtype=dtype, device=device) * 16.0, 0.35,
            (32, 32, 32), 4, True, None, mode, engine=engine)

    mm = run(cuda, torch.float32, "matmul")
    _close_cpu(mm, run(cuda, torch.float32, "xla"))
    _close_cpu(mm, run("cpu", torch.float64, "xla"))


@pytest.mark.parametrize("api", ["global", "per-backend"])
def test_matmul_dft_keeps_full_f32_with_tf32_on(cuda, api):
    """TF32 turned on by the caller: ``matmul_rfft_convolve`` and
    ``fft_mode="matmul"`` still meet the f32 bar against f64, and the
    caller's setting is back afterwards."""
    from nvalchemiops_torch.interactions.electrostatics import pme
    from nvalchemiops_torch.mathops.matmul_dft import matmul_rfft_convolve

    rng = np.random.default_rng(74)
    mesh = rng.normal(size=(2, 32, 24, 20))
    kern = rng.uniform(0.5, 1.5, size=(32, 24, 11))
    pos = rng.uniform(0, 16.0, (2, 300, 3))
    q = rng.normal(size=(2, 300))

    def conv(device, dtype):
        return matmul_rfft_convolve(
            torch.as_tensor(mesh, dtype=dtype, device=device),
            torch.as_tensor(kern, dtype=dtype, device=device))

    def pme_mm(device, dtype, mode):
        return pme.batch_pme_reciprocal(
            torch.as_tensor(pos, dtype=dtype, device=device),
            torch.as_tensor(q, dtype=dtype, device=device),
            torch.eye(3, dtype=dtype, device=device) * 16.0, 0.35,
            (32, 32, 32), 4, True, None, mode, engine="dense")

    matmul = torch.backends.cuda.matmul
    if api == "per-backend" and not hasattr(matmul, "fp32_precision"):
        pytest.skip("this torch has no per-backend fp32_precision setting")
    ref_conv = conv("cpu", torch.float64)
    ref_pme = pme_mm("cpu", torch.float64, "xla")
    if api == "global":
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("high")
    else:
        prev = matmul.fp32_precision
        matmul.fp32_precision = "tf32"
    try:
        _close_cpu(conv(cuda, torch.float32), ref_conv)
        _close_cpu(pme_mm(cuda, torch.float32, "matmul"), ref_pme)
        if api == "global":
            assert torch.get_float32_matmul_precision() == "high"
        else:
            assert matmul.fp32_precision == "tf32"
    finally:
        if api == "global":
            torch.set_float32_matmul_precision(prev)
        else:
            matmul.fp32_precision = prev
        torch.backends.cuda.matmul.allow_tf32 = False


def test_host_inputs_run_on_the_card(cuda):
    """Entry points given numpy inputs only place them on the card (the D3
    tables are numpy) and agree with the call on CPU tensors."""
    from nvalchemiops_torch import spline
    from nvalchemiops_torch.interactions.dispersion.dense_d3 import (
        element_rows,
    )
    from nvalchemiops_torch.mathops import safe_divide

    rng = np.random.default_rng(75)
    numbers = rng.integers(0, 10, 40).astype(np.int32)
    table = rng.normal(size=(10, 5, 5, 3))
    num, den = rng.normal(size=64), rng.normal(size=64)
    den[:3] = 0.0
    idx = rng.integers(-40, 40, (20, 3)).astype(np.int32)
    for got, want in (
            (element_rows(numbers, table),
             element_rows(torch.as_tensor(numbers), torch.as_tensor(table))),
            (safe_divide(num, den),
             safe_divide(torch.as_tensor(num), torch.as_tensor(den))),
            (spline.wrap_grid_index(idx, 16),
             spline.wrap_grid_index(torch.as_tensor(idx), 16))):
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("alpha", [0.0, 0.35])
def test_dense_coulomb_on_card_matches_list_coulomb(cuda, alpha,
                                                    monkeypatch):
    """The batched dense Coulomb on the card in f64, in passes of a few
    rows and in one, against the list Coulomb on the card's neighbor
    matrix (the erfc polynomial's 1.5e-7 against the exact erfc where
    damped)."""
    from nvalchemiops_torch.interactions.electrostatics import (
        batch_dense_coulomb_energy_forces, coulomb_energy_forces, dense,
    )
    from nvalchemiops_torch.neighborlist import neighbor_list

    rng = np.random.default_rng(73)
    b, n, box, cutoff = 3, 200, 14.0, 6.0
    pos = torch.as_tensor(rng.uniform(0, box, (b, n, 3)), device=cuda)
    q = torch.as_tensor(rng.normal(size=(b, n)), device=cuda)
    cell = torch.eye(3, dtype=torch.float64, device=cuda) * box
    whole = batch_dense_coulomb_energy_forces(pos, q, cell, cutoff, alpha)
    monkeypatch.setattr(dense, "DENSE_PAIR_CHUNK", 17 * n)
    rows = batch_dense_coulomb_energy_forces(pos, q, cell, cutoff, alpha)
    for a, c in zip(whole, rows):
        assert torch.equal(a, c)
    for s in range(b):
        nm, _, sh = neighbor_list(pos[s], cutoff, cell=cell,
                                  pbc=torch.tensor([True] * 3),
                                  max_neighbors=256)
        ref = coulomb_energy_forces(pos[s], q[s], cell, cutoff, alpha,
                                    neighbor_matrix=nm,
                                    neighbor_matrix_shifts=sh)
        _close_cpu((whole[0][s], whole[1][s]), ref,
                   rtol=1e-10 if alpha == 0.0 else 2e-6)


def _dftd3_inputs(device, fmt):
    """Two triclinic systems (one padding atom) with per-system cells, the
    port's batched naive neighbour list built on the CPU in f64, in
    ``fmt``."""
    from nvalchemiops_torch.neighborlist import (
        get_neighbor_list_from_neighbor_matrix, neighbor_list,
    )

    rng = np.random.default_rng(77)
    cells = np.stack([np.eye(3) * 8.0 + rng.uniform(-0.5, 0.5, (3, 3))
                      for _ in range(2)])
    pos = np.concatenate([rng.uniform(0, 1, (40, 3)) @ c for c in cells])
    numbers = rng.integers(1, 5, 80).astype(np.int32)
    numbers[5] = 0
    bidx = np.repeat(np.arange(2), 40).astype(np.int32)
    nm, num, sh = neighbor_list(
        torch.as_tensor(pos), 6.0, cell=torch.as_tensor(cells),
        pbc=np.array([[True] * 3] * 2), batch_idx=torch.as_tensor(bidx),
        max_neighbors=128, method="batch_naive")
    kw = dict(neighbor_matrix=nm, neighbor_matrix_shifts=sh)
    if fmt == "list":
        nl, ptr, us = get_neighbor_list_from_neighbor_matrix(
            nm, num, sh, fill_value=80)
        kw = dict(neighbor_list=nl, neighbor_ptr=ptr, unit_shifts=us)
    kw = {k: v.to(device) for k, v in kw.items()}
    t = {k: torch.as_tensor(v, device=device) for k, v in
         (("positions", pos), ("numbers", numbers), ("batch_idx", bidx),
          ("cell", cells))}
    rcov, r4r2, c6, cna = _d3_tables(rng)
    cn_ref = np.broadcast_to(cna[:, None, :, None],
                             c6.shape[:2] + (5, 5)).copy()
    return t, kw, (rcov, r4r2, c6, cn_ref)


@pytest.mark.parametrize("fmt", ["matrix", "list"])
def test_dftd3_on_card_matches_cpu(cuda, fmt):
    """``dftd3`` (plain torch) on the card against the same call on CPU
    tensors, f64, with ``batch_idx``, per-system cells and the virial, at
    1e-10 of scale."""
    from nvalchemiops_torch.interactions.dispersion import dftd3

    def run(device):
        t, kw, (rcov, r4r2, c6, cn_ref) = _dftd3_inputs(device, fmt)
        return dftd3(t["positions"], t["numbers"], 0.42, 4.1, 1.7,
                     covalent_radii=rcov, r4r2=r4r2, c6_reference=c6,
                     coord_num_ref=cn_ref, batch_idx=t["batch_idx"],
                     cell=t["cell"], compute_virial=True, output_dtype=None,
                     **kw)

    _close_cpu(run(cuda), run("cpu"), rtol=1e-10)


def test_window_virial_on_card_matches_cpu(cuda):
    """``grid_dftd3(compute_virial=True)``: kernel 1 on the card against
    the plain path on the CPU, both f32 (energy, forces, virial), at the
    bar of a kernel against its plain version, 1e-5 of scale."""
    from nvalchemiops_torch.grid import build_atom_grid, estimate_grid_geometry
    from nvalchemiops_torch.interactions.dispersion import grid_dftd3

    rng = np.random.default_rng(78)
    cell = np.array([[11.0, 0.0, 0.0], [2.0, 10.5, 0.0], [1.0, -1.5, 11.5]])
    pos = rng.uniform(0, 1, (150, 3)) @ cell
    numbers = rng.integers(1, 5, 150).astype(np.int32)
    rcov, r4r2, c6, cna = _d3_tables(rng)
    pbc = np.array([True] * 3)
    dims, radius, cap = estimate_grid_geometry(cell, pbc, 3.4, 150, 0.4)

    def run(device, dtype):
        g = build_atom_grid(torch.as_tensor(pos, dtype=dtype, device=device),
                            torch.as_tensor(cell, dtype=dtype, device=device),
                            pbc, dims, radius, cap)
        return grid_dftd3(g, numbers, rcov, r4r2, c6, cna, 3.4, 0.42, 4.1,
                          1.7, compute_virial=True, cell=cell)

    out = run(cuda, torch.float32)
    ref = run("cpu", torch.float32)
    for i in (0, 1, 3):
        _close_cpu((out[i],), (ref[i],), rtol=1e-5)


def test_dftd3_host_inputs_run_on_the_card(cuda):
    """``dftd3`` and ``D3Parameters`` given numpy inputs only place them on
    the card and agree with the call on CPU tensors."""
    from nvalchemiops_torch.interactions.dispersion import D3Parameters, dftd3

    t, kw, tables = _dftd3_inputs("cpu", "matrix")
    params = D3Parameters(*tables)
    assert params.c6ab.device.type == "cuda"
    got = dftd3(t["positions"].numpy(), t["numbers"].numpy(), 0.42, 4.1, 1.7,
                d3_params=params, batch_idx=t["batch_idx"].numpy(),
                cell=t["cell"].numpy(), output_dtype=None,
                **{k: v.numpy() for k, v in kw.items()})
    want = dftd3(t["positions"], t["numbers"], 0.42, 4.1, 1.7,
                 d3_params=D3Parameters(*tables, device="cpu"),
                 batch_idx=t["batch_idx"], cell=t["cell"], output_dtype=None,
                 **kw)
    _close_cpu(got, want, rtol=1e-10)


def _xla_case(device, dtype):
    """150 atoms (every ninth a padding atom) in an 11 A cube with charges,
    on a grid for 3.4 A, and a 6^3 jittered crystal on its voxel stencil
    for 4.5 A: the inputs of the ``engine="xla"`` calls."""
    from nvalchemiops_torch import grid, stencil

    rng = np.random.default_rng(79)
    cell = np.eye(3) * 11.0
    pos = rng.uniform(0, 11.0, (150, 3))
    numbers = rng.integers(1, 5, 150).astype(np.int32)
    numbers[::9] = 0
    q = rng.normal(size=150)
    tab = _d3_tables(rng)
    pbc = np.array([True] * 3)
    dims, radius, cap = grid.estimate_grid_geometry(cell, pbc, 3.4, 150, 0.4)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    g = grid.build_atom_grid(t(pos), t(cell), pbc, dims, radius, cap)
    lat = np.stack(np.meshgrid(*([np.arange(6)] * 3), indexing="ij"),
                   -1).reshape(-1, 3) * 3.0
    sg = stencil.build_stencil_auto(
        t(lat + rng.uniform(-0.2, 0.2, lat.shape)), t(np.eye(3) * 18.0),
        [True] * 3, 4.5)
    return dict(g=g, sg=sg, numbers=numbers, q=t(q), tab=tab, cell=cell,
                pos=t(pos), q_s=t(rng.normal(size=216)),
                rcov=t(rng.uniform(0.8, 1.4, 216)),
                decn=t(rng.normal(size=216)))


def _xla_calls(c):
    """Every ``engine="xla"`` entry point once, the virial with no cell,
    and the grid's neighbour counts: name -> zero-argument call."""
    from nvalchemiops_torch import grid, stencil
    from nvalchemiops_torch.interactions.dispersion import dense_d3, grid_d3

    d3 = (*c["tab"], 3.4, 0.42, 4.1, 1.7)
    pos_b = c["pos"][:144].reshape(4, 36, 3) * (8.0 / 11.0)
    num_b = c["numbers"][:144].reshape(4, 36)
    return {
        "grid_dftd3 virial": lambda: grid_d3.grid_dftd3(
            c["g"], c["numbers"], *d3, engine="xla", compute_virial=True),
        "grid coulomb": lambda: grid.grid_coulomb_energy_forces(
            c["g"], c["q"], 3.4, 0.35, engine="xla"),
        "fused": lambda: grid_d3.grid_dftd3_coulomb(
            c["g"], c["numbers"], c["q"], *d3, coulomb_cutoff=2.9,
            alpha=0.3, engine="xla")[:4],
        "batch grid": lambda: grid_d3.batch_grid_dftd3(
            pos_b, num_b, np.eye(3) * 8.0, [True] * 3, 3.4, *c["tab"], 0.42,
            4.1, 1.7, engine="xla"),
        "batch dense": lambda: dense_d3.batch_dense_dftd3(
            pos_b, num_b, np.eye(3) * 8.0, 5.0, *c["tab"], 0.42, 4.1, 1.7,
            system_chunk=2, engine="xla"),
        "neighbor count": lambda: grid.grid_neighbor_count(c["g"], 3.4, 150),
        "stencil": lambda: (
            stencil.stencil_coulomb_energy_forces(c["sg"], c["q_s"], 4.5,
                                                  0.35, engine="xla")
            + (stencil.stencil_coordination_numbers(
                c["sg"], c["rcov"], 4.5, engine="xla"),
               stencil.stencil_cn_chain_forces(
                   c["sg"], c["rcov"], c["decn"], 4.5, engine="xla"))),
    }


#: the kernels each ``engine="xla"`` call launches on the card
XLA_ROUTES = {
    "grid_dftd3 virial": ("window_sweep_cn", "window_sweep_d3_direct",
                          "window_sweep_chain"),
    "grid coulomb": ("window_sweep_coulomb",),
    "fused": ("window_sweep_cn", "window_sweep_d3_direct_coulomb",
              "window_sweep_chain"),
    "batch grid": ("window_sweep_cn", "window_sweep_d3_direct",
                   "window_sweep_chain"),
    "batch dense": ("dense_pairs_cn", "dense_pairs_direct",
                    "dense_pairs_chain"),
    "neighbor count": (),
    "stencil": ("stencil_sweep_coulomb", "stencil_sweep_cn",
                "stencil_sweep_chain"),
}


@pytest.mark.parametrize("name", list(XLA_ROUTES))
def test_xla_routes_on_card_match_cpu(cuda, name):
    """``engine="xla"`` on the card runs the kernels' routes (the window
    engine, kernel 1 batched over the systems for the batch grid, kernel
    4, kernel 9) and launches exactly their kernels; in f32
    it meets the f32 bar against the f64 call on CPU tensors.  The grid's
    neighbour counts (a plain sweep, no kernel) run in f64 and match
    exactly."""
    from nvalchemiops_torch.kernels import launch_counts, reset_launch_counts

    ref = _xla_calls(_xla_case("cpu", torch.float64))[name]()
    dtype = torch.float64 if name == "neighbor count" else torch.float32
    calls = _xla_calls(_xla_case(cuda, dtype))
    reset_launch_counts()
    out = calls[name]()
    launched = {k for k, v in launch_counts.items() if v}
    assert launched == set(XLA_ROUTES[name]), launch_counts
    if name == "neighbor count":
        assert torch.equal(out.cpu(), ref)
    else:
        _close_cpu(tuple(out), tuple(ref))


@pytest.mark.parametrize("api", ["global", "per-backend"])
def test_xla_routes_meet_the_f32_bar_with_tf32_on(cuda, api):
    """TF32 turned on by the caller: ``engine="xla"`` of the grid and dense
    D3 in f32 on the card still meets the f32 bar, 1e-5 of scale against
    the f64 call on the CPU, and the caller's setting is back
    afterwards."""
    from nvalchemiops_torch.interactions.dispersion import dense_d3, grid_d3

    def run(device, dtype):
        c = _xla_case(device, dtype)
        d3 = (*c["tab"], 3.4, 0.42, 4.1, 1.7)
        pos_b = c["pos"][:144].reshape(4, 36, 3) * (8.0 / 11.0)
        return (grid_d3.grid_dftd3(c["g"], c["numbers"], *d3,
                                   engine="xla")[1],
                dense_d3.batch_dense_dftd3(
                    pos_b, c["numbers"][:144].reshape(4, 36),
                    np.eye(3) * 8.0, 5.0, *c["tab"], 0.42, 4.1, 1.7,
                    engine="xla")[1])

    matmul = torch.backends.cuda.matmul
    if api == "per-backend" and not hasattr(matmul, "fp32_precision"):
        pytest.skip("this torch has no per-backend fp32_precision setting")
    ref = run("cpu", torch.float64)
    if api == "global":
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("high")
    else:
        prev = matmul.fp32_precision
        matmul.fp32_precision = "tf32"
    try:
        _close_cpu(run(cuda, torch.float32), ref)
        if api == "global":
            assert torch.get_float32_matmul_precision() == "high"
        else:
            assert matmul.fp32_precision == "tf32"
    finally:
        if api == "global":
            torch.set_float32_matmul_precision(prev)
        else:
            matmul.fp32_precision = prev
        torch.backends.cuda.matmul.allow_tf32 = False


def test_default_engines_launch_the_kernels(cuda):
    """On a CUDA tensor the default engines run the kernels: ``grid_dftd3``
    kernel 1 (with its virial too), the grid Coulomb kernel 1, the stencil
    sweeps kernel 9 and the dense D3 kernel 4, each launch counted."""
    from nvalchemiops_torch import grid, stencil
    from nvalchemiops_torch.interactions.dispersion import dense_d3, grid_d3
    from nvalchemiops_torch.kernels import launch_counts, reset_launch_counts

    c = _xla_case(cuda, torch.float32)
    d3 = (*c["tab"], 3.4, 0.42, 4.1, 1.7)
    pos_b = c["pos"][:144].reshape(4, 36, 3) * (8.0 / 11.0)
    reset_launch_counts()
    grid_d3.grid_dftd3(c["g"], c["numbers"], *d3)
    grid_d3.grid_dftd3(c["g"], c["numbers"], *d3, compute_virial=True,
                       cell=c["cell"])
    grid.grid_coulomb_energy_forces(c["g"], c["q"], 3.4, 0.35)
    stencil.stencil_coordination_numbers(c["sg"], c["rcov"], 4.5)
    stencil.stencil_cn_chain_forces(c["sg"], c["rcov"], c["decn"], 4.5)
    dense_d3.batch_dense_dftd3(pos_b, c["numbers"][:144].reshape(4, 36),
                               np.eye(3) * 8.0, 5.0, *c["tab"], 0.42, 4.1,
                               1.7)
    for key, n in (("window_sweep_cn", 2), ("window_sweep_d3_direct", 2),
                   ("window_sweep_chain", 2), ("window_sweep_coulomb", 1),
                   ("stencil_sweep_cn", 1), ("stencil_sweep_chain", 1),
                   ("dense_pairs_cn", 1), ("dense_pairs_direct", 1),
                   ("dense_pairs_chain", 1)):
        assert launch_counts[key] == n, (key, launch_counts)


def test_math_extras_take_numpy_input_to_the_card(cuda):
    """The GTO and harmonic functions given numpy inputs (and a Python
    ``sigma``) place them on the card and agree with the call on CPU
    tensors in f64."""
    from nvalchemiops_torch import mathops

    pts = np.random.default_rng(80).normal(size=(6, 3))
    for name in ("gto_density_all", "eval_gto_fourier",
                 "spherical_harmonics_gradient", "gto_normalization"):
        fn = getattr(mathops, name)
        if name == "gto_normalization":
            got, want = fn(0.7), fn(0.7, device="cpu")
        elif name.startswith(("gto", "eval_gto")):
            got, want = fn(pts, 0.7), fn(torch.as_tensor(pts), 0.7)
        else:
            got, want = fn(pts), fn(torch.as_tensor(pts))
        _close_cpu(got, want, rtol=1e-12)


@pytest.mark.parametrize("backend,world", [("nccl", 1), ("gloo", 2)])
def test_parallel_paths_on_card_match_single_process(cuda, tmp_path, backend,
                                                     world):
    """The multi-rank paths on the card: one rank on NCCL, and two ranks
    sharing cuda:0 over gloo (rows staged through host memory).  The
    open-z grid case's four domain sweeps, the tile-split PME with forces
    and the dense batch PME launch their kernels on every rank and agree
    with the single-process calls within 1e-5 of each output's scale."""
    from nvalchemiops_torch.parallel._dist import spawn_ranks
    from tests import _torch_parallel_ranks as ranks

    out = tmp_path / "card.npz"
    spawn_ranks(ranks.card_cases, world, backend, args=(str(out),),
                deadline_s=300.0, threads=0)
    res = dict(np.load(out))
    counts = json.loads(str(res.pop("counts")))
    for key in ("window_sweep_cn", "window_sweep_coulomb",
                "window_sweep_d3_direct", "window_sweep_chain",
                "window_sweep_d3_direct_coulomb", "windowed_spread",
                "windowed_gather_grad", "separable_spread",
                "separable_gather"):
        assert counts.get(key), (key, counts)
    assert len(res) == len(ranks.GRID_KEYS) + 4
    for name, err in res.items():
        assert float(err) <= RTOL, (name, float(err))


def _batch_window_case(device, seed=61, b=3, n=1500, box=16.0, cutoff=6.0):
    """A batch of ``b`` systems with padding atoms and per-system cells on
    one grid geometry, and its D3 arguments."""
    rng = np.random.default_rng(seed)
    tab = _d3_tables(rng)
    frac = rng.uniform(0.0, 1.0, (b, n, 3))
    cells = np.stack([np.eye(3) * box + np.triu(rng.normal(0.0, 0.2, (3, 3)),
                                                1) for _ in range(b)])
    pos = np.einsum("bnk,bkl->bnl", frac, cells)
    numbers = rng.integers(1, 5, (b, n)).astype(np.int32)
    numbers[:, ::7] = 0
    f32 = torch.float32
    return (torch.as_tensor(pos, dtype=f32, device=device), numbers,
            torch.as_tensor(cells, dtype=f32, device=device),
            np.array([True] * 3), cutoff, *tab, 0.42, 4.1, 1.7)


def _per_system_loop(args, engine="window"):
    """``grid_dftd3`` on ``engine`` (one kernel launch a pass and system)
    on each system's part of the batch grid that ``batch_grid_dftd3``
    builds."""
    from nvalchemiops_torch import grid
    from nvalchemiops_torch.interactions.dispersion import grid_d3

    pos, numbers, cells, pbc, cutoff = args[:5]
    dims, radius, cap = grid.estimate_grid_geometry(
        cells[0].cpu().numpy(), pbc, cutoff, pos.shape[1])
    g = grid.batch_build_atom_grid(pos, cells, pbc, dims, radius, cap)
    outs = [grid_d3.grid_dftd3(grid.system_grid(g, i), numbers[i],
                               *args[5:9], cutoff, *args[9:], engine=engine)
            for i in range(pos.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


#: engine -> its kernel's wrapper, as ``grid_d3`` imports it
BATCH_ENGINES = {"window": "window_sweep", "block": "chunk_sweep",
                 "pallas": "row_sweep"}


@pytest.mark.parametrize("engine", list(BATCH_ENGINES))
def test_batched_kernels_match_plain_and_the_loop(cuda, engine):
    """``batch_grid_dftd3`` on the card makes exactly three launches of the
    engine's kernel (1, 8 or 7; one a pass, every system in each); each
    captured batched launch agrees with its plain version (the per-system
    loop of the plain version) and with per-system launches on the same
    planes; the outputs agree with the per-system loop."""
    from nvalchemiops_torch.interactions.dispersion import grid_d3
    from nvalchemiops_torch.kernels import chunk_sweep as cs
    from nvalchemiops_torch.kernels import launch_counts, reset_launch_counts
    from nvalchemiops_torch.kernels import row_sweep as rs
    from nvalchemiops_torch.kernels import window_sweep as ws

    name = BATCH_ENGINES[engine]
    kern, plain = {"window_sweep": (ws.window_sweep, ws.window_sweep_plain),
                   "row_sweep": (rs.row_sweep, rs.row_sweep_plain),
                   "chunk_sweep": (cs.chunk_sweep, cs.chunk_sweep_plain),
                   }[name]
    args = _batch_window_case(cuda)
    calls = []
    reset_launch_counts()
    seen = _record([(grid_d3, name)], lambda: calls.append(
        grid_d3.batch_grid_dftd3(*args, engine=engine)))
    torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts.items() if v}
    assert counts == {f"{name}_{b}": 1 for b in ("cn", "d3_direct",
                                                  "chain")}, counts
    got = calls[0]
    for (_, body), (a, kw) in seen.items():
        out_k = kern(body, *a, **kw)
        out_p = plain(body, *a, **kw)
        own = a[1]
        per = {k: kw[k] for k in ("lf", "cf") if kw.get(k) is not None}
        loop = [kern(body, a[0], own[i], a[2][i], *a[3:],
                     **{k: v[i] for k, v in per.items()})
                for i in range(own.shape[0])]
        torch.cuda.synchronize()
        for k in range(2):
            for f in range(out_k[k].shape[1]):
                _close(out_k[k][:, f], out_p[k][:, f])
                _close(out_k[k][:, f], torch.stack([o[k][f] for o in loop]))
    want = _per_system_loop(args, engine)
    for a, w in zip(got, want):
        assert torch.isfinite(a).all()
        _close(a, w)


def test_train_step_on_card_matches_cpu_f64(cuda):
    """``train_step`` at 4 x 64 atoms (6 A boxes) in f32 on the card
    against f64 on the CPU: the loss within 1e-5 relative and each field
    of the new parameters within 1e-6 of its scale."""
    from nvalchemiops_torch import entry, parallel

    out = {}
    for dtype, dev in ((torch.float32, cuda), (torch.float64, "cpu")):
        params = parallel.init_mlip_params(4, dtype, device=dev)
        tables = parallel.default_d3_tables(4, dtype=dtype, device=dev)
        batch = entry.make_batch(4, 64, dtype=dtype, device=dev)
        out[dtype] = parallel.train_step(params, tables, batch, 2.9)
    (new32, loss32), (new64, loss64) = out[torch.float32], out[torch.float64]
    assert loss32.device.type == "cuda"
    assert abs(loss32.item() - loss64.item()) <= 1e-5 * abs(loss64.item())
    for f in new64._fields:
        a, b = getattr(new32, f).double().cpu(), getattr(new64, f)
        assert (a - b).abs().max().item() <= 1e-6 * b.abs().max().item(), f


# ---------------------------------------------------------------------------
# Windows that overflow shared memory, the f64 route and other cards
# ---------------------------------------------------------------------------


def _every_sweep_body(cuda, seed=13, zmax=16, n=1500, box=22.0, cutoff=5.0):
    """The calls of kernels 1, 7 and 8 on every body on one grid (zm = 85
    at zmax 16): ``{(wrapper, body): (args, kwargs)}``."""
    from nvalchemiops_torch import grid
    from nvalchemiops_torch.interactions.dispersion import grid_d3

    g, numbers, q, tab, cutoff = _grid_case(cuda, seed, zmax, n, box, cutoff)
    d3 = (*tab, cutoff, 0.42, 4.1, 1.7)

    def run():
        for engine in ("window", "pallas", "block"):
            grid_d3.grid_dftd3(g, numbers, *d3, engine=engine)
        for engine in ("window", "block"):
            grid_d3.grid_dftd3_coulomb(g, numbers, q, *d3,
                                       coulomb_cutoff=0.8 * cutoff,
                                       alpha=0.35, engine=engine)
            grid.grid_coulomb_energy_forces(g, q, cutoff, 0.35,
                                            engine=engine)

    seen = _record([(grid_d3, "window_sweep"), (grid_d3, "row_sweep"),
                    (grid_d3, "chunk_sweep"), (grid, "window_sweep"),
                    (grid, "chunk_sweep")], run)
    return g, seen


@pytest.mark.parametrize("kernel", ["window_sweep", "row_sweep",
                                    "chunk_sweep"])
def test_sliced_kernels_match_plain(cuda, kernel):
    """Kernels 1, 7 and 8 with slicing forced through the wrapper's plan
    on a small grid, every body: kernel 1 stages cap + 7 slots a group
    (every window cut in slices, the home row's centre cell too) and splits
    each cell's own slots over two blocks; kernels 7 and 8 stage cap / 2 +
    3 own slots (cut mid-cell, over blocks) against cap + 7 candidates at
    a time.  Each against its plain version."""
    import dataclasses

    from nvalchemiops_torch.kernels import chunk_sweep as cs
    from nvalchemiops_torch.kernels import launch_counts
    from nvalchemiops_torch.kernels import row_sweep as rs
    from nvalchemiops_torch.kernels import window_sweep as ws

    kern, plain = {"window_sweep": (ws.window_sweep, ws.window_sweep_plain),
                   "row_sweep": (rs.row_sweep, rs.row_sweep_plain),
                   "chunk_sweep": (cs.chunk_sweep, cs.chunk_sweep_plain),
                   }[kernel]
    g, seen = _every_sweep_body(cuda)
    cap = g.cap
    plan = ((cap + 7, cap // 2 + 1) if kernel == "window_sweep"
            else (cap // 2 + 3, cap + 7))
    calls = [(body, a, kw) for (name, body), (a, kw) in seen.items()
             if name == kernel]
    if kernel == "window_sweep":
        body, a, kw = next(c for c in calls if c[0] == "d3_direct_coulomb")
        calls.append((body, a[:3] + (dataclasses.replace(
            a[3], combine_forces=not a[3].combine_forces),) + a[4:], kw))
    bodies = {"window_sweep": ws.BODIES, "row_sweep": rs.BODIES,
              "chunk_sweep": cs.BODIES}[kernel]
    assert {c[0] for c in calls} == set(bodies)
    for body, a, kw in calls:
        before = launch_counts[f"{kernel}_{body}"]
        out_k = kern(body, *a, plan=plan, **kw)
        assert launch_counts[f"{kernel}_{body}"] == before + 1
        out_p = plain(body, *a, **kw)
        torch.cuda.synchronize()
        for x, y in zip(out_k, out_p):
            for fx, fy in zip(x, y):
                _close(fx, fy)


def _dryrun_grid(device, dtype=torch.float32):
    """The JAX dry run's grid: 400 atoms in a 4 A box at 4 A, occupancy
    0.3 (dims 1^3, cap 1,336), zmax-4 tables."""
    from nvalchemiops_torch import grid

    rng = np.random.default_rng(1)
    pos = rng.uniform(0, 4.0, (400, 3))
    tab = _d3_tables(rng)
    numbers = rng.integers(1, 5, 400).astype(np.int32)
    cell = np.eye(3) * 4.0
    dims, radius, cap = grid.estimate_grid_geometry(cell, [True] * 3, 4.0,
                                                    400, 0.3)
    g = grid.build_atom_grid(torch.as_tensor(pos, dtype=dtype, device=device),
                             torch.as_tensor(cell, dtype=dtype,
                                             device=device),
                             [True] * 3, dims, radius, cap)
    return g, numbers, tab


def test_cap_1336_runs_every_engine_against_plain(cuda):
    """The dry run's one cell of cap 1,336: ``grid_dftd3`` on the window,
    block and pallas engines on the card (their windows overflow shared
    memory, so each kernel stages slices), every kernel call against its
    plain version, the engines' forces against each other."""
    from nvalchemiops_torch.interactions.dispersion import grid_d3

    g, numbers, tab = _dryrun_grid(cuda)
    assert g.cap == 1336 and tuple(g.dims) == (1, 1, 1)
    outs = {}

    def run():
        for engine in ("window", "block", "pallas"):
            outs[engine] = grid_d3.grid_dftd3(g, numbers, *tab, 4.0, 0.42,
                                              4.1, 1.7, engine=engine)

    seen = _record([(grid_d3, "window_sweep"), (grid_d3, "row_sweep"),
                    (grid_d3, "chunk_sweep")], run)
    assert len(seen) == 9
    _replay(seen)
    for engine in ("block", "pallas"):
        assert torch.isfinite(outs[engine][1]).all()
        err = (outs[engine][1] - outs["window"][1]).abs().max().item()
        assert err <= 1e-4 * outs["window"][1].abs().max().item(), engine


def _route_calls(device, dtype=torch.float64):
    """The kernel routes on one input each: ``grid_dftd3`` on the three
    grid engines, ``dense_dftd3`` and the single-system
    ``pme_reciprocal_space`` (windowed)."""
    from nvalchemiops_torch.interactions.dispersion import dense_d3, grid_d3
    from nvalchemiops_torch.interactions.electrostatics.pme import (
        pme_reciprocal_space,
    )

    c = _xla_case(device, dtype)
    d3 = (*c["tab"], 3.4, 0.42, 4.1, 1.7)
    calls = {f"grid_dftd3 {e}": (lambda e=e: grid_d3.grid_dftd3(
        c["g"], c["numbers"], *d3, engine=e)) for e in ("window", "block",
                                                       "pallas")}
    calls["dense_dftd3"] = lambda: dense_d3.dense_dftd3(
        c["pos"], c["numbers"], c["cell"], 5.0, *d3[:4], 0.42, 4.1, 1.7)
    calls["pme_reciprocal_space"] = lambda: pme_reciprocal_space(
        c["pos"], c["q"], torch.as_tensor(c["cell"], dtype=dtype,
                                          device=device), 0.35,
        mesh_dimensions=(16, 16, 16), compute_forces=True)
    return calls


@pytest.mark.parametrize("entry", ["grid_dftd3 window", "grid_dftd3 block",
                                   "grid_dftd3 pallas", "dense_dftd3",
                                   "pme_reciprocal_space"])
def test_f64_routes_on_card_match_cpu(cuda, entry):
    """f64 inputs on the card take the plain versions there: no kernel
    launches, and the outputs match the same call on CPU tensors within
    1e-10 of scale; f32 inputs of the same call launch kernels."""
    from nvalchemiops_torch.kernels import launch_counts, reset_launch_counts

    ref = _route_calls("cpu")[entry]()
    reset_launch_counts()
    got = _route_calls(cuda)[entry]()
    torch.cuda.synchronize()
    assert not any(launch_counts.values()), launch_counts
    _close_cpu(tuple(got), tuple(ref), rtol=1e-10)
    reset_launch_counts()
    _route_calls(cuda, torch.float32)[entry]()
    assert any(launch_counts.values()), entry


def test_kernel_runs_on_a_second_card():
    """A kernel wrapper given tensors on cuda:1 launches there (its runtime
    calls act on that card) and agrees with its plain version."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA device")
    from nvalchemiops_torch.interactions.dispersion import grid_d3
    from nvalchemiops_torch.kernels import launch_counts, reset_launch_counts

    dev = torch.device("cuda", 1)
    g, numbers, q, tab, cutoff = _grid_case(dev, 14, 4)
    reset_launch_counts()
    seen = _record([(grid_d3, "window_sweep"), (grid_d3, "row_sweep")],
                   lambda: [grid_d3.grid_dftd3(g, numbers, *tab, cutoff,
                                               0.42, 4.1, 1.7, engine=e)
                            for e in ("window", "pallas")])
    assert launch_counts["window_sweep_d3_direct"] == 1
    assert launch_counts["row_sweep_d3_direct"] == 1
    assert all(a[1].device == dev for a, _ in seen.values())
    _replay(seen)

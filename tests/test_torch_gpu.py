# SPDX-License-Identifier: Apache-2.0
"""CUDA kernels of the PyTorch port against their plain versions, on the
card.  Every test here needs a CUDA device and skips without one.

This file imports neither JAX nor the test helpers that do, so it also
runs where JAX is not installed:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py``.
"""

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


def test_wrappers_refuse_float64_on_cuda(cuda):
    from nvalchemiops_torch.kernels import window_sweep as ws
    from nvalchemiops_torch.kernels import windowed_gather as wg

    own = torch.zeros(4, 2, 2, 2, 8, dtype=torch.float64, device=cuda)
    cand = torch.zeros(4, 4, 4, 4, 8, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="takes torch.float32"):
        ws.window_sweep("cn", (1, 1, 1), own, cand,
                        ws.SweepParams(cutoff=3.0))
    smat = torch.zeros(8, 16, 72, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="takes torch.float32"):
        wg.spread_windows(smat, torch.zeros(8, 16, dtype=torch.float64,
                                            device=cuda), 12)


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

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
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from benchmarks.composite_accuracy import (
        load_reference, relative_errors, rms_errors,
    )
    from nvalchemiops_torch.composite import compute_forces

    bars = {"d3": (7.54e-4, 7.21e-4), "coulomb": (1.82e-5, 1.69e-5),
            "pme": (7.51e-5, 9.13e-5)}
    forces = compute_forces(torch.float32, cuda)
    ref = load_reference()
    rel, rms = relative_errors(forces, ref), rms_errors(forces, ref)
    for k, (bar_max, bar_rms) in bars.items():
        assert rel[k] <= 1.25 * bar_max, (k, rel[k])
        assert rms[k] <= 1.25 * bar_rms, (k, rms[k])

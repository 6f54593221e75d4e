# SPDX-License-Identifier: Apache-2.0
"""The port's fused D3 + Coulomb sweep, ``grid_dftd3_coulomb`` on the block
(kernel 8) and window (kernel 1) engines, against the JAX package's xla
engine in f64 (rtol 1e-9), on the fused case of the JAX grid tests
(tests/test_grid.py:406-464), with and without ``combine_forces``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvalchemiops_tpu.interactions.dispersion import grid_d3 as jd3
from nvalchemiops_torch.interactions.dispersion import grid_d3 as td3
from tests._torch_port import assert_close, port_grid
from tests.test_torch_chunk_sweep import A1, A2, S8, _grid, _tables


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: Tier-1 runs six test workers on the CPU, and a
    torch thread pool in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fused_case():
    """tests/test_grid.py:406-464: 120 atoms with charges; the JAX xla
    engine's fused references at (alpha, Coulomb cutoff) = (0, cutoff) and
    (0.35, 2.8)."""
    rng = np.random.default_rng(9)
    tab = _tables(rng)
    pos = rng.uniform(0, 10.0, (120, 3))
    numbers = rng.integers(1, 5, 120).astype(np.int32)
    q = rng.normal(size=120)
    g = _grid(pos, np.eye(3) * 10.0, np.array([True] * 3), 3.2, 120)
    refs = {}
    for alpha, ccut in ((0.0, 3.2), (0.35, 2.8)):
        refs[alpha, ccut] = tuple(np.asarray(a) for a in jd3.grid_dftd3_coulomb(
            g, jnp.asarray(numbers), jnp.asarray(q),
            *(jnp.asarray(t) for t in tab), 3.2, A1, A2, S8,
            coulomb_cutoff=ccut, alpha=alpha, engine="xla"))
    return dict(pos=pos, numbers=numbers, q=q, tab=tab, gt=port_grid(g),
                refs=refs)


@pytest.mark.parametrize("combine", [False, True])
@pytest.mark.parametrize("alpha,ccut", [(0.0, 3.2), (0.35, 2.8)])
@pytest.mark.parametrize("engine", ["block", "window"])
def test_grid_dftd3_coulomb_matches_jax_xla(fused_case, engine, alpha, ccut,
                                            combine):
    c = fused_case
    e_j, f_j, cn_j, ec_j, fc_j = c["refs"][alpha, ccut]
    out = td3.grid_dftd3_coulomb(c["gt"], c["numbers"], c["q"], *c["tab"],
                                 3.2, A1, A2, S8, coulomb_cutoff=ccut,
                                 alpha=alpha, engine=engine,
                                 combine_forces=combine)
    e_t, f_t, cn_t, ec_t, fc_t = out
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-9)
    assert_close(cn_t, cn_j, rtol=1e-9)
    assert_close(ec_t, ec_j, rtol=1e-9)
    if combine:
        assert fc_t is None
        assert_close(f_t, f_j + fc_j, rtol=1e-9)
    else:
        assert_close(f_t, f_j, rtol=1e-9)
        assert_close(fc_t, fc_j, rtol=1e-9)


def test_grid_dftd3_coulomb_xla_engine_raises(fused_case):
    """``engine="xla"`` (which raised ``NotImplementedError`` before; the
    name is kept) runs the window engine and gives the JAX xla engine's
    result."""
    c = fused_case
    out = td3.grid_dftd3_coulomb(c["gt"], c["numbers"], c["q"], *c["tab"],
                                 3.2, A1, A2, S8, engine="xla")
    for a, r in zip(out, c["refs"][0.0, 3.2]):
        assert_close(a, r, rtol=1e-9)


@pytest.mark.parametrize("engine", ["block", "window"])
def test_fused_f32_matches_jax_same_engine_interpret(fused_case, engine):
    """The JAX fused engine of the same name (its Pallas kernel in
    interpret mode) in f32 against the port's in f32, at (alpha, Coulomb
    cutoff) = (0.35, 2.8), with the tolerances of tests/test_grid.py's
    fused test."""
    c = fused_case
    g32 = _grid(c["pos"], np.eye(3) * 10.0, np.array([True] * 3), 3.2, 120,
                jnp.float32)
    q32 = c["q"].astype(np.float32)
    tab32 = tuple(t.astype(np.float32) for t in c["tab"])
    e_j, f_j, cn_j, ec_j, fc_j = jd3.grid_dftd3_coulomb(
        g32, jnp.asarray(c["numbers"]), jnp.asarray(q32),
        *(jnp.asarray(t) for t in tab32), 3.2, A1, A2, S8,
        coulomb_cutoff=2.8, alpha=0.35, engine=engine)
    e_t, f_t, cn_t, ec_t, fc_t = td3.grid_dftd3_coulomb(
        port_grid(g32, torch.float32), c["numbers"], q32, *tab32, 3.2, A1,
        A2, S8, coulomb_cutoff=2.8, alpha=0.35, engine=engine)
    assert f_t.dtype == torch.float32
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-6)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=1e-6)
    np.testing.assert_allclose(cn_t.numpy(), np.asarray(cn_j), atol=1e-5)
    np.testing.assert_allclose(ec_t.numpy(), np.asarray(ec_j), atol=1e-5)
    np.testing.assert_allclose(fc_t.numpy(), np.asarray(fc_j), atol=1e-5)

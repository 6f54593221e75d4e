# SPDX-License-Identifier: Apache-2.0
"""The port's super-chunk engines (kernel 8's plain version on the CPU)
against the JAX package.

In f64 the oracle is the JAX ``engine="xla"`` row sweep, which the JAX
package's own tests hold these engines to, at rtol 1e-9; once in f32 the
port meets the JAX block engine itself (its Pallas kernel in interpret
mode) within the JAX tests' tolerances.  The systems are those of the JAX
grid tests (tests/test_grid.py: the engine and Coulomb cases).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvalchemiops_tpu import grid as jgrid
from nvalchemiops_tpu.interactions.dispersion import grid_d3 as jd3
from nvalchemiops_torch import grid as tgrid
from nvalchemiops_torch.interactions.dispersion import grid_d3 as td3
from nvalchemiops_torch.kernels import chunk_sweep as cs
from tests._torch_port import assert_close, port_grid, synthetic_tables


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: Tier-1 runs six test workers on the CPU, and a
    torch thread pool in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


A1, A2, S8 = 0.42, 4.1, 1.7


def _tables(rng, zmax=4, sparse=False):
    rcov = np.concatenate([[0.0], rng.uniform(0.6, 1.4, zmax)])
    r4r2 = np.concatenate([[0.0], rng.uniform(2.0, 6.0, zmax)])
    cna = np.concatenate([np.zeros((1, 5)),
                          np.cumsum(rng.uniform(0.3, 1.0, (zmax, 5)), 1)])
    c6 = rng.uniform(5.0, 40.0, (zmax + 1, zmax + 1, 5, 5))
    c6[0] = 0.0
    c6[:, 0] = 0.0
    if sparse:                      # some reference points unavailable
        avail = rng.random((zmax + 1, 5)) < 0.8
        avail[:, 0] = True
        avail[0] = False
        c6 *= avail[:, None, :, None] & avail[None, :, None, :]
    c6 = 0.5 * (c6 + np.swapaxes(np.swapaxes(c6, 0, 1), 2, 3))
    return rcov, r4r2, c6, cna


def _grid(pos, cell, pbc, cutoff, n, dtype=jnp.float64):
    dims, radius, cap = jgrid.estimate_grid_geometry(
        cell, pbc, cutoff, n, target_occupancy=0.4)
    g = jgrid.build_atom_grid(jnp.asarray(pos, dtype),
                              jnp.asarray(cell, dtype), pbc, dims, radius,
                              cap)
    assert int(g.counts_max) <= cap
    return g


@pytest.fixture(scope="module")
def engines_case():
    """tests/test_grid.py:281-316: 100 atoms, sparse reference points."""
    rng = np.random.default_rng(11)
    tab = _tables(rng, sparse=True)
    pos = rng.uniform(0, 10.0, (100, 3))
    numbers = rng.integers(1, 5, 100).astype(np.int32)
    g = _grid(pos, np.eye(3) * 10.0, np.array([True] * 3), 3.2, 100)
    ref = jd3.grid_dftd3(g, jnp.asarray(numbers),
                         *(jnp.asarray(t) for t in tab), 3.2, A1, A2, S8,
                         engine="xla")
    return dict(pos=pos, numbers=numbers, tab=tab, g=g, ref=ref)


@pytest.mark.parametrize("block_g", [None, 1])
def test_grid_dftd3_block_matches_jax_xla(engines_case, block_g):
    c = engines_case
    e_j, f_j, cn_j = c["ref"]
    e_t, f_t, cn_t = td3.grid_dftd3(port_grid(c["g"]), c["numbers"],
                                    *c["tab"], 3.2, A1, A2, S8,
                                    engine="block", block_G=block_g)
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-9)
    assert_close(f_t, f_j, rtol=1e-9)
    assert_close(cn_t, cn_j, rtol=1e-9)


def test_block_engine_f32_matches_jax_block_interpret(engines_case):
    """The JAX block engine itself (Pallas interpret) in f32 against the
    port's block engine in f32, at the JAX test's tolerances."""
    c = engines_case
    g32 = _grid(c["pos"], np.eye(3) * 10.0, np.array([True] * 3), 3.2, 100,
                jnp.float32)
    e_j, f_j, cn_j = jd3.grid_dftd3(
        g32, jnp.asarray(c["numbers"]),
        *(jnp.asarray(t, jnp.float32) for t in c["tab"]), 3.2, A1, A2, S8,
        engine="block")
    e_t, f_t, cn_t = td3.grid_dftd3(
        port_grid(g32, torch.float32), c["numbers"],
        *(t.astype(np.float32) for t in c["tab"]), 3.2, A1, A2, S8,
        engine="block")
    assert f_t.dtype == torch.float32
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-6)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=1e-6)
    np.testing.assert_allclose(cn_t.numpy(), np.asarray(cn_j), atol=1e-5)


@pytest.mark.parametrize("alpha", [0.0, 0.4])
def test_grid_coulomb_block_matches_jax_xla(alpha):
    """tests/test_grid.py:466-480: 150 atoms, pbc (x, y) only."""
    rng = np.random.default_rng(5)
    pos = rng.uniform(0, 12.0, (150, 3))
    q = rng.normal(size=150)
    g = _grid(pos, np.eye(3) * 12.0, np.array([True, True, False]), 3.5,
              150)
    e_j, f_j = jgrid.grid_coulomb_energy_forces(g, jnp.asarray(q), 3.5,
                                                alpha, engine="xla")
    e_t, f_t = tgrid.grid_coulomb_energy_forces(port_grid(g),
                                                torch.as_tensor(q), 3.5,
                                                alpha, engine="block")
    assert_close(e_t, e_j, rtol=1e-9)
    assert_close(f_t, f_j, rtol=1e-9)


def test_grid_coulomb_block_f32_matches_jax_block_interpret():
    """The JAX block Coulomb engine itself (Pallas interpret) in f32
    against the port's in f32, at tests/test_grid.py:466-480's tolerance."""
    rng = np.random.default_rng(5)
    pos = rng.uniform(0, 12.0, (150, 3))
    q = rng.normal(size=150).astype(np.float32)
    g = _grid(pos, np.eye(3) * 12.0, np.array([True, True, False]), 3.5,
              150, jnp.float32)
    e_j, f_j = jgrid.grid_coulomb_energy_forces(g, jnp.asarray(q), 3.5, 0.4,
                                                engine="block")
    e_t, f_t = tgrid.grid_coulomb_energy_forces(
        port_grid(g, torch.float32), torch.as_tensor(q), 3.5, 0.4,
        engine="block")
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), atol=1e-5)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=1e-5)


def test_super_chunk_cells_fits_shared_memory():
    """G divides cx, fits a block's 227 KB, and prefers ~128 own rows."""
    assert cs.super_chunk_cells("coulomb", 16, 40, 1) == 4      # M = 160
    assert cs.super_chunk_cells("d3_direct", 16, 40, 1, 30) == 4
    g85 = cs.super_chunk_cells("d3_direct_coulomb", 16, 40, 1, 170)
    assert g85 == 2 and cs.chunk_smem_bytes(
        "d3_direct_coulomb", 4, 40, 1, 170) > cs.SMEM_BYTES
    assert cs.super_chunk_cells("cn", 7, 16, 2) == 7            # M = 112
    with pytest.raises(ValueError, match="shared memory"):
        cs.super_chunk_cells("d3_direct", 4, 200, 3, 170)
    own = torch.zeros(4, 2, 2, 6, 8, dtype=torch.float64)
    cand = torch.zeros(4, 4, 4, 8, 8, dtype=torch.float64)
    with pytest.raises(ValueError, match="must divide"):
        cs.chunk_sweep("cn", (1, 1, 1), own, cand,
                       td3.SweepParams(cutoff=3.0), 4)


def test_batch_grid_dftd3_block_matches_jax_block():
    """``batch_grid_dftd3`` passes ``engine`` through to ``grid_dftd3``, as
    the JAX function does; two systems with padding atoms, f64."""
    rng = np.random.default_rng(45)
    b, n, box, cutoff = 2, 90, 10.0, 3.5
    pos = rng.uniform(0, box, (b, n, 3))
    numbers = rng.integers(1, 5, (b, n)).astype(np.int32)
    numbers[:, -3:] = 0
    tab = synthetic_tables(seed=45)
    cell = np.eye(3) * box
    pbc = np.array([True] * 3)
    e_j, f_j, cn_j = jd3.batch_grid_dftd3(
        jnp.asarray(pos), jnp.asarray(numbers), jnp.asarray(cell), pbc,
        cutoff, *(jnp.asarray(t) for t in tab), A1, A2, S8, engine="block")
    e_t, f_t, cn_t = td3.batch_grid_dftd3(
        torch.as_tensor(pos), numbers, torch.as_tensor(cell), pbc, cutoff,
        *tab, A1, A2, S8, engine="block")
    assert_close(e_t, e_j, rtol=1e-9)
    assert_close(f_t, f_j, rtol=1e-9)
    assert_close(cn_t, cn_j, rtol=1e-9)

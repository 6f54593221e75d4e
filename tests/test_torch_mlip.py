# SPDX-License-Identifier: Apache-2.0
"""The port's MLIP forward pass (``parallel.mlip``) against the JAX
package's, on the CPU in f64.

The starting parameters and tables are drawn as the JAX package draws
them and must be equal; ``mlip_energy`` and ``batched_energy_forces`` run
at ``__graft_entry__._make_batch(4, 256, 4, ...)``'s inputs (``entry()``'s
shapes) and at 4 x 32 atoms, with the JAX weights carried over by
``interop.mlip_params_from_numpy`` / ``mlip_tables_from_numpy``, within
rtol 1e-10.  Forces sum to ~0 per system (translation invariance).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvalchemiops_torch import interop
from nvalchemiops_torch import parallel as tpar
from nvalchemiops_tpu import parallel as jpar
from __graft_entry__ import _make_batch

from tests._torch_port import assert_close

F64 = torch.float64
ZMAX = 4
CUTOFF = 2.9
RTOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: Tier-1 runs six test workers on the CPU, and a
    torch thread pool in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(nt):
    return {f: np.asarray(getattr(nt, f)) for f in nt._fields}


@functools.lru_cache(maxsize=None)
def _weights():
    """JAX's f64 parameters and tables, and the port's carried over."""
    params = jpar.init_mlip_params(ZMAX, jnp.float64)
    tables = jpar.default_d3_tables(ZMAX, dtype=jnp.float64)
    return (params, tables,
            interop.mlip_params_from_numpy(_fields(params), device="cpu"),
            interop.mlip_tables_from_numpy(_fields(tables), device="cpu"))


@functools.lru_cache(maxsize=None)
def _batch(b, n):
    positions, numbers, cell, _, _ = _make_batch(b, n, ZMAX, jnp.float64)
    return positions, numbers, cell


@functools.lru_cache(maxsize=None)
def _jax_forward(b, n):
    jparams, jtables, _, _ = _weights()
    e, f = jax.jit(jpar.batched_energy_forces, static_argnums=5)(
        jparams, jtables, *_batch(b, n), CUTOFF)
    return np.asarray(e), np.asarray(f)


def test_parameters_and_tables_equal_jax_s():
    """The port's own draws equal the JAX package's: the tables bit for
    bit (the same numpy draws), the parameters within an ulp (``sin``)."""
    for dtype, jdtype in ((torch.float64, jnp.float64),
                          (torch.float32, jnp.float32)):
        jp = jpar.init_mlip_params(ZMAX, jdtype)
        jt = jpar.default_d3_tables(ZMAX, seed=3, dtype=jdtype)
        tp = tpar.init_mlip_params(ZMAX, dtype, device="cpu")
        tt = tpar.default_d3_tables(ZMAX, seed=3, dtype=dtype, device="cpu")
        assert tpar.MLIPParams._fields == jpar.MLIPParams._fields
        assert tpar.D3Tables._fields == jpar.D3Tables._fields
        for f in jt._fields:
            got = getattr(tt, f)
            assert got.dtype == dtype
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(getattr(jt, f)))
        for f in jp._fields:
            got = getattr(tp, f)
            assert got.dtype == dtype and got.shape == getattr(jp, f).shape
            np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jp, f)),
                                       rtol=2 * np.finfo(got.numpy().dtype).eps,
                                       atol=0)


@pytest.mark.parametrize("shape", [(4, 256), (4, 32)])
def test_batched_energy_forces_match_jax(shape):
    _, _, params, tables = _weights()
    positions, numbers, cell = (torch.from_numpy(np.array(a))
                                for a in _batch(*shape))
    energies, forces = tpar.batched_energy_forces(params, tables, positions,
                                                  numbers, cell, CUTOFF)
    e_ref, f_ref = _jax_forward(*shape)
    assert energies.dtype == F64 and forces.shape == positions.shape
    assert_close(energies, e_ref, RTOL)
    assert_close(forces, f_ref, RTOL)
    net = forces.sum(dim=1).abs().max().item()
    assert net < 1e-9 * forces.abs().sum().item()
    assert not positions.requires_grad


def test_mlip_energy_matches_jax_with_padding():
    """One system with padding atoms (``numbers == 0``) and a non-default
    ``alpha``."""
    jparams, jtables, params, tables = _weights()
    positions, numbers, cell = _batch(4, 32)
    z = np.asarray(numbers[1]).copy()
    z[::5] = 0
    e_ref = jax.jit(jpar.mlip_energy, static_argnums=5)(
        jparams, jtables, positions[1], jnp.asarray(z), cell[1], CUTOFF,
        alpha=0.45)
    e = tpar.mlip_energy(params, tables,
                         torch.from_numpy(np.array(positions[1])),
                         torch.from_numpy(z),
                         torch.from_numpy(np.array(cell[1])), CUTOFF,
                         alpha=0.45)
    assert_close(e, float(e_ref), RTOL)

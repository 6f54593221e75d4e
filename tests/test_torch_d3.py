# SPDX-License-Identifier: Apache-2.0
"""The port's DFT-D3(BJ) grid engine and D3 tables against the JAX
package, in f64 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvalchemiops_tpu import grid as jgrid
from nvalchemiops_tpu.interactions.dispersion import d3_data as jdata
from nvalchemiops_tpu.interactions.dispersion import grid_d3 as jd3
from nvalchemiops_torch import interop
from nvalchemiops_torch.interactions.dispersion import d3_data as tdata
from nvalchemiops_torch.interactions.dispersion import grid_d3 as td3
from tests._torch_port import (
    assert_close, port_grid, random_system, synthetic_tables,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: Tier-1 runs six test workers on the CPU, and a
    torch thread pool in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


A1, A2, S8 = 0.42, 4.1, 1.7


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_realistic_tables_equal_jax_copy(dtype):
    a = tdata.realistic_test_tables(dtype)
    b = jdata.realistic_test_tables(dtype)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_table_helpers_match_jax():
    t = tdata.realistic_test_tables(np.float64)
    cna_t = td3.element_cn_ref(t["cn_ref"])
    np.testing.assert_array_equal(cna_t,
                                  np.asarray(jd3.element_cn_ref(t["cn_ref"])))
    np.testing.assert_array_equal(td3.element_c6_mask(t["c6ab"]),
                                  np.asarray(jd3.element_c6_mask(t["c6ab"])))
    numbers = np.array([55, 17, 17, 0, 55, 1], np.int32)
    got = td3.compact_d3_elements(numbers, t["rcov"], t["r4r2"], t["c6ab"],
                                  cna_t)
    want = jd3.compact_d3_elements(numbers, t["rcov"], t["r4r2"], t["c6ab"],
                                   cna_t)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    bad = t["cn_ref"].copy()
    bad[1, 2, 0, 0] += 1.0
    with pytest.raises(ValueError, match="element-structured"):
        td3.element_cn_ref(bad)
    bad_c6 = t["c6ab"].copy()
    bad_c6[1, 1, 0, 0] = 0.0
    with pytest.raises(ValueError, match="separable"):
        td3.element_c6_mask(bad_c6)


def _realistic_tables():
    t = tdata.realistic_test_tables(np.float64)
    return (t["rcov"], t["r4r2"], t["c6ab"],
            td3.element_cn_ref(t["cn_ref"]))


@pytest.mark.parametrize("tables", ["synthetic", "realistic"])
def test_grid_dftd3_matches_jax(tables):
    """Energy, forces and CNs vs the JAX xla engine, rtol 1e-9."""
    if tables == "synthetic":
        pos, cell, numbers, _ = random_system(seed=21, n=170, box=11.0)
        tab = synthetic_tables(seed=21)
        cutoff = 3.8
    else:
        pos, cell, numbers, _ = random_system(seed=22, n=150, box=12.0)
        numbers = np.where(numbers % 2 == 0, 17, 55).astype(np.int32)
        numbers[::7] = 6              # a carbon or two: 3 present elements
        tab = _realistic_tables()
        cutoff = 4.2
    pbc = np.array([True] * 3)
    dims, radius, cap = jgrid.estimate_grid_geometry(cell, pbc, cutoff,
                                                     len(pos), 0.5)
    gj = jgrid.build_atom_grid(jnp.asarray(pos), jnp.asarray(cell), pbc,
                               dims, radius, cap)
    e_j, f_j, cn_j = jd3.grid_dftd3(gj, jnp.asarray(numbers),
                                    *(jnp.asarray(a) for a in tab), cutoff,
                                    A1, A2, S8, engine="xla")
    tt = interop.d3_tables_from_numpy(*tab, device="cpu")
    e_t, f_t, cn_t = td3.grid_dftd3(port_grid(gj), numbers, tt["rcov"],
                                    tt["r4r2"], tt["c6ab"],
                                    tt["cn_ref_elem"], cutoff, A1, A2, S8)
    assert e_t.dtype == torch.float64 and f_t.shape == (len(pos), 3)
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-9)
    assert_close(f_t, f_j, rtol=1e-9)
    assert_close(cn_t, cn_j, rtol=1e-9)


def test_grid_dftd3_padding_atoms_are_parked():
    """numbers == 0 atoms take no part, as in the JAX package."""
    pos, cell, numbers, _ = random_system(seed=23, n=120, box=10.0)
    numbers[::5] = 0
    tab = synthetic_tables(seed=23)
    pbc = np.array([True] * 3)
    dims, radius, cap = jgrid.estimate_grid_geometry(cell, pbc, 3.5, 120, 0.5)
    gj = jgrid.build_atom_grid(jnp.asarray(pos), jnp.asarray(cell), pbc,
                               dims, radius, cap)
    e_j, f_j, cn_j = jd3.grid_dftd3(gj, jnp.asarray(numbers),
                                    *(jnp.asarray(a) for a in tab), 3.5,
                                    A1, A2, S8, engine="xla")
    e_t, f_t, cn_t = td3.grid_dftd3(port_grid(gj), numbers, *tab, 3.5,
                                    A1, A2, S8)
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-9)
    assert_close(f_t, f_j, rtol=1e-9)
    assert float(f_t[::5].abs().max()) == 0.0


def test_grid_dftd3_engine_other_than_window_raises():
    """An engine name neither package has raises ``ValueError`` (the JAX
    package's ``"xla"`` runs the window engine; tests/test_torch_xla_engines.py
    holds it to JAX)."""
    g = port_grid(jgrid.build_atom_grid(
        jnp.zeros((4, 3)), jnp.eye(3) * 9.0, np.array([True] * 3),
        (2, 2, 2), (1, 1, 1), 8))
    tab = synthetic_tables()
    with pytest.raises(ValueError, match="unknown engine"):
        td3.grid_dftd3(g, np.ones(4, np.int32), *tab, 3.0, A1, A2, S8,
                       engine="mosaic")

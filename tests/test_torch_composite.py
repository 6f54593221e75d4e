# SPDX-License-Identifier: Apache-2.0
"""The port's whole slice (grid -> D3 -> Coulomb -> PME) against the JAX
package, and its f32 composite against the committed f64 reference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import composite_accuracy as jca
from nvalchemiops_torch import composite
from tests._torch_port import assert_close

SMALL = dict(n_rep=4, cutoff=5.0, alpha=0.4, mesh=(16, 16, 16))  # 128 atoms


def test_build_system_equals_jax_bit_for_bit():
    for n_rep, seed in ((composite.N_REP, 0), (3, 5)):
        got = composite.build_system(n_rep, seed)
        want = jca.build_system(n_rep, seed)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            b = np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_constants_equal_jax_composite():
    for name in ("N_REP", "A_LAT", "CUTOFF", "ALPHA", "MESH", "D3_A1",
                 "D3_A2", "D3_S8"):
        assert getattr(composite, name) == getattr(jca, name), name


def _jax_slice(n_rep, cutoff, alpha, mesh):
    """The JAX composite's stages (xla engines) at a small size, f64."""
    from nvalchemiops_tpu.grid import (
        build_atom_grid, choose_grid_origin, estimate_grid_geometry,
        grid_coulomb_energy_forces,
    )
    from nvalchemiops_tpu.interactions.dispersion.grid_d3 import (
        compact_d3_elements, grid_dftd3,
    )
    from nvalchemiops_tpu.interactions.electrostatics.pme import (
        pme_reciprocal_space,
    )
    from nvalchemiops_tpu.spline_windowed import observed_tile_capacity

    pos_np, cell_np, numbers, charges, rcov, r4r2, cna, c6 = \
        jca.build_system(n_rep)
    numbers, rcov, r4r2, c6, cna = (np.asarray(a) for a in
                                    compact_d3_elements(numbers, rcov, r4r2,
                                                        c6, cna))
    pbc = np.array([True] * 3)
    pos, cell = jnp.asarray(pos_np), jnp.asarray(cell_np)
    dims, radius, cap = estimate_grid_geometry(cell, pbc, cutoff,
                                               pos.shape[0], 0.75)
    origin_np, observed = choose_grid_origin(pos, cell, pbc, dims)
    cap = max(int(np.ceil((observed + 1) / 8)) * 8,
              int(np.ceil(observed * 1.02 / 8)) * 8)
    g = build_atom_grid(pos, cell, pbc, dims, radius, cap,
                        origin=jnp.asarray(origin_np) if origin_np.any()
                        else None)
    _, f_d3, _ = grid_dftd3(g, jnp.asarray(numbers), jnp.asarray(rcov),
                            jnp.asarray(r4r2), jnp.asarray(c6),
                            jnp.asarray(cna), cutoff, jca.D3_A1, jca.D3_A2,
                            jca.D3_S8, engine="xla")
    _, f_c = grid_coulomb_energy_forces(g, jnp.asarray(charges), cutoff,
                                        alpha, engine="xla")
    _, f_p = pme_reciprocal_space(
        pos, jnp.asarray(charges), cell, alpha, mesh_dimensions=mesh,
        compute_forces=True,
        tile_capacity=observed_tile_capacity(pos, cell, mesh))
    return {"d3": np.asarray(f_d3), "coulomb": np.asarray(f_c),
            "pme": np.asarray(f_p)}


def test_slice_matches_jax_f64():
    """128-atom CsCl, 5 A cutoff, 16^3 mesh: every stage's forces agree
    with the JAX package at f64 to 1e-9 of the stage's force scale."""
    want = _jax_slice(**SMALL)
    got = composite.compute_forces(torch.float64, "cpu", **SMALL)
    for k in ("d3", "coulomb", "pme"):
        assert np.abs(want[k]).max() > 0
        assert_close(got[k], want[k], rtol=1e-9, err_msg=k)


# the JAX package's recorded f32-vs-f64 force errors on this composite
# (max rel, RMS rel); the port's f32 path must stay within 1.25x of them
JAX_F32_BARS = {"d3": (7.54e-4, 7.21e-4), "coulomb": (1.82e-5, 1.69e-5),
                "pme": (7.51e-5, 9.13e-5)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_composite_against_committed_reference(dtype):
    ref = jca.load_reference()
    assert ref is not None
    forces = composite.compute_forces(dtype, "cpu")
    rel = jca.relative_errors(forces, ref)
    rms = jca.rms_errors(forces, ref)
    for k, (bar_max, bar_rms) in JAX_F32_BARS.items():
        if dtype == torch.float64:     # same math as the f64 reference
            assert rel[k] < 1e-10 and rms[k] < 1e-10, (k, rel[k], rms[k])
        else:
            assert rel[k] <= 1.25 * bar_max, (k, rel[k])
            assert rms[k] <= 1.25 * bar_rms, (k, rms[k])

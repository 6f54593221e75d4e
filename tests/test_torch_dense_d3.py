# SPDX-License-Identifier: Apache-2.0
"""The port's batched DFT-D3 against the JAX package, in f64 on the CPU:
the dense triangle-block engine, the batched halo grid and its D3, and the
``batch_dftd3`` router."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvalchemiops_tpu import grid as jgrid
from nvalchemiops_tpu.interactions.dispersion import dense_d3 as jdense
from nvalchemiops_tpu.interactions.dispersion import grid_d3 as jd3
from nvalchemiops_torch import grid as tgrid
from nvalchemiops_torch import interop
from nvalchemiops_torch.interactions.dispersion import dense_d3 as tdense
from nvalchemiops_torch.interactions.dispersion import grid_d3 as td3
from nvalchemiops_torch.kernels import dense_pairs as tds
from nvalchemiops_torch.kernels.window_sweep import SweepParams
from tests._torch_port import assert_close, synthetic_tables


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: Tier-1 runs six test workers on the CPU, and a
    torch thread pool in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


A1, A2, S8 = 0.42, 4.1, 1.7


def _batch(seed, b, n, box, zmax=4, n_pad_atoms=0):
    """Uniform random systems ``[b, n, 3]`` in a cubic box; the last
    ``n_pad_atoms`` atoms of each are padding (numbers == 0)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, box, (b, n, 3))
    numbers = rng.integers(1, zmax + 1, (b, n)).astype(np.int32)
    if n_pad_atoms:
        numbers[:, -n_pad_atoms:] = 0
    return pos, numbers


def _jax_args(tab):
    return tuple(jnp.asarray(a) for a in tab)


@pytest.mark.parametrize("cell,cutoff", [
    (np.eye(3) * 41.2, 21.2),
    (np.eye(3) * 8.0, 6.3),
    (np.eye(3) * 27.0, 9.0),
    (np.array([[8.0, 0, 0], [4.0, 8.0, 0], [0, 0, 8.0]]), 6.3),
])
def test_image_combos_match_jax(cell, cutoff):
    assert tdense._image_combos(True, cell, cutoff) == \
        jdense._image_combos(True, cell, cutoff)
    assert tdense.min_perpendicular_width(cell) == \
        jdense.min_perpendicular_width(cell)
    assert tdense._resolve_images(None, cell, cutoff) == \
        jdense._resolve_images(None, cell, cutoff)


@pytest.mark.parametrize("mode", ["min_image", "images"])
def test_dense_dftd3_matches_jax_xla(mode):
    """E, F and CN vs the JAX xla planes, rtol 1e-9, with padding atoms;
    ``images`` runs the pruned second-image combos (cutoff / width 0.7)."""
    box, cutoff = (11.0, 4.5) if mode == "min_image" else (9.0, 6.3)
    pos, numbers = _batch(41, 1, 130, box, n_pad_atoms=7)
    pos, numbers = pos[0], numbers[0]
    cell = np.eye(3) * box
    tab = synthetic_tables(seed=41)
    e_j, f_j, cn_j = jdense.dense_dftd3(
        jnp.asarray(pos), jnp.asarray(numbers), jnp.asarray(cell), cutoff,
        *_jax_args(tab), A1, A2, S8, engine="xla")
    e_t, f_t, cn_t = tdense.dense_dftd3(
        torch.as_tensor(pos), numbers, torch.as_tensor(cell), cutoff, *tab,
        A1, A2, S8)
    assert e_t.dtype == torch.float64 and f_t.shape == (130, 3)
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-9)
    assert_close(f_t, f_j, rtol=1e-9)
    assert_close(cn_t, cn_j, rtol=1e-9)
    assert float(f_t[-7:].abs().max()) == 0.0
    assert float(cn_t[-7:].abs().max()) == 0.0


def test_plain_dense_pairs_matches_jax_pallas_interpret():
    """The port's plain triangle-block sweep (64-atom tiles) against the
    JAX Mosaic sweep in interpret mode (128-atom blocks), per output: E,
    F, CN.  Cells are exact in f32, which the JAX kernel reads them in."""
    b, n, cutoff = 2, 150, 4.0
    pos, numbers = _batch(42, b, n, 12.0, n_pad_atoms=5)
    cells = np.stack([np.eye(3) * (12.0 + 0.5 * i) for i in range(b)])
    tab = synthetic_tables(seed=42)
    out_j = jdense.batch_dense_dftd3(
        jnp.asarray(pos), jnp.asarray(numbers), jnp.asarray(cells), cutoff,
        *_jax_args(tab), A1, A2, S8, engine="pallas", block=128,
        interpret=True)
    out_t = tdense.batch_dense_dftd3(
        torch.as_tensor(pos), numbers, torch.as_tensor(cells), cutoff, *tab,
        A1, A2, S8)
    for name, a, want in zip(("energy", "forces", "cn"), out_t, out_j):
        assert_close(a, want, rtol=1e-9, err_msg=name)


@pytest.mark.parametrize("case", ["pbc_shared", "pbc_per_system",
                                  "mixed_pbc", "overflow"])
def test_batch_build_atom_grid_matches_jax(case):
    b, n = 3, 160
    pbc = [True, False, True] if case == "mixed_pbc" else [True] * 3
    rng = np.random.default_rng(43)
    pos = rng.uniform(-0.05, 1.05, (b, n, 3)) * 11.0
    if case == "pbc_per_system":
        cells = np.stack([np.diag([11.0, 11.5, 12.0]) * (1 + 0.02 * i)
                          for i in range(b)])
    else:
        cells = np.diag([11.0, 11.5, 12.0])
    dims, radius, cap = jgrid.estimate_grid_geometry(
        np.asarray(cells).reshape(-1, 3, 3)[0], np.array(pbc), 3.4, n, 0.5)
    if case == "overflow":
        cap = 4
    gj = jgrid.batch_build_atom_grid(jnp.asarray(pos), jnp.asarray(cells),
                                     np.array(pbc), dims, radius, cap)
    gt = tgrid.batch_build_atom_grid(torch.as_tensor(pos),
                                     torch.as_tensor(cells), pbc, dims,
                                     radius, cap)
    for f in ("flat_slot", "ext_aid", "ext_shift_code", "ext_valid",
              "counts_max"):
        np.testing.assert_array_equal(getattr(gt, f).numpy(),
                                      np.asarray(getattr(gj, f)), err_msg=f)
    assert gt.ext_aid.dtype == torch.int32 and gt.counts_max.shape == (b,)
    if case == "overflow":
        assert int(gt.counts_max.max()) > cap
    for f in ("ext_px", "ext_py", "ext_pz"):
        np.testing.assert_allclose(getattr(gt, f).numpy(),
                                   np.asarray(getattr(gj, f)),
                                   rtol=1e-12, atol=1e-12, err_msg=f)
    # a system of the batch equals the single-system build
    cell1 = cells[1] if np.ndim(cells) == 3 else cells
    one = tgrid.build_atom_grid(torch.as_tensor(pos[1]),
                                torch.as_tensor(cell1), pbc, dims, radius,
                                cap)
    sys1 = tgrid.system_grid(gt, 1)
    for f in ("flat_slot", "ext_aid", "counts_max"):
        assert torch.equal(getattr(sys1, f), getattr(one, f)), f


def test_batch_atom_grid_from_numpy_round_trip():
    pos, _ = _batch(44, 2, 90, 10.0)
    cell = np.eye(3) * 10.0
    pbc = np.array([True] * 3)
    dims, radius, cap = jgrid.estimate_grid_geometry(cell, pbc, 3.0, 90, 0.5)
    gj = jgrid.batch_build_atom_grid(jnp.asarray(pos), jnp.asarray(cell),
                                     pbc, dims, radius, cap)
    fields = {f: np.asarray(getattr(gj, f))
              for f in interop.ATOM_GRID_FIELDS}
    gt = interop.batch_atom_grid_from_numpy(fields, dims, radius, cap,
                                            device="cpu")
    assert gt.counts_max.shape == (2,) and gt.ext_px.dim() == 5
    with pytest.raises(ValueError, match="leading system axis"):
        interop.batch_atom_grid_from_numpy(
            dict(fields, counts_max=fields["counts_max"][0]), dims, radius,
            cap, device="cpu")


def test_batch_grid_dftd3_matches_jax():
    b, n, box, cutoff = 2, 140, 11.0, 3.8
    pos, numbers = _batch(45, b, n, box, n_pad_atoms=4)
    cell = np.eye(3) * box
    pbc = np.array([True] * 3)
    tab = synthetic_tables(seed=45)
    e_j, f_j, cn_j = jd3.batch_grid_dftd3(
        jnp.asarray(pos), jnp.asarray(numbers), jnp.asarray(cell), pbc,
        cutoff, *_jax_args(tab), A1, A2, S8)
    e_t, f_t, cn_t = td3.batch_grid_dftd3(
        torch.as_tensor(pos), numbers, torch.as_tensor(cell), pbc, cutoff,
        *tab, A1, A2, S8)
    assert e_t.shape == (b,) and f_t.shape == (b, n, 3)
    assert_close(e_t, e_j, rtol=1e-9)
    assert_close(f_t, f_j, rtol=1e-9)
    assert_close(cn_t, cn_j, rtol=1e-9)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        td3.batch_grid_dftd3(torch.as_tensor(pos), numbers,
                             torch.as_tensor(cell), pbc, cutoff, *tab, A1,
                             A2, S8, engine="xla")


def test_batch_dftd3_router():
    """The router's decisions mirror the JAX package's: dense for small
    all-PBC systems, grid for mixed pbc or more than BATCH_DENSE_MAX_ATOMS
    atoms, dense when the grid cannot represent the cutoff; the results
    equal the chosen engine's."""
    b, n, box = 2, 96, 12.0
    pos_np, numbers = _batch(46, b, n, box)
    pos = torch.as_tensor(pos_np)
    cell = np.eye(3) * box
    pbc = np.array([True] * 3)
    pbc_mix = np.array([True, False, True])
    tab = synthetic_tables(seed=46)
    args = (3.4, *tab, A1, A2, S8)

    assert tdense.batch_route(cell, pbc, 3.4, n) == "dense"
    e_a, f_a, _ = tdense.batch_dftd3(pos, numbers, cell, pbc, *args)
    e_d, f_d, _ = tdense.batch_dense_dftd3(pos, numbers, cell, *args)
    assert torch.equal(e_a, e_d) and torch.equal(f_a, f_d)

    assert tdense.batch_route(cell, pbc_mix, 3.4, n) == "grid"
    e_m, _, _ = tdense.batch_dftd3(pos, numbers, cell, pbc_mix, *args)
    e_g, _, _ = td3.batch_grid_dftd3(pos, numbers, cell, pbc_mix, *args)
    assert torch.equal(e_m, e_g)
    e_jm, _, _ = jdense.batch_dftd3(jnp.asarray(pos_np),
                                    jnp.asarray(numbers), jnp.asarray(cell),
                                    pbc_mix, 3.4, *_jax_args(tab), A1, A2,
                                    S8)
    assert_close(e_m, e_jm, rtol=1e-9)

    # both engines agree physically on the all-PBC workload
    e_g2, f_g2, _ = td3.batch_grid_dftd3(pos, numbers, cell, pbc, *args)
    assert_close(e_a, e_g2, rtol=1e-9)
    assert_close(f_a, f_g2, rtol=1e-9)

    # more atoms per system than the dense bound -> grid
    assert tdense.batch_route(np.eye(3) * 54.0, pbc, 9.0,
                              tdense.BATCH_DENSE_MAX_ATOMS + 1) == "grid"
    assert tdense.BATCH_DENSE_MAX_ATOMS == jdense.BATCH_DENSE_MAX_ATOMS

    # cutoff beyond the grid bound -> dense with images, as in JAX
    assert tdense.batch_route(cell, pbc, 7.0, n) == "dense"
    e_big, _, _ = tdense.batch_dftd3(pos, numbers, cell, pbc, 7.0, *tab,
                                     A1, A2, S8)
    e_jbig, _, _ = jdense.batch_dftd3(jnp.asarray(pos_np),
                                      jnp.asarray(numbers),
                                      jnp.asarray(cell), pbc, 7.0,
                                      *_jax_args(tab), A1, A2, S8)
    assert_close(e_big, e_jbig, rtol=1e-9)

    # dense with mixed pbc raises: forced, or routed there because the
    # grid cannot represent the cutoff
    with pytest.raises(ValueError, match="full PBC"):
        tdense.batch_dftd3(pos, numbers, cell, pbc_mix, *args,
                           engine="dense")
    assert tdense.batch_route(cell, pbc_mix, 13.0, n) == "dense"
    with pytest.raises(ValueError, match="full PBC"):
        tdense.batch_dftd3(pos, numbers, cell, pbc_mix, 13.0, *tab, A1, A2,
                           S8)


def test_dense_pairs_wrapper_checks():
    feats = torch.zeros(1, 64, 5, dtype=torch.float64)
    cells = torch.eye(3, dtype=torch.float64).reshape(1, 9)
    params = SweepParams(cutoff=3.0)
    with pytest.raises(ValueError, match="multiple"):
        tds.dense_pairs("cn", feats[:, :60], cells, [(0, 0, 0)], params)
    with pytest.raises(ValueError, match="expected 6 features"):
        tds.dense_pairs("chain", feats, cells, [(0, 0, 0)], params)
    with pytest.raises(ValueError, match="lw"):
        tds.dense_pairs("direct", torch.zeros(1, 64, 15), cells,
                        [(0, 0, 0)], params)
    with pytest.raises(ValueError, match="unsupported device"):
        tds.dense_pairs("cn", feats.to("meta"), cells.to("meta"),
                        [(0, 0, 0)], params)
    out = tds.dense_pairs("cn", feats, cells, [(0, 0, 0)], params)
    assert out.shape == (1, 1, 64)

# SPDX-License-Identifier: Apache-2.0
"""The port's package surface against the JAX package's, on the CPU: the
namespace, the dtype policy and math helpers, the element-table rows, the
Fortran table parser (on synthetic text blocks) and
``grid.build_atom_grid_auto``.

Inputs are made from a seed with numpy and go through both packages; f64
results are held at 1e-12 of their scale, integer grid state exactly.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nvalchemiops_torch
import nvalchemiops_tpu
from nvalchemiops_torch import grid as tgrid
from nvalchemiops_torch import types as ttypes
from nvalchemiops_torch.interactions.dispersion import d3_data as td3data
from nvalchemiops_torch.interactions.dispersion import dense_d3 as tdense
from nvalchemiops_torch.mathops import math as tmath
from nvalchemiops_tpu import grid as jgrid
from nvalchemiops_tpu import types as jtypes
from nvalchemiops_tpu.interactions.dispersion import d3_data as jd3data
from nvalchemiops_tpu.interactions.dispersion import dense_d3 as jdense
from nvalchemiops_tpu.mathops import math as jmath

from tests._torch_port import assert_close, grid_fields

RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: Tier-1 runs six test workers on the CPU, and a
    torch thread pool in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Namespace
# ---------------------------------------------------------------------------


def test_namespace_holds_the_jax_subpackages_but_parallel():
    """Every name of the JAX package's ``__all__`` is an attribute of the
    port but ``parallel`` (the multi-device paths, not ported yet), and so
    are both names of ``interactions.__all__``."""
    missing = [n for n in nvalchemiops_tpu.__all__
               if not hasattr(nvalchemiops_torch, n)]
    assert missing == ["parallel"]
    assert sorted(nvalchemiops_torch.__all__) == sorted(
        n for n in nvalchemiops_tpu.__all__ if n != "parallel")
    assert sorted(nvalchemiops_tpu.interactions.__all__) == sorted(
        nvalchemiops_torch.interactions.__all__)
    for n in nvalchemiops_tpu.interactions.__all__:
        assert hasattr(nvalchemiops_torch.interactions, n)
    # every name of the JAX dispersion namespace (D3Parameters, dftd3 and
    # the grid and dense engines)
    jdisp = nvalchemiops_tpu.interactions.dispersion
    tdisp = nvalchemiops_torch.interactions.dispersion
    assert set(jdisp.__all__) <= set(tdisp.__all__)
    for n in jdisp.__all__:
        assert hasattr(tdisp, n)
    assert tdisp.dftd3 is tdisp.dftd3.__globals__["dftd3"]
    assert nvalchemiops_torch.grid.build_atom_grid_auto is \
        tgrid.build_atom_grid_auto


def test_mathops_and_grid_export_the_jax_lists():
    """``mathops`` exports exactly the JAX list plus the port's
    ``apply_mat3_batched``; ``grid`` every JAX name but the TPU layout
    choice ``use_slot_gather``, each name bound in the namespace."""
    tm, jm = nvalchemiops_torch.mathops, nvalchemiops_tpu.mathops
    assert sorted(tm.__all__) == sorted(jm.__all__ + ["apply_mat3_batched"])
    for n in tm.__all__:
        assert callable(getattr(tm, n)), n
    assert set(jgrid.__all__) - set(tgrid.__all__) == {"use_slot_gather"}
    for n in tgrid.__all__:
        assert hasattr(tgrid, n), n


def test_import_builds_no_kernel_and_imports_no_jax():
    """In a fresh interpreter, importing the package and its subpackages
    neither builds nor loads the kernel library, and imports no JAX."""
    code = (
        "import sys\n"
        "import nvalchemiops_torch as t\n"
        "from nvalchemiops_torch.kernels.build import load_library\n"
        "t.grid, t.spline_windowed, t.interactions.electrostatics\n"
        "assert load_library.cache_info().currsize == 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'nvalchemiops_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(nvalchemiops_torch.__file__))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=root))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ---------------------------------------------------------------------------
# Types and math helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float32",
                                   "float64"])
def test_dtype_policy_matches_jax(dtype):
    want = jtypes.canonical_float_dtype(dtype)
    for given in (dtype, getattr(torch, dtype), jnp.dtype(dtype)):
        assert str(ttypes.canonical_float_dtype(given)) == f"torch.{want}"
    assert str(ttypes.accumulator_dtype(dtype)) == \
        f"torch.{jtypes.accumulator_dtype(dtype)}"
    assert len(ttypes.SUPPORTED_FLOAT_DTYPES) == len(
        jtypes.SUPPORTED_FLOAT_DTYPES)
    assert getattr(torch, dtype) in ttypes.SUPPORTED_FLOAT_DTYPES


@pytest.mark.parametrize("dtype", ["int32", torch.int64, np.int16, "bogus"])
def test_unsupported_dtypes_raise(dtype):
    with pytest.raises(ValueError, match="Unsupported"):
        ttypes.canonical_float_dtype(dtype)


def test_math_helpers_match_jax():
    rng = np.random.default_rng(1)
    num = rng.normal(size=(7, 5))
    den = rng.normal(size=(7, 5))
    den[0, :3] = [0.0, 1e-13, -5e-13]
    for eps in (1e-12, 0.5):
        got = tmath.safe_divide(torch.as_tensor(num), torch.as_tensor(den),
                                eps)
        want = jmath.safe_divide(jnp.asarray(num), jnp.asarray(den), eps)
        assert_close(got, want, rtol=RTOL)
        assert (got[np.abs(den) < eps] == 0).all()
    x = rng.uniform(0.1, 3.0, (11,))
    assert_close(tmath.exp_over_x(torch.as_tensor(x), 0.7),
                 jmath.exp_over_x(jnp.asarray(x), 0.7), rtol=RTOL)
    pos = rng.normal(size=(2, 9, 3))
    kv = rng.normal(size=(2, 6, 3))
    got = tmath.dot_phases(torch.as_tensor(pos), torch.as_tensor(kv))
    assert got.shape == (2, 9, 6)
    assert_close(got, jmath.dot_phases(jnp.asarray(pos), jnp.asarray(kv)),
                 rtol=RTOL)
    assert torch.equal(nvalchemiops_torch.mathops.dot_phases(
        torch.as_tensor(pos[0]), torch.as_tensor(kv[0])), got[0])


def _host_input_calls():
    """Entry points of the port called with numpy inputs only: ``name ->
    f(host_inputs, **device_kw)``."""
    from nvalchemiops_torch import spline as tsp
    from nvalchemiops_torch.interactions.electrostatics import dense as tdc

    rng = np.random.default_rng(6)
    num, den = rng.normal(size=5), rng.normal(size=5)
    pos = rng.uniform(0, 8.0, (6, 3))
    cell = np.eye(3) * 8.0
    theta = rng.uniform(0, 1, (6, 3))
    offset = rng.integers(-1, 3, (6, 3)).astype(np.int32)
    q = rng.normal(size=6)
    return {
        "element_rows": lambda **kw: tdense.element_rows(
            np.array([0, 2, 1], np.int32), rng.normal(size=(3, 2)), **kw),
        "safe_divide": lambda **kw: tmath.safe_divide(num, den, **kw),
        "exp_over_x": lambda **kw: tmath.exp_over_x(num ** 2 + 0.1, 0.7,
                                                    **kw),
        "dot_phases": lambda **kw: tmath.dot_phases(pos, theta, **kw),
        "wrap_grid_index": lambda **kw: tsp.wrap_grid_index(offset - 2, 16,
                                                            **kw),
        "bspline_grid_offset": lambda **kw: tsp.bspline_grid_offset(
            np.arange(8, dtype=np.int32)[:, None], 2, theta, **kw),
        "compute_fractional_coords": lambda **kw: tsp.compute_fractional_coords(
            pos, cell, (8, 8, 8), **kw),
        "bspline_weight_3d": lambda **kw: tsp.bspline_weight_3d(
            theta, offset, 4, **kw),
        "bspline_weight_gradient_3d": lambda **kw:
            tsp.bspline_weight_gradient_3d(theta, offset, 4, (8, 8, 8),
                                           **kw),
        "dense_coulomb_energy_forces": lambda **kw:
            tdc.dense_coulomb_energy_forces(pos, q, cell, 3.9, 0.3, **kw),
        "batch_dense_coulomb_energy_forces": lambda **kw:
            tdc.batch_dense_coulomb_energy_forces(pos[None], q[None], cell,
                                                  3.9, 0.3, **kw),
        "dftd3": lambda **kw: _dftd3_host_call(pos, cell, rng, **kw),
    }


def _dftd3_host_call(pos, cell, rng, **kw):
    """``dftd3`` on numpy positions, numbers, cell, tables and a
    neighbour matrix of every other atom (no shift)."""
    from nvalchemiops_torch.interactions.dispersion import dftd3

    n = pos.shape[0]
    nm = np.array([[j for j in range(n) if j != i] for i in range(n)],
                  np.int32)
    c6 = rng.uniform(5.0, 40.0, (3, 3, 5, 5))
    c6 = 0.5 * (c6 + np.swapaxes(np.swapaxes(c6, 0, 1), 2, 3))
    cn_ref = np.broadcast_to(np.arange(5.0)[:, None], (3, 3, 5, 5)).copy()
    return dftd3(pos, np.r_[[1, 2] * (n // 2)].astype(np.int32), 0.4, 4.2,
                 1.8, covalent_radii=np.r_[0.0, 0.8, 1.1],
                 r4r2=np.r_[0.0, 3.0, 4.0], c6_reference=c6,
                 coord_num_ref=cn_ref, cell=cell, neighbor_matrix=nm,
                 neighbor_matrix_shifts=np.zeros(nm.shape + (3,), np.int32),
                 **kw)


def _leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("entry", sorted(_host_input_calls()))
def test_host_inputs_run_on_the_card_unless_told(entry):
    """An entry point given no tensor runs on the card by default (where
    there is none, it fails for want of CUDA) and on the CPU with
    ``device="cpu"``."""
    call = _host_input_calls()[entry]
    got = _leaves(call(device="cpu"))
    assert all(t.device.type == "cpu" for t in got)
    if torch.cuda.is_available():
        on_card = _leaves(call())
        assert all(t.device.type == "cuda" for t in on_card)
    else:
        with pytest.raises((AssertionError, RuntimeError),
                           match=r"(?i)cuda|nvidia"):
            call()
    assert ttypes.default_device(np.zeros(3)) == torch.device("cuda")
    assert ttypes.default_device(np.zeros(3), "cpu") == torch.device("cpu")


# ---------------------------------------------------------------------------
# Element rows and the table parser
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(13,), (3, 7)])
def test_element_rows_match_jax(shape):
    rng = np.random.default_rng(2)
    table = rng.normal(size=(6, 5, 4))
    numbers = rng.integers(0, 6, shape).astype(np.int32)
    got = tdense.element_rows(torch.as_tensor(numbers), torch.as_tensor(table))
    want = jdense.element_rows(jnp.asarray(numbers), jnp.asarray(table))
    assert got.shape == shape + (5, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tdense.element_rows(numbers, torch.as_tensor(table)).numpy(),
        np.asarray(want))


DFTD3_F = """
c covalent radii (a comment line in the classic column)
      data rcov /
     . 0.32, 0.46, 1.20, ! He, then Li
     . 0.94, 0.77 /
! a whole-line comment: data r2r4 / 9.9 /
      data r2r4 /
     . 8.0589D+00, 3.4698, 29.0974, 14.8517, 11.8799E0 /
"""
PARS_F = """
      real*8 pars(35)
      pars(1:15)=(/
     . 3.0267e+00, 1.0, 1.0, 0.9118, 0.9118, ! H(CN .91)-H(CN .91)
     . 4.7379e+00, 1.0, 101.0, 0.9118, 0.0,
     . 7.5916e+00, 101.0, 101.0, 0.0, 0.0 /)
      pars(16:35)=(/
     . 1.5583e+00, 2.0, 2.0, 0.0, 0.0,
     . 2.1036e+00, 1.0, 2.0, 0.9118, 0.0,
     . 3.0824e+00, 101.0, 2.0, 0.0, 0.0,
     . 9.9999e+00, 601.0, 1.0, 0.5, 0.9118 /)
"""


def test_parser_matches_jax_on_synthetic_blocks():
    """The port's copy of the parser gives the JAX package's tables
    exactly: D and E exponents, comment lines and inline comments, a
    record with a CN-grid index past 5 skipped, blocks shorter than the
    94 elements."""
    got = td3data.parse_dftd3_fortran(DFTD3_F, PARS_F)
    want = jd3data.parse_dftd3_fortran(DFTD3_F, PARS_F)
    assert sorted(got) == sorted(want) == ["c6ab", "cn_ref", "r4r2", "rcov"]
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["c6ab"][1, 1, 1, 0] == np.float32(4.7379)
    assert got["c6ab"][1, 1, 0, 5 - 1] == 0.0          # code 601 skipped
    np.testing.assert_allclose(got["rcov"][5], (4 / 3) * 0.77 / 0.52917726,
                               rtol=1e-6)
    assert got["rcov"][6] == 0.0


def test_parser_raises_without_a_block():
    with pytest.raises(ValueError, match="r2r4"):
        td3data.parse_dftd3_fortran("      data rcov / 0.32 /\n", PARS_F)
    with pytest.raises(ValueError, match="empty"):
        td3data.parse_dftd3_fortran(
            "      data rcov / /\n      data r2r4 / 1.0 /\n", PARS_F)


# ---------------------------------------------------------------------------
# build_atom_grid_auto
# ---------------------------------------------------------------------------


def _auto_system(kind, n=320, box=14.0, seed=3):
    rng = np.random.default_rng(seed)
    cell = np.eye(3) * box
    if kind == "triclinic":
        cell[1, 0], cell[2, 1] = 1.5, -1.0
    pbc = np.array([True, True, kind != "mixed"])
    pos = rng.uniform(0, 1, (n, 3)) @ cell
    return pos, cell, pbc


def _assert_same_grid(gt, gj):
    assert (gt.dims, gt.radius, gt.cap) == (gj.dims, gj.radius, gj.cap)
    want = grid_fields(gj)
    for f, a in want.items():
        got = getattr(gt, f).numpy()
        if f in ("ext_px", "ext_py", "ext_pz"):
            assert_close(got, a, rtol=RTOL, err_msg=f)
        else:
            np.testing.assert_array_equal(got.astype(np.int64),
                                          a.astype(np.int64), err_msg=f)
    ncells = int(np.prod(gt.dims))
    assert (gt.flat_slot < ncells * gt.cap).all()      # every atom slotted


@pytest.mark.parametrize("kind", ["cubic", "triclinic", "mixed"])
@pytest.mark.parametrize("geometry", [True, False])
def test_build_atom_grid_auto_matches_jax(kind, geometry):
    pos, cell, pbc = _auto_system(kind)
    gj = jgrid.build_atom_grid_auto(jnp.asarray(pos), jnp.asarray(cell), pbc,
                                    4.5, optimize_geometry=geometry)
    gt = tgrid.build_atom_grid_auto(torch.as_tensor(pos),
                                    torch.as_tensor(cell), pbc, 4.5,
                                    optimize_geometry=geometry)
    _assert_same_grid(gt, gj)


def test_build_atom_grid_auto_options_match_jax():
    """The estimate's own knobs and the zero origin, as in JAX."""
    pos, cell, pbc = _auto_system("cubic", seed=4)
    for kw in (dict(optimize_geometry=False, optimize_origin=False),
               dict(optimize_geometry=False, target_occupancy=0.4,
                    bins_per_cutoff=2)):
        gj = jgrid.build_atom_grid_auto(jnp.asarray(pos), jnp.asarray(cell),
                                        pbc, 4.5, **kw)
        gt = tgrid.build_atom_grid_auto(torch.as_tensor(pos),
                                        torch.as_tensor(cell), pbc, 4.5,
                                        **kw)
        _assert_same_grid(gt, gj)


def test_build_atom_grid_auto_rebuilds_a_short_capacity(monkeypatch):
    """A geometry whose capacity is below the build's occupancy is built
    again with the true capacity: no atom is dropped, as in JAX."""
    pos, cell, pbc = _auto_system("cubic", seed=5)
    for mod in (jgrid, tgrid):
        real = mod.choose_grid_geometry

        def short(*a, _real=real, **k):
            dims, radius, _, origin = _real(*a, **k)
            return dims, radius, 8, origin

        monkeypatch.setattr(mod, "choose_grid_geometry", short)
    gj = jgrid.build_atom_grid_auto(jnp.asarray(pos), jnp.asarray(cell), pbc,
                                    4.5)
    gt = tgrid.build_atom_grid_auto(torch.as_tensor(pos),
                                    torch.as_tensor(cell), pbc, 4.5)
    assert gt.cap > 8 and int(gt.counts_max) > 8
    _assert_same_grid(gt, gj)

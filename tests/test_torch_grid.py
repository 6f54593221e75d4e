# SPDX-License-Identifier: Apache-2.0
"""The port's halo atom grid against the JAX package's, in f64 on the CPU.

Integer structures (slots, atom ids, shift codes, occupancy) must be equal;
position planes agree to 1e-12.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvalchemiops_tpu import grid as jgrid
from nvalchemiops_torch import grid as tgrid
from nvalchemiops_torch.neighborlist.neighbor_utils import (
    pack_shifts, unpack_shifts,
)
from tests._torch_port import port_grid


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: Tier-1 runs six test workers on the CPU, and a
    torch thread pool in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {
    "cubic_pbc": (np.diag([12.0, 14.0, 11.0]), [True] * 3, 300, None),
    "open": (np.diag([12.0, 14.0, 11.0]), [False] * 3, 300, None),
    "mixed_pbc": (np.diag([12.0, 14.0, 11.0]), [True, False, True], 300,
                  None),
    "triclinic": (np.array([[12.0, 0, 0], [2.0, 11.0, 0], [-1.0, 1.5, 13.0]]),
                  [True] * 3, 250, None),
    "origin_shift": (np.eye(3) * 12.0, [True] * 3, 200, [0.5, 0.0, 0.5]),
}


def _positions(cell, n, seed):
    rng = np.random.default_rng(seed)
    # include atoms outside the box: periodic axes wrap, open ones clamp
    return rng.uniform(-0.1, 1.1, (n, 3)) @ cell


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_atom_grid_matches_jax(case):
    cell, pbc, n, origin = CASES[case]
    pos = _positions(cell, n, seed=len(case))
    cutoff = 3.2
    dims, radius, cap = jgrid.estimate_grid_geometry(cell, np.array(pbc),
                                                     cutoff, n, 0.4)
    assert tgrid.estimate_grid_geometry(cell, pbc, cutoff, n, 0.4) == (
        dims, radius, cap)
    jo = None if origin is None else jnp.asarray(origin)
    gj = jgrid.build_atom_grid(jnp.asarray(pos), jnp.asarray(cell),
                               np.array(pbc), dims, radius, cap, origin=jo)
    gt = tgrid.build_atom_grid(torch.as_tensor(pos), torch.as_tensor(cell),
                               pbc, dims, radius, cap, origin=origin)
    for f in ("flat_slot", "ext_aid", "ext_shift_code", "ext_valid",
              "counts_max"):
        np.testing.assert_array_equal(getattr(gt, f).numpy(),
                                      np.asarray(getattr(gj, f)), err_msg=f)
    assert gt.ext_aid.dtype == torch.int32
    for f in ("ext_px", "ext_py", "ext_pz"):
        np.testing.assert_allclose(getattr(gt, f).numpy(),
                                   np.asarray(getattr(gj, f)),
                                   rtol=1e-12, atol=1e-12, err_msg=f)


def test_build_atom_grid_overflow_goes_to_trash_slot():
    """Atoms past a cell's capacity land in the trash slot, as in JAX."""
    cell = np.eye(3) * 9.0
    pos = _positions(cell, 200, seed=3)
    dims, radius, cap = (3, 3, 3), (1, 1, 1), 4      # ~7 atoms per cell
    gj = jgrid.build_atom_grid(jnp.asarray(pos), jnp.asarray(cell),
                               np.array([True] * 3), dims, radius, cap)
    gt = tgrid.build_atom_grid(torch.as_tensor(pos), torch.as_tensor(cell),
                               [True] * 3, dims, radius, cap)
    trash = 27 * cap
    assert int(gt.counts_max) > cap
    assert (gt.flat_slot == trash).any()
    np.testing.assert_array_equal(gt.flat_slot.numpy(),
                                  np.asarray(gj.flat_slot))
    np.testing.assert_array_equal(gt.ext_aid.numpy(), np.asarray(gj.ext_aid))


@pytest.mark.parametrize("radius", [(1, 1, 1), (2, 1, 2)])
def test_fold_halo_matches_jax(radius):
    dims = (4, 3, 5)
    rng = np.random.default_rng(5)
    ext = rng.normal(size=tuple(d + 2 * r for d, r in zip(dims, radius))
                     + (6,))

    class _Geom:  # fold_halo reads only dims and radius
        pass

    gj = _Geom()
    gj.dims, gj.radius = dims, radius
    gt = tgrid.AtomGrid(*([None] * 8), dims=dims, radius=radius, cap=6)
    np.testing.assert_allclose(
        tgrid.fold_halo(gt, torch.as_tensor(ext)).numpy(),
        np.asarray(jgrid.fold_halo(gj, jnp.asarray(ext))), rtol=1e-15)


def test_slot_helpers_match_jax():
    cell = np.eye(3) * 10.0
    pos = _positions(cell, 150, seed=9)
    dims, radius, cap = jgrid.estimate_grid_geometry(
        cell, np.array([True] * 3), 3.0, 150, 0.4)
    gj = jgrid.build_atom_grid(jnp.asarray(pos), jnp.asarray(cell),
                               np.array([True] * 3), dims, radius, cap)
    gt = port_grid(gj)
    vals = np.random.default_rng(1).normal(size=(3, 150))
    plane_j = jgrid.scatter_to_grid(gj, jnp.asarray(vals[0]))
    plane_t = tgrid.scatter_to_grid(gt, torch.as_tensor(vals[0]))
    np.testing.assert_array_equal(plane_t.numpy(), np.asarray(plane_j))
    np.testing.assert_array_equal(tgrid.gather_from_grid(gt, plane_t).numpy(),
                                  vals[0])
    rows = tgrid.scatter_rows_to_grid(gt, [torch.as_tensor(v) for v in vals])
    back = tgrid.gather_rows_from_grid(gt, rows)
    for k in range(3):
        np.testing.assert_array_equal(back[k].numpy(), vals[k])
    ext_j = jgrid._extend_like(gj, plane_j, 0.0)
    ext_t = tgrid._extend_like(gt, plane_t, 0.0)
    np.testing.assert_array_equal(ext_t.numpy(), np.asarray(ext_j))


def test_choose_grid_geometry_matches_jax():
    from nvalchemiops_torch.composite import build_system

    pos, cell, *_ = build_system(n_rep=10)
    pbc = np.array([True] * 3)
    gj = jgrid.choose_grid_geometry(jnp.asarray(pos), jnp.asarray(cell), pbc,
                                    6.0)
    gt = tgrid.choose_grid_geometry(torch.as_tensor(pos),
                                    torch.as_tensor(cell), pbc, 6.0)
    assert gt[:3] == gj[:3]
    assert (gt[3] is None) == (gj[3] is None)
    if gt[3] is not None:
        np.testing.assert_array_equal(gt[3], gj[3])
    oj = jgrid.choose_grid_origin(jnp.asarray(pos), jnp.asarray(cell), pbc,
                                  gt[0])
    ot = tgrid.choose_grid_origin(torch.as_tensor(pos), torch.as_tensor(cell),
                                  pbc, gt[0])
    np.testing.assert_array_equal(ot[0], oj[0])
    assert ot[1] == oj[1]


def test_shift_codes_round_trip():
    s = torch.tensor([[-3, 0, 7], [511, -511, 2]], dtype=torch.int32)
    code = pack_shifts(s[:, 0], s[:, 1], s[:, 2])
    from nvalchemiops_tpu.neighborlist.neighbor_utils import (
        pack_shifts as jpack,
    )
    np.testing.assert_array_equal(
        code.numpy(), np.asarray(jpack(*(jnp.asarray(s[:, k].numpy())
                                         for k in range(3)))))
    assert torch.equal(torch.stack(unpack_shifts(code), dim=-1), s)


def test_coulomb_engine_other_than_window_raises():
    gt = tgrid.AtomGrid(*([None] * 8), dims=(1, 1, 1), radius=(1, 1, 1),
                        cap=8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tgrid.grid_coulomb_energy_forces(gt, torch.zeros(3), 3.0,
                                         engine="xla")


def test_import_leaves_jax_out():
    code = ("import sys, nvalchemiops_torch, nvalchemiops_torch.composite, "
            "nvalchemiops_torch.interop, nvalchemiops_torch.kernels.build, "
            "nvalchemiops_torch.stencil, "
            "nvalchemiops_torch.interactions.dispersion.grid_d3, "
            "nvalchemiops_torch.kernels.row_sweep, "
            "nvalchemiops_torch.kernels.chunk_sweep, "
            "nvalchemiops_torch.kernels.stencil_sweep; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
            "if m.startswith('jax'))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr

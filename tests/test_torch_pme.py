# SPDX-License-Identifier: Apache-2.0
"""The port's tile-windowed spline path and PME reciprocal space against
the JAX package, in f64 on the CPU.  The JAX Pallas spread/gather kernels
run in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvalchemiops_tpu import spline as jspline
from nvalchemiops_tpu import spline_windowed as jsw
from nvalchemiops_tpu.interactions.electrostatics import k_vectors as jkv
from nvalchemiops_tpu.interactions.electrostatics import pme as jpme
from nvalchemiops_tpu.pallas.windowed_gather import (
    pallas_spread_windows, pallas_windowed_gather_grad,
)
from nvalchemiops_torch import interop
from nvalchemiops_torch import spline as tspline
from nvalchemiops_torch import spline_windowed as tsw
from nvalchemiops_torch.interactions.electrostatics import k_vectors as tkv
from nvalchemiops_torch.interactions.electrostatics import pme as tpme
from nvalchemiops_torch.kernels import windowed_gather as twg
from tests._torch_port import assert_close, random_system


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: Tier-1 runs six test workers on the CPU, and a
    torch thread pool in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MESH = (16, 16, 24)
ALPHA = 0.45


@pytest.fixture(scope="module")
def system():
    pos, cell, _, q = random_system(seed=31, n=190, box=10.0)
    cell = cell @ np.array([[1.0, 0.0, 0.0], [0.1, 1.0, 0.0],
                            [-0.05, 0.08, 1.0]])      # a little triclinic
    q = q - q.mean()
    return pos, cell, q


@pytest.fixture(scope="module")
def tiles(system):
    pos, cell, _ = system
    cap = jsw.observed_tile_capacity(jnp.asarray(pos), jnp.asarray(cell),
                                     MESH)
    assert tsw.observed_tile_capacity(torch.as_tensor(pos),
                                      torch.as_tensor(cell), MESH) == cap
    tj = jsw.build_mesh_tiles(jnp.asarray(pos), jnp.asarray(cell), MESH, 4,
                              cap)
    tt = tsw.build_mesh_tiles(torch.as_tensor(pos), torch.as_tensor(cell),
                              MESH, 4, cap)
    return tj, tt


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_bspline_basis_matches_jax(order):
    u = np.linspace(-0.5, order + 0.5, 97)
    for tf, jf in ((tspline.bspline_weight, jspline.bspline_weight),
                   (tspline.bspline_derivative, jspline.bspline_derivative)):
        np.testing.assert_array_equal(tf(torch.as_tensor(u), order).numpy(),
                                      np.asarray(jf(jnp.asarray(u), order)))


@pytest.mark.parametrize("triclinic", [False, True])
def test_build_mesh_tiles_matches_jax(system, triclinic):
    """Slot maps equal; smat within 1e-12 of its scale: the port's
    stencil weights are the local forms in ``theta`` (better conditioned
    in f32) where the JAX package's are the expanded forms in ``u``, and a
    triclinic cell's inverse differs in the last bit between the two
    linear-algebra backends."""
    pos, cell, _ = system
    if not triclinic:
        cell = np.diag(np.diag(cell))
    cap = 32
    tj = jsw.build_mesh_tiles(jnp.asarray(pos), jnp.asarray(cell), MESH, 4,
                              cap)
    tt = tsw.build_mesh_tiles(torch.as_tensor(pos), torch.as_tensor(cell),
                              MESH, 4, cap)
    assert_close(tt.smat, tj.smat, rtol=1e-12)
    for f in ("flat_slot", "aid", "counts_max"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(tj, f)), err_msg=f)
    assert tt.w_win == tj.w_win == 12


def _tiles_from_jax(tj):
    fields = {f: np.asarray(getattr(tj, f))
              for f in interop.MESH_TILES_FIELDS}
    return interop.mesh_tiles_from_numpy(fields, tj.mesh_dims, tj.tile,
                                         tj.cap, tj.order, tj.has_grad,
                                         device="cpu")


def test_windowed_spread_matches_jax(system, tiles):
    tj, _ = tiles
    tt = _tiles_from_jax(tj)
    q = system[2]
    mesh_j = jsw.windowed_spread(tj, jnp.asarray(q))
    assert_close(tsw.windowed_spread(tt, torch.as_tensor(q)), mesh_j,
                 rtol=1e-12)


def test_windowed_gather_matches_jax(tiles):
    tj, _ = tiles
    tt = _tiles_from_jax(tj)
    mesh = np.random.default_rng(2).normal(size=MESH)
    v_j, g_j = jsw.windowed_gather(tj, jnp.asarray(mesh), with_gradient=True)
    v_t, g_t = tsw.windowed_gather(tt, torch.as_tensor(mesh),
                                   with_gradient=True)
    assert_close(v_t, v_j, rtol=1e-12)
    assert_close(g_t, g_j, rtol=1e-12)
    assert_close(tsw.windowed_gather(tt, torch.as_tensor(mesh)),
                 jsw.windowed_gather(tj, jnp.asarray(mesh)), rtol=1e-12)


def test_plain_kernels_match_jax_pallas_interpret(system):
    """The kernels' plain versions vs the JAX Pallas kernels they replace
    (interpret mode).  Those kernels fix float32 accumulation, so this
    comparison runs in f32: tolerance 1e-5 of each output's scale (the two
    sum ~cap * W^2 products in different orders)."""
    pos, cell, q = system
    f32 = jnp.float32
    tj = jsw.build_mesh_tiles(jnp.asarray(pos, f32), jnp.asarray(cell, f32),
                              MESH, 4, 32)
    tt = _tiles_from_jax(tj)
    assert tt.smat.dtype == torch.float32
    q_t = torch.cat([torch.as_tensor(q, dtype=torch.float32),
                     torch.zeros(1)])[tt.aid.long()].reshape(-1, tt.cap)
    win_j = pallas_spread_windows(tj, jnp.asarray(q_t.numpy()),
                                  interpret=True)
    assert_close(twg.spread_windows(tt.smat, q_t, tt.w_win), win_j,
                 rtol=1e-5)
    mesh = np.random.default_rng(3).normal(size=MESH).astype(np.float32)
    v_p, g_p = pallas_windowed_gather_grad(tj, jnp.asarray(mesh),
                                           interpret=True)
    v_t, g_t = tsw.windowed_gather(tt, torch.as_tensor(mesh),
                                   with_gradient=True)
    assert_close(v_t, v_p, rtol=1e-5)
    assert_close(g_t, g_p, rtol=1e-5)


def test_k_vectors_match_jax(system):
    cell = system[1]
    kv_j, k2_j = jkv.generate_k_vectors_pme(jnp.asarray(cell), MESH)
    kv_t, k2_t = tkv.generate_k_vectors_pme(torch.as_tensor(cell), MESH)
    assert_close(kv_t, kv_j, rtol=1e-13)
    assert_close(k2_t, k2_j, rtol=1e-13)


@pytest.mark.parametrize("compute_forces", [True, False])
def test_pme_reciprocal_space_matches_jax(system, compute_forces):
    pos, cell, q = system
    cap = tsw.observed_tile_capacity(torch.as_tensor(pos),
                                     torch.as_tensor(cell), MESH)
    kw = dict(mesh_dimensions=MESH, compute_forces=compute_forces,
              compute_charge_gradients=True, tile_capacity=cap)
    out_j = jpme.pme_reciprocal_space(jnp.asarray(pos), jnp.asarray(q),
                                      jnp.asarray(cell), ALPHA, **kw)
    out_t = tpme.pme_reciprocal_space(torch.as_tensor(pos),
                                      torch.as_tensor(q),
                                      torch.as_tensor(cell), ALPHA, **kw)
    assert len(out_t) == len(out_j) == (3 if compute_forces else 2)
    for a, b in zip(out_t, out_j):
        assert_close(a, b, rtol=1e-9)


def test_pme_raises_where_jax_falls_back(system):
    """Tile overflow falls back to the dense path, as in the JAX package;
    so does a mesh the windowed path does not support (15 x 16 x 16),
    which used to raise."""
    pos, cell, q = system
    args = (torch.as_tensor(pos), torch.as_tensor(q), torch.as_tensor(cell),
            ALPHA)
    jargs = (jnp.asarray(pos), jnp.asarray(q), jnp.asarray(cell), ALPHA)
    for kw in (dict(mesh_dimensions=MESH, tile_capacity=1),
               dict(mesh_dimensions=(15, 16, 16))):
        out_t = tpme.pme_reciprocal_space(*args, compute_forces=True, **kw)
        out_j = jpme.pme_reciprocal_space(*jargs, compute_forces=True, **kw)
        for a, b in zip(out_t, out_j):
            assert_close(a, b, rtol=1e-9)


def test_gather_kernel_wrapper_checks(tiles):
    _, tt = tiles
    win = torch.zeros(tt.smat.shape[0], 12, 144, dtype=torch.float64)
    with pytest.raises(ValueError, match="do not match"):
        twg.gather_grad_planes(tt.smat[..., :36], win, 12)
    with pytest.raises(ValueError, match="unsupported device"):
        twg.gather_grad_planes(tt.smat.to("meta"), win.to("meta"), 12)

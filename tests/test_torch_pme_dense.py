# SPDX-License-Identifier: Apache-2.0
"""The port's dense separable spline path and batched PME against the JAX
package, in f64 on the CPU; the separable kernels' plain versions against
the JAX Pallas kernels they replace (interpret mode, f32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvalchemiops_tpu import spline as jspline
from nvalchemiops_tpu.interactions.electrostatics import pme as jpme
from nvalchemiops_tpu.pallas.spread import (
    pallas_separable_gather, pallas_separable_spread,
)
from nvalchemiops_torch import spline as tspline
from nvalchemiops_torch.interactions.electrostatics import pme as tpme
from nvalchemiops_torch.kernels import separable_spline as tss
from tests._torch_port import assert_close

MESH = (16, 12, 20)        # any dims: the dense path needs no tiles
ALPHA = 0.4


def _systems(seed, b, n, box=9.0, triclinic=True):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.5, box + 0.5, (b, n, 3))
    q = rng.normal(size=(b, n))
    q = q - q.mean(axis=1, keepdims=True)
    shear = np.array([[1.0, 0.0, 0.0], [0.08, 1.0, 0.0], [-0.05, 0.1, 1.0]])
    cells = np.stack([np.eye(3) * (box + 0.3 * i)
                      @ (shear if triclinic else np.eye(3))
                      for i in range(b)])
    return pos, q, cells


def test_stencil_matches_jax():
    pos, _, cells = _systems(51, 1, 120)
    gj, wj, dwj, invj = jspline._stencil(jnp.asarray(pos[0]),
                                         jnp.asarray(cells[0]), MESH, 4,
                                         None)
    gt, wt, dwt, invt = tspline._stencil(torch.as_tensor(pos[0]),
                                         torch.as_tensor(cells[0]), MESH, 4)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    assert gt.dtype == torch.int32
    assert_close(wt, wj, rtol=1e-9)
    assert_close(dwt, dwj, rtol=1e-9)
    assert_close(invt, invj[0], rtol=1e-12)


@pytest.mark.parametrize("fn", ["spread", "gather", "gradient"])
def test_dense_single_matches_jax(fn):
    pos, q, cells = _systems(52, 1, 150)
    pos, q, cell = pos[0], q[0], cells[0]
    mesh = np.random.default_rng(53).normal(size=MESH)
    jargs = (jnp.asarray(pos), jnp.asarray(cell))
    targs = (torch.as_tensor(pos), torch.as_tensor(cell))
    if fn == "spread":
        want = jspline.dense_spread_single(jargs[0], jnp.asarray(q),
                                           jargs[1], MESH)
        got = tspline.dense_spread_single(targs[0], torch.as_tensor(q),
                                          targs[1], MESH)
    elif fn == "gather":
        want = jspline.dense_gather_single(jargs[0], jnp.asarray(mesh),
                                           jargs[1])
        got = tspline.dense_gather_single(targs[0], torch.as_tensor(mesh),
                                          targs[1])
    else:
        want = jspline.dense_gather_gradient_single(
            jargs[0], jnp.asarray(q), jnp.asarray(mesh), jargs[1])
        got = tspline.dense_gather_gradient_single(
            targs[0], torch.as_tensor(q), torch.as_tensor(mesh), targs[1])
    assert tuple(got.shape) == tuple(np.shape(want))
    assert_close(got, want, rtol=1e-9)


def test_dense_batch_axis_equals_per_system():
    pos, q, cells = _systems(54, 3, 80)
    pos_t, q_t, cells_t = (torch.as_tensor(a) for a in (pos, q, cells))
    mesh_b = tspline.dense_spread_single(pos_t, q_t, cells_t, MESH)
    f_b = tspline.dense_gather_gradient_single(pos_t, q_t, mesh_b, cells_t)
    for i in range(3):
        mesh_1 = tspline.dense_spread_single(pos_t[i], q_t[i], cells_t[i],
                                             MESH)
        assert_close(mesh_b[i], mesh_1, rtol=1e-13)
        assert_close(f_b[i], tspline.dense_gather_gradient_single(
            pos_t[i], q_t[i], mesh_1, cells_t[i]), rtol=1e-13)


def test_plain_kernels_match_jax_pallas_interpret():
    """Plain spread and gather (one pass: value + three derivative gathers)
    against ``pallas_separable_spread`` / ``pallas_separable_gather`` in
    interpret mode, fed the same stencil.  The Pallas kernels accumulate in
    float32, so this compares in f32: 1e-5 of each output's scale."""
    f32 = jnp.float32
    pos, q, cells = _systems(55, 1, 200)
    pos_j, cell_j = jnp.asarray(pos[0], f32), jnp.asarray(cells[0], f32)
    gidx, w, dw, _ = jspline._stencil(pos_j, cell_j, MESH, 4, None)
    mats = [jspline._axis_weight_matrix(gidx[:, d], w[:, d], MESH[d])
            for d in range(3)]
    dmats = [jspline._axis_weight_matrix(gidx[:, d], dw[:, d], MESH[d])
             for d in range(3)]
    q32 = jnp.asarray(q[0], f32)
    mesh_j = pallas_separable_spread(q32[:, None] * mats[0], mats[1],
                                     mats[2], interpret=True)
    g_t, w_t, dw_t = (torch.as_tensor(np.array(a))[None]
                      for a in (gidx, w, dw))
    mesh_t = tss.separable_spread(g_t.contiguous(), w_t.contiguous(),
                                  torch.as_tensor(np.array(q32))[None],
                                  MESH)
    assert mesh_t.dtype == torch.float32
    assert_close(mesh_t[0], mesh_j, rtol=1e-5)

    pot = np.random.default_rng(56).normal(size=MESH).astype(np.float32)
    val_j = pallas_separable_gather(jnp.asarray(pot), *mats, interpret=True)
    grad_j = [pallas_separable_gather(
        jnp.asarray(pot), *[dmats[k] if k == d else mats[k]
                            for k in range(3)], interpret=True)
        for d in range(3)]
    val_t, grad_t = tss.separable_gather(torch.as_tensor(pot)[None], g_t,
                                         w_t, dw_t)
    assert_close(val_t[0], val_j, rtol=1e-5)
    for d in range(3):
        assert_close(grad_t[0, :, d], grad_j[d], rtol=1e-5)


@pytest.mark.parametrize("engine", ["dense", "windowed"])
@pytest.mark.parametrize("pattern", ["e", "ef", "eg", "efg"])
def test_batch_pme_reciprocal_matches_jax(engine, pattern):
    """Per-system alpha and cells; JAX with its XLA FFT.  The windowed
    engine runs 16-point tiles at this 16^3 mesh, as in the JAX package."""
    mesh = (16, 16, 16)
    pos, q, cells = _systems(57, 2, 90)
    alphas = np.array([0.4, 0.45])
    kw = dict(compute_forces="f" in pattern,
              compute_charge_gradients="g" in pattern, engine=engine)
    out_j = jpme.batch_pme_reciprocal(jnp.asarray(pos), jnp.asarray(q),
                                      jnp.asarray(cells),
                                      jnp.asarray(alphas), mesh,
                                      fft_mode="xla", **kw)
    out_t = tpme.batch_pme_reciprocal(torch.as_tensor(pos),
                                      torch.as_tensor(q),
                                      torch.as_tensor(cells),
                                      torch.as_tensor(alphas), mesh, **kw)
    if pattern == "e":
        out_j, out_t = (out_j,), (out_t,)
    assert len(out_t) == len(out_j) == len(pattern)
    for a, b in zip(out_t, out_j):
        assert tuple(a.shape) == tuple(np.shape(b))
        assert_close(a, b, rtol=1e-9)


def test_batch_pme_shared_cell_and_auto_engine():
    """Shared ``[3, 3]`` cell, scalar alpha: auto picks dense at 16^3, as
    in the JAX package, and equals the forced dense engine."""
    mesh = (16, 16, 16)
    pos, q, cells = _systems(58, 2, 70, triclinic=False)
    args = (torch.as_tensor(pos), torch.as_tensor(q),
            torch.as_tensor(cells[0]), ALPHA, mesh)
    e_a, f_a = tpme.batch_pme_reciprocal(*args, compute_forces=True)
    e_d, f_d = tpme.batch_pme_reciprocal(*args, compute_forces=True,
                                         engine="dense")
    assert torch.equal(e_a, e_d) and torch.equal(f_a, f_d)
    e_j, f_j = jpme.batch_pme_reciprocal(
        jnp.asarray(pos), jnp.asarray(q), jnp.asarray(cells[0]), ALPHA,
        mesh, compute_forces=True, fft_mode="xla")
    assert_close(e_a, e_j, rtol=1e-9)
    assert_close(f_a, f_j, rtol=1e-9)
    assert abs(float(f_a.sum(1).abs().max())) < 1e-10    # net force removed


@pytest.mark.parametrize("compute_forces", [True, False])
def test_pme_overflow_fallback_matches_jax(compute_forces):
    """``pme_reciprocal_space`` with a too-small ``tile_capacity`` takes
    the dense path; the JAX package falls back the same way."""
    mesh = (16, 16, 24)
    pos, q, cells = _systems(59, 1, 180)
    kw = dict(mesh_dimensions=mesh, compute_forces=compute_forces,
              compute_charge_gradients=True, tile_capacity=8)
    out_j = jpme.pme_reciprocal_space(jnp.asarray(pos[0]), jnp.asarray(q[0]),
                                      jnp.asarray(cells[0]), ALPHA, **kw)
    out_t = tpme.pme_reciprocal_space(torch.as_tensor(pos[0]),
                                      torch.as_tensor(q[0]),
                                      torch.as_tensor(cells[0]), ALPHA, **kw)
    assert len(out_t) == len(out_j)
    for a, b in zip(out_t, out_j):
        assert_close(a, b, rtol=1e-9)


def test_batch_pme_and_kernel_checks():
    pos, q, cells = _systems(60, 1, 10)
    args = (torch.as_tensor(pos), torch.as_tensor(q), torch.as_tensor(cells),
            ALPHA)
    with pytest.raises(ValueError, match="not supported"):
        tpme.batch_pme_reciprocal(*args, (12, 12, 12))
    with pytest.raises(ValueError, match="unknown batched PME engine"):
        tpme.batch_pme_reciprocal(*args, (16, 16, 16), engine="matmul")
    g = torch.zeros(1, 10, 3, 4, dtype=torch.int32)
    w = torch.zeros(1, 10, 3, 4)
    with pytest.raises(ValueError, match=r"\[B, N\]"):
        tss.separable_spread(g, w, torch.zeros(10), (8, 8, 8))
    with pytest.raises(ValueError, match="must match w"):
        tss.separable_gather(torch.zeros(1, 8, 8, 8), g, w, w[..., :2])
    with pytest.raises(ValueError, match="unsupported device"):
        tss.separable_spread(g.to("meta"), w.to("meta"),
                             torch.zeros(1, 10, device="meta"), (8, 8, 8))

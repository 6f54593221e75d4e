# SPDX-License-Identifier: Apache-2.0
"""The port's spline API against the JAX package's, on the CPU: the basis
helpers and the deconvolution, the multi-channel and vector-field spreads
and gathers on each of their routes (tile-windowed, the dense fallback
after a tile overflow or on a mesh the windows reject, and ``batch_idx``),
the mesh-tile rebuild detector and refresh, and the f32 B-spline weights
of the single-system PME.

f64 outputs are held at 1e-10 of their scale (the helpers at 1e-12),
integer outputs exactly; one f32 case per entry point at 1.25x the JAX
package's own f32-vs-f64 error.  The kernels run their plain versions
here; each channel is also held to its own single-channel call.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvalchemiops_torch import interop
from nvalchemiops_torch import spline as tsp
from nvalchemiops_torch import spline_windowed as tsw
from nvalchemiops_torch.interactions.electrostatics import pme as tpme
from nvalchemiops_tpu import spline as jsp
from nvalchemiops_tpu import spline_windowed as jsw
from nvalchemiops_tpu.interactions.electrostatics import pme as jpme

from tests._torch_port import assert_close

F64 = torch.float64
RTOL = 1e-10
MESH = (16, 16, 16)

#: the JAX tile build as one compiled program (op by op it compiles each
#: operation on its first call, ~10 s on the CPU)
_jax_tiles = jax.jit(jsw.build_mesh_tiles, static_argnums=(2, 3, 4),
                     static_argnames=("tile", "need_grad"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: Tier-1 runs six test workers on the CPU, and a
    torch thread pool in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _err(a, ref):
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    r = np.asarray(ref, np.float64)
    return np.abs(a - r).max() / np.abs(r).max()


def _cell(box=10.0):
    cell = np.eye(3) * box
    cell[0, 1], cell[1, 2] = 0.5, -0.3
    return cell


# ---------------------------------------------------------------------------
# Basis helpers and deconvolution
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_stencil_helpers_match_jax(order):
    rng = np.random.default_rng(10 + order)
    cell = _cell()
    pos = rng.uniform(0, 1, (11, 3)) @ cell
    dims = (16, 20, 24)
    bj, tj = jsp.compute_fractional_coords(jnp.asarray(pos), jnp.asarray(cell),
                                           dims)
    bt, tt = tsp.compute_fractional_coords(torch.as_tensor(pos),
                                           torch.as_tensor(cell), dims)
    assert bt.dtype == torch.int32
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    assert_close(tt, tj, rtol=1e-12)

    pts = np.arange(order ** 3)[:, None] * np.ones((11,), np.int32)
    oj = jsp.bspline_grid_offset(jnp.asarray(pts), order, tj[None])
    ot = tsp.bspline_grid_offset(torch.as_tensor(pts), order, tt[None])
    assert ot.dtype == torch.int32
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    assert_close(tsp.bspline_weight_3d(tt[None], ot, order),
                 jsp.bspline_weight_3d(tj[None], oj, order), rtol=1e-12)
    assert_close(tsp.bspline_weight_gradient_3d(tt[None], ot, order, dims),
                 jsp.bspline_weight_gradient_3d(tj[None], oj, order, dims),
                 rtol=1e-12)
    absolute = bt[None] + ot
    wt = tsp.wrap_grid_index(absolute, torch.tensor(dims))
    wj = jsp.wrap_grid_index(jnp.asarray(absolute.numpy()), jnp.asarray(dims))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    assert int(tsp.wrap_grid_index(-3, 16, device="cpu")) == 13


def test_fractional_coords_with_batch_idx_match_jax():
    rng = np.random.default_rng(14)
    cells = np.stack([_cell(9.0), np.eye(3) * 10.0, _cell(11.0)])
    bidx = np.repeat(np.arange(3), 7).astype(np.int32)
    pos = np.concatenate([rng.uniform(0, 1, (7, 3)) @ c for c in cells])
    bj, tj = jsp.compute_fractional_coords(jnp.asarray(pos),
                                           jnp.asarray(cells), MESH,
                                           jnp.asarray(bidx))
    bt, tt = tsp.compute_fractional_coords(torch.as_tensor(pos),
                                           torch.as_tensor(cells), MESH,
                                           torch.as_tensor(bidx))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    assert_close(tt, tj, rtol=1e-12)


@pytest.mark.parametrize("order", [1, 2, 3, 4, 5])
def test_deconvolution_matches_jax(order):
    for n in (5, 6, 8):   # the 3-D case's axes: one compile each
        assert_close(
            tsp.compute_bspline_deconvolution_1d(n, order, device="cpu"),
            jsp.compute_bspline_deconvolution_1d(n, order), rtol=1e-12)
    got = tsp.compute_bspline_deconvolution((8, 5, 6), order, device="cpu")
    assert got.shape == (8, 5, 6) and got.dtype == F64
    assert_close(got, jsp.compute_bspline_deconvolution((8, 5, 6), order),
                 rtol=1e-12)


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_stencils_and_tiles_match_jax_in_f64(order):
    """The local-form weights of the dense stencil and of the mesh tiles
    equal the JAX package's expanded forms to 1e-12 of their scale, at
    the same indices and slots."""
    pos, _, _, cell = _md_system(seed=20 + order)
    cap = tsw.mesh_tile_capacity(pos.shape[0], MESH)
    gj, wj, dwj, _ = jsp._stencil(jnp.asarray(pos), jnp.asarray(cell), MESH,
                                  order, None)
    gt, wt, dwt, _ = tsp._stencil(torch.as_tensor(pos),
                                  torch.as_tensor(cell), MESH, order)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    assert_close(wt, wj, rtol=1e-12)
    assert_close(dwt, dwj, rtol=1e-12)
    tj = _jax_tiles(jnp.asarray(pos), jnp.asarray(cell), MESH, order, cap)
    tt = tsw.build_mesh_tiles(torch.as_tensor(pos), torch.as_tensor(cell),
                              MESH, order, cap)
    assert_close(tt.smat, tj.smat, rtol=1e-12)
    for f in ("flat_slot", "aid"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(tj, f)))


# ---------------------------------------------------------------------------
# Channels and vector fields
# ---------------------------------------------------------------------------


def _route_system(route, dtype=np.float64, seed=30):
    """``(positions, cell, batch_idx, mesh_dims)`` of one route: one system
    the windows take, one whose atoms crowd a tile past its capacity, one
    on a mesh the windows reject, three concatenated systems.  Every route
    holds 100 atoms, so the JAX package compiles its shared operations
    once."""
    rng = np.random.default_rng(seed)
    bidx = None
    mesh = MESH
    cell = _cell()
    if route == "windowed":
        pos = rng.uniform(0, 1, (100, 3)) @ cell
    elif route == "overflow":
        pos = rng.uniform(0.5, 4.5, (100, 3))
        cell = np.eye(3) * 10.0
    elif route == "rejected":
        pos = rng.uniform(0, 1, (100, 3)) @ cell
        mesh = (15, 16, 16)
    else:
        cell = np.stack([_cell(9.0), np.eye(3) * 10.0, _cell(11.0)])
        sizes = (34, 33, 33)
        pos = np.concatenate([rng.uniform(0, 1, (k, 3)) @ c
                              for k, c in zip(sizes, cell)])
        bidx = np.repeat(np.arange(3), sizes).astype(np.int32)
    return pos.astype(dtype), cell.astype(dtype), bidx, mesh


def _args(route, pkg, dtype=np.float64):
    pos, cell, bidx, mesh = _route_system(route, dtype)
    if pkg == "jax":
        return (jnp.asarray(pos), jnp.asarray(cell),
                None if bidx is None else jnp.asarray(bidx), mesh)
    return (torch.as_tensor(pos), torch.as_tensor(cell),
            None if bidx is None else torch.as_tensor(bidx), mesh)


def _fields(route, n_sys, mesh, dtype=np.float64, seed=31):
    """Per-atom channel values ``[N, 3]``, charges ``[N]``, channel meshes
    ``[.., 3, nx, ny, nz]`` and vector meshes ``[.., nx, ny, nz, 3]``."""
    rng = np.random.default_rng(seed)
    n = _route_system(route)[0].shape[0]
    lead = () if route != "batch_idx" else (n_sys,)
    return (rng.normal(size=(n, 3)).astype(dtype),
            rng.normal(size=n).astype(dtype),
            rng.normal(size=lead + (3,) + mesh).astype(dtype),
            rng.normal(size=lead + mesh + (3,)).astype(dtype))


def _call(pkg, entry, route, dtype=np.float64):
    mod = jsp if pkg == "jax" else tsp
    pos, cell, bidx, mesh = _args(route, pkg, dtype)
    vals, q, cmesh, vmesh = _fields(route, 3, mesh, dtype)
    conv = jnp.asarray if pkg == "jax" else torch.as_tensor
    if entry == "spread_channels":
        return mod.spline_spread_channels(pos, conv(vals), cell, mesh, 4,
                                          bidx)
    if entry == "gather_channels":
        return mod.spline_gather_channels(pos, conv(cmesh), cell, 4, bidx)
    return mod.spline_gather_vec3(pos, conv(q), conv(vmesh), cell, 4, bidx)


ROUTES = ["windowed", "overflow", "rejected", "batch_idx"]
ENTRIES = ["spread_channels", "gather_channels", "gather_vec3"]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("entry", ENTRIES)
def test_channel_api_matches_jax(entry, route):
    got = _call("torch", entry, route)
    want = _call("jax", entry, route)
    assert tuple(got.shape) == tuple(want.shape)
    assert_close(got, want, rtol=RTOL)


@pytest.mark.parametrize("route", ROUTES)
def test_each_channel_is_its_single_channel_call(route):
    """Every channel equals its own ``spline_spread`` / ``spline_gather``
    call bit for bit: one launch per channel on every route."""
    pos, cell, bidx, mesh = _args(route, "torch")
    vals, q, cmesh, vmesh = (torch.as_tensor(a)
                             for a in _fields(route, 3, mesh))
    spread = tsp.spline_spread_channels(pos, vals, cell, mesh, 4, bidx)
    chan = tsp.spline_gather_channels(pos, cmesh, cell, 4, bidx)
    vec = tsp.spline_gather_vec3(pos, q, vmesh, cell, 4, bidx)
    cax = 1 if bidx is not None else 0
    for c in range(3):
        one = tsp.spline_spread(pos, vals[:, c].contiguous(), cell, mesh, 4,
                                bidx)
        assert torch.equal(spread.select(cax, c), one)
        assert torch.equal(chan[:, c], tsp.spline_gather(
            pos, cmesh.select(cax, c), cell, 4, bidx))
        assert torch.equal(vec[:, c], q * tsp.spline_gather(
            pos, vmesh[..., c], cell, 4, bidx))


@pytest.mark.parametrize("entry", ENTRIES)
def test_channel_api_f32_within_jax_bar(entry):
    ref = _call("jax", entry, "windowed")
    j32 = _call("jax", entry, "windowed", np.float32)
    t32 = _call("torch", entry, "windowed", np.float32)
    assert t32.dtype == torch.float32
    bar = 1.25 * _err(j32, ref)
    assert 0.0 < _err(t32, ref) <= bar, (_err(t32, ref), bar)


# ---------------------------------------------------------------------------
# Mesh-tile rebuild detector and refresh
# ---------------------------------------------------------------------------


def _md_system(n=300, box=12.0, seed=40):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, box, (n, 3))
    cell = np.eye(3) * box
    # a nudge that keeps every atom inside its tile (tile = 8 mesh points)
    inside = (pos * MESH[0] / box) % 8.0
    safe = ((inside > 0.2) & (inside < 7.3)).all(axis=1)
    pos2 = pos + np.where(safe[:, None], 1e-3, 0.0)
    pos3 = pos.copy()
    pos3[7] = (pos3[7] + box / 2.0) % box      # a full tile away
    return pos, pos2, pos3, cell


def _tile_state(t):
    return {f: getattr(t, f) for f in ("smat", "flat_slot", "aid")}


def _assert_tiles_equal(a, b):
    for f, v in _tile_state(a).items():
        assert torch.equal(v, getattr(b, f)), f


@pytest.mark.parametrize("grad", [False, True])
def test_refresh_equals_a_fresh_build_and_jax(grad):
    pos, pos2, pos3, cell = _md_system()
    cap = tsw.mesh_tile_capacity(pos.shape[0], MESH)
    tt = tsw.build_mesh_tiles(torch.as_tensor(pos), torch.as_tensor(cell),
                              MESH, 4, cap, need_grad=grad)
    tj = _jax_tiles(jnp.asarray(pos), jnp.asarray(cell), MESH, 4, cap,
                    need_grad=grad)
    p2 = torch.as_tensor(pos2)
    flag = tsw.mesh_tiles_need_rebuild(tt, p2)
    assert flag.dim() == 0 and flag.dtype == torch.bool
    assert not bool(flag)
    assert not bool(jsw.mesh_tiles_need_rebuild(tj, jnp.asarray(pos2)))
    refreshed = tsw.refresh_mesh_tiles(tt, p2)
    _assert_tiles_equal(refreshed, tsw.build_mesh_tiles(
        p2, torch.as_tensor(cell), MESH, 4, cap, need_grad=grad))
    _assert_tiles_equal(refreshed, tsw.refresh_mesh_tiles(
        tt, p2, torch.as_tensor(cell)))
    rj = jsw.refresh_mesh_tiles(tj, jnp.asarray(pos2))
    assert_close(refreshed.smat, rj.smat, rtol=1e-12)
    assert (refreshed.has_grad, refreshed.cap) == (grad, cap)
    assert bool(tsw.mesh_tiles_need_rebuild(tt, torch.as_tensor(pos3)))
    assert bool(jsw.mesh_tiles_need_rebuild(tj, jnp.asarray(pos3)))


def test_refresh_of_jax_tiles_matches_jax():
    """Tiles built by the JAX package, carried over, refreshed by the port,
    against the JAX package's refresh; the detector agrees on them."""
    pos, pos2, pos3, cell = _md_system(seed=42)
    cap = jsw.mesh_tile_capacity(pos.shape[0], MESH)
    tj = _jax_tiles(jnp.asarray(pos), jnp.asarray(cell), MESH, 4, cap)
    fields = {f: np.asarray(getattr(tj, f))
              for f in interop.MESH_TILES_FIELDS}
    tt = interop.mesh_tiles_from_numpy(fields, tj.mesh_dims, tj.tile, tj.cap,
                                       tj.order, tj.has_grad, device="cpu")
    for p in (pos2, pos3):
        assert bool(tsw.mesh_tiles_need_rebuild(tt, torch.as_tensor(p))) == \
            bool(jsw.mesh_tiles_need_rebuild(tj, jnp.asarray(p)))
    rt = tsw.refresh_mesh_tiles(tt, torch.as_tensor(pos2))
    rj = jsw.refresh_mesh_tiles(tj, jnp.asarray(pos2), jnp.asarray(cell))
    assert_close(rt.smat, rj.smat, rtol=1e-12)
    for f in ("flat_slot", "aid"):
        np.testing.assert_array_equal(getattr(rt, f).numpy(),
                                      np.asarray(getattr(rj, f)))


def test_build_overflow_forces_a_rebuild():
    """Atoms past a tile's capacity at build time force a rebuild even
    where nothing moved, as in JAX."""
    pos, _, _, cell = _md_system(seed=44)
    for cap in (8, tsw.mesh_tile_capacity(pos.shape[0], MESH)):
        tt = tsw.build_mesh_tiles(torch.as_tensor(pos), torch.as_tensor(cell),
                                  MESH, 4, cap)
        tj = _jax_tiles(jnp.asarray(pos), jnp.asarray(cell), MESH, 4, cap)
        got = bool(tsw.mesh_tiles_need_rebuild(tt, torch.as_tensor(pos)))
        assert got == bool(jsw.mesh_tiles_need_rebuild(tj, jnp.asarray(pos)))
        assert got == (cap == 8)


# ---------------------------------------------------------------------------
# f32 B-spline weights of the single-system PME
# ---------------------------------------------------------------------------


def _pme_system():
    rng = np.random.default_rng(50)
    cell = _cell()
    pos = rng.uniform(0, 1, (120, 3)) @ cell
    q = rng.normal(size=120)
    return pos, q - q.mean(), cell


def _pme(pkg, dtype, mesh, cap):
    pos, q, cell = _pme_system()
    if pkg == "jax":
        conv, mod = (lambda a: jnp.asarray(a, dtype)), jpme
    else:
        tdt = {np.float64: F64, np.float32: torch.float32}[dtype]
        conv, mod = (lambda a: torch.as_tensor(a, dtype=tdt)), tpme
    return mod.pme_reciprocal_space(conv(pos), conv(q), conv(cell), 0.4,
                                    mesh, compute_forces=True,
                                    tile_capacity=cap)


@functools.lru_cache(maxsize=None)
def _jax_pme_f64(mesh):
    """The JAX package's f64 result on ``mesh``, shared by the routes that
    use it: on one mesh its windowed and dense routes agree far below any
    f32 error, so one compiled program serves both."""
    return _pme("jax", np.float64, mesh, None)


@pytest.mark.parametrize("route", ["windowed", "tile overflow",
                                   "rejected mesh"])
def test_single_system_pme_f32_within_jax_bar(route):
    """One system, no ``batch_idx``: the windowed engine and the dense
    route, each within 1.25x the JAX package's own f32 error (on the same
    route) against its f64 result (energies and forces)."""
    mesh = (15, 16, 16) if route == "rejected mesh" else MESH
    cap = 1 if route == "tile overflow" else None
    ref = _jax_pme_f64(mesh)
    j32 = _pme("jax", np.float32, mesh, cap)
    t32 = _pme("torch", np.float32, mesh, cap)
    t64 = _pme("torch", np.float64, mesh, cap)
    for r, j, t, t6 in zip(ref, j32, t32, t64):
        assert t.dtype == torch.float32
        assert_close(t6, r, rtol=RTOL)
        bar = 1.25 * _err(j, r)
        assert 0.0 < _err(t, r) <= bar, (_err(t, r), bar)

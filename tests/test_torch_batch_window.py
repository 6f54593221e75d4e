# SPDX-License-Identifier: Apache-2.0
"""``batch_grid_dftd3`` as one batched sweep a pass on every grid engine
(kernel 1 on ``"window"``, 8 on ``"block"``, 7 on ``"pallas"``: one launch
a pass for every system) against the port's per-system loop and the JAX
package's ``batch_grid_dftd3``, on the CPU.

On CPU tensors each kernel wrapper runs its plain version, for a batched
grid the per-system loop of the single-grid plain version, so the batched
call must give the bits of ``grid_dftd3`` run on each system's part of the
batch grid on the same engine.  Against JAX
``batch_grid_dftd3(engine="xla")`` the energies, forces and CNs agree
within rtol 1e-9 in f64 on every engine.  The systems hold padding atoms
(``numbers == 0``) and take per-system ``[B, 3, 3]`` cells (a shared grid
geometry from ``cells[0]``), fully periodic and with an open axis.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvalchemiops_torch import grid as tgrid
from nvalchemiops_torch.interactions.dispersion import grid_d3 as td3
from nvalchemiops_torch.kernels import window_sweep as ws
from nvalchemiops_tpu.interactions.dispersion import grid_d3 as jd3

from tests._torch_port import assert_close, synthetic_tables

A1, A2, S8 = 0.42, 4.1, 1.7
CUTOFF = 3.8
RTOL = 1e-9
#: (name, pbc): fully periodic and an open y axis
PBCS = (("periodic", (True, True, True)), ("open_y", (True, False, True)))
#: the grid engines with a batched kernel
ENGINES = ("window", "block", "pallas")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: Tier-1 runs six test workers on the CPU, and a
    torch thread pool in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _systems(seed=61, b=3, n=110, box=11.0):
    """``b`` systems of ``n`` atoms, every seventh a padding atom, in boxes
    that differ by a small shear (one grid geometry)."""
    rng = np.random.default_rng(seed)
    frac = rng.uniform(0.0, 1.0, (b, n, 3))
    cells = np.stack([np.eye(3) * box + np.triu(rng.normal(0.0, 0.2, (3, 3)),
                                                1) for _ in range(b)])
    pos = np.einsum("bnk,bkl->bnl", frac, cells)
    numbers = rng.integers(1, 5, (b, n)).astype(np.int32)
    numbers[:, ::7] = 0
    return pos, numbers, cells


def _args(pbc, dtype=torch.float64):
    pos, numbers, cells = _systems()
    return (torch.as_tensor(pos, dtype=dtype), numbers,
            torch.as_tensor(cells, dtype=dtype), np.array(pbc), CUTOFF,
            *synthetic_tables(seed=61), A1, A2, S8)


def _loop(args, engine="window"):
    """``grid_dftd3`` on ``engine`` on each system's part of the batch grid
    that ``batch_grid_dftd3`` builds."""
    pos, numbers, cells, pbc, cutoff = args[:5]
    dims, radius, cap = tgrid.estimate_grid_geometry(
        cells[0].numpy(), pbc, cutoff, pos.shape[1])
    g = tgrid.batch_build_atom_grid(pos, cells, pbc, dims, radius, cap)
    outs = [td3.grid_dftd3(tgrid.system_grid(g, i), numbers[i], *args[5:9],
                           cutoff, *args[9:], engine=engine)
            for i in range(pos.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


@functools.lru_cache(maxsize=None)
def _jax(pbc):
    pos, numbers, cells = _systems()
    tables = tuple(jnp.asarray(t) for t in synthetic_tables(seed=61))
    out = jd3.batch_grid_dftd3(jnp.asarray(pos), jnp.asarray(numbers),
                               jnp.asarray(cells), np.array(pbc), CUTOFF,
                               *tables, A1, A2, S8, engine="xla")
    return tuple(np.asarray(a) for a in out)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name,pbc", PBCS)
def test_batched_sweep_equals_the_per_system_loop(name, pbc, engine):
    """The batched call (and on the window engine ``engine="xla"``, which
    runs it) gives the per-system loop's bits: energies [B], forces [B, n,
    3] and CNs [B, n]."""
    args = _args(pbc)
    want = _loop(args, engine)
    for eng in (engine, "xla") if engine == "window" else (engine,):
        got = td3.batch_grid_dftd3(*args, engine=eng)
        assert [tuple(a.shape) for a in got] == [(3,), (3, 110, 3), (3, 110)]
        for a, w in zip(got, want):
            assert torch.equal(a, w), eng


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name,pbc", PBCS)
def test_batched_sweep_matches_jax(name, pbc, engine):
    got = td3.batch_grid_dftd3(*_args(pbc), engine=engine)
    for a, w, what in zip(got, _jax(pbc), ("energy", "forces", "cn")):
        assert_close(a, w, RTOL, err_msg=what)
    # padding atoms carry no force and no CN
    _, numbers, _ = _systems()
    pad = torch.as_tensor(numbers == 0)
    assert float(got[1][pad].abs().max()) == 0.0
    assert float(got[2][pad].abs().max()) == 0.0


def test_batched_grid_helpers_equal_their_per_system_calls():
    """On a batched grid the scatter, extension, fold and gather helpers
    act per system: each system's slice equals the helper on
    ``system_grid``."""
    pos, numbers, cells = _systems()
    pbc = np.array([True, False, True])
    pos_t, cells_t = torch.as_tensor(pos), torch.as_tensor(cells)
    dims, radius, cap = tgrid.estimate_grid_geometry(cells[0], pbc, CUTOFF,
                                                     pos.shape[1])
    g = tgrid.batch_build_atom_grid(pos_t, cells_t, pbc, dims, radius, cap)
    vals = torch.as_tensor(np.random.default_rng(3).normal(
        size=numbers.shape))
    (plane,) = tgrid.scatter_rows_to_grid(g, (vals,))
    ext = tgrid._extend_like(g, plane, 0.0)
    feat = tgrid._extend_like(g, torch.stack([plane, 2 * plane], -1), 0.0)
    folded = tgrid.fold_halo(g, ext)
    (back,) = tgrid.gather_rows_from_grid(g, (plane,))
    for i in range(pos.shape[0]):
        gi = tgrid.system_grid(g, i)
        (pi,) = tgrid.scatter_rows_to_grid(gi, (vals[i],))
        assert torch.equal(plane[i], pi)
        assert torch.equal(ext[i], tgrid._extend_like(gi, pi, 0.0))
        assert torch.equal(feat[i], tgrid._extend_like(
            gi, torch.stack([pi, 2 * pi], -1), 0.0))
        assert torch.equal(folded[i], tgrid.fold_halo(gi, ext[i]))
        assert torch.equal(back[i], tgrid.gather_rows_from_grid(gi, (pi,))[0])
        assert torch.equal(tgrid._interior(g, g.ext_px)[i],
                           tgrid._interior(gi, gi.ext_px))
    assert torch.equal(back, vals)


def _planes(seed, b=2, cz=2, cy=3, cx=3, cap=8, radius=(1, 1, 1), n_own=4):
    rng = np.random.default_rng(seed)
    rz, ry, rx = radius
    ext = (cz + 2 * rz, cy + 2 * ry, cx + 2 * rx, cap)
    cand = rng.uniform(0.0, 6.0, (b, n_own) + ext)
    cand[:, 3] = rng.uniform(0.6, 1.4, (b,) + ext)
    own = cand[:, :, rz:rz + cz, ry:ry + cy, rx:rx + cx]
    return torch.as_tensor(own.copy()), torch.as_tensor(cand)


def test_batch_wrapper_is_the_per_system_plain_loop():
    """On the CPU ``window_sweep`` on a batched grid's planes runs its plain
    version, each system equal to ``window_sweep_plain`` on its planes; the
    CN and chain bodies at one system and at three."""
    params = ws.SweepParams(cutoff=2.5)
    for b in (1, 3):
        own, cand = _planes(7, b=b)
        got = ws.window_sweep("cn", (1, 1, 1), own, cand, params)
        assert got[0].shape == (b, 1) + own.shape[2:]
        assert got[1].shape == (b, 1) + cand.shape[2:]
        for i in range(b):
            want = ws.window_sweep_plain("cn", (1, 1, 1), own[i], cand[i],
                                         params)
            assert torch.equal(got[0][i], want[0])
            assert torch.equal(got[1][i], want[1])
    own, cand = _planes(8, b=2, n_own=5)
    got = ws.window_sweep_plain("chain", (1, 1, 1), own, cand, params)
    want = ws.window_sweep("chain", (1, 1, 1), own[1], cand[1], params)
    assert torch.equal(got[0][1], want[0]) and torch.equal(got[1][1], want[1])


def test_batch_wrapper_rejects_bad_shapes():
    params = ws.SweepParams(cutoff=2.5)
    own, cand = _planes(9, b=2)
    with pytest.raises(ValueError, match="one B"):
        ws.window_sweep("cn", (1, 1, 1), own, cand[:1], params)
    with pytest.raises(ValueError, match="one B"):
        ws.window_sweep("cn", (1, 1, 1), own, cand[0], params)
    with pytest.raises(ValueError, match="do not extend"):
        ws.window_sweep("cn", (1, 2, 1), own, cand, params)
    with pytest.raises(ValueError, match="unknown sweep body"):
        ws.window_sweep("d4", (1, 1, 1), own, cand, params)


def test_batch_grid_dftd3_rejects_an_unknown_engine():
    with pytest.raises(ValueError, match="unknown engine"):
        td3.batch_grid_dftd3(*_args((True, True, True)), engine="mosaic")
    # the hybrid engine needs a stencil, which the batched entry never has
    with pytest.raises(ValueError, match="StencilGrid"):
        td3.batch_grid_dftd3(*_args((True, True, True)), engine="hybrid")


@pytest.mark.parametrize("engine", ["pallas", "block"])
def test_batched_grid_runs_each_engine_per_system(engine):
    """Kernels 7 and 8 take a batched grid's planes with the system axis,
    as kernel 1 does: ``_sweep`` on the batch grid returns ``[F, B, ..]``,
    each system equal to the sweep of its own grid's planes."""
    pos, numbers, cells = _systems()
    pbc = np.array([True, True, True])
    dims, radius, cap = tgrid.estimate_grid_geometry(cells[0], pbc, CUTOFF,
                                                     pos.shape[1])
    g = tgrid.batch_build_atom_grid(torch.as_tensor(pos),
                                    torch.as_tensor(cells), pbc, dims,
                                    radius, cap)
    own = td3._stack(g, [tgrid._interior(g, g.ext_px),
                         tgrid._interior(g, g.ext_py),
                         tgrid._interior(g, g.ext_pz),
                         torch.ones_like(tgrid._interior(g, g.ext_px))])
    cand = td3._stack(g, [g.ext_px, g.ext_py, g.ext_pz,
                          torch.ones_like(g.ext_px)])
    params = ws.SweepParams(cutoff=CUTOFF)
    got = td3._sweep(g, engine, None, "cn", own, cand, params)
    assert got[0].shape == (1, 3) + own.shape[2:]
    for i in range(3):
        gi = tgrid.system_grid(g, i)
        want = td3._sweep(gi, engine, None, "cn", own[i], cand[i], params)
        assert torch.equal(got[0][:, i], want[0])
        assert torch.equal(got[1][:, i], want[1])

# SPDX-License-Identifier: Apache-2.0
"""``engine="xla"`` (the JAX package's XLA engines) against the JAX
package on the CPU.  The port runs a kernel's route for it: the window
engine (kernel 1) for ``grid_dftd3`` with and without the virial, the grid
Coulomb, the fused D3 + Coulomb sweep and ``batch_grid_dftd3``; kernel 4
for ``dense_dftd3`` / ``batch_dense_dftd3``.  The virial where the JAX
package falls back to its XLA engine (no cell, the block, pallas and
hybrid engines) is the window engine's, with the ghost shifts from the
ghost positions when there is no cell.  Also the grid's offset sweeps that
the JAX ``grid`` exports (the neighbour counts, coordination numbers and
the half-space row sweep) and f32 against JAX's own f32 error.  The
stencil's ``"xla"`` sweeps are held to JAX in tests/test_torch_stencil.py.

Inputs are made from a seed with numpy; both packages get the same grid
(the JAX build carried over by ``interop``).  f64 results are held at
rtol 1e-9, neighbour counts exactly, f32 forces within 1.25x the JAX
package's own f32-vs-f64 error.  Each JAX program compiles once per shape
and flag, so the cases share one system and cache the JAX results.
"""

import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvalchemiops_torch import grid as tgrid
from nvalchemiops_torch import stencil as tst
from nvalchemiops_torch.interactions.dispersion import dense_d3 as tdense
from nvalchemiops_torch.interactions.dispersion import grid_d3 as td3
from nvalchemiops_torch.kernels.window_sweep import BODY_FNS, SweepParams
from nvalchemiops_tpu import grid as jgrid
from nvalchemiops_tpu.interactions.dispersion import dense_d3 as jdense
from nvalchemiops_tpu.interactions.dispersion import grid_d3 as jd3
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
CUTOFF = 3.4
RTOL = 1e-9
F32_FACTOR = 1.25
PBC = np.array([True] * 3)


@functools.lru_cache(maxsize=None)
def _system(dtype=np.float64):
    """150 atoms in an 11 A cube, every ninth a padding atom, charges and
    synthetic tables; the JAX grid (cap from occupancy 0.4) and the port's
    copy of it in ``dtype``."""
    pos, cell, numbers, q = random_system(61, 150, 11.0)
    numbers[::9] = 0
    tab = synthetic_tables(seed=61)
    dims, radius, cap = jgrid.estimate_grid_geometry(cell, PBC, CUTOFF, 150,
                                                     0.4)
    gj = jgrid.build_atom_grid(jnp.asarray(pos, dtype), jnp.asarray(cell,
                                                                    dtype),
                               PBC, dims, radius, cap)
    return dict(pos=pos, cell=cell, numbers=numbers, q=q, tab=tab, gj=gj,
                gt=port_grid(gj, dtype=getattr(torch, np.dtype(dtype).name)))


def _jtab(tab, dtype=np.float64):
    return [jnp.asarray(t, dtype) for t in tab]


@functools.lru_cache(maxsize=None)
def _jax_d3(dtype=np.float64):
    """JAX ``grid_dftd3(engine="xla", compute_virial=True)``."""
    s = _system(dtype)
    out = jd3.grid_dftd3(s["gj"], jnp.asarray(s["numbers"]),
                         *_jtab(s["tab"], dtype), CUTOFF, A1, A2, S8,
                         engine="xla", compute_virial=True)
    return tuple(np.asarray(a) for a in out)


@functools.lru_cache(maxsize=None)
def _jax_coulomb(alpha, dtype=np.float64):
    s = _system(dtype)
    out = jgrid.grid_coulomb_energy_forces(
        s["gj"], jnp.asarray(s["q"], dtype), CUTOFF, alpha, engine="xla")
    return tuple(np.asarray(a) for a in out)


def _f32_error(f32, f64):
    f32, f64 = np.asarray(f32, np.float64), np.asarray(f64, np.float64)
    return np.abs(f32 - f64).max() / np.abs(f64).max()


def _window_d3(**kw):
    s = _system()
    return td3.grid_dftd3(s["gt"], s["numbers"], *s["tab"], CUTOFF, A1, A2,
                          S8, engine="window", **kw)


def _same_bits(out, ref):
    assert len(out) == len(ref)
    assert all(torch.equal(a, r) for a, r in zip(out, ref))


@pytest.mark.parametrize("virial", [False, True])
def test_grid_dftd3_xla_matches_jax(virial):
    """Energy, forces, CNs (and the virial) against the JAX xla engine;
    the call is the window engine's, bit for bit."""
    s = _system()
    kw = dict(compute_virial=True, cell=s["cell"]) if virial else {}
    out = td3.grid_dftd3(s["gt"], s["numbers"], *s["tab"], CUTOFF, A1, A2,
                         S8, engine="xla", **kw)
    _same_bits(out, _window_d3(**kw))
    ref = _jax_d3()
    assert len(out) == (4 if virial else 3)
    assert out[1].shape == (150, 3) and out[1].dtype == torch.float64
    for a, r in zip(out, ref):
        assert_close(a, r, rtol=RTOL)


@pytest.mark.parametrize("route", ["no cell", "block", "pallas", "hybrid"])
def test_virial_fallbacks_match_jax(route):
    """``compute_virial=True`` with no cell, with the block or pallas
    engine, or with a stencil (the hybrid engine), where the JAX package
    takes its XLA engine's virial, runs the window engine with no stencil
    and returns JAX's results; with a cell, the window call's bits."""
    s = _system()
    kw = dict(compute_virial=True, cell=s["cell"])
    if route == "no cell":
        kw.pop("cell")
    elif route == "hybrid":
        kw["stencil"] = tst.build_stencil_grid(
            torch.as_tensor(s["pos"]), torch.as_tensor(s["cell"]), PBC,
            (12, 12, 12), (4, 4, 4))
    else:
        kw["engine"] = route
    out = td3.grid_dftd3(s["gt"], s["numbers"], *s["tab"], CUTOFF, A1, A2,
                         S8, **kw)
    for a, r in zip(out, _jax_d3()):
        assert_close(a, r, rtol=RTOL)
    if "cell" in kw:
        _same_bits(out, _window_d3(compute_virial=True, cell=s["cell"]))


@pytest.mark.parametrize("alpha", [0.0, 0.35])
def test_grid_coulomb_xla_matches_jax(alpha):
    s = _system()
    e, f = tgrid.grid_coulomb_energy_forces(s["gt"], torch.as_tensor(s["q"]),
                                            CUTOFF, alpha, engine="xla")
    e_j, f_j = _jax_coulomb(alpha)
    assert_close(e, e_j, rtol=RTOL)
    assert_close(f, f_j, rtol=RTOL)


@functools.lru_cache(maxsize=None)
def _jax_fused():
    s = _system()
    out = jd3.grid_dftd3_coulomb(
        s["gj"], jnp.asarray(s["numbers"]), jnp.asarray(s["q"]),
        *_jtab(s["tab"]), CUTOFF, A1, A2, S8, coulomb_cutoff=2.9, alpha=0.3,
        engine="xla")
    return tuple(np.asarray(a) for a in out)


@pytest.mark.parametrize("combine", [False, True])
def test_grid_dftd3_coulomb_xla_matches_jax(combine):
    """The fused pass (D3 direct and Coulomb on one window, the Coulomb
    pair at its own cutoff) against JAX; ``combine_forces`` sums the two
    force channels afterwards, as the JAX xla engine does."""
    s = _system()
    e, f, cn, ec, fc = td3.grid_dftd3_coulomb(
        s["gt"], s["numbers"], s["q"], *s["tab"], CUTOFF, A1, A2, S8,
        coulomb_cutoff=2.9, alpha=0.3, engine="xla", combine_forces=combine)
    e_j, f_j, cn_j, ec_j, fc_j = _jax_fused()
    for a, r in ((e, e_j), (cn, cn_j), (ec, ec_j)):
        assert_close(a, r, rtol=RTOL)
    if combine:
        assert fc is None
        assert_close(f, f_j + fc_j, rtol=RTOL)
    else:
        assert_close(f, f_j, rtol=RTOL)
        assert_close(fc, fc_j, rtol=RTOL)


def test_batch_grid_dftd3_xla_matches_jax():
    """Three systems with padding atoms against the JAX engine's vmap; the
    call is the window engine's loop over systems, bit for bit."""
    rng = np.random.default_rng(62)
    pos = rng.uniform(0, 10.0, (3, 110, 3))
    numbers = rng.integers(0, 5, (3, 110)).astype(np.int32)
    cell = np.eye(3) * 10.0
    tab = synthetic_tables(seed=62)
    ref = jd3.batch_grid_dftd3(jnp.asarray(pos), jnp.asarray(numbers),
                               jnp.asarray(cell), PBC, CUTOFF, *_jtab(tab),
                               A1, A2, S8, engine="xla")
    args = (torch.as_tensor(pos), numbers, torch.as_tensor(cell), PBC,
            CUTOFF, *tab, A1, A2, S8)
    out = td3.batch_grid_dftd3(*args, engine="xla")
    _same_bits(out, td3.batch_grid_dftd3(*args))
    assert [tuple(a.shape) for a in out] == [(3,), (3, 110, 3), (3, 110)]
    for a, r in zip(out, ref):
        assert_close(a, r, rtol=RTOL)


@functools.lru_cache(maxsize=None)
def _dense_case(cutoff):
    """Four 40-atom systems in 8 A boxes (padding atoms included) and the
    JAX xla engine's batch: 3.5 A is minimum image, 5 A takes the image
    combos."""
    rng = np.random.default_rng(63)
    pos = rng.uniform(0, 8.0, (4, 40, 3))
    numbers = rng.integers(0, 5, (4, 40)).astype(np.int32)
    cell = np.eye(3) * 8.0
    tab = synthetic_tables(seed=63)
    ref = jdense.batch_dense_dftd3(
        jnp.asarray(pos), jnp.asarray(numbers), jnp.asarray(cell), cutoff,
        *_jtab(tab), A1, A2, S8, engine="xla", system_chunk=2)
    return pos, numbers, cell, tab, tuple(np.asarray(a) for a in ref)


@pytest.mark.parametrize("call", ["batch", "single"])
@pytest.mark.parametrize("cutoff", [3.5, 5.0])
def test_dense_xla_matches_jax(cutoff, call):
    """Kernel 4's route for the JAX pair-plane engine: the batch in chunks
    of 2 systems and whole (the same bits as ``engine="auto"``), and one
    system alone, against the JAX engine."""
    pos, numbers, cell, tab, ref = _dense_case(cutoff)
    args = (cell, cutoff, *tab, A1, A2, S8)
    if call == "single":
        out = tdense.dense_dftd3(torch.as_tensor(pos[0]), numbers[0], *args,
                                 engine="xla")
        ref = tuple(r[0] for r in ref)
    else:
        out = tdense.batch_dense_dftd3(torch.as_tensor(pos), numbers, *args,
                                       system_chunk=2, engine="xla")
        whole = tdense.batch_dense_dftd3(torch.as_tensor(pos), numbers,
                                         *args, engine="xla")
        _same_bits(whole, tdense.batch_dense_dftd3(torch.as_tensor(pos),
                                                   numbers, *args))
        for a, b in zip(out, whole):
            assert_close(a, b, rtol=1e-12)
    for a, r in zip(out, ref):
        assert_close(a, r, rtol=RTOL)


def test_grid_neighbor_count_is_exact():
    """Counts (``INDEX_DTYPE``) equal the JAX package's; padding atoms count
    as atoms here, as in the JAX helper."""
    s = _system()
    got = tgrid.grid_neighbor_count(s["gt"], CUTOFF, 150)
    want = np.asarray(jgrid.grid_neighbor_count(s["gj"], CUTOFF, 150))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) > 0


def test_grid_coordination_numbers_match_jax():
    s = _system()
    rcov = np.random.default_rng(64).uniform(0.6, 1.4, 150)
    got = tgrid.grid_coordination_numbers(s["gt"], rcov, CUTOFF, 15.0)
    want = jgrid.grid_coordination_numbers(s["gj"], jnp.asarray(rcov),
                                           CUTOFF, 15.0)
    assert_close(got, want, rtol=RTOL)


def _grid_function(*params):
    """The one ``grid.__all__`` function with these parameters (the half-
    space row sweep and its home mask are JAX export names that a test file
    may not spell)."""
    found = [getattr(tgrid, n) for n in tgrid.__all__
             if inspect.isfunction(getattr(tgrid, n)) and set(params)
             <= set(inspect.signature(getattr(tgrid, n)).parameters)]
    assert len(found) == 1, found
    return found[0]


def test_half_space_sweeps_agree():
    """The grid's half-space row sweep (x-merged candidate windows, the j
    side folded back through the halo) with the window engine's Coulomb
    pair body gives the JAX xla engine's Coulomb; its home mask keeps x
    chunk 0's slot pairs i < j and every pair of chunks 1..rx."""
    s = _system()
    g = s["gt"]
    q_plane = tgrid.scatter_to_grid(g, torch.as_tensor(s["q"]))
    q_ext = tgrid._extend_like(g, q_plane, 0.0)
    sweep = _grid_function("kernel", "num_ext_acc")
    rx = g.radius[2]
    home = _grid_function("cap", "rx")(g.cap, rx, "cpu")
    slot_i = torch.arange(g.cap)[:, None]
    slot_j = torch.arange((rx + 1) * g.cap)[None, :]
    assert torch.equal(home, ((slot_j >= g.cap) | (slot_i < slot_j)).reshape(
        1, 1, 1, g.cap, -1))
    body = BODY_FNS["coulomb"]
    params = SweepParams(cutoff=CUTOFF, alpha=0.35)
    names = ("px", "py", "pz", "q")

    def kern(carry, own, cand, is_home):
        o = [own[k][..., :, None] for k in names]
        c = [cand[k][..., None, :] for k in names]
        own_b, j_b = body(o, c, params, home if is_home else None, None,
                          None)
        return (tuple(a + b.sum(-1) for a, b in zip(carry, own_b)),
                tuple(b.sum(-2) for b in j_b))

    zeros = torch.zeros_like(q_plane)
    carry, folded = sweep(g, kern, (zeros,) * 4, 4, (("q", q_ext),),
                          (("q", q_plane),))
    e, *f = tgrid.gather_rows_from_grid(
        g, [a + b for a, b in zip(carry, folded)])
    e_j, f_j = _jax_coulomb(0.35)
    assert_close(e, e_j, rtol=RTOL)
    assert_close(torch.stack(f, dim=-1), f_j, rtol=RTOL)


@pytest.mark.parametrize("path", ["grid_dftd3", "coulomb", "dense"])
def test_f32_within_jax_f32_error(path):
    """f32 forces against the JAX f64 result, within 1.25x the JAX
    package's own f32-vs-f64 error on the same path."""
    if path == "grid_dftd3":
        s = _system(np.float32)
        got = td3.grid_dftd3(s["gt"], s["numbers"], *s["tab"], CUTOFF, A1,
                             A2, S8, engine="xla")[1]
        j32, j64 = _jax_d3(np.float32)[1], _jax_d3()[1]
    elif path == "coulomb":
        s = _system(np.float32)
        got = tgrid.grid_coulomb_energy_forces(
            s["gt"], torch.as_tensor(s["q"], dtype=torch.float32), CUTOFF,
            0.35, engine="xla")[1]
        j32, j64 = _jax_coulomb(0.35, np.float32)[1], _jax_coulomb(0.35)[1]
    else:
        pos, numbers, cell, tab, ref = _dense_case(5.0)
        got = tdense.batch_dense_dftd3(
            torch.as_tensor(pos, dtype=torch.float32), numbers, cell, 5.0,
            *tab, A1, A2, S8, engine="xla")[1]
        j32 = jdense.batch_dense_dftd3(
            jnp.asarray(pos, jnp.float32), jnp.asarray(numbers),
            jnp.asarray(cell, jnp.float32), 5.0, *_jtab(tab, np.float32),
            A1, A2, S8, engine="xla")[1]
        j64 = ref[1]
    assert got.dtype == torch.float32
    assert _f32_error(got, j64) <= F32_FACTOR * _f32_error(j32, j64)

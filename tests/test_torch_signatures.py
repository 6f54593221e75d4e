# SPDX-License-Identifier: Apache-2.0
"""The port's public signatures follow the JAX package's.

For every ``__all__`` function of ``nvalchemiops_torch`` with a namesake at
the same module path of the JAX package, the JAX parameter names are a
prefix, in order, of the port's: a positional call that is valid against
the JAX package binds to the same parameters in the port.  Port-only
parameters come after them.  One function is exempt (``EXEMPT``).

Then a few positional calls that bound to other parameters before bind as
JAX binds them, the knobs with a port meaning are honoured, the TPU-only
knobs are checked (``ValueError`` on a value the JAX package has no
meaning for) and the calls that raised ``NotImplementedError`` before
(``engine="xla"``, the virial where the JAX package takes its XLA engine's)
give the JAX package's results.
"""

import importlib
import inspect
import pkgutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nvalchemiops_torch
from nvalchemiops_torch import grid as tgrid
from nvalchemiops_torch import spline_windowed as tsw
from nvalchemiops_torch.interactions.dispersion import dense_d3 as tdense
from nvalchemiops_torch.interactions.dispersion import grid_d3 as td3
from nvalchemiops_torch.interactions.electrostatics import k_vectors as tkv
from nvalchemiops_torch.interactions.electrostatics import pme as tpme
from nvalchemiops_tpu import grid as jgrid
from nvalchemiops_tpu.interactions.dispersion import dense_d3 as jdense
from nvalchemiops_tpu.interactions.dispersion import grid_d3 as jd3
from nvalchemiops_tpu.interactions.electrostatics import k_vectors as jkv
from nvalchemiops_tpu.interactions.electrostatics import pme as jpme

from tests._torch_port import assert_close, synthetic_tables


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: Tier-1 runs six test workers on the CPU, and a
    torch thread pool in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F64 = torch.float64
A1, A2, S8 = 0.42, 4.1, 1.7

#: port functions whose parameters differ from the JAX namesake's by
#: design, with the reason
EXEMPT = {
    # the JAX form takes a traced pass-kernel function with its carry
    # (kernel, init, num_ext_acc); the port's takes the name of a pass body
    # of its CUDA kernel and that body's parameters (body, params)
    "nvalchemiops_torch.stencil.stencil_reduce_sym",
}


def _namesakes():
    """``(port module, name, port function, JAX function)`` for every
    ``__all__`` function of the port with a JAX namesake."""
    found = []
    for info in pkgutil.walk_packages(nvalchemiops_torch.__path__,
                                      "nvalchemiops_torch."):
        mod = importlib.import_module(info.name)
        try:
            jmod = importlib.import_module(
                info.name.replace("nvalchemiops_torch", "nvalchemiops_tpu",
                                  1))
        except ModuleNotFoundError:
            continue
        for name in getattr(mod, "__all__", []):
            fn, jfn = getattr(mod, name), getattr(jmod, name, None)
            if (inspect.isfunction(fn) and jfn is not None
                    and inspect.isfunction(inspect.unwrap(jfn))):
                found.append((info.name, name, fn, inspect.unwrap(jfn)))
    return found


def test_jax_parameters_are_an_ordered_prefix_of_the_port_s():
    found = _namesakes()
    assert len(found) > 40
    differ = []
    for mod, name, fn, jfn in found:
        port = list(inspect.signature(fn).parameters)
        ref = list(inspect.signature(jfn).parameters)
        if port[:len(ref)] != ref:
            differ.append(f"{mod}.{name}")
    assert sorted(differ) == sorted(EXEMPT)


def test_walk_covers_the_jax_grid_and_mathops_lists():
    """The walk above reaches every function of the JAX ``grid`` and
    ``mathops`` lists (``use_slot_gather``, a TPU layout choice, is not
    ported), the generated harmonic accessors and both math modules
    included."""
    walked = {}
    for mod, name, _, _ in _namesakes():
        walked.setdefault(mod, set()).add(name)
    for sub in ("grid", "mathops"):
        jmod = importlib.import_module(f"nvalchemiops_tpu.{sub}")
        want = {n for n in jmod.__all__ if inspect.isfunction(
            inspect.unwrap(getattr(jmod, n)))} - {"use_slot_gather"}
        assert want and want <= walked[f"nvalchemiops_torch.{sub}"], sub
    # the JAX math modules list no __all__: every port name has a namesake
    for sub in ("gto", "spherical_harmonics"):
        mod = f"nvalchemiops_torch.mathops.{sub}"
        assert set(importlib.import_module(mod).__all__) == walked[mod], sub


def _dtype_name(x):
    """The name of a torch, numpy or JAX dtype (or dtype type), else
    None."""
    if isinstance(x, torch.dtype):
        return str(x).replace("torch.", "")
    if isinstance(x, np.dtype) or (isinstance(x, type)
                                   and issubclass(x, np.generic)):
        return np.dtype(x).name
    dt = getattr(x, "dtype", None)          # jnp.float32 and its kin
    return dt.name if isinstance(dt, np.dtype) else None


def _same_default(port, ref):
    """Equal defaults; a dtype equals its namesake in the other library
    (the port's ``torch.float32`` is the JAX package's ``jnp.float32``)."""
    names = _dtype_name(port), _dtype_name(ref)
    if names[0] is not None or names[1] is not None:
        return names[0] == names[1]
    return port == ref


def test_same_default_equates_a_dtype_with_its_namesake():
    assert _same_default(torch.float32, jnp.float32)
    assert _same_default(torch.float64, np.float64)
    assert not _same_default(torch.float32, jnp.float64)
    assert not _same_default(torch.float32, "float32")
    assert not _same_default(torch.float32, None)
    assert _same_default(None, None) and _same_default("window", "window")


def test_defaults_of_the_shared_parameters_are_the_jax_defaults():
    """Shared parameters take the JAX defaults (a dtype counts as its
    namesake); the one exception is ``batch_grid_dftd3``'s engine, which
    is the JAX XLA engine (a TPU fit) and the window engine (kernel 1) in
    the port."""
    allowed = {("batch_grid_dftd3", "engine")}
    for mod, name, fn, jfn in _namesakes():
        if f"{mod}.{name}" in EXEMPT:
            continue
        port = inspect.signature(fn).parameters
        for pname, jpar in inspect.signature(jfn).parameters.items():
            if (name, pname) in allowed:
                assert port[pname].default == "window"
                continue
            assert _same_default(port[pname].default, jpar.default), (
                name, pname)


def _pme_system(seed, b=2, n=40, box=8.0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, box, (b, n, 3))
    q = rng.normal(size=(b, n))
    q -= q.mean(-1, keepdims=True)
    return pos, q, np.eye(3) * box


def test_batch_pme_positional_fft_mode_binds_as_in_jax():
    """Argument 9 is ``fft_mode``: ``(..., None, "auto")`` asks for energies
    only, as in the JAX package (it used to ask for charge gradients)."""
    pos, q, cell = _pme_system(101)
    mesh = (16, 16, 16)
    out = tpme.batch_pme_reciprocal(torch.as_tensor(pos), torch.as_tensor(q),
                                    torch.as_tensor(cell), 0.35, mesh, 4,
                                    False, None, "auto")
    assert isinstance(out, torch.Tensor) and out.shape == (2, 40)
    ref = jpme.batch_pme_reciprocal(jnp.asarray(pos), jnp.asarray(q),
                                    jnp.asarray(cell), 0.35, mesh, 4, False,
                                    None, "xla")
    assert_close(out, ref, rtol=1e-9)


def test_batch_pme_tile_is_honoured():
    """``tile`` picks the windowed engine's tile: 8-point tiles run the
    W = 12 windows where the default takes 16-point (W = 20) ones, and the
    results agree."""
    pos, q, cell = _pme_system(102)
    args = (torch.as_tensor(pos), torch.as_tensor(q), torch.as_tensor(cell),
            0.35, (32, 32, 32))
    widths = []
    orig = tsw.gather_grad_planes

    def record(smat, win, w_win):
        widths.append(w_win)
        return orig(smat, win, w_win)

    tsw.gather_grad_planes = record
    try:
        e16, f16 = tpme.batch_pme_reciprocal(*args, compute_forces=True,
                                             engine="windowed")
        e8, f8 = tpme.batch_pme_reciprocal(*args, compute_forces=True,
                                           engine="windowed", tile=8)
    finally:
        tsw.gather_grad_planes = orig
    assert widths == [20, 20, 12, 12]
    assert_close(e8, e16, rtol=1e-9)
    assert_close(f8, f16, rtol=1e-9)


def _dense_batch(seed, b=4, n=60, box=10.0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, box, (b, n, 3))
    numbers = rng.integers(1, 4, (b, n)).astype(np.int32)
    return pos, numbers, np.eye(3) * box, synthetic_tables(seed=seed)


def _jax_tabs(tab):
    return [jnp.asarray(t) for t in tab]


def test_batch_dense_positional_system_chunk_binds_as_in_jax():
    """Argument 15 is ``system_chunk``: a chunk size given by position runs
    the batch in chunks (it used to force the second-image sweep), and the
    result equals the whole batch's and the JAX package's."""
    pos, numbers, cell, tab = _dense_batch(103)
    args = (torch.as_tensor(pos), numbers, torch.as_tensor(cell), 4.0, *tab,
            A1, A2, S8, 1.0, 16.0, -4.0)
    whole = tdense.batch_dense_dftd3(*args)
    chunked = tdense.batch_dense_dftd3(*args, 2)
    ref = jdense.batch_dense_dftd3(
        jnp.asarray(pos), jnp.asarray(numbers), jnp.asarray(cell), 4.0,
        *_jax_tabs(tab), A1, A2, S8, 1.0, 16.0, -4.0, 2, engine="xla")
    for a, b, r in zip(chunked, whole, ref):
        assert_close(a, b, rtol=1e-12)
        assert_close(a, r, rtol=1e-9)
    with pytest.raises(ValueError, match="system_chunk"):
        tdense.batch_dense_dftd3(*args, 3)


def test_batch_dftd3_grid_takes_target_occupancy():
    """``batch_dftd3(..., engine="grid", target_occupancy=...)`` reaches the
    grid engine's geometry choice, as in the JAX package."""
    pos, numbers, cell, tab = _dense_batch(104, b=2, n=200, box=14.0)
    pbc = np.array([True] * 3)
    out = tdense.batch_dftd3(torch.as_tensor(pos), numbers,
                             torch.as_tensor(cell), pbc, 4.5, *tab, A1, A2,
                             S8, engine="grid", target_occupancy=0.1)
    caps = []
    orig = td3.batch_build_atom_grid

    def record(positions, cells, pbc_, dims, radius, cap):
        caps.append(cap)
        return orig(positions, cells, pbc_, dims, radius, cap)

    td3.batch_build_atom_grid = record
    try:
        for occ in (0.1, 0.9):
            td3.batch_grid_dftd3(torch.as_tensor(pos), numbers,
                                 torch.as_tensor(cell), pbc, 4.5, *tab, A1,
                                 A2, S8, 1.0, 16.0, -4.0, occ)
    finally:
        td3.batch_build_atom_grid = orig
    assert caps[0] > caps[1]
    ref = jdense.batch_dftd3(jnp.asarray(pos), jnp.asarray(numbers),
                             jnp.asarray(cell), pbc, 4.5, *_jax_tabs(tab),
                             A1, A2, S8, engine="grid", target_occupancy=0.1)
    for a, r in zip(out, ref):
        assert_close(a, r, rtol=1e-9)


def test_dense_combos_are_honoured():
    """Explicit image combos replace the distance-pruned ones, as in the
    JAX package."""
    pos, numbers, cell, tab = _dense_batch(105, b=1, n=70, box=9.0)
    combos = [(0, 0, 0), (1, 0, 0), (0, 1, 0)]
    out = tdense.dense_dftd3(torch.as_tensor(pos[0]), numbers[0],
                             torch.as_tensor(cell), 6.0, *tab, A1, A2, S8,
                             images=True, combos=combos)
    ref = jdense.dense_dftd3(jnp.asarray(pos[0]), jnp.asarray(numbers[0]),
                             jnp.asarray(cell), 6.0, *_jax_tabs(tab), A1, A2,
                             S8, images=True, combos=combos, engine="xla")
    full = tdense.dense_dftd3(torch.as_tensor(pos[0]), numbers[0],
                              torch.as_tensor(cell), 6.0, *tab, A1, A2, S8,
                              images=True)
    for a, r in zip(out, ref):
        assert_close(a, r, rtol=1e-9)
    assert not torch.equal(out[0], full[0])    # (0, 0, 1) reaches 6 A


def test_reciprocal_cell_is_used_when_given():
    rng = np.random.default_rng(106)
    cell = np.eye(3) * 7.0 + rng.uniform(-0.3, 0.3, (3, 3))
    mesh = (8, 8, 8)
    recip = 2.0 * np.pi * np.linalg.inv(cell.T)
    kv, k2 = tkv.generate_k_vectors_pme(torch.as_tensor(cell), mesh,
                                        torch.as_tensor(recip))
    jkv_, jk2 = jkv.generate_k_vectors_pme(jnp.asarray(cell), mesh,
                                           jnp.asarray(recip))
    assert_close(kv, jkv_, rtol=1e-12)
    assert_close(k2, jk2, rtol=1e-12)
    kv2, _ = tkv.generate_k_vectors_pme(torch.as_tensor(cell), mesh,
                                        torch.as_tensor(2.0 * recip))
    assert_close(kv2, 2.0 * kv, rtol=1e-12)


def _grid_system(seed, n=160, box=12.0, cutoff=4.5):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, box, (n, 3))
    numbers = rng.integers(1, 4, n).astype(np.int32)
    cell = np.eye(3) * box
    tab = synthetic_tables(seed=seed)
    pbc = np.array([True] * 3)
    dims, radius, cap = tgrid.estimate_grid_geometry(
        torch.as_tensor(cell), pbc, cutoff, n, 0.6)
    g = tgrid.build_atom_grid(torch.as_tensor(pos), torch.as_tensor(cell),
                              pbc, dims, radius, cap)
    return g, numbers, tab, cutoff, cell, pos


def test_grid_dftd3_knobs():
    """``precision`` and ``bilinear`` are checked and change nothing;
    ``cell`` is carried; ``feature_dtype`` rounds the window engine's
    pass-2 features."""
    g, numbers, tab, cutoff, cell, _ = _grid_system(107)
    args = (g, numbers, *tab, cutoff, A1, A2, S8)
    base = td3.grid_dftd3(*args)
    for kw in (dict(precision=jax.lax.Precision.HIGHEST),
               dict(precision="highest"), dict(precision=("high", "default")),
               dict(bilinear="split"), dict(bilinear="quad"),
               dict(cell=torch.as_tensor(cell)),
               dict(feature_dtype=torch.float64),
               dict(feature_dtype=np.float64)):
        for a, b in zip(td3.grid_dftd3(*args, **kw), base):
            assert torch.equal(a, b), kw
    for fd in (torch.float32, jnp.float32, "float32"):
        e32, f32, _ = td3.grid_dftd3(*args, feature_dtype=fd)
        assert not torch.equal(f32, base[1])
        assert_close(f32, base[1], rtol=1e-5)
    for kw in (dict(precision="fast"), dict(precision=3),
               dict(bilinear="outer"), dict(feature_dtype="int32"),
               dict(feature_dtype="bogus"), dict(engine="mosaic"),
               dict(hybrid_cn="voxel")):
        with pytest.raises(ValueError):
            td3.grid_dftd3(*args, **kw)


@pytest.mark.parametrize("call", [
    "grid_dftd3(compute_virial=True) without cell",
    "grid_dftd3(compute_virial=True, engine='block')",
    "grid_dftd3(engine='xla')",
    "grid_dftd3_coulomb(engine='xla')", "batch_grid_dftd3(engine='xla')",
    "dense_dftd3(engine='xla')", "batch_dense_dftd3(engine='xla')",
])
def test_unported_knobs_raise_naming_roadmap(call):
    """The calls that raised ``NotImplementedError`` naming ROADMAP before
    (the name is kept): each now runs a kernel's route (the window engine,
    kernel 4) and gives the JAX package's result on the same inputs (rtol
    1e-9, f64)."""
    g, numbers, tab, cutoff, cell, gpos = _grid_system(108, n=80, box=10.0)
    gj = jgrid.build_atom_grid(jnp.asarray(gpos), jnp.asarray(cell),
                               np.array([True] * 3), g.dims, g.radius, g.cap)
    pos, _, pcell = _pme_system(109)
    pos_t = torch.as_tensor(pos)
    q = np.random.default_rng(108).normal(size=80)
    d3 = (*tab, cutoff, A1, A2, S8)
    jd3_args = (*_jax_tabs(tab), cutoff, A1, A2, S8)
    ones = np.ones((2, 40), np.int32)
    calls = {
        "grid_dftd3(compute_virial=True) without cell": (
            lambda: td3.grid_dftd3(g, numbers, *d3, compute_virial=True),
            lambda: jd3.grid_dftd3(gj, jnp.asarray(numbers), *jd3_args,
                                   compute_virial=True)),
        "grid_dftd3(compute_virial=True, engine='block')": (
            lambda: td3.grid_dftd3(g, numbers, *d3, compute_virial=True,
                                   cell=cell, engine="block"),
            lambda: jd3.grid_dftd3(gj, jnp.asarray(numbers), *jd3_args,
                                   compute_virial=True, engine="xla")),
        "grid_dftd3(engine='xla')": (
            lambda: td3.grid_dftd3(g, numbers, *d3, engine="xla"),
            lambda: jd3.grid_dftd3(gj, jnp.asarray(numbers), *jd3_args,
                                   engine="xla")),
        "grid_dftd3_coulomb(engine='xla')": (
            lambda: td3.grid_dftd3_coulomb(g, numbers, q, *d3,
                                           engine="xla"),
            lambda: jd3.grid_dftd3_coulomb(gj, jnp.asarray(numbers),
                                           jnp.asarray(q), *jd3_args,
                                           engine="xla")),
        "batch_grid_dftd3(engine='xla')": (
            lambda: td3.batch_grid_dftd3(
                pos_t, ones, torch.as_tensor(pcell), [True] * 3, 3.5, *tab,
                A1, A2, S8, engine="xla"),
            lambda: jd3.batch_grid_dftd3(
                jnp.asarray(pos), jnp.asarray(ones), jnp.asarray(pcell),
                np.array([True] * 3), 3.5, *_jax_tabs(tab), A1, A2, S8,
                engine="xla")),
        "dense_dftd3(engine='xla')": (
            lambda: tdense.dense_dftd3(
                pos_t[0], ones[0], torch.as_tensor(pcell), 3.5, *tab, A1,
                A2, S8, engine="xla"),
            lambda: jdense.dense_dftd3(
                jnp.asarray(pos[0]), jnp.asarray(ones[0]),
                jnp.asarray(pcell), 3.5, *_jax_tabs(tab), A1, A2, S8,
                engine="xla")),
        "batch_dense_dftd3(engine='xla')": (
            lambda: tdense.batch_dense_dftd3(
                pos_t, ones, torch.as_tensor(pcell), 3.5, *tab, A1, A2, S8,
                engine="xla"),
            lambda: jdense.batch_dense_dftd3(
                jnp.asarray(pos), jnp.asarray(ones), jnp.asarray(pcell), 3.5,
                *_jax_tabs(tab), A1, A2, S8, engine="xla")),
    }
    port, ref = calls[call]
    out, want = port(), ref()
    assert len(out) == len(want)
    for a, r in zip(out, want):
        assert_close(a, r, rtol=1e-9)


@pytest.mark.parametrize("entry", ["pme_reciprocal_space",
                                   "batch_pme_reciprocal"])
def test_matmul_fft_mode_binds_by_position_as_in_jax(entry):
    """``fft_mode`` given by position (argument 15 of
    ``pme_reciprocal_space``, 9 of ``batch_pme_reciprocal``) takes the
    matrix-product DFT, as in the JAX package, and agrees with it."""
    pos, q, pcell = _pme_system(109)
    mesh = (16, 16, 16)
    if entry == "pme_reciprocal_space":
        pos, q = pos[0], q[0]
        rest = (mesh, None, 4, None, None, None, True, False, 1e-6, None,
                "matmul")
    else:
        rest = (mesh, 4, True, None, "matmul")
    out = getattr(tpme, entry)(torch.as_tensor(pos), torch.as_tensor(q),
                               torch.as_tensor(pcell), 0.35, *rest)
    ref = getattr(jpme, entry)(jnp.asarray(pos), jnp.asarray(q),
                               jnp.asarray(pcell), 0.35, *rest)
    assert len(out) == len(ref) == 2
    for a, r in zip(out, ref):
        assert_close(a, r, rtol=1e-9)


@pytest.mark.parametrize("knob", ["batch_idx", "mesh_spacing", "accuracy"])
def test_pme_mesh_and_batch_knobs_bind_as_in_jax(knob):
    """``batch_idx`` (argument 8), ``mesh_spacing`` (argument 6, no mesh
    given) and ``accuracy`` (argument 13, neither given), passed by
    position, bind as in the JAX package and give its results."""
    pos, q, pcell = _pme_system(109)
    if knob == "batch_idx":
        pos, q = pos.reshape(-1, 3), q.reshape(-1)
        cell = np.stack([pcell, pcell])
        bidx = np.repeat(np.arange(2), 40).astype(np.int32)
        targs = ((16, 16, 16), None, 4, torch.as_tensor(bidx))
        jargs = ((16, 16, 16), None, 4, jnp.asarray(bidx))
    else:
        pos, q, cell = pos[0], q[0], pcell
        if knob == "mesh_spacing":
            targs = jargs = (None, 0.5)
        else:
            targs = jargs = (None, None, 4, None, None, None, True, False,
                             1e-5)
    out = tpme.pme_reciprocal_space(torch.as_tensor(pos), torch.as_tensor(q),
                                    torch.as_tensor(cell), 0.35, *targs)
    ref = jpme.pme_reciprocal_space(jnp.asarray(pos), jnp.asarray(q),
                                    jnp.asarray(cell), 0.35, *jargs)
    out, ref = ((out,), (ref,)) if knob != "accuracy" else (out, ref)
    assert len(out) == len(ref)
    for a, r in zip(out, ref):
        assert_close(a, r, rtol=1e-9)


def test_tpu_only_knobs_are_checked():
    """Values the JAX package knows are accepted (and change nothing);
    others raise ``ValueError``."""
    pos, q, pcell = _pme_system(110, b=1)
    pos_t, q_t = torch.as_tensor(pos[0]), torch.as_tensor(q[0])
    cell_t = torch.as_tensor(pcell)
    base = tpme.pme_reciprocal_space(pos_t, q_t, cell_t, 0.35, (16, 16, 16),
                                     compute_forces=True)
    for kw in (dict(spread_engine="pallas"), dict(gather_engine="pallas"),
               dict(fft_mode="xla")):
        for a, b in zip(tpme.pme_reciprocal_space(
                pos_t, q_t, cell_t, 0.35, (16, 16, 16), compute_forces=True,
                **kw), base):
            assert torch.equal(a, b)
    for kw in (dict(spread_engine="mosaic"), dict(gather_engine="cuda"),
               dict(fft_mode="auto"), dict(fft_mode="cufft")):
        with pytest.raises(ValueError):
            tpme.pme_reciprocal_space(pos_t, q_t, cell_t, 0.35, (16, 16, 16),
                                      **kw)
    with pytest.raises(ValueError):
        tpme.batch_pme_reciprocal(pos_t[None], q_t[None], cell_t, 0.35,
                                  (16, 16, 16), fft_mode="fft")

    tiles = tsw.build_mesh_tiles(pos_t, cell_t, (16, 16, 16), 4, 32)
    mesh = torch.as_tensor(np.random.default_rng(111).normal(
        size=(16, 16, 16)))
    spread = tsw.windowed_spread(tiles, q_t)
    assert torch.equal(tsw.windowed_spread(tiles, q_t, "pallas"), spread)
    gathered = tsw.windowed_gather(tiles, mesh, True)
    for order in ("m", "z"):
        for a, b in zip(tsw.windowed_gather(tiles, mesh, True, order),
                        gathered):
            assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tsw.windowed_spread(tiles, q_t, "mosaic")
    with pytest.raises(ValueError):
        tsw.windowed_gather(tiles, mesh, True, "y")

    dpos, numbers, dcell, tab = _dense_batch(112, b=1, n=50, box=9.0)
    dargs = (torch.as_tensor(dpos[0]), numbers[0], torch.as_tensor(dcell),
             3.5, *tab, A1, A2, S8)
    dbase = tdense.dense_dftd3(*dargs)
    for kw in (dict(engine="pallas"), dict(block=128),
               dict(interpret=True)):
        for a, b in zip(tdense.dense_dftd3(*dargs, **kw), dbase):
            assert torch.equal(a, b)
    for kw in (dict(engine="mosaic"), dict(block=0), dict(block=64.0),
               dict(interpret="yes"), dict(combos=[(0, 2, 0)])):
        with pytest.raises(ValueError):
            tdense.dense_dftd3(*dargs, **kw)

# SPDX-License-Identifier: Apache-2.0
"""The port's voxel stencil (``nvalchemiops_torch.stencil``; kernel 9's
plain version on the CPU) against the JAX package's ``stencil.py``.

On the JAX stencil tests' crystals: the geometry search and the build must
agree exactly in their integer structures (voxel index, occupancy) and to
1e-12 in the f64 position planes; the three sweeps, through the port's
half-space and full-space plain versions, meet the JAX ``engine="xla"``
sweep at rtol 1e-9 on the JAX build's state; once in f32 the port meets
the JAX Pallas kernel (interpret mode) at the JAX tests' tolerances; and
the hybrid D3 engine meets ``grid_dftd3(stencil=...)`` at rtol 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvalchemiops_tpu import stencil as jst
from nvalchemiops_tpu.grid import build_atom_grid_auto
from nvalchemiops_tpu.interactions.dispersion import grid_d3 as jd3
from nvalchemiops_torch import interop
from nvalchemiops_torch import stencil as tst
from nvalchemiops_torch.interactions.dispersion import grid_d3 as td3
from nvalchemiops_torch.kernels import launch_counts
from nvalchemiops_torch.kernels import stencil_sweep as ss
from nvalchemiops_torch.kernels.window_sweep import SweepParams
from tests._torch_port import assert_close, port_grid, synthetic_tables


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: Tier-1 runs six test workers on the CPU, and a
    torch thread pool in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PBC = np.array([True] * 3)


def _crystal(n_rep=8, a=3.0, jitter=0.2, seed=0):
    """tests/test_stencil.py's jittered simple-cubic crystal (numpy f64)."""
    rng = np.random.default_rng(seed)
    pts = np.stack(np.meshgrid(*([np.arange(n_rep)] * 3), indexing="ij"),
                   -1).reshape(-1, 3) * a
    return pts + rng.uniform(-jitter, jitter, pts.shape), np.eye(3) * (
        n_rep * a)


def _nonperiodic():
    """tests/test_stencil.py:81-106: a 6^3 crystal inside a 20 A box."""
    rng = np.random.default_rng(7)
    pts = np.stack(np.meshgrid(*([np.arange(6)] * 3), indexing="ij"),
                   -1).reshape(-1, 3) * 3.0 + 1.0
    return (pts + rng.uniform(-0.2, 0.2, pts.shape), np.eye(3) * 20.0,
            np.array([False] * 3))


CASES = {
    "crystal8": lambda: (*_crystal(8), PBC, 6.5),
    "crystal6": lambda: (*_crystal(6), PBC, 6.0),
    "nonperiodic": lambda: (*_nonperiodic(), 6.5),
}


def _jax_build(pos, cell, pbc, cutoff, dtype=jnp.float64):
    """The JAX stencil build as its tests make it (geometry search, then
    the build with the found origin)."""
    pj = jnp.asarray(pos, dtype)
    cj = jnp.asarray(cell, dtype)
    dims, radius, origin, _ = jst.choose_stencil_geometry(pj, cj, pbc, cutoff)
    return jst.build_stencil_grid(pj, cj, pbc, dims, radius,
                                  origin=None if not origin.any() else origin)


def _port(sg, dtype=torch.float64):
    """The port's StencilGrid holding exactly the JAX build's state."""
    fields = {f: np.asarray(getattr(sg, f))
              for f in interop.STENCIL_GRID_FIELDS}
    return interop.stencil_grid_from_numpy(fields, sg.dims, sg.radius,
                                           sg.pbc, dtype=dtype, device="cpu")


@pytest.mark.parametrize("case", sorted(CASES))
def test_choose_stencil_geometry_matches_jax(case):
    pos, cell, pbc, cutoff = CASES[case]()
    gj = jst.choose_stencil_geometry(jnp.asarray(pos), jnp.asarray(cell), pbc,
                                     cutoff)
    gt = tst.choose_stencil_geometry(torch.as_tensor(pos),
                                     torch.as_tensor(cell), pbc, cutoff)
    assert gj is not None and gt is not None
    assert gt[0] == gj[0] and gt[1] == gj[1] and gt[3] == gj[3] == 1
    np.testing.assert_array_equal(gt[2], gj[2])


def test_choose_stencil_geometry_dense_gas_matches_jax():
    """tests/test_stencil.py:42-49: a dense random gas has no occupancy-1
    binning, or both packages find the same one."""
    rng = np.random.default_rng(1)
    pos = rng.uniform(0, 10.0, (600, 3))
    cell = np.eye(3) * 10.0
    gj = jst.choose_stencil_geometry(jnp.asarray(pos), jnp.asarray(cell), PBC,
                                     4.0)
    gt = tst.choose_stencil_geometry(torch.as_tensor(pos),
                                     torch.as_tensor(cell), PBC, 4.0)
    assert (gj is None) == (gt is None)
    if gj is None:
        assert tst.build_stencil_auto(torch.as_tensor(pos),
                                      torch.as_tensor(cell), PBC, 4.0) is None
    else:
        assert gt[:2] == gj[:2] and gt[3] == gj[3] <= 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_stencil_matches_jax(case):
    pos, cell, pbc, cutoff = CASES[case]()
    sj = _jax_build(pos, cell, pbc, cutoff)
    if case == "nonperiodic":
        dims, radius, origin, _ = tst.choose_stencil_geometry(
            torch.as_tensor(pos), torch.as_tensor(cell), pbc, cutoff)
        st = tst.build_stencil_grid(torch.as_tensor(pos),
                                    torch.as_tensor(cell), pbc, dims, radius,
                                    origin=None if not origin.any()
                                    else origin)
    else:
        st = tst.build_stencil_auto(torch.as_tensor(pos),
                                    torch.as_tensor(cell), pbc, cutoff)
    assert st.dims == tuple(sj.dims) and st.radius == tuple(sj.radius)
    assert st.pbc == tuple(sj.pbc)
    assert (st.ext_dims, st.col_pad, st.flat_width) == (
        tuple(sj.ext_dims), sj.col_pad, sj.flat_width)
    np.testing.assert_array_equal(st.flat_idx.numpy(), np.asarray(sj.flat_idx))
    assert int(st.counts_max) == int(sj.counts_max) == 1
    for f in ("ext_px", "ext_py", "ext_pz"):
        assert_close(getattr(st, f), np.asarray(getattr(sj, f)), rtol=1e-12,
                     err_msg=f)


def test_scatter_gather_round_trip():
    pos, cell, pbc, cutoff = CASES["crystal8"]()
    st = tst.build_stencil_auto(torch.as_tensor(pos), torch.as_tensor(cell),
                                pbc, cutoff)
    vals = torch.arange(pos.shape[0], dtype=torch.float64)
    plane = tst.scatter_to_stencil(st, vals)
    assert torch.equal(tst.gather_from_stencil(st, plane), vals)
    a, b = tst.gather_rows_from_stencil(st, (plane, 2.0 * plane))
    assert torch.equal(a, vals) and torch.equal(b, 2.0 * vals)
    ext = tst.extend_stencil(st, plane, 0.0)
    assert ext.shape == (st.ext_dims[0], st.flat_width)
    assert torch.equal(tst._interior_of_ext(st, ext), plane)
    own = tst.own_flat_from_interior(st, plane)
    assert torch.equal(tst.own_interior(st, own), plane)


@pytest.fixture(scope="module")
def sweep_case():
    """tests/test_stencil.py:123-157's inputs (crystal n_rep 6, 6 A) in
    f64 on the JAX build, with the JAX xla sweeps' outputs."""
    pos, cell, pbc, cutoff = CASES["crystal6"]()
    rng = np.random.default_rng(9)
    n = pos.shape[0]
    q, rcov, decn = (rng.normal(size=n), rng.uniform(0.8, 1.4, n),
                     rng.normal(size=n))
    sj = _jax_build(pos, cell, pbc, cutoff)
    ref = {
        "coulomb": jst.stencil_coulomb_energy_forces(
            sj, jnp.asarray(q), cutoff, 0.35, engine="xla"),
        "coulomb0": jst.stencil_coulomb_energy_forces(
            sj, jnp.asarray(q), cutoff, 0.0, engine="xla"),
        "cn": jst.stencil_coordination_numbers(sj, jnp.asarray(rcov), cutoff,
                                               engine="xla"),
        "chain": jst.stencil_cn_chain_forces(sj, jnp.asarray(rcov),
                                             jnp.asarray(decn), cutoff,
                                             engine="xla"),
    }
    return dict(pos=pos, cell=cell, cutoff=cutoff, q=q, rcov=rcov, decn=decn,
                sj=sj, st=_port(sj), ref=ref)


def _port_sweep(st, body, c, engine):
    q, rcov, decn = (torch.as_tensor(c[k]) for k in ("q", "rcov", "decn"))
    cutoff = c["cutoff"]
    if body == "coulomb":
        return tst.stencil_coulomb_energy_forces(st, q, cutoff, 0.35,
                                                 engine=engine)
    if body == "coulomb0":
        return tst.stencil_coulomb_energy_forces(st, q, cutoff, 0.0,
                                                 engine=engine)
    if body == "cn":
        return tst.stencil_coordination_numbers(st, rcov, cutoff,
                                                engine=engine)
    return tst.stencil_cn_chain_forces(st, rcov, decn, cutoff, engine=engine)


@pytest.mark.parametrize("engine", [None, "xla", "stack", "fuse"])
@pytest.mark.parametrize("body", ["coulomb", "coulomb0", "cn", "chain"])
def test_stencil_sweeps_match_jax_xla(sweep_case, body, engine):
    """The half-space plain sweep (``None`` resolves to it on the CPU) and
    the full-space plain version (``"stack"``, ``"fuse"``) against the JAX
    half-space sweep, in f64."""
    c = sweep_case
    got = _port_sweep(c["st"], body, c, engine)
    want = c["ref"][body]
    if not isinstance(want, tuple):
        got, want = (got,), (want,)
    for a, b in zip(got, want):
        assert float(np.abs(np.asarray(b)).max()) > 0.0
        assert_close(a, np.asarray(b), rtol=1e-9)


def test_stencil_coulomb_nonperiodic_matches_jax_xla():
    pos, cell, pbc, cutoff = CASES["nonperiodic"]()
    q = np.random.default_rng(3).normal(size=pos.shape[0])
    sj = _jax_build(pos, cell, pbc, cutoff)
    e_j, f_j = jst.stencil_coulomb_energy_forces(sj, jnp.asarray(q), cutoff,
                                                 0.35, engine="xla")
    for engine in ("xla", "stack"):
        e_t, f_t = tst.stencil_coulomb_energy_forces(
            _port(sj), torch.as_tensor(q), cutoff, 0.35, engine=engine)
        assert_close(e_t, e_j, rtol=1e-9)
        assert_close(f_t, f_j, rtol=1e-9)


def test_stencil_f32_matches_jax_pallas_interpret(sweep_case):
    """The JAX full-space Pallas kernel (interpret mode) in f32 against the
    port's full-space plain version in f32, at the tolerances of
    tests/test_stencil.py:139-157: the Coulomb and chain bodies (the CN
    body's logistic is the chain body's, and each interpreted call takes
    seconds)."""
    c = sweep_case
    sj = _jax_build(c["pos"], c["cell"], PBC, c["cutoff"], jnp.float32)
    st = _port(sj, torch.float32)
    cutoff = c["cutoff"]
    q32, rcov32, decn32 = (c[k].astype(np.float32) for k in ("q", "rcov",
                                                           "decn"))
    e_j, f_j = jst.stencil_coulomb_energy_forces(sj, jnp.asarray(q32), cutoff,
                                                 0.35, engine="pallas")
    e_t, f_t = tst.stencil_coulomb_energy_forces(st, torch.as_tensor(q32),
                                                 cutoff, 0.35, engine="stack")
    assert f_t.dtype == torch.float32
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(
        tst.stencil_cn_chain_forces(st, torch.as_tensor(rcov32),
                                    torch.as_tensor(decn32), cutoff,
                                    engine="stack").numpy(),
        np.asarray(jst.stencil_cn_chain_forces(
            sj, jnp.asarray(rcov32), jnp.asarray(decn32), cutoff,
            engine="pallas")),
        rtol=1e-4, atol=2e-5)


@pytest.fixture(scope="module")
def hybrid_case():
    """tests/test_stencil.py:197-232's system (crystal n_rep 8, 6.5 A, five
    elements) in f64, on the JAX row grid and stencil."""
    pos, cell, pbc, cutoff = CASES["crystal8"]()
    rng = np.random.default_rng(6)
    tab = synthetic_tables(seed=6, zmax=5)
    numbers = rng.integers(1, 6, pos.shape[0]).astype(np.int32)
    g = build_atom_grid_auto(jnp.asarray(pos), jnp.asarray(cell), pbc, cutoff)
    sj = _jax_build(pos, cell, pbc, cutoff)
    return dict(numbers=numbers, tab=tab, cutoff=cutoff, g=g, sj=sj,
                gt=port_grid(g), st=_port(sj))


@pytest.mark.parametrize("hybrid_cn", ["stencil", "row"])
def test_hybrid_d3_matches_jax(hybrid_case, hybrid_cn):
    c = hybrid_case
    e_j, f_j, cn_j = jd3.grid_dftd3(
        c["g"], jnp.asarray(c["numbers"]), *(jnp.asarray(t) for t in c["tab"]),
        c["cutoff"], 0.42, 4.1, 1.7, stencil=c["sj"], hybrid_cn=hybrid_cn)
    e_t, f_t, cn_t = td3.grid_dftd3(
        c["gt"], c["numbers"], *c["tab"], c["cutoff"], 0.42, 4.1, 1.7,
        stencil=c["st"], hybrid_cn=hybrid_cn)
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-9)
    assert_close(f_t, f_j, rtol=1e-9)
    assert_close(cn_t, cn_j, rtol=1e-9)


def test_stencil_wrapper_runs_plain_version_on_cpu(sweep_case):
    """On a CPU tensor the kernel wrapper is its plain version (no launch);
    the engine names resolve as the JAX package's do off the TPU."""
    c = sweep_case
    st = c["st"]
    rcov_int = tst.scatter_to_stencil(st, torch.as_tensor(c["rcov"]))
    ext_named = (tst.extend_stencil(st, rcov_int, 0.0),)
    own_named = (tst.own_flat_from_interior(st, rcov_int),)
    ext, own = tst._planes(st, ext_named, own_named)
    params = SweepParams(cutoff=c["cutoff"])
    before = dict(launch_counts)
    a = ss.stencil_sweep("cn", st.dims, st.radius, ext, own, params)
    assert launch_counts == before
    assert torch.equal(a, ss.stencil_sweep_plain("cn", st.dims, st.radius,
                                                 ext, own, params))
    assert len(ss.full_offsets(st.radius)) == (
        np.prod([2 * r + 1 for r in st.radius]) - 1)
    assert tst._resolve_engine(None, torch.device("cpu")) == "xla"
    assert tst._resolve_engine(None, torch.device("cuda")) == "pallas"
    with pytest.raises(ValueError, match="unknown stencil engine"):
        tst._resolve_engine("mosaic", torch.device("cpu"))
    # a named "xla" engine takes the half-space sweep on a CPU tensor (no
    # kernel launch) and kernel 9 on a CUDA tensor
    assert tst._resolve_engine("xla", torch.device("cuda")) == "pallas"
    assert tst._resolve_engine("stack", torch.device("cuda")) == "stack"
    own_acc, folded = tst.stencil_reduce_sym(st, "cn", params, ext_named,
                                             own_named)
    (cn_x,) = tst._sweep(st, "cn", params, "xla", ext_named, own_named)
    assert launch_counts == before
    assert torch.equal(cn_x, tst.own_interior(st, own_acc[0]) + folded[0])
    with pytest.raises(ValueError, match="expected 5 features"):
        ss.stencil_sweep("chain", st.dims, st.radius, ext, own, params)
    with pytest.raises(ValueError, match="unsupported device"):
        ss.stencil_sweep("cn", st.dims, st.radius, ext.to("meta"),
                         own.to("meta"), params)

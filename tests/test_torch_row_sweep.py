# SPDX-License-Identifier: Apache-2.0
"""The port's per-row engine, ``grid_dftd3(engine="pallas")`` (kernel 7's
plain version on the CPU), against the JAX package, and the plain versions
of kernels 7 and 8 against kernel 1's, body by body.

In f64 the oracle is the JAX ``engine="xla"`` row sweep (rtol 1e-9); once
in f32 the port meets the JAX pallas engine itself (its Pallas kernel in
interpret mode) within the JAX tests' tolerances.  Kernels 1, 7 and 8 visit
the same pairs in different orders and groupings, so their plain versions
compute one function: the test holds each to kernel 1's in f64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvalchemiops_tpu.interactions.dispersion import grid_d3 as jd3
from nvalchemiops_torch import grid as tgrid
from nvalchemiops_torch.interactions.dispersion import grid_d3 as td3
from nvalchemiops_torch.kernels import chunk_sweep as cs
from nvalchemiops_torch.kernels import launch_counts
from nvalchemiops_torch.kernels import row_sweep as rs
from nvalchemiops_torch.kernels import window_sweep as ws
from tests._torch_port import assert_close, port_grid, synthetic_tables
from tests.test_torch_chunk_sweep import A1, A2, S8, _grid, _tables


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: Tier-1 runs six test workers on the CPU, and a
    torch thread pool in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines_case():
    """tests/test_grid.py:281-316: 100 atoms, sparse reference points."""
    rng = np.random.default_rng(11)
    tab = _tables(rng, sparse=True)
    pos = rng.uniform(0, 10.0, (100, 3))
    numbers = rng.integers(1, 5, 100).astype(np.int32)
    return dict(pos=pos, numbers=numbers, tab=tab)


def test_grid_dftd3_pallas_matches_jax_xla(engines_case):
    c = engines_case
    g = _grid(c["pos"], np.eye(3) * 10.0, np.array([True] * 3), 3.2, 100)
    e_j, f_j, cn_j = jd3.grid_dftd3(g, jnp.asarray(c["numbers"]),
                                    *(jnp.asarray(t) for t in c["tab"]), 3.2,
                                    A1, A2, S8, engine="xla")
    e_t, f_t, cn_t = td3.grid_dftd3(port_grid(g), c["numbers"], *c["tab"],
                                    3.2, A1, A2, S8, engine="pallas")
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-9)
    assert_close(f_t, f_j, rtol=1e-9)
    assert_close(cn_t, cn_j, rtol=1e-9)


def test_pallas_engine_f32_matches_jax_pallas_interpret(engines_case):
    """The JAX pallas engine itself (Pallas interpret) in f32 against the
    port's pallas engine in f32, at the JAX test's tolerances, on the
    case's first 60 atoms in an 8 A box (a 2^3-cell grid keeps the
    interpreted kernel's unrolled loops short)."""
    c = dict(engines_case, pos=engines_case["pos"][:60] * 0.8,
             numbers=engines_case["numbers"][:60])
    g32 = _grid(c["pos"], np.eye(3) * 8.0, np.array([True] * 3), 3.2, 60,
                jnp.float32)
    e_j, f_j, cn_j = jd3.grid_dftd3(
        g32, jnp.asarray(c["numbers"]),
        *(jnp.asarray(t, jnp.float32) for t in c["tab"]), 3.2, A1, A2, S8,
        engine="pallas")
    e_t, f_t, cn_t = td3.grid_dftd3(
        port_grid(g32, torch.float32), c["numbers"],
        *(t.astype(np.float32) for t in c["tab"]), 3.2, A1, A2, S8,
        engine="pallas")
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-6)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=1e-6)
    np.testing.assert_allclose(cn_t.numpy(), np.asarray(cn_j), atol=1e-5)


@pytest.fixture(scope="module")
def sweep_inputs():
    """Every body's inputs on one port-built grid (f64), in kernel 1's
    layout (candidate z, q, e[mesh], edc[mesh]) and in the zm-wide layout
    of kernels 7 and 8 (candidate rows cf)."""
    rng = np.random.default_rng(31)
    n, box, cutoff = 130, 10.0, 3.4
    pos = torch.as_tensor(rng.uniform(0, box, (n, 3)))
    numbers = rng.integers(1, 5, n).astype(np.int32)
    numbers[::13] = 0
    tab = synthetic_tables(seed=31)
    q = rng.normal(size=n)
    pbc = [True] * 3
    dims, radius, cap = tgrid.estimate_grid_geometry(np.eye(3) * box, pbc,
                                                     cutoff, n, 0.5)
    g = tgrid.build_atom_grid(pos, torch.eye(3, dtype=torch.float64) * box,
                              pbc, dims, radius, cap)
    _, _, planes, (q_p,) = td3._d3_inputs(g, numbers, *tab, extra=(q,))
    z_p, z_e, rcov_p, rcov_e, r4r2_p, r4r2_e, cna, mask, c6p = planes
    params = ws.SweepParams(cutoff=cutoff, a1=A1, a2=A2, s8=S8, alpha=0.35,
                            ccutoff=0.85 * cutoff)
    px_d = td3._parked_px(g, z_e)
    cn_p = td3._d3_pass1_cn(g, px_d, rcov_p, rcov_e, params)
    lf, e_p, edc_p, w_p = td3._d3_plane_features(z_p, cn_p, cna, mask, c6p,
                                                 params.k3)
    ext = lambda p: tgrid._extend_like(g, p, 0.0)          # noqa: E731
    e_e, edc_e, w_e, q_e = ext(e_p), ext(edc_p), ext(w_p), ext(q_p)
    decn_p = torch.as_tensor(rng.normal(size=z_p.shape)) * (z_p > 0)
    si_p, si_e = (torch.sqrt(p * td3._SQRT3) for p in (r4r2_p, r4r2_e))
    own_geo = [tgrid._interior(g, p) for p in (px_d, g.ext_py, g.ext_pz)]
    cand_geo = [px_d, g.ext_py, g.ext_pz]
    mesh_feats = [torch.movedim(e_e, -1, 0), torch.movedim(edc_e, -1, 0)]
    zf = z_e.to(px_d.dtype)[None]
    scalars = {
        "cn": ([rcov_p], [rcov_e]),
        "chain": ([rcov_p, decn_p], [rcov_e, ext(decn_p)]),
        "coulomb": ([q_p], [q_e]),
        "d3_direct": ([si_p, w_p], [si_e, w_e]),
        "d3_direct_coulomb": ([si_p, w_p, q_p], [si_e, w_e, q_e]),
    }
    out = {}
    for body, (own_x, cand_x) in scalars.items():
        own = torch.stack(own_geo + own_x)
        wide = torch.stack(cand_geo + cand_x)
        if body == "d3_direct":
            win = torch.cat([wide, zf] + mesh_feats)
        elif body == "d3_direct_coulomb":
            win = torch.cat([wide[:5], zf, wide[5:]] + mesh_feats)
        else:
            win = wide
        out[body] = (own, win.contiguous(), wide)
    cf = td3._wide_rows(e_e, edc_e, z_e, lf.shape[-1] // 2)
    return dict(g=g, params=params, lf=lf, cf=cf, bodies=out)


@pytest.mark.parametrize("kernel,body", [
    ("row", "cn"), ("row", "d3_direct"), ("row", "chain"),
    ("chunk", "cn"), ("chunk", "d3_direct"), ("chunk", "chain"),
    ("chunk", "coulomb"), ("chunk", "d3_direct_coulomb"),
])
def test_plain_versions_equal_kernel1_plain(sweep_inputs, kernel, body):
    """Kernel 7's and kernel 8's plain versions (the super-chunk one with
    all cx cells in one chunk, so it also visits pairs beyond rx cells)
    equal kernel 1's plain version, own and j-side planes, in f64."""
    s = sweep_inputs
    g, p = s["g"], s["params"]
    own, win, wide = s["bodies"][body]
    d3 = body.startswith("d3_direct")
    lf, cf = (s["lf"], s["cf"]) if d3 else (None, None)
    want = ws.window_sweep_plain(body, g.radius, own, win, p, lf=lf)
    if kernel == "row":
        got = rs.row_sweep_plain(body, g.radius, own, wide, p, lf, cf)
    else:
        got = cs.chunk_sweep_plain(body, g.radius, own, wide, p, g.dims[2],
                                   lf, cf)
    assert float(want[0].abs().max()) > 0.0
    for a, b in zip(got, want):
        assert a.shape == b.shape
        for k in range(b.shape[0]):
            assert_close(a[k], b[k].numpy(), rtol=1e-12,
                         err_msg=f"{body} output {k}")


def test_wide_wrappers_run_plain_version_on_cpu(sweep_inputs):
    s = sweep_inputs
    g, p = s["g"], s["params"]
    own, _, wide = s["bodies"]["d3_direct"]
    before = dict(launch_counts)
    a = rs.row_sweep("d3_direct", g.radius, own, wide, p, s["lf"], s["cf"])
    b = cs.chunk_sweep("d3_direct", g.radius, own, wide, p, 1, s["lf"],
                       s["cf"])
    assert launch_counts == before            # no kernel launched on CPU
    for x, y in zip(a, b):
        assert_close(x, y.numpy(), rtol=1e-12)
    with pytest.raises(ValueError, match="candidate rows cf"):
        rs.row_sweep("d3_direct", g.radius, own, wide, p, s["lf"])
    with pytest.raises(ValueError, match="unsupported device"):
        rs.row_sweep("cn", g.radius, *(t.to("meta") for t in
                                       s["bodies"]["cn"][::2]), p)
    with pytest.raises(ValueError, match="unknown chunk_sweep body"):
        cs.chunk_sweep("virial", g.radius, own, wide, p, 1)

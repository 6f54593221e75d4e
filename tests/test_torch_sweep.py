# SPDX-License-Identifier: Apache-2.0
"""The pair sweep's plain version, one test per pass body, against the JAX
package on an identical grid (passed in through ``interop``), in f64.

The JAX side is the ``engine="xla"`` row sweep, which walks the same
pair-once enumeration and attributes each pair to the same own slot, so
per-slot planes compare directly.  One tiny case runs the JAX window engine
itself (its Pallas kernel in interpret mode).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvalchemiops_tpu import grid as jgrid
from nvalchemiops_tpu.interactions.dispersion import grid_d3 as jd3
from nvalchemiops_torch import grid as tgrid
from nvalchemiops_torch.interactions.dispersion import grid_d3 as td3
from nvalchemiops_torch.kernels import launch_counts
from nvalchemiops_torch.kernels.window_sweep import (
    SweepParams, window_sweep, window_sweep_plain,
)
from tests._torch_port import (
    assert_close, jax_d3_planes, port_grid, random_system, synthetic_tables,
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
CUTOFF = 3.6


@pytest.fixture(scope="module")
def system():
    """180 random atoms, radius-(1, 1, 1) grid, synthetic tables."""
    pos, cell, numbers, charges = random_system(seed=11, n=180, box=11.0)
    tables = synthetic_tables()
    pbc = np.array([True] * 3)
    dims, radius, cap = jgrid.estimate_grid_geometry(cell, pbc, CUTOFF, 180,
                                                     0.5)
    gj = jgrid.build_atom_grid(jnp.asarray(pos), jnp.asarray(cell), pbc,
                               dims, radius, cap)
    return dict(pos=pos, numbers=numbers, charges=charges, tables=tables,
                gj=gj, gt=port_grid(gj))


@pytest.fixture(scope="module")
def jax_pass2(system):
    return jax_d3_planes(system["gj"], system["numbers"], *system["tables"],
                         CUTOFF, A1, A2, S8, skip_chain=True)


def _port_inputs(system):
    """The port's per-slot table planes on the shared grid."""
    gt = system["gt"]
    rcov, r4r2, c6, cna = (torch.as_tensor(a) for a in system["tables"])
    nl = torch.as_tensor(system["numbers"]).long()
    zf, rcov_p, r4r2_p = tgrid.scatter_rows_to_grid(
        gt, (nl.double(), rcov[nl], r4r2[nl]))
    z_plane = zf.to(torch.int32)
    z_ext = tgrid._extend_like(gt, z_plane, 0)
    return dict(z_plane=z_plane, z_ext=z_ext, rcov_p=rcov_p,
                rcov_e=tgrid._extend_like(gt, rcov_p, 0.0), r4r2_p=r4r2_p,
                r4r2_e=tgrid._extend_like(gt, r4r2_p, 0.0),
                px_d=td3._parked_px(gt, z_ext), cna=cna, c6=c6,
                mask=torch.as_tensor(td3.element_c6_mask(c6.numpy())))


def test_cn_body_matches_jax(system):
    gt = system["gt"]
    inp = _port_inputs(system)
    params = SweepParams(cutoff=CUTOFF)
    cn_plane = td3._d3_pass1_cn(gt, inp["px_d"], inp["rcov_p"],
                                inp["rcov_e"], params)
    rcov = system["tables"][0]
    cn_j = jgrid.grid_coordination_numbers(
        system["gj"], jnp.asarray(rcov[system["numbers"]]), CUTOFF)
    assert_close(tgrid.gather_from_grid(gt, cn_plane), cn_j, rtol=1e-10)


def test_d3_direct_body_matches_jax(system, jax_pass2):
    """Pass 2 alone, fed the JAX CN plane: energies, direct forces and
    dE/dCN per slot."""
    gt = system["gt"]
    inp = _port_inputs(system)
    e_j, fx_j, fy_j, fz_j, cn_j, decn_j = jax_pass2
    zmax1, mesh = inp["cna"].shape
    c6p = inp["c6"].permute(0, 2, 1, 3).reshape(zmax1, mesh, zmax1 * mesh)
    lf, e_pl, edc_pl, w_pl = td3._d3_plane_features(
        inp["z_plane"], torch.tensor(cn_j), inp["cna"], inp["mask"], c6p,
        -4.0)
    si_p = torch.sqrt(inp["r4r2_p"] * td3._SQRT3)
    si_e = torch.sqrt(inp["r4r2_e"] * td3._SQRT3)
    params = SweepParams(cutoff=CUTOFF, a1=A1, a2=A2, s8=S8)
    out = td3._d3_pass2_direct(gt, inp["px_d"], inp["z_ext"], si_p, si_e,
                               w_pl, e_pl, edc_pl, lf, params)
    assert np.abs(decn_j).max() > 1e-4, "dE/dCN too small to test"
    for name, got, want in zip(("e", "fx", "fy", "fz", "decn"), out,
                               (e_j, fx_j, fy_j, fz_j, decn_j)):
        assert_close(got, want, rtol=1e-9, err_msg=name)


def test_chain_body_matches_jax(system, jax_pass2):
    """Pass 3 alone, fed the JAX dE/dCN plane: the chain-rule forces are
    the JAX pass-3 planes minus its pass-2 planes."""
    gt = system["gt"]
    inp = _port_inputs(system)
    full = jax_d3_planes(system["gj"], system["numbers"],
                         *system["tables"], CUTOFF, A1, A2, S8)
    decn_j = jax_pass2[5]
    out = td3._d3_pass3_chain(gt, inp["px_d"], inp["rcov_p"], inp["rcov_e"],
                              torch.tensor(decn_j),
                              SweepParams(cutoff=CUTOFF))
    for k in range(3):
        chain_j = full[1 + k] - jax_pass2[1 + k]
        scale = np.abs(jax_pass2[1 + k]).max()
        assert np.abs(chain_j).max() > 1e-3 * scale
        np.testing.assert_allclose(out[k].numpy(), chain_j, rtol=1e-8,
                                   atol=1e-11 * scale)


@pytest.mark.parametrize("alpha", [0.0, 0.4])
def test_coulomb_body_matches_jax(system, alpha):
    q = system["charges"]
    e_j, f_j = jgrid.grid_coulomb_energy_forces(
        system["gj"], jnp.asarray(q), CUTOFF, alpha, engine="xla")
    e_t, f_t = tgrid.grid_coulomb_energy_forces(system["gt"],
                                                torch.as_tensor(q), CUTOFF,
                                                alpha)
    assert_close(e_t, e_j, rtol=1e-9)
    assert_close(f_t, f_j, rtol=1e-9)


def test_wrapper_runs_plain_version_on_cpu(system):
    gt = system["gt"]
    own = torch.stack([tgrid._interior(gt, p) for p in
                       (gt.ext_px, gt.ext_py, gt.ext_pz)]
                      + [tgrid._interior(gt, gt.ext_pz)])
    cand = torch.stack([gt.ext_px, gt.ext_py, gt.ext_pz, gt.ext_pz])
    before = dict(launch_counts)
    p = SweepParams(cutoff=CUTOFF, k1=16.0)
    a = window_sweep("cn", gt.radius, own, cand, p)
    b = window_sweep_plain("cn", gt.radius, own, cand, p)
    assert launch_counts == before            # no kernel launched on CPU
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="own features"):
        window_sweep("d3_direct", gt.radius, own, cand, p)
    with pytest.raises(ValueError, match="unsupported device"):
        window_sweep("cn", gt.radius, own.to("meta"), cand.to("meta"), p)


def test_kernel_build_is_lazy_and_needs_nvcc(monkeypatch):
    """Importing the port builds nothing; a build without nvcc raises."""
    from nvalchemiops_torch.kernels import build

    assert build.load_library.cache_info().currsize == 0
    path = build.library_path()
    assert path == build.library_path()
    assert path != build.library_path(("-Xptxas", "-v"))
    assert path.startswith(build.BUILD_DIR)
    assert sorted(os.path.basename(f) for f in build._sources()) == [
        "chunk_sweep.cu", "dense_pairs.cu", "device.cu", "row_sweep.cu",
        "separable_spline.cu", "stencil_sweep.cu", "window_sweep.cu",
        "windowed_gather.cu"]
    assert [os.path.basename(f) for f in build._headers()] == [
        "pair_bodies.cuh"]
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_window_engine_interpret_tiny():
    """The JAX window engine itself (Pallas interpret) on a tiny grid vs
    the port's grid_dftd3 on the same grid."""
    pos, cell, numbers, _ = random_system(seed=17, n=60, box=8.0, zmax=3)
    tables = synthetic_tables(seed=17, zmax=3)
    pbc = np.array([True] * 3)
    dims, radius, cap = jgrid.estimate_grid_geometry(cell, pbc, 3.5, 60, 0.5)
    gj = jgrid.build_atom_grid(jnp.asarray(pos), jnp.asarray(cell), pbc,
                               dims, radius, cap)
    e_j, f_j, cn_j = jd3.grid_dftd3(
        gj, jnp.asarray(numbers), *(jnp.asarray(t) for t in tables), 3.5,
        A1, A2, S8, engine="window")
    e_t, f_t, cn_t = td3.grid_dftd3(port_grid(gj), numbers, *tables, 3.5,
                                    A1, A2, S8, engine="window")
    assert_close(e_t, np.asarray(e_j), rtol=1e-9)
    assert_close(f_t, f_j, rtol=1e-9)
    assert_close(cn_t, cn_j, rtol=1e-10)

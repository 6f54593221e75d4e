# SPDX-License-Identifier: Apache-2.0
"""References of the port's multi-rank tests: the port's single-process
calls and the JAX package's namesakes on ``jax.devices()[:D]``, each
computed once per process (``lru_cache``), and the tolerance check."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from nvalchemiops_torch.parallel._dist import spawn_ranks
from nvalchemiops_tpu import parallel as jpar
from nvalchemiops_tpu.grid import build_atom_grid as jbuild

from tests import _torch_parallel_ranks as R

JAX_TOL = 1e-9
SINGLE_TOL = 1e-10
#: the sharded MLIP step against the single-process train_step
MLIP_SINGLE_TOL = 1e-12
GRID_KEYS = R.GRID_KEYS


def within(got, want, tol, what):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max()) if want.size else 0.0
    scale = float(np.abs(want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:g} x {scale:.3e}"


# ---------------------------------------------------------------------------
# References: the port's single-process calls and the JAX package's
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def single():
    """The port's single-process calls on every case."""
    out = {}
    for name, pbc, seed in R.GRID_CASES:
        res = R.grid_outputs(None, R.grid_system(seed), pbc)
        out.update({f"{name}/{k}": v.numpy() for k, v in res.items()})
    for case in R.PME_CASES:
        for k, v in enumerate(R.pme_outputs(None, case)):
            out[f"{case[0]}/{k}"] = v.numpy()
    for case in R.BATCH_CASES:
        for k, v in enumerate(R.batch_outputs(None, case)):
            out[f"{case[0]}/{k}"] = v.numpy()
    return out


@functools.lru_cache(maxsize=None)
def jax_grid(world, case):
    """The JAX domain sweeps of one grid case on ``world`` devices."""
    name, pbc, seed = case
    s = R.grid_system(seed)
    dims, radius, cap = R.geometry(s["cell"], pbc, len(s["pos"]))
    g = jbuild(jnp.asarray(s["pos"]), jnp.asarray(s["cell"]), np.array(pbc),
               dims, radius, cap)
    mesh = jpar.make_z_mesh(jax.devices()[:world])
    cell, q = jnp.asarray(s["cell"]), jnp.asarray(s["q"])
    z = jnp.asarray(s["numbers"])
    tables = tuple(jnp.asarray(s[k]) for k in ("rcov", "r4r2", "c6", "cna"))
    cn = jpar.domain_dftd3_cn(mesh, g, tables[0][z], cell, R.CUTOFF,
                              pbc=pbc)
    ec, fc = jpar.domain_coulomb_energy_forces(mesh, g, q, cell, R.CUTOFF,
                                               0.35, pbc=pbc)
    d3 = jpar.domain_dftd3(mesh, g, z, *tables, R.CUTOFF, *R.D3_ARGS, cell,
                           pbc=pbc)
    fused = jpar.domain_dftd3_coulomb(mesh, g, z, q, *tables, R.CUTOFF,
                                      *R.D3_ARGS, cell, alpha=0.4, pbc=pbc)
    return dict(zip(GRID_KEYS, (np.asarray(a) for a in
                                (cn, ec, fc, *d3, *fused))))


@functools.lru_cache(maxsize=None)
def jax_pme(world, case):
    name, seed, n, box, mesh_dims, alpha, forces = case
    pos, q, cell = R.pme_system(seed, n, box)
    res = jpar.domain_pme_reciprocal(
        jpar.make_z_mesh(jax.devices()[:world]), jnp.asarray(pos),
        jnp.asarray(q), jnp.asarray(cell), alpha, mesh_dims,
        compute_forces=forces)
    return [np.asarray(a) for a in (res if forces else (res,))]


@functools.lru_cache(maxsize=None)
def jax_batch(world, case):
    name, seed, b, n, box, mesh_dims, engine = case
    pos, q, cell = R.batch_system(seed, b, n, box)
    res = jpar.sharded_batch_pme_reciprocal(
        Mesh(np.array(jax.devices()[:world]), ("dp",)), jnp.asarray(pos),
        jnp.asarray(q), jnp.asarray(cell), R.BATCH_ALPHA, mesh_dims,
        compute_forces=True, engine=engine)
    return [np.asarray(a) for a in res]


@functools.lru_cache(maxsize=None)
def mlip_single():
    """The port's single-process ``train_step`` on the MLIP batch."""
    return R.mlip_step()


@functools.lru_cache(maxsize=None)
def jax_mlip():
    """The JAX package's ``train_step`` (jitted) on the MLIP batch, f64."""
    pos, numbers, cells, te, tf = R.mlip_train_batch()
    params = jpar.init_mlip_params(R.MLIP_ZMAX, jnp.float64)
    tables = jpar.default_d3_tables(R.MLIP_ZMAX, dtype=jnp.float64)
    batch = (jnp.asarray(pos), jnp.asarray(numbers), jnp.asarray(cells),
             jnp.asarray(te), jnp.asarray(tf))
    new, loss = jax.jit(jpar.train_step, static_argnums=(3, 4))(
        params, tables, batch, R.MLIP_CUTOFF, R.MLIP_LR)
    return ({f: np.asarray(getattr(new, f)) for f in new._fields},
            np.asarray(loss))


def check_mlip_mesh(got, world, dp, sp):
    """Every rank's new parameters and loss from the sharded step on a (dp,
    sp) mesh against the single-process step and the JAX step."""
    new1, loss1 = mlip_single()
    new_j, loss_j = jax_mlip()
    for r in range(world):
        key = f"mlip{dp}x{sp}/{r}"
        within(got[f"{key}/loss"], loss1, MLIP_SINGLE_TOL,
               f"{key} loss vs single process")
        within(got[f"{key}/loss"], loss_j, JAX_TOL, f"{key} loss vs JAX")
        for f, want in new1.items():
            within(got[f"{key}/{f}"], want, MLIP_SINGLE_TOL,
                   f"{key} {f} vs single process")
            within(got[f"{key}/{f}"], new_j[f], JAX_TOL, f"{key} {f} vs JAX")


def spawn_world(world, tmp_path_factory, names=None):
    """Spawn ``world`` gloo ranks through the launcher once; rank 0's
    outputs of every case (or those in ``names``)."""
    path = tmp_path_factory.mktemp(f"world{world}") / "out.npz"
    spawn_ranks(R.run_cases, world, "gloo", args=(str(path), names),
                deadline_s=400.0)
    return dict(np.load(path))


def check_grid_case(got, world, case, with_jax=True):
    """The four domain sweeps of one grid case against the single process
    and (``with_jax``) against JAX on ``world`` devices."""
    one = single()
    ref = jax_grid(world, case) if with_jax else {}
    for key in GRID_KEYS:
        name = f"{case[0]}/{key}"
        if with_jax:
            within(got[name], ref[key], JAX_TOL, f"{name} vs JAX")
        within(got[name], one[name], SINGLE_TOL,
               f"{name} vs single process")


def check_pme_case(got, world, case, jax_ref):
    """One tile-split or batch-split PME case against JAX and the single
    process."""
    one = single()
    for k, want in enumerate(jax_ref(world, case)):
        name = f"{case[0]}/{k}"
        within(got[name], want, JAX_TOL, f"{name} vs JAX")
        within(got[name], one[name], SINGLE_TOL, f"{name} vs single process")

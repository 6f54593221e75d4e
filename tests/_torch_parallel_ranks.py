# SPDX-License-Identifier: Apache-2.0
"""Rank bodies and inputs of the port's multi-rank tests.

Spawned ranks import this module, so it imports neither JAX nor the JAX
package: inputs are made here with numpy from a seed, and the test module
(which imports JAX) hands the same arrays to the JAX package.

Every rank of a world runs every case of :data:`GRID_CASES`,
:data:`PME_CASES` and :data:`BATCH_CASES` on CPU tensors in f64 (the
kernels then run their plain versions), the sharded MLIP training step on
each ``(dp, sp)`` mesh of :data:`MLIP_MESHES` and, in a world of two, the
rank body of ``entry.dryrun_multichip``, and checks the ``ValueError``
cases; rank 0 writes the outputs (the MLIP step's of every rank) to an
``.npz``.
"""

import json
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from nvalchemiops_torch import entry, parallel
from nvalchemiops_torch.grid import (
    build_atom_grid, estimate_grid_geometry, grid_coulomb_energy_forces,
)
from nvalchemiops_torch.interactions.dispersion.grid_d3 import (
    grid_dftd3, grid_dftd3_coulomb,
)
from nvalchemiops_torch.interactions.electrostatics.pme import (
    batch_pme_reciprocal, pme_reciprocal_space,
)

F64 = torch.float64
CUTOFF = 4.0
D3_ARGS = (0.42, 4.1, 1.7)            # a1, a2, s8
#: pbc (x, y, z): fully periodic, an open z (the ring's edges parked), an
#: open x and every axis open
PBCS = ((True, True, True), (True, True, False), (False, True, True),
        (False, False, False))
GRID_CASES = tuple((f"pbc{i}", pbc, 3 + i) for i, pbc in enumerate(PBCS))
#: the tile-split PME: (name, seed, atoms, box, mesh, alpha, forces)
PME_CASES = (("pme_forces", 11, 600, 24.0, (32, 32, 32), 0.4, True),
             ("pme_energies", 12, 300, 16.0, (16, 16, 32), 0.5, False))
#: the batch-split PME: (name, seed, systems, atoms, box, mesh, engine)
BATCH_CASES = (("batch_dense", 21, 4, 48, 9.0, (16, 16, 16), "dense"),
               ("batch_windowed", 22, 4, 40, 9.0, (16, 16, 16), "windowed"))
BATCH_ALPHA = 0.4
#: output names of the grid cases
GRID_KEYS = ("cn", "ec", "fc", "ed3", "fd3", "cnd3", "fused_ed3",
             "fused_fd3", "fused_cn", "fused_ec", "fused_fc")
#: the sharded MLIP training step: the (dp, sp) meshes of each world size,
#: on a batch of 4 systems x 16 atoms (every fifth a padding atom) that
#: divides over each of them
MLIP_MESHES = {2: ((1, 2), (2, 1)), 4: ((2, 2), (1, 4), (4, 1))}
MLIP_ZMAX = 4
MLIP_CUTOFF = 2.1
MLIP_LR = 1e-3


def grid_system(seed, n=800, box=32.0, zmax=4):
    """The domain tests' system (``tests/test_domain.py``): uniform
    positions in a 32 A box, charges, element ids and D3 tables."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, box, (n, 3))
    q = rng.normal(size=n)
    numbers = rng.integers(1, zmax + 1, n).astype(np.int32)
    rcov = np.r_[0.0, rng.uniform(0.6, 1.4, zmax)]
    r4r2 = np.r_[0.0, rng.uniform(2.0, 6.0, zmax)]
    cna = np.vstack([np.zeros(5),
                     np.cumsum(rng.uniform(0.3, 1.0, (zmax, 5)), 1)])
    c6 = rng.uniform(5.0, 40.0, (zmax + 1, zmax + 1, 5, 5))
    c6[0] = 0.0
    c6[:, 0] = 0.0
    c6 = 0.5 * (c6 + np.swapaxes(np.swapaxes(c6, 0, 1), 2, 3))
    return dict(pos=pos, cell=np.eye(3) * box, q=q, numbers=numbers,
                rcov=rcov, r4r2=r4r2, cna=cna, c6=c6)


def geometry(cell, pbc, n):
    """8 cells a side, radius 1 (target occupancy 0.4)."""
    return estimate_grid_geometry(cell, np.array(pbc), CUTOFF, n,
                                  target_occupancy=0.4)


def port_grid(s, pbc, dtype=F64, device="cpu"):
    dims, radius, cap = geometry(s["cell"], pbc, len(s["pos"]))
    return build_atom_grid(_t(s["pos"], dtype, device),
                           _t(s["cell"], dtype, device), np.array(pbc),
                           dims, radius, cap)


def pme_system(seed, n, box):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, box, (n, 3)), rng.normal(size=n), np.eye(3) * box


def batch_system(seed, b, n, box):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, box, (b, n, 3)), rng.normal(size=(b, n)),
            np.eye(3) * box)


def mlip_train_batch(seed=31, b=4, n=16):
    """The MLIP training batch (numpy): positions in boxes of 4.5-4.8 A
    (per-system ``[B, 3, 3]`` cells), element ids with padding atoms,
    energy and force targets."""
    rng = np.random.default_rng(seed)
    boxes = 4.5 + 0.1 * np.arange(b)
    pos = rng.uniform(0.0, 1.0, (b, n, 3)) * boxes[:, None, None]
    numbers = rng.integers(1, MLIP_ZMAX + 1, (b, n)).astype(np.int32)
    numbers[:, ::5] = 0
    cells = np.eye(3)[None] * boxes[:, None, None]
    return (pos, numbers, cells, rng.normal(size=b),
            rng.normal(size=(b, n, 3)) * 0.01)


def mlip_weights():
    """The port's f64 starting parameters and tables on the CPU."""
    return (parallel.init_mlip_params(MLIP_ZMAX, F64, device="cpu"),
            parallel.default_d3_tables(MLIP_ZMAX, dtype=F64, device="cpu"))


def mlip_step(mesh=None, batch=None):
    """``(new_params, loss)`` as numpy: the sharded step on ``mesh``'s
    block of the batch, or with ``mesh=None`` the single-process
    ``train_step`` on the whole batch."""
    params, tables = mlip_weights()
    batch = mlip_train_batch() if batch is None else batch
    if mesh is None:
        batch = tuple(torch.as_tensor(a) for a in batch)
        new, loss = parallel.train_step(params, tables, batch, MLIP_CUTOFF,
                                        MLIP_LR)
    else:
        step = parallel.sharded_train_step(mesh, MLIP_CUTOFF, MLIP_LR)
        new, loss = step(params, tables,
                         parallel.shard_batch(mesh, batch, device="cpu"))
    return ({f: getattr(new, f).numpy() for f in new._fields},
            loss.numpy())


def check_shard_rejections(world):
    """``shard_batch`` refuses a batch whose systems do not divide over dp
    or whose atoms do not divide over sp (both meshes of every rank)."""
    raised = 0
    for dp, sp, b, n in ((world, 1, world + 1, 16), (1, world, 4, 17)):
        mesh = parallel.make_mesh(dp=dp, sp=sp)
        _raises(lambda: parallel.shard_batch(
            mesh, mlip_train_batch(b=b, n=n), device="cpu"))
        raised += 1
    return raised


def _t(a, dtype=F64, device="cpu"):
    return torch.as_tensor(a, dtype=dtype, device=device)


def grid_outputs(zmesh, s, pbc, dtype=F64, device="cpu"):
    """``{name: tensor}`` of the four domain sweeps on system ``s`` (or,
    with ``zmesh=None``, of the single-process calls they split: the
    window engine's)."""
    g = port_grid(s, pbc, dtype, device)
    cell, q = _t(s["cell"], dtype, device), _t(s["q"], dtype, device)
    z = s["numbers"]
    tables = (s["rcov"], s["r4r2"], s["c6"], s["cna"])
    rcov_a = _t(s["rcov"], dtype, device)[torch.as_tensor(z).long()]
    if zmesh is None:
        ed3, fd3, cnd3 = grid_dftd3(g, z, *tables, CUTOFF, *D3_ARGS)
        ec, fc = grid_coulomb_energy_forces(g, q, CUTOFF, 0.35)
        fused = grid_dftd3_coulomb(g, z, q, *tables, CUTOFF, *D3_ARGS,
                                   alpha=0.4, engine="window")
        return dict(zip(GRID_KEYS, (cnd3, ec, fc, ed3, fd3, cnd3, *fused)))
    out = {}
    out["cn"] = parallel.domain_dftd3_cn(zmesh, g, rcov_a, cell, CUTOFF,
                                         pbc=pbc)
    out["ec"], out["fc"] = parallel.domain_coulomb_energy_forces(
        zmesh, g, q, cell, CUTOFF, 0.35, pbc=pbc)
    out["ed3"], out["fd3"], out["cnd3"] = parallel.domain_dftd3(
        zmesh, g, z, *tables, CUTOFF, *D3_ARGS, cell, pbc=pbc)
    (out["fused_ed3"], out["fused_fd3"], out["fused_cn"], out["fused_ec"],
     out["fused_fc"]) = parallel.domain_dftd3_coulomb(
        zmesh, g, z, q, *tables, CUTOFF, *D3_ARGS, cell, alpha=0.4, pbc=pbc)
    return out


def pme_outputs(zmesh, case, dtype=F64, device="cpu"):
    """The tile-split PME of one case (with ``zmesh=None``, the
    single-process ``pme_reciprocal_space``), as a tuple."""
    _, seed, n, box, mesh_dims, alpha, forces = case
    pos, q, cell = (_t(a, dtype, device) for a in pme_system(seed, n, box))
    if zmesh is None:
        out = pme_reciprocal_space(pos, q, cell, alpha,
                                   mesh_dimensions=mesh_dims,
                                   compute_forces=forces)
    else:
        out = parallel.domain_pme_reciprocal(zmesh, pos, q, cell, alpha,
                                             mesh_dims,
                                             compute_forces=forces)
    return out if forces else (out,)


def batch_outputs(dpmesh, case, dtype=F64, device="cpu"):
    """The batch-split PME of one case (with ``dpmesh=None``, the
    unsplit ``batch_pme_reciprocal``)."""
    _, seed, b, n, box, mesh_dims, engine = case
    pos, q, cell = (_t(a, dtype, device)
                    for a in batch_system(seed, b, n, box))
    if dpmesh is None:
        return batch_pme_reciprocal(pos, q, cell, BATCH_ALPHA, mesh_dims,
                                    compute_forces=True, engine=engine)
    return parallel.sharded_batch_pme_reciprocal(
        dpmesh, pos, q, cell, BATCH_ALPHA, mesh_dims, compute_forces=True,
        engine=engine)


def _raises(fn):
    try:
        fn()
    except ValueError:
        return
    raise AssertionError(f"{fn} did not raise ValueError")


def check_rejections(world, zmesh, dpmesh):
    """The ``ValueError`` cases: a grid whose z cells do not split into
    slabs of at least ``rz`` cells, a batch that does not divide over the
    ranks, a mesh the windows reject and (D > 1) a tile count that does
    not divide."""
    s = grid_system(5, n=100, box=9.0)
    pbc = (True, True, True)
    g = build_atom_grid(_t(s["pos"]), _t(s["cell"]), np.array(pbc),
                        *estimate_grid_geometry(s["cell"], np.array(pbc),
                                                3.0, 100,
                                                target_occupancy=0.4))
    cz = g.dims[0]
    if cz % world or cz // world < g.radius[0]:
        _raises(lambda: parallel.domain_coulomb_energy_forces(
            zmesh, g, _t(s["q"]), _t(s["cell"]), 3.0))
        _raises(lambda: parallel.domain_dftd3_cn(
            zmesh, g, _t(s["q"]) ** 2, _t(s["cell"]), 3.0))
    pos, q, cell = batch_system(21, world + 1, 8, 9.0)
    if (world + 1) % world:
        _raises(lambda: parallel.sharded_batch_pme_reciprocal(
            dpmesh, _t(pos), _t(q), _t(cell), 0.4, (16, 16, 16)))
    pos, q, cell = pme_system(12, 50, 9.0)
    _raises(lambda: parallel.domain_pme_reciprocal(
        zmesh, _t(pos), _t(q), _t(cell), 0.4, (36, 36, 36)))
    if world > 1:
        _raises(lambda: parallel.domain_pme_reciprocal(
            zmesh, _t(pos), _t(q), _t(cell), 0.4, (8, 8, 8)))
    return cz


def run_cases(rank, world, out_path, names=None):
    """Rank body: every case on this world (or those in ``names``); rank 0
    saves the outputs."""
    def wanted(name):
        return names is None or name in names

    zmesh = parallel.make_z_mesh()
    dpmesh = parallel.make_mesh()
    assert zmesh.mesh_dim_names == ("z",) and zmesh.size() == world
    assert dpmesh.mesh_dim_names == ("dp", "sp")
    # a 1-D ("dp",) mesh splits the batch over every rank; the ("dp",
    # "sp") mesh of make_mesh over its dp axis
    dp1 = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("dp",))
    saved = {"bad_cz": check_rejections(world, zmesh, dp1)}
    for name, pbc, seed in GRID_CASES:
        if wanted(name):
            out = grid_outputs(zmesh, grid_system(seed), pbc)
            saved.update({f"{name}/{k}": v for k, v in out.items()})
    for case in PME_CASES:
        if wanted(case[0]):
            for k, v in enumerate(pme_outputs(zmesh, case)):
                saved[f"{case[0]}/{k}"] = v
    for case, mesh in zip(BATCH_CASES, (dp1, dpmesh)):
        if wanted(case[0]):
            for k, v in enumerate(batch_outputs(mesh, case)):
                saved[f"{case[0]}/{k}"] = v
    if wanted("mlip") and world > 1:
        saved["mlip_bad_shapes"] = check_shard_rejections(world)
        for dp, sp in MLIP_MESHES.get(world, ()):
            got = [None] * world
            dist.all_gather_object(got, mlip_step(parallel.make_mesh(
                dp=dp, sp=sp)))
            for r, (new, loss) in enumerate(got):
                saved[f"mlip{dp}x{sp}/{r}/loss"] = loss
                saved.update({f"mlip{dp}x{sp}/{r}/{f}": v
                              for f, v in new.items()})
    if wanted("dryrun") and world == 2:
        # the rank body of entry.dryrun_multichip(2, device="cpu")
        entry._dryrun_rank(rank, world, "cpu")
        saved["dryrun"] = 1
    if rank == 0:
        np.savez(out_path, **{k: np.asarray(v) for k, v in saved.items()})


def card_cases(rank, world, out_path):
    """Rank body on the card (f32, cuda:0): the open-z grid case, the
    PME with forces and the dense batch through the domain calls and the
    single-process calls; rank 0 saves each output's max |diff| / scale
    and the launches of the domain calls."""
    import torch.distributed as dist

    from nvalchemiops_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.set_device(0)
    dev, f32 = torch.device("cuda", 0), torch.float32
    zmesh = parallel.make_z_mesh()
    dp1 = parallel.make_mesh(dp=world, sp=1)
    s, pbc = grid_system(GRID_CASES[1][2]), GRID_CASES[1][1]
    reset_launch_counts()
    got = grid_outputs(zmesh, s, pbc, f32, dev)
    got.update(("pme/" + str(k), v) for k, v in enumerate(
        pme_outputs(zmesh, PME_CASES[0], f32, dev)))
    got.update(("batch/" + str(k), v) for k, v in enumerate(
        batch_outputs(dp1, BATCH_CASES[0], f32, dev)))
    counts = {k: v for k, v in launch_counts.items() if v}
    transport = parallel._dist.transport(zmesh.get_group("z"), dev)
    assert transport == ("nccl" if dist.get_backend() == "nccl"
                         else "gloo via host"), transport
    if rank != 0:
        return
    want = grid_outputs(None, s, pbc, f32, dev)
    want.update(("pme/" + str(k), v) for k, v in enumerate(
        pme_outputs(None, PME_CASES[0], f32, dev)))
    want.update(("batch/" + str(k), v) for k, v in enumerate(
        batch_outputs(None, BATCH_CASES[0], f32, dev)))
    errors = {k: ((got[k].double() - w.double()).abs().max()
                  / w.double().abs().max()).item() for k, w in want.items()}
    np.savez(out_path, counts=np.array(json.dumps(counts)), **errors)


def fail_on_rank(rank, world, bad_rank):
    """A rank body that raises on ``bad_rank``."""
    if rank == bad_rank:
        raise RuntimeError(f"rank {rank} fails on purpose")


def sleep_forever(rank, world):
    """A rank body that never returns."""
    while True:
        time.sleep(1.0)

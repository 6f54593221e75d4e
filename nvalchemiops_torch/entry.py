# SPDX-License-Identifier: Apache-2.0
"""Entry points of the port: the MLIP forward on one card and a dry run of
every multi-rank path (counterparts of the JAX package's ``entry()`` and
``dryrun_multichip(n)``).

- :func:`entry` returns ``(forward, args)``: the batched MLIP forward
  (:func:`parallel.mlip.batched_energy_forces`) at 4 systems x 256 atoms,
  zmax 4, 6 A boxes, cutoff 2.9 A, and its inputs, drawn from a seed as
  the JAX package draws them.
- :func:`dryrun_multichip` spawns ``n_devices`` ranks; each runs one
  :func:`parallel.mlip.sharded_train_step` on the ``("dp", "sp")`` mesh of
  :func:`parallel.mlip.make_mesh` at ``2 dp`` systems x ``16 sp`` atoms,
  then the z-slab domain sweeps (Coulomb and D3 on kernel 1), the
  tile-split PME on a ``(8 n)^3`` mesh and the batch-split PME on ``2 n``
  systems x 64 atoms at 16^3, and checks that the loss and the energies
  are finite.

Both run on the card unless the caller names the CPU; neither falls back
to the CPU on its own.  Importing this module builds no kernel and starts
no process group.
"""

from __future__ import annotations

import numpy as np
import torch

from nvalchemiops_torch.types import default_device

__all__ = ["entry", "dryrun_multichip"]

ZMAX = 4
CUTOFF = 2.9           # < half the 6 A box, for the minimum-image pair sum
BOX = 6.0


def _device(device):
    """The device an entry point runs on: the card unless ``device`` names
    another; a card that is not there raises."""
    dev = default_device(None, device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the entry points run on the card "
                           "unless called with device='cpu'")
    return dev


def make_batch(num_systems: int, atoms_per_system: int, zmax: int = ZMAX,
               dtype=torch.float32, device=None, box: float = BOX):
    """The MLIP batch ``(positions [B, n, 3], numbers [B, n], cells [B, 3,
    3], target_e [B], target_f [B, n, 3])``: numpy ``default_rng(0)``
    draws in cubic boxes of ``box`` A, as the JAX package's entry points
    draw them (6 A), on ``device`` (the card unless named)."""
    dev = _device(device)
    rng = np.random.default_rng(0)
    positions = rng.uniform(0, box, (num_systems, atoms_per_system, 3))
    numbers = rng.integers(1, zmax + 1, (num_systems, atoms_per_system))
    cell = np.tile(np.eye(3) * box, (num_systems, 1, 1))
    target_e = rng.normal(size=(num_systems,))
    target_f = rng.normal(size=positions.shape) * 0.01
    return (torch.as_tensor(positions, dtype=dtype, device=dev),
            torch.as_tensor(numbers, dtype=torch.int32, device=dev),
            torch.as_tensor(cell, dtype=dtype, device=dev),
            torch.as_tensor(target_e, dtype=dtype, device=dev),
            torch.as_tensor(target_f, dtype=dtype, device=dev))


def entry(device=None):
    """The flagship MLIP's forward step: ``(forward, (params, positions,
    numbers, cell))`` with ``forward(params, positions, numbers, cell) ->
    (energies [4], forces [4, 256, 3])`` in f32 on the card (or on
    ``device``)."""
    from nvalchemiops_torch.parallel.mlip import (
        batched_energy_forces, default_d3_tables, init_mlip_params,
    )

    dev = _device(device)
    dtype = torch.float32
    params = init_mlip_params(ZMAX, dtype, device=dev)
    tables = default_d3_tables(ZMAX, dtype=dtype, device=dev)
    positions, numbers, cell, _, _ = make_batch(4, 256, ZMAX, dtype, dev)

    def forward(params, positions, numbers, cell):
        return batched_energy_forces(params, tables, positions, numbers, cell,
                                     CUTOFF)

    return forward, (params, positions, numbers, cell)


def dryrun_multichip(n_devices: int, device=None, backend=None) -> None:
    """One sharded training step and one step of each domain-decomposed
    path on ``n_devices`` ranks (spawned processes on
    ``torch.distributed``).

    On the card (the default) ``backend`` defaults to NCCL, one rank per
    card; a machine with fewer cards than ranks raises ``ValueError``
    (``backend="gloo"`` shares one card between the ranks).
    ``device="cpu"`` runs gloo on CPU tensors.  A rank whose loss or
    energies are not finite fails the call (``RuntimeError``)."""
    from nvalchemiops_torch.parallel._dist import spawn_ranks

    n = int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    dev = _device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("NCCL runs on the card: pass backend='gloo' "
                             "with device='cpu'")
        if torch.cuda.device_count() < n:
            raise ValueError(
                f"NCCL takes one rank per card: {n} ranks, "
                f"{torch.cuda.device_count()} cards; backend='gloo' shares "
                "one card between the ranks")
    spawn_ranks(_dryrun_rank, n, backend, args=(dev.type,),
                threads=1 if dev.type == "cpu" else 0)


def _dryrun_rank(rank, world, device_type):
    """One rank of :func:`dryrun_multichip` (the process group is up)."""
    from nvalchemiops_torch.parallel.mlip import (
        default_d3_tables, init_mlip_params, make_mesh, shard_batch,
        sharded_train_step,
    )

    dev = torch.device("cpu")
    if device_type == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    mesh = make_mesh()
    dp, sp = mesh.mesh.shape
    dtype = torch.float32
    params = init_mlip_params(ZMAX, dtype, device=dev)
    tables = default_d3_tables(ZMAX, dtype=dtype, device=dev)
    batch = shard_batch(mesh, make_batch(2 * dp, 16 * sp, ZMAX, dtype, dev),
                        device=dev)
    step = sharded_train_step(mesh, cutoff=CUTOFF, lr=1e-3)
    new_params, loss = step(params, tables, batch)
    if not (torch.isfinite(loss) and all(torch.isfinite(p).all()
                                         for p in new_params)):
        raise RuntimeError(f"rank {rank}: non-finite loss or parameters in "
                           f"the sharded training step ({loss.item()})")
    _dryrun_domain_decomposition(world, dev)


def _dryrun_domain_decomposition(n_devices: int, dev) -> None:
    """The z-slab Coulomb and D3, the tile-split PME and the batch-split
    PME at the JAX dry run's shapes: 400 atoms in a ``4 n`` A box at 4 A,
    a ``(8 n)^3`` mesh, ``2 n`` systems x 64 atoms in 8 A boxes at 16^3.

    The grid is the JAX dry run's (``target_occupancy=0.3``, one cell per
    cutoff): at ``n = 1`` all 400 atoms in one cell of cap 1,336, whose
    windows kernel 1 stages in slices of its shared memory."""
    from torch.distributed.device_mesh import DeviceMesh

    from nvalchemiops_torch.grid import build_atom_grid, estimate_grid_geometry
    from nvalchemiops_torch.parallel.batch_pme import (
        sharded_batch_pme_reciprocal,
    )
    from nvalchemiops_torch.parallel.domain import (
        _mesh_device_type, domain_coulomb_energy_forces, domain_dftd3,
        domain_pme_reciprocal, make_z_mesh,
    )

    f32 = torch.float32

    def t(a, dtype=f32):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    rng = np.random.default_rng(1)
    n, box, cutoff = 400, 4.0 * n_devices, 4.0
    pos = t(rng.uniform(0, box, (n, 3)))
    cell = t(np.eye(3) * box)
    pbc = np.array([True] * 3)
    dims, radius, cap = estimate_grid_geometry(
        np.eye(3) * box, pbc, cutoff, n, target_occupancy=0.3)
    grid = build_atom_grid(pos, cell, pbc, dims, radius, cap)
    if dims[0] % n_devices:
        raise RuntimeError(f"grid {dims} does not split over {n_devices}")

    zmesh = make_z_mesh()
    q = t(rng.normal(size=n))
    e, f = domain_coulomb_energy_forces(zmesh, grid, q, cell, cutoff, 0.3)

    zmax = 4
    numbers = t(rng.integers(1, zmax + 1, n), torch.int32)
    rcov = np.r_[0.0, rng.uniform(0.6, 1.4, zmax)]
    r4r2 = np.r_[0.0, rng.uniform(2.0, 6.0, zmax)]
    cna = np.vstack([np.zeros(5),
                     np.cumsum(rng.uniform(0.3, 1.0, (zmax, 5)), 1)])
    c6 = rng.uniform(5.0, 40.0, (zmax + 1, zmax + 1, 5, 5))
    c6[0] = 0.0
    c6[:, 0] = 0.0
    c6 = 0.5 * (c6 + np.swapaxes(np.swapaxes(c6, 0, 1), 2, 3))
    ed3, fd3, cn = domain_dftd3(zmesh, grid, numbers, rcov, r4r2, c6, cna,
                                cutoff, 0.42, 4.1, 1.7, cell)
    e_pme, f_pme = domain_pme_reciprocal(
        zmesh, pos, q, cell, 0.35, (8 * n_devices,) * 3,
        compute_forces=True)

    # the batch split: one system axis over every rank
    bmesh = DeviceMesh(_mesh_device_type(), torch.arange(n_devices),
                       mesh_dim_names=("dp",))
    rngb = np.random.default_rng(7)
    bb, nn, boxb = 2 * n_devices, 64, 8.0
    pos_b = t(rngb.uniform(0, boxb, (bb, nn, 3)))
    q_b = t(rngb.normal(size=(bb, nn)))
    e_bp, f_bp = sharded_batch_pme_reciprocal(
        bmesh, pos_b, q_b, t(np.eye(3) * boxb), 0.4, (16, 16, 16),
        compute_forces=True)
    finite = {name: bool(torch.isfinite(x).all()) for name, x in (
        ("coulomb", e), ("coulomb forces", f), ("d3", ed3),
        ("d3 forces", fd3), ("cn", cn), ("pme", e_pme),
        ("pme forces", f_pme), ("batch pme", e_bp),
        ("batch pme forces", f_bp))}
    if not all(finite.values()):
        raise RuntimeError(f"non-finite domain-decomposition dry run: "
                           f"{finite}")

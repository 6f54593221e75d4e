# SPDX-License-Identifier: Apache-2.0
"""A differentiable MLIP built from the library's interaction terms
(counterpart of ``nvalchemiops_tpu.parallel.mlip``).

A physically structured machine-learned interatomic potential

    E = E_elec (erfc-damped Coulomb, learnable per-element charges)
      + E_rep  (Born-Mayer exp repulsion, learnable amplitudes/length)
      + E_disp (DFT-D3(BJ)-style dispersion with CN-interpolated C6,
                learnable damping/scaling)

over periodic systems, as a dense minimum-image pair sum; forces are the
exact energy gradients (``torch.autograd``), and the training step
differentiates the force-matching loss through the forces again (a double
backward through the CNs and the C6 interpolation).  Plain torch, as it is
plain XLA in the JAX package: no kernel.  The tables and starting
parameters are drawn as the JAX package draws them, so both packages start
from equal bits.

Multi-rank: :func:`make_mesh` builds the ``("dp", "sp")`` mesh of the JAX
package on ``torch.distributed``; :func:`shard_batch` gives each rank its
block of a batch (systems over ``dp``, atoms over ``sp``) and
:func:`sharded_train_step` the step on those blocks, with the collectives
that XLA inserts in the JAX package written out: each ``sp`` rank gathers
its systems' atoms, takes the energy of the pairs of its own rows and its
gradient, the forces are one all-reduce of those gradients, and the
parameter gradients one all-reduce over the mesh (no collective sits
inside an autograd graph).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from nvalchemiops_torch.interactions.dispersion._kernels import (
    _c6_interpolate,
)
from nvalchemiops_torch.mathops.math import apply_mat3, erfc_approx
from nvalchemiops_torch.parallel._dist import (
    all_gather_cat, all_reduce_sum, axis_group,
)
from nvalchemiops_torch.parallel.domain import _mesh_device_type
from nvalchemiops_torch.types import default_device

__all__ = [
    "MLIPParams",
    "init_mlip_params",
    "mlip_energy",
    "batched_energy_forces",
    "train_step",
    "make_mesh",
    "shard_batch",
    "sharded_train_step",
]


class MLIPParams(NamedTuple):
    """Learnable parameters (element-indexed tables + scalars)."""

    charge: torch.Tensor  # [Zmax+1] per-element partial charges
    repulse_a: torch.Tensor  # [Zmax+1] Born-Mayer amplitudes (log-space)
    repulse_rho: torch.Tensor  # [] Born-Mayer decay length (log-space)
    s6: torch.Tensor  # [] dispersion scalings
    s8: torch.Tensor
    a1: torch.Tensor  # [] BJ damping
    a2: torch.Tensor


class D3Tables(NamedTuple):
    """Fixed element tables for the dispersion term."""

    rcov: torch.Tensor
    r4r2: torch.Tensor
    c6ab: torch.Tensor
    cn_ref: torch.Tensor


def init_mlip_params(zmax: int, dtype=torch.float32,
                     device="cuda") -> MLIPParams:
    """Smooth, non-degenerate starting parameters for the toy MLIP (on
    ``device``, the card unless the caller names another)."""
    z = torch.arange(zmax + 1, dtype=dtype, device=device)

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=device)

    return MLIPParams(
        charge=0.1 * torch.sin(z),
        repulse_a=torch.full((zmax + 1,), 1.0, dtype=dtype, device=device),
        repulse_rho=scalar(-1.0),  # log(rho) ~ rho = 0.37
        s6=scalar(1.0),
        s8=scalar(1.5),
        a1=scalar(0.4),
        a2=scalar(4.0),
    )


def default_d3_tables(zmax: int, seed: int = 0, dtype=torch.float32,
                      device="cuda") -> D3Tables:
    """Smooth synthetic element tables (for demos and benchmarks): the JAX
    package's numpy draws, on ``device``."""
    rng = np.random.default_rng(seed)
    rcov = np.concatenate([[0.0], rng.uniform(0.6, 1.4, zmax)])
    r4r2 = np.concatenate([[0.0], rng.uniform(2.0, 6.0, zmax)])
    c6 = rng.uniform(5.0, 40.0, (zmax + 1, zmax + 1, 5, 5))
    c6[0] = 0.0
    c6[:, 0] = 0.0
    c6 = 0.5 * (c6 + np.swapaxes(np.swapaxes(c6, 0, 1), 2, 3))
    cn = np.cumsum(rng.uniform(0.3, 1.0, (zmax + 1, zmax + 1, 5, 5)), axis=2)
    return D3Tables(*(torch.as_tensor(a, dtype=dtype, device=device)
                      for a in (rcov, r4r2, c6, cn)))


def _minimum_image_pairs(positions, cell):
    """All-pair displacement vectors ``[n, n, 3]`` under the minimum-image
    convention (``torch.round`` rounds half to even, as ``jnp.round``);
    for cutoffs below half the box.  Differentiable in positions and
    cell."""
    frac = apply_mat3(positions, torch.linalg.inv(cell))
    dfrac = frac[None, :, :] - frac[:, None, :]
    dfrac = dfrac - torch.round(dfrac)
    return apply_mat3(dfrac, cell)


def mlip_energy(params: MLIPParams, tables: D3Tables, positions, numbers,
                cell, cutoff, alpha=0.6):
    """Total energy of one (padded) periodic system.

    ``numbers == 0`` marks padding atoms.  Dense minimum-image pair sum,
    for systems up to a few thousand atoms.
    """
    return _system_energy(params, tables, positions, numbers, cell, cutoff,
                          alpha)


def _system_energy(params, tables, positions, numbers, cell, cutoff,
                   alpha=0.6, rows=None):
    """:func:`mlip_energy`, or with ``rows`` (a slice of atoms) the energy
    of the pairs of those rows: half of each pair term with an atom of
    ``rows`` on its left.  The CNs take every atom either way, so the rows
    of a partition of the atoms sum to the total."""
    dtype, device = positions.dtype, positions.device
    n = positions.shape[0]
    numbers = torch.as_tensor(numbers, device=device).long()
    alive = numbers != 0
    zero = torch.zeros((), dtype=dtype, device=device)
    own = slice(None) if rows is None else rows

    def half_sum(terms):
        return 0.5 * torch.sum(torch.where(mask, terms, zero)[own])

    d = _minimum_image_pairs(positions, cell)
    r2 = torch.sum(d * d, dim=-1)
    eye = torch.eye(n, dtype=torch.bool, device=device)
    pair_ok = alive[:, None] & alive[None, :] & ~eye
    r2_safe = torch.where(pair_ok, r2, torch.ones_like(r2))
    r = torch.sqrt(r2_safe)
    mask = pair_ok & (r < cutoff) & (r > 1e-6)
    r = torch.where(mask, r, torch.ones_like(r))
    inv_r = 1.0 / r
    alive_f = alive.to(dtype)

    q = params.charge[numbers] * alive_f
    qq = q[:, None] * q[None, :]
    e_elec = half_sum(qq * erfc_approx(alpha * r) * inv_r)

    a_rep = torch.exp(params.repulse_a)[numbers] * alive_f
    rho = torch.exp(params.repulse_rho)
    e_rep = half_sum(a_rep[:, None] * a_rep[None, :] * torch.exp(-r / rho))

    # dispersion: CN -> C6(CN) -> BJ-damped -C6/r^6 - C8/r^8
    rcov = tables.rcov[numbers]
    rcov_ij = rcov[:, None] + rcov[None, :]
    f_cn = 1.0 / (1.0 + torch.exp(-16.0 * (rcov_ij * inv_r - 1.0)))
    cn = torch.sum(torch.where(mask, f_cn, zero), dim=1)

    zi = numbers[:, None]
    zj = numbers[None, :]
    c6_mat = tables.c6ab[zi, zj]
    cnref_i = tables.cn_ref[zi, zj]
    cnref_j = tables.cn_ref[zj, zi]
    c6, _, _ = _c6_interpolate(cn[:, None], cn[None, :], c6_mat, cnref_i,
                               cnref_j, -4.0)

    r4r2 = tables.r4r2[numbers]
    rr = 3.0 * r4r2[:, None] * r4r2[None, :]
    r0 = params.a1 * torch.sqrt(rr) + params.a2
    r6 = r2_safe ** 3
    r8 = r2_safe ** 4
    e_disp = half_sum(
        -c6 * (params.s6 / (r6 + r0 ** 6) + params.s8 * rr / (r8 + r0 ** 8)))
    return e_elec + e_rep + e_disp


def _energies_forces(params, tables, positions, numbers, cell, cutoff,
                     create_graph):
    """``[B]`` energies and ``[B, n, 3]`` forces (-dE/dr by autograd);
    with ``create_graph`` both stay functions of the parameters, so a loss
    of the forces can be differentiated again."""
    with torch.enable_grad():
        pos = positions.detach().requires_grad_(True)
        energies = torch.stack([
            _system_energy(params, tables, pos[b], numbers[b], cell[b],
                           cutoff)
            for b in range(pos.shape[0])])
        (grad,) = torch.autograd.grad(energies.sum(), pos,
                                      create_graph=create_graph)
    return energies, -grad


def batched_energy_forces(params, tables, positions, numbers, cell, cutoff):
    """``[B, n, ...]`` batched energies ``[B]`` and forces ``[B, n, 3]``
    (forces = -dE/dr, exact, by ``torch.autograd.grad`` of the summed
    energies); both detached."""
    energies, forces = _energies_forces(params, tables, positions, numbers,
                                        cell, cutoff, create_graph=False)
    return energies.detach(), forces.detach()


def _batch_tensors(batch, device=None):
    """``(positions, numbers, cell, target_e, target_f)`` as tensors: on
    the first tensor's device (else ``device``, the card unless named),
    floats in the positions' dtype, the element ids as given."""
    dev = default_device(next((a for a in batch
                               if isinstance(a, torch.Tensor)), None), device)
    positions = torch.as_tensor(batch[0], device=dev)
    dtype = positions.dtype
    numbers = torch.as_tensor(batch[1], device=dev)
    return (positions, numbers) + tuple(
        torch.as_tensor(a, device=dev).to(dtype) for a in batch[2:])


def loss_fn(params, tables, batch, cutoff):
    """Energy + force MSE of the batched MLIP against the batch targets:
    the mean squared energy error over systems plus the squared force
    error summed over alive atoms (``numbers != 0``) and divided by their
    count.  Differentiable in the parameters through the forces."""
    positions, numbers, cell, target_e, target_f = _batch_tensors(batch)
    energies, forces = _energies_forces(params, tables, positions, numbers,
                                        cell, cutoff, create_graph=True)
    alive = (numbers != 0)[..., None]
    n_alive = torch.clamp(alive.sum(), min=1).to(positions.dtype)
    e_loss = torch.mean((energies - target_e) ** 2)
    f_loss = torch.sum(torch.where(alive, (forces - target_f) ** 2,
                                   torch.zeros_like(forces))) / n_alive
    return e_loss + f_loss


def _leaves(params):
    """Fresh leaves of the parameters that autograd differentiates."""
    return MLIPParams(*(p.detach().requires_grad_(True) for p in params))


def _sgd(leaves, grads, lr):
    return MLIPParams(*((p - lr * g).detach() for p, g in zip(leaves,
                                                               grads)))


def train_step(params, tables, batch, cutoff, lr=1e-3):
    """One SGD step on the force-matching loss (fully differentiable): the
    loss and its gradient with respect to every field of ``params`` (a
    double backward through the forces).  Returns ``(new_params, loss)``,
    ``new_params = params - lr * grad`` field by field, detached."""
    leaves = _leaves(params)
    with torch.enable_grad():
        loss = loss_fn(leaves, tables, batch, cutoff)
        grads = torch.autograd.grad(loss, leaves)
    return _sgd(leaves, grads, lr), loss.detach()


def make_mesh(devices=None, dp: int | None = None,
              sp: int | None = None) -> DeviceMesh:
    """A ``("dp", "sp")`` mesh over ``devices`` (global ranks; default:
    every rank of the initialised process group), with the JAX package's
    factorisation when ``dp`` or ``sp`` is not given: the widest ``sp``
    that divides the rank count, preferring ``sp >= dp``.  Every rank of
    the group calls it."""
    ranks = list(range(dist.get_world_size()) if devices is None
                 else devices)
    n = len(ranks)
    if dp is None or sp is None:
        sp = 1
        for cand in range(int(np.sqrt(n)), 0, -1):
            if n % cand == 0:
                sp = n // cand
                break
        dp = n // sp
    return DeviceMesh(_mesh_device_type(),
                      torch.tensor(ranks).reshape(dp, sp),
                      mesh_dim_names=("dp", "sp"))


def shard_batch(mesh: DeviceMesh, batch, device=None):
    """This rank's block of a ``(positions, numbers, cell, target_e,
    target_f)`` batch on a ``("dp", "sp")`` mesh: systems over ``"dp"``
    and atoms over ``"sp"`` for the per-atom arrays (positions ``[B/dp,
    n/sp, 3]``, numbers, force targets), systems over ``"dp"`` for the
    per-system ones (cells ``[B/dp, 3, 3]``, energy targets), as JAX's
    ``NamedSharding``s place them.  Raises ``ValueError`` where B does not
    divide over dp or n over sp.

    The blocks go on ``device``: by default the mesh's card under NCCL,
    else the batch's own device (the card for arrays that are not
    tensors); pass ``device="cpu"`` for the CPU."""
    _, dp, dp_rank = axis_group(mesh, "dp")
    _, sp, sp_rank = axis_group(mesh, "sp")
    if device is None and mesh.device_type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    if device is not None:
        batch = tuple(a.to(device) if isinstance(a, torch.Tensor) else a
                      for a in batch)
    positions, numbers, cell, target_e, target_f = _batch_tensors(batch,
                                                                  device)
    b, n = positions.shape[0], positions.shape[1]
    if b % dp or n % sp:
        raise ValueError(f"a batch of {b} systems x {n} atoms does not "
                         f"shard over dp={dp} x sp={sp}")
    if cell.dim() == 2:
        cell = cell.expand(b, 3, 3)
    sys_rows = slice(dp_rank * (b // dp), (dp_rank + 1) * (b // dp))
    atoms = slice(sp_rank * (n // sp), (sp_rank + 1) * (n // sp))
    return (positions[sys_rows, atoms].contiguous(),
            numbers[sys_rows, atoms].contiguous(),
            cell[sys_rows].contiguous(), target_e[sys_rows].contiguous(),
            target_f[sys_rows, atoms].contiguous())


def sharded_train_step(mesh: DeviceMesh, cutoff: float, lr: float = 1e-3):
    """The training step for a ``("dp", "sp")`` mesh: ``step(params,
    tables, batch) -> (new_params, loss)`` on this rank's block of the
    batch (:func:`shard_batch`), with the parameters replicated.  Every
    rank returns the new parameters and the global loss of
    :func:`train_step` on the whole batch.

    Per rank: the ``sp`` ranks of a system all-gather its positions and
    element ids (a fresh leaf ``x``); each computes the CNs of the whole
    system and the energy ``E_r`` of the pairs of its own rows, and ``g_r
    = dE_r/dx`` keeping the graph.  The energies and forces are
    all-reduces of the values ``E_r`` and ``-g_r`` over ``sp``; the loss
    and its cotangents ``dL/dE`` and ``dL/dF`` follow from the global
    sums (energy errors over ``dp``, force errors and the alive count over
    the mesh), and one ``autograd.grad`` of ``(E_r, g_r)`` weighted by
    them gives this rank's share of the parameter gradients, summed over
    the mesh."""
    sp_group, _, sp_rank = axis_group(mesh, "sp")
    dp_group, dp, _ = axis_group(mesh, "dp")

    def mesh_sum(t):
        return all_reduce_sum(all_reduce_sum(t, sp_group), dp_group)

    def step(params, tables, batch):
        positions, numbers, cell, target_e, target_f = _batch_tensors(batch)
        b_local, n_local = positions.shape[0], positions.shape[1]
        rows = slice(sp_rank * n_local, (sp_rank + 1) * n_local)
        x_all = all_gather_cat(positions.detach(), sp_group, dim=1)
        z_all = all_gather_cat(numbers, sp_group, dim=1)
        leaves = _leaves(params)
        with torch.enable_grad():
            x_all = x_all.detach().requires_grad_(True)
            e_r = torch.stack([
                _system_energy(leaves, tables, x_all[b], z_all[b], cell[b],
                               cutoff, rows=rows)
                for b in range(b_local)])
            (g_r,) = torch.autograd.grad(e_r.sum(), x_all, create_graph=True)
        energies = all_reduce_sum(e_r.detach(), sp_group)
        forces = -all_reduce_sum(g_r.detach(), sp_group)[:, rows]
        alive = (numbers != 0)[..., None]
        dtype = positions.dtype
        n_alive = torch.clamp(mesh_sum(alive.sum().to(dtype)), min=1)
        n_systems = b_local * dp
        de = energies - target_e
        df = torch.where(alive, forces - target_f, torch.zeros_like(forces))
        loss = (all_reduce_sum((de * de).sum(), dp_group) / n_systems
                + mesh_sum((df * df).sum()) / n_alive)
        # cotangents: dL/dE_r is dL/dE of the rank's systems, and dL/dg_r
        # is -dL/dF (F = -sum of g_r over sp)
        dl_de = 2.0 * de / n_systems
        dl_df = all_gather_cat(2.0 * df / n_alive, sp_group, dim=1)
        with torch.enable_grad():
            grads = torch.autograd.grad(
                (e_r, g_r), leaves, grad_outputs=(dl_de, -dl_df),
                allow_unused=True)
        grads = [mesh_sum(torch.zeros_like(p) if g is None else g)
                 for p, g in zip(leaves, grads)]
        return _sgd(leaves, grads, lr), loss

    return step

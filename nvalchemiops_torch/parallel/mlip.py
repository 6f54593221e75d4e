# SPDX-License-Identifier: Apache-2.0
"""The differentiable MLIP's forward pass (counterpart of
``nvalchemiops_tpu.parallel.mlip``, without its training step).

A physically structured machine-learned interatomic potential

    E = E_elec (erfc-damped Coulomb, learnable per-element charges)
      + E_rep  (Born-Mayer exp repulsion, learnable amplitudes/length)
      + E_disp (DFT-D3(BJ)-style dispersion with CN-interpolated C6,
                learnable damping/scaling)

over periodic systems, as a dense minimum-image pair sum; forces are the
exact energy gradients (``torch.autograd``).  Plain torch, as it is plain
XLA in the JAX package: no kernel.  The tables and starting parameters are
drawn as the JAX package draws them, so both packages start from equal
bits.  :func:`make_mesh` builds the ``("dp", "sp")`` mesh of the JAX
package on ``torch.distributed``.
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
from nvalchemiops_torch.parallel.domain import _mesh_device_type

__all__ = [
    "MLIPParams",
    "init_mlip_params",
    "mlip_energy",
    "batched_energy_forces",
    "make_mesh",
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
    dtype, device = positions.dtype, positions.device
    n = positions.shape[0]
    numbers = torch.as_tensor(numbers, device=device).long()
    alive = numbers != 0
    zero = torch.zeros((), dtype=dtype, device=device)

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
    e_elec = 0.5 * torch.sum(torch.where(
        mask, qq * erfc_approx(alpha * r) * inv_r, zero))

    a_rep = torch.exp(params.repulse_a)[numbers] * alive_f
    rho = torch.exp(params.repulse_rho)
    e_rep = 0.5 * torch.sum(torch.where(
        mask, a_rep[:, None] * a_rep[None, :] * torch.exp(-r / rho), zero))

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
    e_disp = 0.5 * torch.sum(torch.where(
        mask,
        -c6 * (params.s6 / (r6 + r0 ** 6) + params.s8 * rr / (r8 + r0 ** 8)),
        zero))
    return e_elec + e_rep + e_disp


def batched_energy_forces(params, tables, positions, numbers, cell, cutoff):
    """``[B, n, ...]`` batched energies ``[B]`` and forces ``[B, n, 3]``
    (forces = -dE/dr, exact, by ``torch.autograd.grad`` of the summed
    energies)."""
    with torch.enable_grad():
        pos = positions.detach().requires_grad_(True)
        energies = torch.stack([
            mlip_energy(params, tables, pos[b], numbers[b], cell[b], cutoff)
            for b in range(pos.shape[0])])
        (grad,) = torch.autograd.grad(energies.sum(), pos)
    return energies.detach(), -grad


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

# SPDX-License-Identifier: Apache-2.0
"""PME reciprocal-space electrostatics, single system, tile-windowed spline
path (counterpart of ``nvalchemiops_tpu.interactions.electrostatics.pme``).

Pipeline: windowed spread (CUDA kernel) -> ``torch.fft.rfftn`` -> divide by
the B-spline dealiasing factor, multiply by the Green's function ->
``irfftn`` -> windowed gather of the potential and its spline-derivative
gradient (CUDA kernel) -> self/background corrections.  Forces are the
analytic gradient of the discrete energy (one inverse FFT), with the
mesh-accuracy net force removed.

Conventions as in the JAX package: ``G(k) = 2 pi exp(-k^2/(4 alpha^2)) /
(V k^2)``, dealiasing ``[sinc(mx/nx) sinc(my/ny) sinc(mz/nz)]^order``
squared, unscaled forward and inverse transforms, and ``E_i -= (alpha /
sqrt(pi)) q_i^2 + (pi / (2 alpha^2 V)) q_i Q``.

The port raises where the JAX package falls back: a mesh the windowed
path does not support, and tile overflow (``counts_max > cap``); the dense
spline path and the batched PME are ROADMAP items.
"""

from __future__ import annotations

import math

import torch

from nvalchemiops_torch import spline_windowed as sw
from nvalchemiops_torch.interactions.electrostatics.k_vectors import (
    generate_k_vectors_pme,
)
from nvalchemiops_torch.mathops.math import apply_mat3, sinc_normalized

__all__ = ["pme_green_structure_factor", "pme_reciprocal_space"]

TWOPI = 2.0 * math.pi
SQRT_PI = math.sqrt(math.pi)


def pme_green_structure_factor(k_squared, mesh_dimensions, alpha, cell,
                               spline_order: int):
    """Green's function and ``|B(k)|^2`` dealiasing factor on the rfft grid
    (single system).  Returns ``(green [nx, ny, nz//2+1], sf_sq)``."""
    nx, ny, nz = (int(d) for d in mesh_dimensions)
    dtype, device = k_squared.dtype, k_squared.device
    volume = torch.abs(torch.linalg.det(cell.reshape(3, 3).to(dtype)))
    alpha = torch.as_tensor(alpha, dtype=dtype, device=device)
    good = k_squared > 1e-10
    ks_safe = torch.where(good, k_squared, torch.ones_like(k_squared))
    green = torch.where(
        good,
        TWOPI * torch.exp(-(0.25 / (alpha * alpha)) * ks_safe)
        / (ks_safe * volume),
        torch.zeros_like(k_squared),
    )
    mx = torch.fft.fftfreq(nx, dtype=dtype, device=device) * nx
    my = torch.fft.fftfreq(ny, dtype=dtype, device=device) * ny
    mz = torch.fft.rfftfreq(nz, dtype=dtype, device=device) * nz
    sinc3 = (sinc_normalized(mx / nx)[:, None, None]
             * sinc_normalized(my / ny)[None, :, None]
             * sinc_normalized(mz / nz)[None, None, :])
    sf = torch.clamp(sinc3 ** spline_order, min=1e-10)
    return green, sf * sf


def pme_reciprocal_space(
    positions,
    charges,
    cell,
    alpha,
    mesh_dimensions,
    spline_order: int = 4,
    k_vectors=None,
    k_squared=None,
    compute_forces: bool = False,
    compute_charge_gradients: bool = False,
    tile_capacity: int | None = None,
):
    """FFT-based reciprocal-space PME for one system.

    Return patterns: ``energies``, ``(energies, forces)``,
    ``(energies, charge_grads)``, ``(energies, forces, charge_grads)``.
    ``tile_capacity`` overrides the Poisson-safe tile capacity with an
    observed one (:func:`spline_windowed.observed_tile_capacity`).  Raises
    ``ValueError`` when a tile overflows its capacity, and
    ``NotImplementedError`` for a mesh the windowed path does not support.
    """
    dtype = positions.dtype
    n = positions.shape[0]
    mesh_dimensions = tuple(int(d) for d in mesh_dimensions)
    cell = torch.as_tensor(cell, dtype=dtype,
                           device=positions.device).reshape(3, 3)
    if not sw.windowed_applicable(mesh_dimensions, spline_order):
        raise NotImplementedError(
            f"mesh {mesh_dimensions} / order {spline_order}: only the "
            "tile-windowed path (every mesh dim a multiple of 8, order <= 4) "
            "is ported; the dense spline path is a ROADMAP item")
    cap = tile_capacity or sw.mesh_tile_capacity(n, mesh_dimensions)
    tiles = sw.build_mesh_tiles(positions, cell, mesh_dimensions,
                                spline_order, cap, need_grad=compute_forces)
    counts_max = int(tiles.counts_max)
    if counts_max > cap:
        raise ValueError(
            f"PME mesh tile overflow: {counts_max} atoms in one tile, "
            f"capacity {cap}; pass a larger tile_capacity (the dense-spread "
            "fallback is a ROADMAP item)")

    mesh = sw.windowed_spread(tiles, charges)
    if k_vectors is None or k_squared is None:
        k_vectors, k_squared = generate_k_vectors_pme(cell, mesh_dimensions)
    green, sf_sq = pme_green_structure_factor(k_squared, mesh_dimensions,
                                              alpha, cell, spline_order)
    mesh_fft = torch.fft.rfftn(mesh, norm="backward")
    potential = torch.fft.irfftn(mesh_fft / sf_sq * green, s=mesh_dimensions,
                                 norm="forward").to(dtype)

    alpha_t = torch.as_tensor(alpha, dtype=dtype, device=positions.device)
    volume = torch.abs(torch.linalg.det(cell))
    q_tot = charges.sum()
    if compute_forces:
        raw, grad_frac = sw.windowed_gather(tiles, potential,
                                            with_gradient=True)
    else:
        raw = sw.windowed_gather(tiles, potential)
    energies = (charges * raw
                - (alpha_t / SQRT_PI) * charges * charges
                - (math.pi / (2.0 * alpha_t ** 2)) * charges * q_tot / volume)
    charge_grads = None
    if compute_charge_gradients:
        charge_grads = (2.0 * raw - 2.0 * (alpha_t / SQRT_PI) * charges
                        - (math.pi / alpha_t ** 2) * q_tot / volume)
    forces = None
    if compute_forces:
        forces = 2.0 * apply_mat3(-charges[:, None] * grad_frac, tiles.inv.T)
        # smooth-PME gradient forces carry a mesh-accuracy net force;
        # remove it uniformly (the standard SPME remedy)
        forces = forces - forces.mean(dim=0, keepdim=True)
    if forces is not None and charge_grads is not None:
        return energies, forces, charge_grads
    if forces is not None:
        return energies, forces
    if charge_grads is not None:
        return energies, charge_grads
    return energies

# SPDX-License-Identifier: Apache-2.0
"""Ewald / PME parameter estimation (counterpart of the JAX package's
``interactions/electrostatics/parameters.py``): Kolafa-Perram balancing
for Ewald and the B-spline error estimate for the PME mesh.  Mesh
dimensions are Python ints (host side, static FFT shapes); everything else
is computed from the tensors, so it stays differentiable."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from nvalchemiops_torch.neighborlist.neighbor_utils import host_array

__all__ = [
    "EwaldParameters",
    "PMEParameters",
    "estimate_ewald_parameters",
    "estimate_pme_mesh_dimensions",
    "estimate_pme_parameters",
    "mesh_spacing_to_dimensions",
]


@dataclass
class EwaldParameters:
    """Ewald splitting parameters, one value per system."""

    alpha: torch.Tensor
    real_space_cutoff: torch.Tensor
    reciprocal_space_cutoff: torch.Tensor


@dataclass
class PMEParameters:
    """PME parameters including the mesh."""

    alpha: torch.Tensor
    mesh_dimensions: tuple[int, int, int]
    mesh_spacing: torch.Tensor
    real_space_cutoff: torch.Tensor


def _atoms_per_system(positions, num_systems: int, batch_idx):
    dtype, device = positions.dtype, positions.device
    if batch_idx is None:
        return torch.full((num_systems,), positions.shape[0], dtype=dtype,
                          device=device)
    ones = torch.ones(positions.shape[0], dtype=dtype, device=device)
    return torch.zeros(num_systems, dtype=dtype, device=device).index_add(
        0, torch.as_tensor(batch_idx, device=device).long(), ones)


def _cells(positions, cell):
    return torch.as_tensor(cell, dtype=positions.dtype,
                           device=positions.device).reshape(-1, 3, 3)


def estimate_ewald_parameters(positions, cell, batch_idx=None,
                              accuracy: float = 1e-6):
    """Kolafa-Perram estimate per system:
    ``eta = (V^2/N)^(1/6) / sqrt(2 pi)``, ``alpha = 1/(sqrt(2) eta)``,
    ``r_cut = sqrt(-2 ln eps) eta``, ``k_cut = sqrt(-2 ln eps) / eta``."""
    cell_b = _cells(positions, cell)
    volume = torch.abs(torch.linalg.det(cell_b))
    num_atoms = _atoms_per_system(positions, cell_b.shape[0], batch_idx)
    eta = (volume ** 2 / num_atoms) ** (1.0 / 6.0) / math.sqrt(2.0 * math.pi)
    error_factor = math.sqrt(-2.0 * math.log(accuracy))
    return EwaldParameters(
        alpha=1.0 / (math.sqrt(2.0) * eta),
        real_space_cutoff=error_factor * eta,
        reciprocal_space_cutoff=error_factor / eta,
    )


def _round_up_pow2(n: np.ndarray) -> np.ndarray:
    return np.power(2, np.ceil(np.log2(np.maximum(n, 1)))).astype(np.int64)


def estimate_pme_mesh_dimensions(cell, alpha, accuracy: float = 1e-6):
    """Mesh dims ``n = ceil(2 alpha L / (3 eps^(1/5)))`` rounded up to
    powers of 2, the maximum over the batch (host side)."""
    cell_np = host_array(cell, np.float64).reshape(-1, 3, 3)
    alpha_np = host_array(alpha, np.float64).reshape(-1)
    lengths = np.linalg.norm(cell_np, axis=2)
    n = 2.0 * alpha_np[:, None] * lengths / (3.0 * accuracy ** 0.2)
    dims = _round_up_pow2(np.ceil(n.max(axis=0)))
    return int(dims[0]), int(dims[1]), int(dims[2])


def estimate_pme_parameters(positions, cell, batch_idx=None,
                            accuracy: float = 1e-6):
    """Ewald estimate plus the PME mesh."""
    cell_b = _cells(positions, cell)
    ewald = estimate_ewald_parameters(positions, cell_b, batch_idx, accuracy)
    mesh_dims = estimate_pme_mesh_dimensions(cell_b, ewald.alpha, accuracy)
    lengths = torch.linalg.norm(cell_b, dim=2)
    mesh_spacing = lengths / torch.as_tensor(mesh_dims, dtype=lengths.dtype,
                                             device=lengths.device)
    return PMEParameters(
        alpha=ewald.alpha,
        mesh_dimensions=mesh_dims,
        mesh_spacing=mesh_spacing,
        real_space_cutoff=ewald.real_space_cutoff,
    )


def mesh_spacing_to_dimensions(cell, mesh_spacing):
    """Power-of-2 mesh dimensions for a target spacing (scalar, per system
    ``[B]`` or per system and axis ``[B, 3]``), the maximum over the
    batch."""
    cell_np = host_array(cell, np.float64).reshape(-1, 3, 3)
    lengths = np.linalg.norm(cell_np, axis=2)
    spacing = host_array(mesh_spacing, np.float64)
    if spacing.ndim == 0:
        dims = np.ceil(lengths / spacing)
    elif spacing.ndim == 1:
        if spacing.shape[0] != cell_np.shape[0]:
            raise ValueError(
                f"mesh_spacing shape {spacing.shape} incompatible with batch "
                f"size {cell_np.shape[0]}")
        dims = np.ceil(lengths / spacing[:, None])
    else:
        if spacing.shape != lengths.shape:
            raise ValueError(
                f"mesh_spacing shape {spacing.shape} incompatible with "
                f"cell_lengths shape {lengths.shape}")
        dims = np.ceil(lengths / spacing)
    dims = _round_up_pow2(dims).max(axis=0)
    return int(dims[0]), int(dims[1]), int(dims[2])

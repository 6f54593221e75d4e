# SPDX-License-Identifier: Apache-2.0
"""Reciprocal-space k-vectors (counterpart of the JAX package's
``interactions/electrostatics/k_vectors.py``).

Reciprocal matrix ``2 pi (cell^T)^-1`` (lattice vectors are cell rows).

- Ewald summation: the half-space Miller set (h > 0, or h = 0 and k > 0,
  or h = k = 0 and l > 0; k = 0 excluded) within host-side ranges, turned
  into k-vectors from the cell tensor, so gradients with respect to the
  cell flow;
- PME: rfft-grid Miller indices (fftfreq/rfftfreq conventions), aligned
  with ``torch.fft.rfftn`` output.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nvalchemiops_torch.neighborlist.neighbor_utils import (
    default_device, host_array,
)
from nvalchemiops_torch.trace import host_read

TWOPI = 2.0 * math.pi

__all__ = ["generate_k_vectors_ewald_summation", "generate_k_vectors_pme"]


def _miller_ranges(cell, k_cutoff) -> np.ndarray:
    """Max Miller index per dimension: ``ceil(k_cutoff * |a_d| / 2 pi)``,
    the maximum over the batch (read on the host: static sizes)."""
    cell_np = host_array(cell, np.float64).reshape(-1, 3, 3)
    lengths = np.linalg.norm(cell_np, axis=-1).max(axis=0) / TWOPI
    kc = float(np.max(host_array(k_cutoff, np.float64)))
    return np.ceil(kc * lengths).astype(np.int64)


def halfspace_miller_indices(max_hkl) -> np.ndarray:
    """All half-space Miller triples within the given ranges (k = 0
    excluded), in the JAX package's order."""
    max_hkl = np.asarray(max_hkl)
    h = np.arange(-max_hkl[0], max_hkl[0] + 1)
    k = np.arange(-max_hkl[1], max_hkl[1] + 1)
    m = np.arange(-max_hkl[2], max_hkl[2] + 1)
    hh, kk, mm = np.meshgrid(h, k, m, indexing="ij")
    grid = np.stack([hh.ravel(), kk.ravel(), mm.ravel()], axis=1)
    hs = (
        (grid[:, 0] > 0)
        | ((grid[:, 0] == 0) & (grid[:, 1] > 0))
        | ((grid[:, 0] == 0) & (grid[:, 1] == 0) & (grid[:, 2] > 0))
    )
    return grid[hs]


def generate_k_vectors_ewald_summation(cell, k_cutoff, max_hkl=None):
    """Half-space k-vectors for classical Ewald summation: ``[K, 3]`` for
    one system, ``[B, K, 3]`` for a batch (the same Miller set through each
    system's reciprocal cell).

    The Miller ranges are read from the cell's values on the host unless
    ``max_hkl`` (an int triple) is given; the k-vector values are computed
    from the cell tensor, so autograd reaches the cell either way.
    """
    cell = torch.as_tensor(cell, device=default_device(cell))
    squeeze = cell.dim() == 2
    cell_b = cell.reshape(-1, 3, 3)
    if max_hkl is None:
        max_hkl = _miller_ranges(cell_b, k_cutoff)
    millers = torch.as_tensor(halfspace_miller_indices(max_hkl),
                              dtype=cell_b.dtype, device=cell_b.device)
    reciprocal = TWOPI * torch.linalg.inv(cell_b.transpose(-1, -2))
    # broadcast multiply-adds, as the JAX package spells the K=3 product
    k_vectors = sum(millers[None, :, d:d + 1] * reciprocal[:, None, d]
                    for d in range(3))
    return k_vectors[0] if squeeze else k_vectors


def generate_k_vectors_pme(cell, mesh_dimensions, reciprocal_cell=None):
    """rfft-grid k-vectors for one system (``cell [3, 3]``) or a batch
    (``cell [B, 3, 3]``).  ``reciprocal_cell`` (rows ``2 pi (cell^T)^-1``,
    shaped like ``cell``) is used as given instead of being computed, as
    in the JAX package.

    Returns ``(k_vectors [.., nx, ny, nz//2+1, 3], k_squared_safe)`` where
    ``k_squared_safe`` floors ``|k|^2`` at 1e-12.
    """
    lead = tuple(cell.shape[:-2]) if cell.dim() == 3 else ()
    cell = cell.reshape(lead + (3, 3))
    dtype, device = cell.dtype, cell.device
    nx, ny, nz = (int(d) for d in mesh_dimensions)
    if reciprocal_cell is None:
        with host_read("pme_kvec_inv", device):
            reciprocal_cell = TWOPI * torch.linalg.inv(
                cell.transpose(-1, -2))
    else:
        reciprocal_cell = torch.as_tensor(
            reciprocal_cell, dtype=dtype, device=device).reshape(lead + (3, 3))
    mx = torch.fft.fftfreq(nx, d=1.0, dtype=dtype, device=device) * nx
    my = torch.fft.fftfreq(ny, d=1.0, dtype=dtype, device=device) * ny
    mz = torch.fft.rfftfreq(nz, d=1.0, dtype=dtype, device=device) * nz
    gx, gy, gz = torch.meshgrid(mx, my, mz, indexing="ij")
    miller = torch.stack([gx, gy, gz], dim=-1)       # [nx, ny, nz//2+1, 3]
    # broadcast multiply-adds, as the JAX package spells the K=3 product
    k_vectors = sum(miller[..., d:d + 1]
                    * reciprocal_cell[..., d, :].reshape(lead + (1, 1, 1, 3))
                    for d in range(3))
    k_squared = (k_vectors ** 2).sum(-1)
    k_squared_safe = torch.where(k_squared > 1e-12, k_squared,
                                 torch.full((), 1e-12, dtype=dtype,
                                            device=device))
    return k_vectors, k_squared_safe

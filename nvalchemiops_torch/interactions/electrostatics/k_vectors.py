# SPDX-License-Identifier: Apache-2.0
"""Reciprocal-space k-vectors for PME (counterpart of
``nvalchemiops_tpu.interactions.electrostatics.k_vectors.generate_k_vectors_pme``).

Reciprocal matrix ``2 pi (cell^T)^-1`` (lattice vectors are cell rows);
Miller indices follow the fftfreq/rfftfreq conventions, so the arrays align
with ``torch.fft.rfftn`` output.
"""

from __future__ import annotations

import math

import torch

TWOPI = 2.0 * math.pi

__all__ = ["generate_k_vectors_pme"]


def generate_k_vectors_pme(cell, mesh_dimensions):
    """rfft-grid k-vectors for one system (``cell [3, 3]``) or a batch
    (``cell [B, 3, 3]``).

    Returns ``(k_vectors [.., nx, ny, nz//2+1, 3], k_squared_safe)`` where
    ``k_squared_safe`` floors ``|k|^2`` at 1e-12.
    """
    lead = tuple(cell.shape[:-2]) if cell.dim() == 3 else ()
    cell = cell.reshape(lead + (3, 3))
    dtype, device = cell.dtype, cell.device
    nx, ny, nz = (int(d) for d in mesh_dimensions)
    reciprocal_cell = TWOPI * torch.linalg.inv(cell.transpose(-1, -2))
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

# SPDX-License-Identifier: Apache-2.0
"""Dense minimum-image (damped) Coulomb for small systems (counterpart of
``nvalchemiops_tpu.interactions.electrostatics.dense``).

Every pair ``(i, j)`` of a system through the minimum image, valid for a
cutoff up to half the smallest box width; the batched form takes ``[B, n,
3]`` stacks with a shared ``[3, 3]`` or per-system ``[B, 3, 3]`` cell.
The JAX package builds the full ``[n, n]`` pair planes in one pass (XLA);
here the pairs go through in passes of at most ``DENSE_PAIR_CHUNK``
slots (whole systems, or rows of one system), so the peak memory is
bounded (64 x 2,000 atoms hold 256 M pair slots) and the sums are those
of one pass: each row's sum runs over all of its ``n`` partners in every
pass.  Plain torch, as the JAX package runs it as XLA.
"""

from __future__ import annotations

import torch

from nvalchemiops_torch.mathops.math import apply_mat3_batched, erfc_approx
from nvalchemiops_torch.types import default_device

__all__ = ["dense_coulomb_energy_forces", "batch_dense_coulomb_energy_forces"]

_TWO_OVER_SQRT_PI = 1.1283791670955126

#: pair slots per pass (``[systems, rows, n]`` planes of 2^24 entries:
#: 64 MiB each in f32; 1,592 MiB peak for 64 x 2,000 atoms on an NVIDIA
#: H100 80GB HBM3 at 700 W, PERF.md)
DENSE_PAIR_CHUNK = 1 << 24


def _pair_block(frac_i, frac_j, q_i, q_j, cell, cutoff, alpha: float):
    """Energies ``[s, r]`` and forces ``[s, r, 3]`` of rows ``frac_i [s, r,
    3]`` against all atoms ``frac_j [s, n, 3]`` of their systems, with
    cells ``[s, 3, 3]`` (the JAX package's operation order)."""
    df = []
    for c in range(3):
        dc = frac_j[:, None, :, c] - frac_i[:, :, c, None]
        df.append(dc - torch.round(dc))
    m = cell[:, None, None]
    dx = df[0] * m[..., 0, 0] + df[1] * m[..., 1, 0] + df[2] * m[..., 2, 0]
    dy = df[0] * m[..., 0, 1] + df[1] * m[..., 1, 1] + df[2] * m[..., 2, 1]
    dz = df[0] * m[..., 0, 2] + df[1] * m[..., 1, 2] + df[2] * m[..., 2, 2]
    del df
    r2 = dx * dx + dy * dy + dz * dz
    ok = (r2 < cutoff * cutoff) & (r2 > 1e-20)
    r2_safe = torch.where(ok, r2, torch.ones_like(r2))
    inv_r = torch.rsqrt(r2_safe)
    qq = q_i[:, :, None] * q_j[:, None, :]
    if alpha > 0:
        ar = alpha * (r2_safe * inv_r)
        erfc_ar = erfc_approx(ar)
        phi = erfc_ar * inv_r
        mag = ((erfc_ar * inv_r + _TWO_OVER_SQRT_PI * alpha
                * torch.exp(-ar * ar)) * inv_r * inv_r)
    else:
        phi = inv_r
        mag = inv_r * inv_r * inv_r
    zero = torch.zeros_like(r2)
    energies = torch.where(ok, 0.5 * qq * phi, zero).sum(-1)
    ncoef = torch.where(ok, -(qq * mag), zero)
    forces = torch.stack([(ncoef * dx).sum(-1), (ncoef * dy).sum(-1),
                          (ncoef * dz).sum(-1)], dim=-1)
    return energies, forces


def _dense_batch(positions, charges, cells, cutoff, alpha):
    """``positions [B, n, 3]``, ``charges [B, n]``, ``cells [B, 3, 3]``, in
    passes of at most ``DENSE_PAIR_CHUNK`` pair slots."""
    pair_chunk = DENSE_PAIR_CHUNK
    b, n = positions.shape[0], positions.shape[1]
    frac = apply_mat3_batched(positions, torch.linalg.inv(cells))
    cutoff = float(cutoff)
    alpha = float(alpha)
    energies = positions.new_zeros((b, n))
    forces = positions.new_zeros((b, n, 3))
    per_system = max(n * n, 1)
    if per_system <= pair_chunk:
        step = pair_chunk // per_system
        for b0 in range(0, b, step):
            s = slice(b0, b0 + step)
            energies[s], forces[s] = _pair_block(
                frac[s], frac[s], charges[s], charges[s], cells[s], cutoff,
                alpha)
        return energies, forces
    rows = max(1, pair_chunk // n)
    for b0 in range(b):
        s = slice(b0, b0 + 1)
        for i0 in range(0, n, rows):
            r = slice(i0, i0 + rows)
            energies[s, r], forces[s, r] = _pair_block(
                frac[s, r], frac[s], charges[s, r], charges[s], cells[s],
                cutoff, alpha)
    return energies, forces


def _positions(positions, device):
    positions = torch.as_tensor(positions,
                                device=default_device(positions, device))
    return positions, positions.dtype, positions.device


def dense_coulomb_energy_forces(positions, charges, cell, cutoff, alpha=0.0,
                                device="cuda"):
    """Per-atom (damped-)Coulomb energies ``[n]`` and forces ``[n, 3]``,
    minimum image over all pairs; the physics of
    ``grid.grid_coulomb_energy_forces``.  Needs a cutoff of at most half
    the smallest box width.  Runs on the device of ``positions``, or on
    ``device`` where it is not a tensor."""
    positions, dtype, device = _positions(positions, device)
    cell = torch.as_tensor(cell, dtype=dtype, device=device).reshape(1, 3, 3)
    charges = torch.as_tensor(charges, dtype=dtype, device=device)
    e, f = _dense_batch(positions[None], charges[None], cell, cutoff, alpha)
    return e[0], f[0]


def batch_dense_coulomb_energy_forces(positions, charges, cells, cutoff,
                                      alpha=0.0, device="cuda"):
    """:func:`dense_coulomb_energy_forces` for each system of ``positions
    [B, n, 3]`` and ``charges [B, n]``, with ``cells`` ``[3, 3]`` shared or
    ``[B, 3, 3]``: ``([B, n], [B, n, 3])``."""
    positions, dtype, device = _positions(positions, device)
    b = positions.shape[0]
    cells = torch.as_tensor(cells, dtype=dtype, device=device)
    if cells.dim() == 2:
        cells = cells.expand(b, 3, 3)
    charges = torch.as_tensor(charges, dtype=dtype, device=device)
    return _dense_batch(positions, charges, cells.contiguous(), cutoff,
                        alpha)

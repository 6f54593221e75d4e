# SPDX-License-Identifier: Apache-2.0
"""Pairwise (damped) Coulomb core shared by ``coulomb.py`` and
``ewald.py`` (counterpart of the JAX package's
``interactions/electrostatics/_pairwise.py``).

Over a full padded neighbor matrix every atom owns its row, so energies,
forces and charge gradients are row sums: no scatter, deterministic.  The
COO list form (``list_pair_terms``) gives the per-pair terms, which the
callers sum per source atom.  Shift matrices arrive as ``[.., 3]`` integer
triples or packed int32 codes (``neighbor_utils.pack_shifts``).

    E_i     = 1/2 sum_j q_i q_j erfc(alpha r) / r        (alpha > 0)
    E_i     = 1/2 sum_j q_i q_j / r                      (alpha = 0)
    F_i     = sum_j q_i q_j [erfc(alpha r)/r^3
              + (2 alpha/sqrt(pi)) exp(-alpha^2 r^2)/r^2] (r_i - r_j_image)
    dE/dq_i = sum_j q_j erfc(alpha r) / r

with ``r_j_image = r_j + S @ cell`` and pairs kept for ``r < cutoff``,
``r > 1e-10``.  Everything is differentiable torch, so autograd of the
energies (positions, charges, cell) agrees with the analytic forces.
"""

from __future__ import annotations

import math

import torch

from nvalchemiops_torch.neighborlist.neighbor_utils import unpack_shifts
from nvalchemiops_torch.types import INDEX_DTYPE

TWO_OVER_SQRT_PI = 2.0 / math.sqrt(math.pi)


def _shift_components(shifts, dtype, aos: bool):
    """``[.., 3]`` or packed ``[..]`` integer shifts -> float planes."""
    if aos:
        return (shifts[..., 0].to(dtype), shifts[..., 1].to(dtype),
                shifts[..., 2].to(dtype))
    sx, sy, sz = unpack_shifts(shifts)
    return sx.to(dtype), sy.to(dtype), sz.to(dtype)


def cartesian_shift_components(shifts, cell, batch_idx, row_index, dtype,
                               aos: bool):
    """Cartesian shift planes ``S @ cell``.  ``row_index``: None for matrix
    layouts (one system per row), the pairs' source atoms for lists."""
    sxf, syf, szf = _shift_components(shifts, dtype, aos)
    cell_b = cell.to(dtype).reshape(-1, 3, 3)
    if batch_idx is not None and cell_b.shape[0] > 1:
        b = batch_idx.long()
        if row_index is not None:
            b = b[row_index]
        if sxf.dim() == 2:
            def comp(r, c):
                return cell_b[b, r, c][:, None]
        else:
            def comp(r, c):
                return cell_b[b, r, c]
    else:
        def comp(r, c):
            return cell_b[0, r, c]
    shx = sxf * comp(0, 0) + syf * comp(1, 0) + szf * comp(2, 0)
    shy = sxf * comp(0, 1) + syf * comp(1, 1) + szf * comp(2, 1)
    shz = sxf * comp(0, 2) + syf * comp(1, 2) + szf * comp(2, 2)
    return shx, shy, shz


def _safe_r(dx, dy, dz):
    r2 = dx * dx + dy * dy + dz * dz
    pos = r2 > 0
    return torch.sqrt(torch.where(pos, r2, torch.ones_like(r2))) * pos


def _gather_pair_geometry(positions, cell, neighbor_matrix, shifts,
                          batch_idx, fill_value):
    """``[N, K]`` pair geometry: ``(r, valid, j, (dx, dy, dz))`` with
    ``d = r_j_image - r_i``."""
    n = positions.shape[0]
    nm = neighbor_matrix.to(INDEX_DTYPE)
    valid = (nm != int(fill_value)) & (nm >= 0) & (nm < n)
    j = torch.clamp(nm, 0, max(n - 1, 0)).long()
    px, py, pz = positions[:, 0], positions[:, 1], positions[:, 2]
    shx, shy, shz = cartesian_shift_components(
        shifts, cell, batch_idx, None, positions.dtype, shifts.dim() == 3)
    dx = px[j] + shx - px[:, None]
    dy = py[j] + shy - py[:, None]
    dz = pz[j] + shz - pz[:, None]
    return _safe_r(dx, dy, dz), valid, j, (dx, dy, dz)


def _kernel_terms(r, mask, alpha, want_force: bool):
    """``(phi, mag)``: the pair potential ``erfc(alpha r)/r`` (``1/r`` for
    ``alpha = 0``) and the force magnitude over ``r`` (None unless
    ``want_force``), evaluated at ``r`` where ``mask``, at 1 elsewhere."""
    r_safe = torch.where(mask, r, torch.ones_like(r))
    inv_r = 1.0 / r_safe
    damped = alpha > 0
    ar = alpha * r_safe
    erfc_ar = torch.special.erfc(ar)
    phi = torch.where(damped, erfc_ar * inv_r, inv_r)
    if not want_force:
        return phi, None
    inv_r2 = inv_r * inv_r
    mag = torch.where(
        damped,
        erfc_ar * inv_r * inv_r2
        + TWO_OVER_SQRT_PI * alpha * torch.exp(-ar * ar) * inv_r2,
        inv_r * inv_r2)
    return phi, mag


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _scalars(positions, cutoff, alpha):
    dtype, device = positions.dtype, positions.device
    return (torch.as_tensor(cutoff, dtype=dtype, device=device),
            torch.as_tensor(alpha, dtype=dtype, device=device))


def pair_energies(positions, charges, cell, neighbor_matrix, shifts, cutoff,
                  alpha, batch_idx=None, fill_value=None):
    """Per-atom (damped) Coulomb energies over a padded neighbor matrix."""
    if fill_value is None:
        fill_value = positions.shape[0]
    r, valid, j, _ = _gather_pair_geometry(
        positions, cell, neighbor_matrix, shifts, batch_idx, fill_value)
    cutoff_t, alpha_t = _scalars(positions, cutoff, alpha)
    mask = valid & (r < cutoff_t) & (r > 1e-10)
    phi, _ = _kernel_terms(r, mask, alpha_t, False)
    e_pair = 0.5 * charges[:, None] * charges[j] * phi
    return torch.where(mask, e_pair, _zero(e_pair)).sum(1)


def pair_energies_forces(positions, charges, cell, neighbor_matrix, shifts,
                         cutoff, alpha, batch_idx=None, fill_value=None):
    """Per-atom energies and analytic forces (row-owner sums over a full
    neighbor matrix)."""
    if fill_value is None:
        fill_value = positions.shape[0]
    r, valid, j, (dx, dy, dz) = _gather_pair_geometry(
        positions, cell, neighbor_matrix, shifts, batch_idx, fill_value)
    cutoff_t, alpha_t = _scalars(positions, cutoff, alpha)
    mask = valid & (r < cutoff_t) & (r > 1e-10)
    phi, mag = _kernel_terms(r, mask, alpha_t, True)
    qq = charges[:, None] * charges[j]
    # force on i points along r_i - r_j_image = -d
    coef = torch.where(mask, qq * mag, _zero(mag))
    forces = torch.stack([(coef * (-dx)).sum(1), (coef * (-dy)).sum(1),
                          (coef * (-dz)).sum(1)], dim=-1)
    e_pair = 0.5 * qq * phi
    return torch.where(mask, e_pair, _zero(e_pair)).sum(1), forces


def pair_charge_gradients(positions, charges, cell, neighbor_matrix, shifts,
                          cutoff, alpha, batch_idx=None, fill_value=None):
    """``d(total energy)/d(charges)``: ``sum_j q_j erfc(alpha r)/r``."""
    if fill_value is None:
        fill_value = positions.shape[0]
    r, valid, j, _ = _gather_pair_geometry(
        positions, cell, neighbor_matrix, shifts, batch_idx, fill_value)
    cutoff_t, alpha_t = _scalars(positions, cutoff, alpha)
    mask = valid & (r < cutoff_t) & (r > 1e-10)
    phi, _ = _kernel_terms(r, mask, alpha_t, False)
    v = charges[j] * phi
    return torch.where(mask, v, _zero(v)).sum(1)


def list_pair_terms(positions, cell, idx_i, idx_j, shifts, cutoff, alpha,
                    batch_idx, want_force: bool = True):
    """Per-pair ingredients of the COO form: ``((dx, dy, dz), mask, phi,
    mag)``; ``alpha`` scalar or per atom (taken at the source atom)."""
    shx, shy, shz = cartesian_shift_components(
        shifts, cell, batch_idx, idx_i, positions.dtype, shifts.dim() == 2)
    px, py, pz = positions[:, 0], positions[:, 1], positions[:, 2]
    dx = px[idx_j] + shx - px[idx_i]
    dy = py[idx_j] + shy - py[idx_i]
    dz = pz[idx_j] + shz - pz[idx_i]
    r = _safe_r(dx, dy, dz)
    cutoff_t, alpha_t = _scalars(positions, cutoff, alpha)
    if alpha_t.dim() == 1:
        alpha_t = alpha_t[idx_i]
    mask = (r < cutoff_t) & (r > 1e-10)
    phi, mag = _kernel_terms(r, mask, alpha_t, want_force)
    return (dx, dy, dz), mask, phi, mag


def segment_sum(values, idx, n: int):
    """``out[idx[p]] += values[p]`` into ``[n, ..]`` (one ``index_add``)."""
    out = torch.zeros((n,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_add(0, idx, values)

# SPDX-License-Identifier: Apache-2.0
"""Direct and erfc-damped Coulomb interactions (counterpart of the JAX
package's ``interactions/electrostatics/coulomb.py``).

``alpha = 0`` gives the bare 1/r law, ``alpha > 0`` the erfc-damped form of
the Ewald/PME real-space term.  Per-atom energies; both neighbor formats:
the padded matrix through the row-owner core of ``_pairwise.py``, the COO
list through per-pair terms summed per source atom.  Computed in the
positions' dtype, on their device, differentiable by autograd.
"""

from __future__ import annotations

import torch

from nvalchemiops_torch.interactions.electrostatics._pairwise import (
    list_pair_terms,
    pair_charge_gradients,
    pair_energies,
    pair_energies_forces,
    segment_sum,
)
from nvalchemiops_torch.types import INDEX_DTYPE

__all__ = ["coulomb_energy", "coulomb_forces", "coulomb_energy_forces"]


def _validate_format(neighbor_list, neighbor_matrix):
    use_list = neighbor_list is not None
    if use_list == (neighbor_matrix is not None):
        raise ValueError(
            "Provide exactly one of neighbor_list(+neighbor_ptr/"
            "neighbor_shifts) or neighbor_matrix(+neighbor_matrix_shifts)")
    return use_list


def _cell(cell, positions):
    return torch.as_tensor(cell, dtype=positions.dtype,
                           device=positions.device)


def _list_pairs(positions, neighbor_list, neighbor_shifts):
    idx_i = neighbor_list[0].long()
    idx_j = neighbor_list[1].long()
    if neighbor_shifts is None:
        neighbor_shifts = torch.zeros((idx_i.shape[0], 3),
                                      dtype=INDEX_DTYPE,
                                      device=positions.device)
    return idx_i, idx_j, neighbor_shifts


def _matrix_shifts(neighbor_matrix, neighbor_matrix_shifts):
    if neighbor_matrix_shifts is None:
        return torch.zeros(tuple(neighbor_matrix.shape) + (3,),
                           dtype=INDEX_DTYPE, device=neighbor_matrix.device)
    return neighbor_matrix_shifts


def coulomb_energy(
    positions,
    charges,
    cell,
    cutoff: float,
    alpha: float = 0.0,
    neighbor_list=None,
    neighbor_ptr=None,
    neighbor_shifts=None,
    neighbor_matrix=None,
    neighbor_matrix_shifts=None,
    fill_value: int | None = None,
    batch_idx=None,
):
    """Per-atom Coulomb energies ``E_i = 1/2 sum_j q_i q_j erfc(ar)/r``
    ``[N]``.  ``neighbor_ptr`` is not needed by the pair formulation."""
    del neighbor_ptr
    cell = _cell(cell, positions)
    n = positions.shape[0]
    if _validate_format(neighbor_list, neighbor_matrix):
        idx_i, idx_j, shifts = _list_pairs(positions, neighbor_list,
                                           neighbor_shifts)
        _d, mask, phi, _ = list_pair_terms(positions, cell, idx_i, idx_j,
                                           shifts, cutoff, alpha, batch_idx,
                                           want_force=False)
        e_pair = 0.5 * charges[idx_i] * charges[idx_j] * phi
        return segment_sum(torch.where(mask, e_pair, torch.zeros_like(
            e_pair)), idx_i, n)
    return pair_energies(
        positions, charges, cell, neighbor_matrix,
        _matrix_shifts(neighbor_matrix, neighbor_matrix_shifts), cutoff,
        alpha, batch_idx=batch_idx, fill_value=fill_value)


def coulomb_energy_forces(
    positions,
    charges,
    cell,
    cutoff: float,
    alpha: float = 0.0,
    neighbor_list=None,
    neighbor_ptr=None,
    neighbor_shifts=None,
    neighbor_matrix=None,
    neighbor_matrix_shifts=None,
    fill_value: int | None = None,
    batch_idx=None,
):
    """Per-atom energies and analytic forces ``(energies [N], forces [N,
    3])``; the neighbor data must be full (each pair in both rows)."""
    del neighbor_ptr
    cell = _cell(cell, positions)
    n = positions.shape[0]
    if _validate_format(neighbor_list, neighbor_matrix):
        idx_i, idx_j, shifts = _list_pairs(positions, neighbor_list,
                                           neighbor_shifts)
        (dx, dy, dz), mask, phi, mag = list_pair_terms(
            positions, cell, idx_i, idx_j, shifts, cutoff, alpha, batch_idx)
        qq = charges[idx_i] * charges[idx_j]
        zero = torch.zeros((), dtype=qq.dtype, device=qq.device)
        e_pair = torch.where(mask, 0.5 * qq * phi, zero)
        coef = torch.where(mask, qq * mag, zero)
        forces = segment_sum(torch.stack([coef * (-dx), coef * (-dy),
                                          coef * (-dz)], dim=-1), idx_i, n)
        return segment_sum(e_pair, idx_i, n), forces
    return pair_energies_forces(
        positions, charges, cell, neighbor_matrix,
        _matrix_shifts(neighbor_matrix, neighbor_matrix_shifts), cutoff,
        alpha, batch_idx=batch_idx, fill_value=fill_value)


def coulomb_forces(
    positions,
    charges,
    cell,
    cutoff: float,
    alpha: float = 0.0,
    **kwargs,
):
    """Forces only."""
    _, forces = coulomb_energy_forces(positions, charges, cell, cutoff,
                                      alpha, **kwargs)
    return forces


def coulomb_charge_gradients(
    positions,
    charges,
    cell,
    cutoff: float,
    alpha: float = 0.0,
    neighbor_list=None,
    neighbor_ptr=None,
    neighbor_shifts=None,
    neighbor_matrix=None,
    neighbor_matrix_shifts=None,
    fill_value: int | None = None,
    batch_idx=None,
):
    """``d(total energy)/d(charges)`` ``[N]``: for full pair data the
    per-atom potential ``sum_j q_j erfc(a r_ij)/r_ij``."""
    del neighbor_ptr
    cell = _cell(cell, positions)
    n = positions.shape[0]
    if _validate_format(neighbor_list, neighbor_matrix):
        idx_i, idx_j, shifts = _list_pairs(positions, neighbor_list,
                                           neighbor_shifts)
        _d, mask, phi, _ = list_pair_terms(positions, cell, idx_i, idx_j,
                                           shifts, cutoff, alpha, batch_idx,
                                           want_force=False)
        v = charges[idx_j] * phi
        return segment_sum(torch.where(mask, v, torch.zeros_like(v)), idx_i,
                           n)
    return pair_charge_gradients(
        positions, charges, cell, neighbor_matrix,
        _matrix_shifts(neighbor_matrix, neighbor_matrix_shifts), cutoff,
        alpha, batch_idx=batch_idx, fill_value=fill_value)

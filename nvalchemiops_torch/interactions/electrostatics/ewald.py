# SPDX-License-Identifier: Apache-2.0
"""Classical Ewald summation (counterpart of the JAX package's
``interactions/electrostatics/ewald.py``).

    E_recip = (1/2V) sum_{k in half-space} G(k) |S(k)|^2,
    G(k) = 8 pi exp(-k^2/(4 alpha^2)) / k^2          (half-space doubling)
    S(k) = sum_j q_j exp(i k.r_j)
    E_self,i = (alpha/sqrt(pi)) q_i^2
    E_bg,i  = (pi / (2 alpha^2)) q_i Q_total / V

Batched systems are packed into a padded ``[B, n_max]`` layout (gathers:
concatenated systems are contiguous), the phases ``k.r`` are broadcast
multiply-adds and the structure factors and per-atom sums are batched
matrix products, over chunks of 512 k-vectors.  Real space is the damped
Coulomb of ``coulomb.py``.
"""

from __future__ import annotations

import math

import torch

from nvalchemiops_torch.interactions.electrostatics.coulomb import (
    coulomb_charge_gradients,
    coulomb_energy,
    coulomb_energy_forces,
)
from nvalchemiops_torch.interactions.electrostatics.k_vectors import (
    generate_k_vectors_ewald_summation,
)
from nvalchemiops_torch.interactions.electrostatics.parameters import (
    estimate_ewald_parameters,
)
from nvalchemiops_torch.neighborlist.neighbor_utils import (
    prepare_batch_idx_ptr,
)
from nvalchemiops_torch.types import INDEX_DTYPE

__all__ = ["ewald_real_space", "ewald_reciprocal_space", "ewald_summation"]

SQRT_PI = math.sqrt(math.pi)
EIGHTPI = 8.0 * math.pi


def returns(energies, forces, charge_grads):
    """The four return patterns: ``energies``, ``(energies, forces)``,
    ``(energies, charge_grads)``, ``(energies, forces, charge_grads)``."""
    if forces is not None and charge_grads is not None:
        return energies, forces, charge_grads
    if forces is not None:
        return energies, forces
    if charge_grads is not None:
        return energies, charge_grads
    return energies


# ---------------------------------------------------------------------------
# Real space
# ---------------------------------------------------------------------------


def ewald_real_space(
    positions,
    charges,
    cell,
    alpha,
    neighbor_list=None,
    neighbor_ptr=None,
    neighbor_shifts=None,
    neighbor_matrix=None,
    neighbor_matrix_shifts=None,
    mask_value: int = -1,
    batch_idx=None,
    compute_forces: bool = False,
    compute_charge_gradients: bool = False,
    cutoff: float | None = None,
):
    """erfc-damped real-space term over the given neighbor data.

    ``alpha`` scalar or per system (``[B]``, with ``batch_idx``).
    ``cutoff`` defaults to unbounded: the pairs are whatever the neighbor
    structure holds.  Return patterns of :func:`returns`.
    """
    if cutoff is None:
        cutoff = math.inf
    alpha_arr = torch.as_tensor(alpha, dtype=positions.dtype,
                                device=positions.device).reshape(-1)
    if alpha_arr.shape[0] > 1:
        if batch_idx is None:
            raise ValueError("Per-system alpha requires batch_idx")
        alpha_atom = alpha_arr[torch.as_tensor(batch_idx).long()]
        # [N, 1] broadcasts over [N, K]; [N] is taken per pair in list form
        alpha_pair = (alpha_atom[:, None] if neighbor_matrix is not None
                      else alpha_atom)
    else:
        alpha_pair = alpha_arr[0]

    kwargs = dict(
        neighbor_list=neighbor_list,
        neighbor_ptr=neighbor_ptr,
        neighbor_shifts=neighbor_shifts,
        neighbor_matrix=neighbor_matrix,
        neighbor_matrix_shifts=neighbor_matrix_shifts,
        fill_value=mask_value,
        batch_idx=batch_idx,
    )
    forces = cg = None
    if compute_forces:
        energies, forces = coulomb_energy_forces(
            positions, charges, cell, cutoff, alpha_pair, **kwargs)
    else:
        energies = coulomb_energy(positions, charges, cell, cutoff,
                                  alpha_pair, **kwargs)
    if compute_charge_gradients:
        cg = coulomb_charge_gradients(positions, charges, cell, cutoff,
                                      alpha_pair, **kwargs)
    return returns(energies, forces, cg)


# ---------------------------------------------------------------------------
# Reciprocal space
# ---------------------------------------------------------------------------


def _pad_layout(batch_idx, batch_ptr, num_systems: int, n_max: int, n: int):
    """Gather maps between the concatenated ``[N]`` and padded ``[B,
    n_max]`` layouts: ``(flat_idx, pad_valid, atom_b, atom_p)``."""
    device = batch_ptr.device
    p = torch.arange(n_max, dtype=INDEX_DTYPE, device=device)
    flat_idx = batch_ptr[:-1, None] + p[None, :]
    counts = batch_ptr[1:] - batch_ptr[:-1]
    pad_valid = p[None, :] < counts[:, None]
    flat_idx = torch.clamp(flat_idx, 0, max(n - 1, 0))
    atom_b = batch_idx.long()
    atom_p = torch.arange(n, device=device) - batch_ptr.long()[atom_b]
    return flat_idx.long(), pad_valid, atom_b, atom_p


def _reciprocal_core(positions, charges, cell_b, k_vectors_b, alpha_b,
                     batch_idx, batch_ptr, n_max: int, num_systems: int,
                     compute_forces: bool, compute_charge_gradients: bool,
                     k_chunk: int = 512):
    """Padded-batch reciprocal-space sums over chunks of ``k_chunk``
    k-vectors, then the self and background corrections."""
    n = positions.shape[0]
    dtype = positions.dtype
    flat_idx, pad_valid, atom_b, atom_p = _pad_layout(
        batch_idx, batch_ptr, num_systems, n_max, n)
    pad_f = pad_valid.to(dtype)
    pos_pad = positions[flat_idx] * pad_f[..., None]        # [B, n_max, 3]
    q_pad = charges[flat_idx] * pad_f                        # [B, n_max]

    volume = torch.abs(torch.linalg.det(cell_b))             # [B]
    alpha = torch.broadcast_to(alpha_b.reshape(-1), (num_systems,)).to(dtype)
    exp_factor = (0.25 / (alpha * alpha))[:, None]

    e_pad = torch.zeros_like(q_pad)
    f_pad = torch.zeros_like(pos_pad) if compute_forces else None
    cg_pad = torch.zeros_like(q_pad) if compute_charge_gradients else None
    for start in range(0, k_vectors_b.shape[1], k_chunk):
        kc = k_vectors_b[:, start:start + k_chunk]           # [B, C, 3]
        k_sq = (kc * kc).sum(-1)
        good = k_sq > 1e-10
        k_sq_safe = torch.where(good, k_sq, torch.ones_like(k_sq))
        green = torch.where(
            good,
            torch.exp(-exp_factor * k_sq_safe) / k_sq_safe * EIGHTPI
            / volume[:, None],
            torch.zeros_like(k_sq))                          # [B, C]
        # phases k.r as a batched product: fused multiply-adds keep the
        # f32 phase error at the JAX package's
        phase = torch.bmm(pos_pad, kc.transpose(1, 2))       # [B, n, C]
        cos_p, sin_p = torch.cos(phase), torch.sin(phase)
        s_re = torch.einsum("bn,bnc->bc", q_pad, cos_p) * green
        s_im = torch.einsum("bn,bnc->bc", q_pad, sin_p) * green
        pot = (torch.einsum("bc,bnc->bn", s_re, cos_p)
               + torch.einsum("bc,bnc->bn", s_im, sin_p))
        e_pad = e_pad + 0.5 * q_pad * pot
        if compute_forces:
            # F_i = q_i sum_k k [sin(k.r_i) S_re_w - cos(k.r_i) S_im_w]
            term = sin_p * s_re[:, None, :] - cos_p * s_im[:, None, :]
            f_pad = f_pad + q_pad[..., None] * torch.einsum(
                "bnc,bcd->bnd", term, kc)
        if compute_charge_gradients:
            cg_pad = cg_pad + pot

    q_total = q_pad.sum(1)
    e_pad = (e_pad - (alpha[:, None] / SQRT_PI) * q_pad * q_pad
             - math.pi / (2.0 * alpha[:, None] ** 2) * q_pad
             * (q_total / volume)[:, None])
    if compute_charge_gradients:
        cg_pad = (cg_pad - 2.0 * alpha[:, None] / SQRT_PI * q_pad
                  - math.pi / (alpha[:, None] ** 2)
                  * (q_total / volume)[:, None])
    # back to the concatenated layout (a gather)
    energies = e_pad[atom_b, atom_p]
    forces = f_pad[atom_b, atom_p] if compute_forces else None
    cg = cg_pad[atom_b, atom_p] if compute_charge_gradients else None
    return energies, forces, cg


def ewald_reciprocal_space(
    positions,
    charges,
    cell,
    k_vectors,
    alpha,
    batch_idx=None,
    compute_forces: bool = False,
    compute_charge_gradients: bool = False,
    batch_ptr=None,
):
    """Reciprocal-space energies (+ forces, + charge gradients), self and
    background corrected.  Batched systems: ``batch_idx`` (atoms
    concatenated per system, contiguous); ``k_vectors`` ``[K, 3]`` shared
    or ``[B, K, 3]``; ``alpha`` scalar or ``[B]``.  Return patterns of
    :func:`returns`."""
    dtype, device = positions.dtype, positions.device
    n = positions.shape[0]
    cell_b = torch.as_tensor(cell, dtype=dtype, device=device).reshape(
        -1, 3, 3)
    num_systems = cell_b.shape[0]
    kv = torch.as_tensor(k_vectors, dtype=dtype, device=device)
    if kv.dim() == 2:
        kv = kv[None].expand((num_systems,) + tuple(kv.shape))
    if batch_idx is None:
        batch_idx_arr = torch.zeros(n, dtype=INDEX_DTYPE, device=device)
        batch_ptr_arr = torch.tensor([0, n], dtype=INDEX_DTYPE,
                                     device=device)
        n_max = n
    else:
        batch_idx_arr, batch_ptr_arr = prepare_batch_idx_ptr(
            batch_idx, batch_ptr, n, device=device)
        counts = batch_ptr_arr[1:] - batch_ptr_arr[:-1]
        n_max = int(counts.max()) if counts.numel() else 0
    alpha_arr = torch.as_tensor(alpha, dtype=dtype,
                                device=device).reshape(-1)
    return returns(*_reciprocal_core(
        positions, charges, cell_b, kv, alpha_arr, batch_idx_arr,
        batch_ptr_arr, n_max, num_systems, compute_forces,
        compute_charge_gradients))


# ---------------------------------------------------------------------------
# Full summation
# ---------------------------------------------------------------------------


def ewald_summation(
    positions,
    charges,
    cell,
    alpha=None,
    k_vectors=None,
    k_cutoff: float | None = None,
    batch_idx=None,
    neighbor_list=None,
    neighbor_ptr=None,
    neighbor_shifts=None,
    neighbor_matrix=None,
    neighbor_matrix_shifts=None,
    mask_value: int | None = None,
    compute_forces: bool = False,
    accuracy: float = 1e-6,
):
    """Real + reciprocal Ewald summation, with the Kolafa-Perram estimate
    for a missing ``alpha`` or k-space cutoff.  Returns per-atom energies,
    and forces with ``compute_forces``.  As in the JAX package, the real
    space takes the first system's ``alpha``, the reciprocal space each
    system's."""
    dtype, device = positions.dtype, positions.device
    cell_b = torch.as_tensor(cell, dtype=dtype, device=device).reshape(
        -1, 3, 3)
    if mask_value is None:
        mask_value = positions.shape[0]
    if alpha is None or (k_vectors is None and k_cutoff is None):
        params = estimate_ewald_parameters(positions, cell_b, batch_idx,
                                           accuracy)
        if alpha is None:
            alpha = params.alpha
        if k_vectors is None and k_cutoff is None:
            k_cutoff = params.reciprocal_space_cutoff
    if k_vectors is None:
        k_vectors = generate_k_vectors_ewald_summation(cell_b, k_cutoff)

    alpha_arr = torch.as_tensor(alpha, dtype=dtype,
                                device=device).reshape(-1)
    real = ewald_real_space(
        positions, charges, cell_b, alpha_arr[0],
        neighbor_list=neighbor_list, neighbor_ptr=neighbor_ptr,
        neighbor_shifts=neighbor_shifts, neighbor_matrix=neighbor_matrix,
        neighbor_matrix_shifts=neighbor_matrix_shifts,
        mask_value=mask_value, batch_idx=batch_idx,
        compute_forces=compute_forces)
    recip = ewald_reciprocal_space(
        positions, charges, cell_b, k_vectors, alpha_arr,
        batch_idx=batch_idx, compute_forces=compute_forces)
    if compute_forces:
        return real[0] + recip[0], real[1] + recip[1]
    return real + recip

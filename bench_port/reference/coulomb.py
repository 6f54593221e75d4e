# SPDX-License-Identifier: Apache-2.0
"""Real-space erfc-damped Coulomb within a cutoff, per atom:
``E_i = 1/2 sum_j q_i q_j erfc(alpha r_ij) / r_ij`` over every image of
every partner with ``r_ij < cutoff`` (no Coulomb constant: charges in e,
lengths in Angstrom), and ``F_i = -d(sum E)/dr_i`` by autograd."""

from __future__ import annotations

import torch

from bench_port.reference.d3 import _chunks


def coulomb(pairs, charges, n_atoms: int, alpha: float,
            dtype=torch.float64, acc=torch.float64):
    """``(energies [n], forces [n, 3])`` over the ordered pairs ``(i, j,
    d)`` of :func:`reference.neighbors.ordered_pairs`."""
    i, j, d64 = pairs
    device = d64.device
    q = torch.as_tensor(charges, device=device).to(dtype)
    energies = torch.zeros(n_atoms, dtype=acc, device=device)
    forces = torch.zeros(n_atoms, 3, dtype=acc, device=device)
    for s in _chunks(i.shape[0]):
        ds = d64[s].to(dtype).requires_grad_(True)
        r = torch.sqrt((ds * ds).sum(-1))
        # erfc has no bfloat16 kernel: the control rounds its value
        erfc = torch.special.erfc(alpha * r.to(acc)).to(dtype)
        e = 0.5 * q[i[s]] * q[j[s]] * erfc / r
        (gd,) = torch.autograd.grad(e.to(acc).sum(), (ds,))
        energies.index_add_(0, i[s], e.detach().to(acc))
        # ordered pairs: the half energies of (i, j) and (j, i) add to the
        # pair's, and so do their gradients
        forces.index_add_(0, i[s], gd.to(acc))
        forces.index_add_(0, j[s], -gd.to(acc))
    return energies, forces

# SPDX-License-Identifier: Apache-2.0
"""Reciprocal-space smooth particle-mesh Ewald of one orthorhombic system,
from its definition:

- charges spread onto an ``n`` mesh with cardinal B-splines of order
  ``p`` (weight ``M_p(u - m)`` at the ``p`` points ``m`` below the scaled
  fractional coordinate ``u``);
- ``phi = IDFT[G(k) / B(k) * DFT[rho]]`` with unscaled transforms,
  ``G(k) = 2 pi exp(-k^2 / (4 alpha^2)) / (V k^2)`` (``G(0) = 0``) and the
  dealiasing ``B(k) = (sinc(mx/nx) sinc(my/ny) sinc(mz/nz))^(2p)``;
- ``E_i = q_i phi(r_i) - alpha / sqrt(pi) q_i^2 - pi / (2 alpha^2 V) q_i
  Q``, with ``phi(r_i)`` gathered with the same weights;
- ``F_i = -d(sum E)/dr_i`` by autograd, less the mean force (the
  mesh's net force, removed uniformly).
"""

from __future__ import annotations

import math

import torch

from bench_port.reference.neighbors import box_lengths


def bspline_weights(t, order: int):
    """``[.., order]``: the weight ``M_order(t + j)`` of mesh point
    ``floor(u) - j`` for ``t = u - floor(u)`` (Essmann et al., J. Chem.
    Phys. 103, 8577 (1995)), by the recursion ``M_k(x) = (x M_{k-1}(x) +
    (k - x) M_{k-1}(x - 1)) / (k - 1)`` (differentiable in ``t``)."""
    w = [torch.ones_like(t)]
    for k in range(2, order + 1):
        zero = torch.zeros_like(t)
        w = [((t + j) * (w[j] if j < k - 1 else zero)
              + (k - t - j) * (w[j - 1] if j >= 1 else zero)) / (k - 1)
             for j in range(k)]
    return torch.stack(w, dim=-1)


def pme_reciprocal(pos, charges, cell, alpha: float, mesh, order: int = 4,
                   dtype=torch.float64, acc=torch.float64):
    """``(energies [n], forces [n, 3])``."""
    device = pos.device
    length = box_lengths(cell).to(device)
    nmesh = torch.tensor([int(v) for v in mesh], device=device)
    volume = float(torch.prod(length))
    # FFTs have no bfloat16 kernels: the control rounds the mesh instead
    fdt = torch.float64 if dtype == torch.float64 else torch.float32
    q = torch.as_tensor(charges, device=device).to(dtype)
    pos_g = pos.to(torch.float64).detach().requires_grad_(True)
    u = pos_g / length * nmesh
    base = torch.floor(u.detach())
    w = bspline_weights((u - base).to(dtype), order)        # [n, 3, p]
    idx = (base.long()[..., None] - torch.arange(order, device=device)
           ) % nmesh[:, None]
    nx, ny, nz = (int(v) for v in nmesh)
    flat = ((idx[:, 0, :, None, None] * ny + idx[:, 1, None, :, None]) * nz
            + idx[:, 2, None, None, :]).reshape(pos.shape[0], -1)
    wts = (w[:, 0, :, None, None] * w[:, 1, None, :, None]
           * w[:, 2, None, None, :]).reshape(pos.shape[0], -1)
    rho = torch.zeros(nx * ny * nz, dtype=fdt, device=device).index_add(
        0, flat.reshape(-1), (q[:, None] * wts).to(fdt).reshape(-1))
    rho = rho.reshape(nx, ny, nz)

    mx = torch.fft.fftfreq(nx, device=device, dtype=torch.float64) * nx
    my = torch.fft.fftfreq(ny, device=device, dtype=torch.float64) * ny
    mz = torch.fft.rfftfreq(nz, device=device, dtype=torch.float64) * nz
    kx, ky, kz = (2.0 * math.pi * m / float(length[a])
                  for a, m in enumerate((mx, my, mz)))
    k2 = (kx[:, None, None] ** 2 + ky[None, :, None] ** 2
          + kz[None, None, :] ** 2)
    green = torch.where(k2 > 1e-10, 2.0 * math.pi * torch.exp(
        -k2 / (4.0 * alpha * alpha)) / (volume * torch.where(
            k2 > 1e-10, k2, torch.ones_like(k2))), torch.zeros_like(k2))
    sinc = (torch.sinc(mx / nx)[:, None, None] * torch.sinc(my / ny)[None, :, None]
            * torch.sinc(mz / nz)[None, None, :])
    kern = (green / sinc ** (2 * order)).to(fdt)
    phi = torch.fft.irfftn(torch.fft.rfftn(rho, norm="backward") * kern,
                           s=(nx, ny, nz), norm="forward")
    phi_at = (phi.reshape(-1).to(dtype)[flat] * wts).to(acc).sum(-1)
    qa = q.to(acc)
    e_total = (qa * phi_at).sum()
    (grad,) = torch.autograd.grad(e_total, (pos_g,))
    forces = -grad.to(acc)
    forces = forces - forces.mean(dim=0, keepdim=True)
    q_tot = qa.sum()
    energies = (qa * phi_at.detach() - alpha / math.sqrt(math.pi) * qa * qa
                - math.pi / (2.0 * alpha * alpha * volume) * qa * q_tot)
    return energies, forces

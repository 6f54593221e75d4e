# SPDX-License-Identifier: Apache-2.0
"""Gaussian-type-orbital densities and their analytic Fourier transforms,
L <= 2 (counterpart of ``nvalchemiops_tpu.mathops.gto``).

- Density: ``phi_{l,m}(r, sigma) = N Y_l^m(r_hat) exp(-r^2 / (2 sigma^2))``
  with ``N = sqrt(4 pi) / (2 pi)^{3/2} / sigma^3``, so the monopole
  integrates to 1.
- Fourier transform: ``phi_hat_{l,m}(k) = (i/2)^l sqrt(4 pi) Y_l^m(k_hat)
  exp(-k^2 sigma^2 / 2)``: real for L in {0, 2}, imaginary for L = 1.

Gradients are closed forms.  Tensors stay on their device; other inputs
go to ``device``, the card unless the caller names another, in numpy's
dtype (a Python float ``sigma`` is float64, as JAX's with x64).
"""

from __future__ import annotations

import math

import torch

from nvalchemiops_torch.mathops.spherical_harmonics import (
    as_tensors,
    eval_all_spherical_harmonics,
    spherical_harmonics,
)

__all__ = [
    "gto_normalization", "gto_self_overlap", "eval_gto_density",
    "gto_gaussian_factor", "gto_integral_l0", "gto_density_l0",
    "gto_density_l1", "gto_density_l2", "gto_density_all",
    "gto_density_l0_gradient", "gto_fourier_l0", "gto_fourier_l1_real",
    "gto_fourier_l1_imag", "gto_fourier_l2_real", "eval_gto_fourier",
]

SQRT_4PI = math.sqrt(4.0 * math.pi)
TWOPI = 2.0 * math.pi

_NUM_COMPONENTS = {0: 1, 1: 4, 2: 9}


def _float(sigma):
    """``sigma`` in a floating dtype (an integer sigma is float64)."""
    return sigma if sigma.is_floating_point() else sigma.double()


def gto_normalization(sigma, device="cuda"):
    """Normalization ``N = sqrt(4 pi) / ((2 pi)^{3/2} sigma^3)``."""
    sigma, = as_tensors((sigma,), device)
    sigma = _float(sigma)
    two_pi = torch.tensor(TWOPI, dtype=sigma.dtype, device=sigma.device)
    return SQRT_4PI / (TWOPI * torch.sqrt(two_pi) * sigma ** 3)


def gto_self_overlap(l: int, sigma, device="cuda"):
    """Self-overlap ``<phi_{l,m} | phi_{l,m}> = 1 / (8 pi^{3/2} sigma^3)``,
    the same for every l (the real harmonics are orthonormal); the value
    consistent with :func:`eval_gto_density`'s normalization, as in the
    JAX package."""
    del l
    sigma, = as_tensors((sigma,), device)
    sigma = _float(sigma)
    pi = torch.tensor(math.pi, dtype=sigma.dtype, device=sigma.device)
    return 1.0 / (8.0 * pi * torch.sqrt(pi) * sigma ** 3)


def eval_gto_density(positions, sigma, l_max: int = 2, device="cuda"):
    """GTO density components at ``positions [..., 3]`` -> ``[..., n_comp]``,
    ``n_comp`` 1/4/9 for ``l_max`` 0/1/2, ordered as
    :func:`~nvalchemiops_torch.mathops.spherical_harmonics.spherical_harmonics`."""
    if l_max not in _NUM_COMPONENTS:
        raise ValueError(f"l_max must be 0, 1 or 2, got {l_max}")
    positions, sigma = as_tensors((positions, sigma), device)
    r2 = (positions * positions).sum(-1, keepdim=True)
    prefactor = gto_normalization(sigma) * torch.exp(-r2 / (2.0 * sigma ** 2))
    return prefactor * spherical_harmonics(positions, l_max=l_max)


def gto_gaussian_factor(r2, sigma, device="cuda"):
    """Radial factor ``exp(-r^2 / (2 sigma^2))``."""
    r2, sigma = as_tensors((r2, sigma), device)
    return torch.exp(-r2 / (2.0 * sigma ** 2))


def gto_integral_l0(sigma, device="cuda"):
    """Integral of the monopole GTO over all space: 1 by construction."""
    sigma, = as_tensors((sigma,), device)
    return torch.ones_like(_float(sigma))


def gto_density_l0(positions, sigma, device="cuda"):
    """Monopole density ``phi_00`` at ``positions [..., 3]`` -> ``[...]``."""
    return eval_gto_density(positions, sigma, 0, device)[..., 0]


def gto_density_l1(positions, sigma, device="cuda"):
    """Dipole densities ``phi_1m`` ``[..., 3]`` (m = -1, 0, +1)."""
    return eval_gto_density(positions, sigma, 1, device)[..., 1:4]


def gto_density_l2(positions, sigma, device="cuda"):
    """Quadrupole densities ``phi_2m`` ``[..., 5]``."""
    return eval_gto_density(positions, sigma, 2, device)[..., 4:9]


def gto_density_all(positions, sigma, device="cuda"):
    """All nine L <= 2 density components ``[..., 9]``."""
    return eval_gto_density(positions, sigma, 2, device)


def gto_density_l0_gradient(positions, sigma, device="cuda"):
    """``grad phi_00 = -phi_00 r / sigma^2`` ``[..., 3]``."""
    positions, sigma = as_tensors((positions, sigma), device)
    phi = gto_density_l0(positions, sigma)
    return (-phi / sigma ** 2)[..., None] * positions


def gto_fourier_l0(k_vectors, sigma, device="cuda"):
    """Real monopole Fourier component ``[...]``."""
    return eval_gto_fourier(k_vectors, sigma, 0, device)[0][..., 0]


def gto_fourier_l1_real(k_vectors, sigma, device="cuda"):
    """Real part of the dipole Fourier components: zero, ``[..., 3]``."""
    return eval_gto_fourier(k_vectors, sigma, 1, device)[0][..., 1:4]


def gto_fourier_l1_imag(k_vectors, sigma, device="cuda"):
    """Imaginary part of the dipole Fourier components ``[..., 3]``."""
    return eval_gto_fourier(k_vectors, sigma, 1, device)[1][..., 1:4]


def gto_fourier_l2_real(k_vectors, sigma, device="cuda"):
    """Real quadrupole Fourier components ``[..., 5]``."""
    return eval_gto_fourier(k_vectors, sigma, 2, device)[0][..., 4:9]


def eval_gto_fourier(k_vectors, sigma, l_max: int = 2, device="cuda"):
    """Analytic Fourier transform of the GTO basis at ``k_vectors [..., 3]``.

    Returns ``(real, imag)``, each ``[..., n_comp]``: L = 0 and L = 2 are
    real (L = 2 carries ``(i/2)^2 = -1/4``), L = 1 is imaginary with
    coefficient ``(1/2) sqrt(4 pi) Y_1^m exp(-k^2 sigma^2 / 2)``.
    """
    if l_max not in _NUM_COMPONENTS:
        raise ValueError(f"l_max must be 0, 1 or 2, got {l_max}")
    k_vectors, sigma = as_tensors((k_vectors, sigma), device)
    k2 = (k_vectors * k_vectors).sum(-1, keepdim=True)
    gauss = torch.exp(-k2 * sigma ** 2 / 2.0)
    y = eval_all_spherical_harmonics(k_vectors)
    zeros = torch.zeros_like(y[..., 0:1])
    real = [SQRT_4PI * y[..., 0:1] * gauss]
    imag = [zeros]
    if l_max >= 1:
        real.append(zeros.expand(y[..., 1:4].shape))
        imag.append(0.5 * SQRT_4PI * y[..., 1:4] * gauss)
    if l_max >= 2:
        real.append(-0.25 * SQRT_4PI * y[..., 4:9] * gauss)
        imag.append(zeros.expand(y[..., 4:9].shape))
    return torch.cat(real, dim=-1), torch.cat(imag, dim=-1)

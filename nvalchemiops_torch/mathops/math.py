# SPDX-License-Identifier: Apache-2.0
"""Scalar math helpers (counterpart of ``nvalchemiops_tpu.mathops.math``).

Elementwise torch expressions with the JAX package's operation order, so
that f64 results agree to the last bits on the CPU.
"""

from __future__ import annotations

import math

import torch

from nvalchemiops_torch.types import placed


def divmod_floor(a, n):
    """Floor division and remainder with Python's ``divmod`` sign convention.

    For integer ``a`` and positive ``n`` returns ``(d, m)`` with
    ``a = d*n + m`` and ``0 <= m < n``.
    """
    d = torch.div(a, n, rounding_mode="floor")
    m = a - d * n
    return d, m


def safe_divide(num, den, eps=1e-12, device="cuda"):
    """``num/den`` with denominators smaller than ``eps`` mapped to 0; on
    the device of a tensor input, else on ``device``."""
    num, den = placed((num, den), device)
    small = torch.abs(den) < eps
    safe_den = torch.where(small, torch.ones_like(den), den)
    q = num / safe_den
    return torch.where(small, torch.zeros_like(q), q)


def exp_over_x(x, prefactor, device="cuda"):
    """``exp(-prefactor * x) / x``, the Ewald Green's-function radial
    factor; on ``x``'s device, else on ``device``."""
    x, = placed((x,), device)
    return torch.exp(-prefactor * x) / x


def erfc_approx(x):
    """Complementary error function, Abramowitz-Stegun 7.1.26 polynomial.

    Max absolute error ~1.5e-7; the same formula runs inside the CUDA pair
    kernels (csrc/window_sweep.cu), so the kernel and its plain version
    differ only by rounding.  ``erfc(-x) = 2 - erfc(x)`` covers negatives.
    """
    a1, a2, a3 = 0.254829592, -0.284496736, 1.421413741
    a4, a5 = -1.453152027, 1.061405429
    p = 0.3275911
    ax = torch.abs(x)
    t = 1.0 / (1.0 + p * ax)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    y = poly * torch.exp(-ax * ax)
    return torch.where(x >= 0, y, 2.0 - y)


def sinc_normalized(x):
    """Normalized sinc ``sin(pi x)/(pi x)`` with a stable value of 1 at 0."""
    small = torch.abs(x) < 1e-6
    safe = torch.where(small, torch.ones_like(x), x)
    pix = math.pi * safe
    return torch.where(small, torch.ones_like(x), torch.sin(pix) / pix)


def apply_mat3(vecs, m):
    """``vecs [.., 3] @ m [3, 3]`` as broadcast multiply-adds.

    Kept as the JAX package's multiply-add form rather than ``@`` so that
    fractional coordinates, and the ``floor``-ed bin and tile indices taken
    from them, come out bit-identical to the reference on the CPU.
    """
    return (vecs[..., 0:1] * m[0] + vecs[..., 1:2] * m[1]
            + vecs[..., 2:3] * m[2])


def apply_mat3_batched(vecs, m):
    """``vecs [.., n, 3] @ m [.., 3, 3]`` per leading index, in the
    multiply-add order of :func:`apply_mat3` (``m [3, 3]`` with ``vecs [n,
    3]`` is :func:`apply_mat3` itself)."""
    m = m[..., None, :, :]
    return (vecs[..., 0:1] * m[..., 0, :] + vecs[..., 1:2] * m[..., 1, :]
            + vecs[..., 2:3] * m[..., 2, :])


def dot_phases(positions, k_vectors, device="cuda"):
    """``positions [.., n, 3] @ k_vectors [.., k, 3]^T`` as three broadcast
    outer products, in the JAX package's order (``[.., n, k]``); on the
    device of a tensor input, else on ``device``."""
    positions, k_vectors = placed((positions, k_vectors), device)
    px = positions[..., :, 0:1]
    py = positions[..., :, 1:2]
    pz = positions[..., :, 2:3]
    kx = k_vectors[..., None, :, 0]
    ky = k_vectors[..., None, :, 1]
    kz = k_vectors[..., None, :, 2]
    return px * kx + py * ky + pz * kz

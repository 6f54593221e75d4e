# SPDX-License-Identifier: Apache-2.0
"""Separable 3-D real-FFT convolution as matrix products (counterpart of
``nvalchemiops_tpu.mathops.matmul_dft``).

PME's reciprocal space is ``irfftn(rfftn(mesh) * kernel)`` with a real
kernel.  A DFT along one axis is a product with the ``[n, n]`` transform
matrix, so the whole convolution is a chain of ``torch.matmul`` calls on
real planes (real and imaginary parts kept apart; no complex tensor).
The JAX package computes the same chain with ``jnp.matmul`` outside any
Pallas kernel; ``batch_pme_reciprocal(fft_mode="matmul")`` and
``pme_reciprocal_space(fft_mode="matmul")`` take it.

The transform matrices are built in float64 with numpy and cast to the
mesh's dtype.  The products need full f32 (TF32 keeps 10 bits of the
phases): the chain runs with f32 matmul precision "highest", whatever the
caller set, and the caller's setting comes back after it.

Normalization matches PME's: unscaled forward (``rfftn(norm="backward")``)
and unscaled inverse (``irfftn(norm="forward")``).
"""

from __future__ import annotations

from contextlib import contextmanager
from functools import lru_cache

import numpy as np
import torch

__all__ = ["matmul_rfft_convolve"]


@lru_cache(maxsize=None)
def _dft_mats(n: int):
    """Full-axis DFT matrices: cos[j,k], -sin[j,k] for exp(-2pi i jk/n)."""
    j, k = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    ang = 2.0 * np.pi * j * k / n
    return np.cos(ang), -np.sin(ang)


@lru_cache(maxsize=None)
def _rdft_mats(n: int):
    """Real-input z-axis matrices, forward ``[n, nh]`` and inverse ``[nh,
    n]``.

    Forward: ``F_k = sum_j m_j e^{-2pi i jk/n}``, ``k = 0..n//2``.
    Inverse (Hermitian-weighted, real output, unscaled):
    ``m_j = sum_k w_k [Re(F_k) cos(2pi jk/n) - Im(F_k) sin(2pi jk/n)]``,
    ``w_k = 1`` for ``k = 0`` and (``n`` even) ``k = n/2``, else 2.
    """
    nh = n // 2 + 1
    j, k = np.meshgrid(np.arange(n), np.arange(nh), indexing="ij")
    ang = 2.0 * np.pi * j * k / n
    fwd_c, fwd_s = np.cos(ang), -np.sin(ang)           # [n, nh]
    w = np.full(nh, 2.0)
    w[0] = 1.0
    if n % 2 == 0:
        w[-1] = 1.0
    inv_c = w[:, None] * np.cos(ang.T)                 # [nh, n]
    inv_s = -(w[:, None] * np.sin(ang.T))
    return fwd_c, fwd_s, inv_c, inv_s


@lru_cache(maxsize=64)
def _mats(nx: int, ny: int, nz: int, dtype, device):
    """The transform matrices of a mesh, cast and placed once."""
    def mat(m):
        return torch.as_tensor(m, dtype=dtype, device=device)

    return (tuple(mat(m) for m in _rdft_mats(nz)),
            tuple(mat(m) for m in _dft_mats(ny)),
            tuple(mat(m) for m in _dft_mats(nx)))


@contextmanager
def _full_f32_matmul():
    """f32 matmuls without TF32 inside, the caller's setting restored on
    exit.  A caller who set the precision per backend
    (``torch.backends.cuda.matmul.fp32_precision``) has it saved and
    restored through the same API: torch refuses to read the global
    setting once the two APIs are mixed."""
    matmul = torch.backends.cuda.matmul
    try:
        prev = torch.get_float32_matmul_precision()
    except RuntimeError:
        prev = None
    if prev is None:
        saved = matmul.fp32_precision
        matmul.fp32_precision = "ieee"
    else:
        torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if prev is None:
            matmul.fp32_precision = saved
        else:
            torch.set_float32_matmul_precision(prev)


def _cyc(x):
    """Cycle the last three axes: (.., a, b, c) -> (.., b, c, a)."""
    return x.permute(*range(x.dim() - 3), -2, -1, -3)


def matmul_rfft_convolve(mesh, kernel):
    """``irfftn(rfftn(mesh, norm="backward") * kernel, norm="forward")``
    over the last three axes, with a real ``kernel`` of shape
    ``mesh.shape[-3:-1] + (n_last//2 + 1,)``, as plain matrix products.

    ``mesh`` may carry leading batch axes (``kernel`` broadcasts against
    them).  The output is real, of the shape and dtype of ``mesh``.
    """
    dtype, device = mesh.dtype, mesh.device
    nx, ny, nz = (int(d) for d in mesh.shape[-3:])
    nzh = nz // 2 + 1
    if tuple(kernel.shape[-3:]) != (nx, ny, nzh):
        raise ValueError(
            f"kernel shape {tuple(kernel.shape[-3:])} != rfft spectrum shape "
            f"{(nx, ny, nzh)}")

    mats = _mats(nx, ny, nz, dtype, device)
    kern = torch.as_tensor(kernel, dtype=dtype, device=device)
    with _full_f32_matmul():
        return _convolve(mesh, kern, *mats)


def _convolve(mesh, kernel, z_mats, y_mats, x_mats):
    """The product chain of :func:`matmul_rfft_convolve`."""
    fz_c, fz_s, iz_c, iz_s = z_mats
    cy, sy = y_mats
    cx, sx = x_mats

    def cmul(re, im, c, s, conj=False):
        # complex product with (c + i s), or its conjugate, on the last axis
        if conj:
            return (re @ c.T + im @ s.T, im @ c.T - re @ s.T)
        return (re @ c - im @ s, re @ s + im @ c)

    # forward.  Layout walk (last three axes):
    # (x, y, z) --mm z--> (x, y, kz) --cyc,cyc--> (kz, x, y)
    # --mm y--> (kz, x, ky) --cyc,cyc--> (ky, kz, x) --mm x--> (ky, kz, kx)
    re = mesh @ fz_c
    im = mesh @ fz_s
    re, im = _cyc(_cyc(re)), _cyc(_cyc(im))      # (kz, x, y)
    re, im = cmul(re, im, cy, sy)                # (kz, x, ky)
    re, im = _cyc(_cyc(re)), _cyc(_cyc(im))      # (ky, kz, x)
    re, im = cmul(re, im, cx, sx)                # (ky, kz, kx)

    # the kernel arrives as (kx, ky, kz): permute to (ky, kz, kx)
    kern = torch.movedim(kernel, -3, -1)
    re = re * kern
    im = im * kern

    # inverse.  (ky, kz, kx) --conj mm x--> (ky, kz, x) --cyc--> (kz, x, ky)
    # --conj mm y--> (kz, x, y) --cyc--> (x, y, kz) --hermitian mm z--> (x, y, z)
    re, im = cmul(re, im, cx, sx, conj=True)     # (ky, kz, x)
    re, im = _cyc(re), _cyc(im)                  # (kz, x, ky)
    re, im = cmul(re, im, cy, sy, conj=True)     # (kz, x, y)
    re, im = _cyc(re), _cyc(im)                  # (x, y, kz)
    return (re @ iz_c + im @ iz_s).contiguous()

# SPDX-License-Identifier: Apache-2.0
"""Cardinal B-spline basis (counterpart of ``nvalchemiops_tpu.spline``'s
``bspline_weight`` and ``bspline_derivative``).

Orders 1-4 on ``[0, order)``; mesh parameter ``u = order/2 + theta -
offset`` as in the JAX package, so the order weights per axis sum to 1.
The dense separable spread/gather of that module is not on the port's path
yet (ROADMAP.md).
"""

from __future__ import annotations

import torch

__all__ = ["bspline_weight", "bspline_derivative"]


def _piecewise(u, pieces):
    """``pieces[k]`` on ``[k, k+1)``, zero outside ``[0, len(pieces))``."""
    out = torch.zeros_like(u)
    for k in reversed(range(len(pieces))):
        out = torch.where((u >= k) & (u < k + 1), pieces[k], out)
    return out


def bspline_weight(u, order: int):
    """Cardinal B-spline basis M_order(u) on [0, order), vectorized."""
    if order == 1:
        return _piecewise(u, [torch.ones_like(u)])
    if order == 2:
        return _piecewise(u, [u, 2.0 - u])
    if order == 3:
        return _piecewise(u, [0.5 * u * u, 0.75 - (u - 1.5) * (u - 1.5),
                              0.5 * ((3.0 - u) * (3.0 - u))])
    if order == 4:
        return _piecewise(u, [
            u * u * u / 6.0,
            (-3.0 * (u * u * u) + 12.0 * (u * u) - 12.0 * u + 4.0) / 6.0,
            (3.0 * (u * u * u) - 24.0 * (u * u) + 60.0 * u - 44.0) / 6.0,
            (4.0 - u) * (4.0 - u) * (4.0 - u) / 6.0,
        ])
    raise ValueError(f"spline order must be 1-4, got {order}")


def bspline_derivative(u, order: int):
    """dM_order/du, vectorized."""
    if order == 1:
        return torch.zeros_like(u)
    if order == 2:
        return _piecewise(u, [torch.ones_like(u), -torch.ones_like(u)])
    if order == 3:
        return _piecewise(u, [u, -2.0 * (u - 1.5), -(3.0 - u)])
    if order == 4:
        return _piecewise(u, [
            0.5 * u * u,
            (-9.0 * (u * u) + 24.0 * u - 12.0) / 6.0,
            (9.0 * (u * u) - 48.0 * u + 60.0) / 6.0,
            -0.5 * ((4.0 - u) * (4.0 - u)),
        ])
    raise ValueError(f"spline order must be 1-4, got {order}")

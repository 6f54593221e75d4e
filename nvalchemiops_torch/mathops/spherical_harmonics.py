# SPDX-License-Identifier: Apache-2.0
"""Real spherical harmonics for L <= 2 with closed-form gradients
(counterpart of ``nvalchemiops_tpu.mathops.spherical_harmonics``).

- Ordering ``[Y00, Y1m1, Y10, Y1p1, Y2m2, Y2m1, Y20, Y2p1, Y2p2]``: L = 1
  maps to (y, z, x), L = 2 to (xy, yz, 3z^2 - r^2, xz, x^2 - y^2).
- Normalization ``sqrt((2l+1)/4pi (l-|m|)!/(l+|m|)!)`` with the real
  combination factors; the origin is regularized by ``EPSILON`` added to
  ``r^2``.

Elementwise torch over a leading batch of position vectors ``[..., 3]``.
Tensors stay on their device; other inputs (numpy arrays, lists) go to
``device``, the card unless the caller names another, in numpy's dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from nvalchemiops_torch.types import default_device

__all__ = ["eval_spherical_harmonics_l0", "eval_spherical_harmonics_l1",
           "eval_spherical_harmonics_l2", "eval_all_spherical_harmonics",
           "spherical_harmonics", "spherical_harmonics_gradient"]

Y00_COEFF = 0.28209479177387814  # 1/sqrt(4 pi)
Y1_COEFF = 0.4886025119029199  # sqrt(3/(4 pi))
Y2_M2_COEFF = 1.0925484305920792  # sqrt(15/(4 pi))
Y2_M1_COEFF = 1.0925484305920792
Y2_0_COEFF = 0.31539156525252005  # sqrt(5/(16 pi))
Y2_P1_COEFF = 1.0925484305920792
Y2_P2_COEFF = 0.5462742152960396  # sqrt(15/(16 pi))

EPSILON = 1e-30


def as_tensors(xs, device):
    """``xs`` as tensors on the device of the first tensor among them, else
    on ``device``; a non-tensor keeps numpy's dtype (a Python float is
    float64)."""
    first = next((x for x in xs if isinstance(x, torch.Tensor)), None)
    dev = default_device(first, device)
    return [x.to(dev) if isinstance(x, torch.Tensor)
            else torch.as_tensor(np.asarray(x), device=dev) for x in xs]


def eval_spherical_harmonics_l0(r, device="cuda"):
    """Y_0^0 for positions ``r [..., 3]`` -> ``[..., 1]``."""
    r, = as_tensors((r,), device)
    return torch.full(r.shape[:-1] + (1,), Y00_COEFF, dtype=r.dtype,
                      device=r.device)


def eval_spherical_harmonics_l1(r, device="cuda"):
    """``(Y_1^-1, Y_1^0, Y_1^+1) ~ (y, z, x) / r`` for ``r [..., 3]`` ->
    ``[..., 3]``."""
    r, = as_tensors((r,), device)
    r2 = (r * r).sum(-1, keepdim=True)
    r_inv = 1.0 / torch.sqrt(r2 + EPSILON)
    x, y, z = r[..., 0:1], r[..., 1:2], r[..., 2:3]
    return Y1_COEFF * torch.cat([y, z, x], dim=-1) * r_inv


def eval_spherical_harmonics_l2(r, device="cuda"):
    """The five L = 2 real harmonics for ``r [..., 3]`` -> ``[..., 5]``."""
    r, = as_tensors((r,), device)
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    r2 = x * x + y * y + z * z + EPSILON
    r2_inv = 1.0 / r2
    return torch.stack([
        Y2_M2_COEFF * x * y * r2_inv,
        Y2_M1_COEFF * y * z * r2_inv,
        Y2_0_COEFF * (3.0 * z * z - r2) * r2_inv,
        Y2_P1_COEFF * x * z * r2_inv,
        Y2_P2_COEFF * (x * x - y * y) * r2_inv,
    ], dim=-1)


def eval_all_spherical_harmonics(r, device="cuda"):
    """All nine harmonics (L = 0..2) for ``r [..., 3]`` -> ``[..., 9]``."""
    r, = as_tensors((r,), device)
    return torch.cat([eval_spherical_harmonics_l0(r),
                      eval_spherical_harmonics_l1(r),
                      eval_spherical_harmonics_l2(r)], dim=-1)


def spherical_harmonics(positions, l_max: int = 2, device="cuda"):
    """Real spherical harmonics up to ``l_max`` (0, 1 or 2) of ``positions
    [..., 3]`` -> ``[..., 1 | 4 | 9]``."""
    positions, = as_tensors((positions,), device)
    if l_max == 0:
        return eval_spherical_harmonics_l0(positions)
    if l_max == 1:
        return torch.cat([eval_spherical_harmonics_l0(positions),
                          eval_spherical_harmonics_l1(positions)], dim=-1)
    if l_max == 2:
        return eval_all_spherical_harmonics(positions)
    raise ValueError(f"l_max must be 0, 1 or 2, got {l_max}")


def spherical_harmonics_gradient(positions, l_max: int = 2, device="cuda"):
    """Closed-form gradients of the real harmonics up to ``l_max`` with
    respect to the Cartesian components of ``positions [..., 3]`` ->
    ``[..., num_components, 3]``."""
    if l_max not in (0, 1, 2):
        raise ValueError(f"l_max must be 0, 1 or 2, got {l_max}")
    positions, = as_tensors((positions,), device)
    x, y, z = positions[..., 0], positions[..., 1], positions[..., 2]
    r2 = x * x + y * y + z * z + EPSILON
    r_inv = 1.0 / torch.sqrt(r2)
    r2_inv = 1.0 / r2
    r3_inv = r_inv * r2_inv
    r4_inv = r2_inv * r2_inv
    zeros = torch.zeros_like(x)
    grads = [(1.0, (zeros, zeros, zeros))]
    if l_max >= 1:
        # d/dv (u/r) = delta_uv / r - u v / r^3, for u in (y, z, x)
        grads += [
            (Y1_COEFF, (-x * y * r3_inv, r_inv - y * y * r3_inv,
                        -y * z * r3_inv)),
            (Y1_COEFF, (-x * z * r3_inv, -y * z * r3_inv,
                        r_inv - z * z * r3_inv)),
            (Y1_COEFF, (r_inv - x * x * r3_inv, -x * y * r3_inv,
                        -x * z * r3_inv)),
        ]
    if l_max >= 2:
        # grad (c u v / r^2) = c (grad(u v) / r^2 - 2 u v r / r^4)
        grads += [
            (Y2_M2_COEFF, (y * r2_inv - 2.0 * x * x * y * r4_inv,
                           x * r2_inv - 2.0 * x * y * y * r4_inv,
                           -2.0 * x * y * z * r4_inv)),
            (Y2_M1_COEFF, (-2.0 * x * y * z * r4_inv,
                           z * r2_inv - 2.0 * y * y * z * r4_inv,
                           y * r2_inv - 2.0 * y * z * z * r4_inv)),
            (Y2_0_COEFF, (-6.0 * x * z * z * r4_inv,
                          -6.0 * y * z * z * r4_inv,
                          6.0 * z * r2_inv - 6.0 * z * z * z * r4_inv)),
            (Y2_P1_COEFF, (z * r2_inv - 2.0 * x * x * z * r4_inv,
                           -2.0 * x * y * z * r4_inv,
                           x * r2_inv - 2.0 * x * z * z * r4_inv)),
            (Y2_P2_COEFF, (2.0 * x * r2_inv - 2.0 * x * (x * x - y * y)
                           * r4_inv,
                           -2.0 * y * r2_inv - 2.0 * y * (x * x - y * y)
                           * r4_inv,
                           -2.0 * z * (x * x - y * y) * r4_inv)),
        ]
    return torch.stack([c * torch.stack(g, dim=-1) for c, g in grads],
                       dim=-2)


# ---------------------------------------------------------------------------
# Per-component accessors, one per harmonic and per gradient, generated as
# in the JAX package: each takes positions [..., 3] and returns the scalar
# harmonic [...] or its gradient [..., 3].
# ---------------------------------------------------------------------------

_COMPONENT_NAMES = ("00", "1m1", "10", "1p1", "2m2", "2m1", "20", "2p1", "2p2")


def _make_component(idx: int, name: str):
    def _value(positions, device="cuda"):
        return eval_all_spherical_harmonics(positions, device)[..., idx]

    def _gradient(positions, device="cuda"):
        return spherical_harmonics_gradient(positions, 2, device)[..., idx, :]

    _value.__name__ = _value.__qualname__ = f"spherical_harmonic_{name}"
    _value.__doc__ = f"Real harmonic Y_{name} at positions [..., 3] -> [...]."
    _gradient.__name__ = _gradient.__qualname__ = (
        f"spherical_harmonic_{name}_gradient")
    _gradient.__doc__ = (f"Gradient of Y_{name} with respect to position "
                         "[..., 3] -> [..., 3].")
    return _value, _gradient


for _idx, _name in enumerate(_COMPONENT_NAMES):
    for _fn in _make_component(_idx, _name):
        globals()[_fn.__name__] = _fn
        __all__.append(_fn.__name__)
del _idx, _name, _fn

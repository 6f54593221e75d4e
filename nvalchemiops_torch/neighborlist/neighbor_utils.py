# SPDX-License-Identifier: Apache-2.0
"""Packed periodic-shift codes (counterpart of the JAX package's
``neighborlist/neighbor_utils.py`` packing helpers).

One int32 per shift, components bit-packed 10 bits each (range +-511)::

    packed = (sx + 512) << 20 | (sy + 512) << 10 | (sz + 512)

The halo grid stores one code per extended cell.
"""

from __future__ import annotations

from nvalchemiops_torch.types import INDEX_DTYPE

SHIFT_PACK_BIAS = 512
SHIFT_PACK_MASK = 1023

__all__ = ["pack_shifts", "unpack_shifts"]


def pack_shifts(sx, sy, sz):
    """Pack three int shift components (|s| <= 511) into one int32."""
    sx = sx.to(INDEX_DTYPE)
    sy = sy.to(INDEX_DTYPE)
    sz = sz.to(INDEX_DTYPE)
    return (
        ((sx + SHIFT_PACK_BIAS) << 20)
        | ((sy + SHIFT_PACK_BIAS) << 10)
        | (sz + SHIFT_PACK_BIAS)
    )


def unpack_shifts(packed):
    """Unpack an int32 shift code into (sx, sy, sz) int32 tensors."""
    packed = packed.to(INDEX_DTYPE)
    sx = ((packed >> 20) & SHIFT_PACK_MASK) - SHIFT_PACK_BIAS
    sy = ((packed >> 10) & SHIFT_PACK_MASK) - SHIFT_PACK_BIAS
    sz = (packed & SHIFT_PACK_MASK) - SHIFT_PACK_BIAS
    return sx, sy, sz

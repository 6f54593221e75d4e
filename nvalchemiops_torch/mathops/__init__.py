# SPDX-License-Identifier: Apache-2.0
"""Math helpers of the PyTorch port."""

from nvalchemiops_torch.mathops.math import (
    apply_mat3,
    apply_mat3_batched,
    divmod_floor,
    erfc_approx,
    sinc_normalized,
)

__all__ = ["apply_mat3", "apply_mat3_batched", "divmod_floor", "erfc_approx",
           "sinc_normalized"]

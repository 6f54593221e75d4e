# SPDX-License-Identifier: Apache-2.0
"""Math helpers of the PyTorch port (counterpart of
``nvalchemiops_tpu.mathops``); the separable DFT convolution is
``mathops.matmul_dft``."""

from nvalchemiops_torch.mathops.math import (
    apply_mat3,
    apply_mat3_batched,
    divmod_floor,
    dot_phases,
    erfc_approx,
    exp_over_x,
    safe_divide,
    sinc_normalized,
)

__all__ = ["apply_mat3", "apply_mat3_batched", "divmod_floor", "dot_phases",
           "erfc_approx", "exp_over_x", "safe_divide", "sinc_normalized"]

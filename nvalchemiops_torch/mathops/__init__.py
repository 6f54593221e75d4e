# SPDX-License-Identifier: Apache-2.0
"""Math helpers of the PyTorch port (counterpart of
``nvalchemiops_tpu.mathops``): the scalar helpers, the real spherical
harmonics and the GTO basis (L <= 2); the separable DFT convolution is
``mathops.matmul_dft``."""

from nvalchemiops_torch.mathops import spherical_harmonics as _sh_mod
from nvalchemiops_torch.mathops.gto import (
    eval_gto_density,
    eval_gto_fourier,
    gto_density_all,
    gto_density_l0,
    gto_density_l0_gradient,
    gto_density_l1,
    gto_density_l2,
    gto_fourier_l0,
    gto_fourier_l1_imag,
    gto_fourier_l1_real,
    gto_fourier_l2_real,
    gto_gaussian_factor,
    gto_integral_l0,
    gto_normalization,
    gto_self_overlap,
)
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
from nvalchemiops_torch.mathops.spherical_harmonics import (
    eval_all_spherical_harmonics,
    eval_spherical_harmonics_l0,
    eval_spherical_harmonics_l1,
    eval_spherical_harmonics_l2,
    spherical_harmonics,
    spherical_harmonics_gradient,
)

# per-component harmonic accessors (spherical_harmonic_00 ... _2p2[_gradient])
_SH_COMPONENT_FNS = [f"spherical_harmonic_{n}{suffix}"
                     for n in _sh_mod._COMPONENT_NAMES
                     for suffix in ("", "_gradient")]
globals().update({n: getattr(_sh_mod, n) for n in _SH_COMPONENT_FNS})
del _sh_mod

__all__ = [
    "apply_mat3",
    "apply_mat3_batched",
    "divmod_floor",
    "dot_phases",
    "erfc_approx",
    "exp_over_x",
    "safe_divide",
    "sinc_normalized",
    "spherical_harmonics",
    "spherical_harmonics_gradient",
    "eval_all_spherical_harmonics",
    "eval_spherical_harmonics_l0",
    "eval_spherical_harmonics_l1",
    "eval_spherical_harmonics_l2",
    "eval_gto_density",
    "eval_gto_fourier",
    "gto_density_all",
    "gto_density_l0",
    "gto_density_l0_gradient",
    "gto_density_l1",
    "gto_density_l2",
    "gto_fourier_l0",
    "gto_fourier_l1_imag",
    "gto_fourier_l1_real",
    "gto_fourier_l2_real",
    "gto_gaussian_factor",
    "gto_integral_l0",
    "gto_normalization",
    "gto_self_overlap",
] + _SH_COMPONENT_FNS

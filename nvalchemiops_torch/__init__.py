# SPDX-License-Identifier: Apache-2.0
"""PyTorch + CUDA port of nvalchemiops_tpu for NVIDIA Hopper (H100).

Same module paths as the JAX package (``grid``, ``spline``,
``spline_windowed``, ``interactions.dispersion.grid_d3``,
``interactions.electrostatics.pme``, ...).  Plain tensor code is PyTorch;
the JAX package's Pallas kernels on this path are hand-written CUDA kernels
under ``csrc/``, built with ``nvcc`` at their first launch (never at
import) and bound with ``ctypes`` (``kernels/``).  On CPU tensors every
kernel wrapper runs its plain PyTorch version instead.

This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"

# SPDX-License-Identifier: Apache-2.0
"""PyTorch + CUDA port of nvalchemiops_tpu for NVIDIA Hopper (H100).

Same module paths as the JAX package (``grid``, ``spline``,
``spline_windowed``, ``interactions.dispersion.grid_d3``,
``interactions.electrostatics.pme``, ...).  Plain tensor code is PyTorch;
the JAX package's Pallas kernels on this path are hand-written CUDA kernels
under ``csrc/``, built with ``nvcc`` at their first launch (never at
import) and bound with ``ctypes`` (``kernels/``).  On CPU tensors every
kernel wrapper runs its plain PyTorch version instead.

The package namespace holds every subpackage of the JAX package;
``parallel`` runs its multi-device paths on ``torch.distributed`` (one
process per rank) and lacks the JAX package's training step.  Importing
them builds and loads no kernel.

``trace`` (outside ``__all__``) holds the port's counters (kernel
launches, host reads, uploads, slot pairs) and times the entry points in
spans while a ``torch.profiler`` session records.

This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"

from nvalchemiops_torch import (  # noqa: E402
    grid,
    interactions,
    mathops,
    neighborlist,
    parallel,
    spline,
    spline_windowed,
)

__all__ = [
    "__version__",
    "grid",
    "interactions",
    "mathops",
    "neighborlist",
    "parallel",
    "spline",
    "spline_windowed",
]

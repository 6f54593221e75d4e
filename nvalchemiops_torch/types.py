# SPDX-License-Identifier: Apache-2.0
"""Dtype policy of the PyTorch port (counterpart of ``nvalchemiops_tpu.types``).

- ``INDEX_DTYPE``: slot maps, atom ids, shift codes and counters are int32.
  Indexing ops that need int64 widen locally and never store the result.
- Floating point: every function computes in the dtype of its positions.
  float64 is the CPU reference precision (the tests hold the port to the
  JAX package at f64); ``KERNEL_DTYPE`` (float32) is the working precision
  on the GPU, the only dtype the CUDA kernels accept.
"""

import torch

INDEX_DTYPE = torch.int32
KERNEL_DTYPE = torch.float32

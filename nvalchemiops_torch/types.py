# SPDX-License-Identifier: Apache-2.0
"""Dtype policy of the PyTorch port (counterpart of ``nvalchemiops_tpu.types``).

- ``INDEX_DTYPE``: slot maps, atom ids, shift codes and counters are int32.
  Indexing ops that need int64 widen locally and never store the result.
- Floating point: every function computes in the dtype of its positions.
  float64 is the CPU reference precision (the tests hold the port to the
  JAX package at f64); ``KERNEL_DTYPE`` (float32) is the working precision
  on the GPU, the only dtype the CUDA kernels accept.
- ``accumulator_dtype``: pairwise sums upcast float16 / bfloat16 to
  float32 and keep float32 / float64 as they are.
- Device: an entry point runs where its tensor inputs lie; where none of
  them is a tensor (numpy arrays, lists, scalars), on the card unless the
  caller passes ``device`` (:func:`default_device`).
"""

import numpy as np
import torch

__all__ = ["INDEX_DTYPE", "KERNEL_DTYPE", "SUPPORTED_FLOAT_DTYPES",
           "canonical_float_dtype", "accumulator_dtype"]

INDEX_DTYPE = torch.int32
KERNEL_DTYPE = torch.float32

#: dtypes accepted for positions / cells across the library
SUPPORTED_FLOAT_DTYPES = (torch.float16, torch.bfloat16, torch.float32,
                          torch.float64)


def default_device(x, device=None):
    """The device an entry point runs on: ``x``'s own for a tensor, else
    ``device`` (the card unless the caller names another)."""
    if isinstance(x, torch.Tensor):
        return x.device
    return torch.device(device if device is not None else "cuda")


def placed(xs, device=None):
    """``xs`` as tensors on the device of the first tensor among them, else
    on ``device`` (:func:`default_device`)."""
    first = next((x for x in xs if isinstance(x, torch.Tensor)), None)
    dev = default_device(first, device)
    return [torch.as_tensor(x, device=dev) for x in xs]


def _as_torch_dtype(dtype):
    """A torch dtype from a torch dtype, a numpy dtype or type, or a name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else getattr(dtype, "name", None)
    if name is None:
        name = np.dtype(dtype).name
    found = getattr(torch, str(name), None)
    if not isinstance(found, torch.dtype):
        raise ValueError(f"Unsupported floating dtype {dtype!r}")
    return found


def canonical_float_dtype(dtype) -> torch.dtype:
    """Validate and canonicalize a floating dtype for positions/cells."""
    dtype = _as_torch_dtype(dtype)
    if dtype not in SUPPORTED_FLOAT_DTYPES:
        raise ValueError(
            f"Unsupported floating dtype {dtype}; expected one of "
            f"{[str(d).replace('torch.', '') for d in SUPPORTED_FLOAT_DTYPES]}"
        )
    return dtype


def accumulator_dtype(dtype) -> torch.dtype:
    """Accumulation dtype for a given input dtype (>= float32)."""
    dtype = _as_torch_dtype(dtype)
    if dtype in (torch.float16, torch.bfloat16):
        return torch.float32
    return dtype

# SPDX-License-Identifier: Apache-2.0
"""Build the CUDA sources into one shared library at first use; load it.

``nvcc`` compiles every ``nvalchemiops_torch/csrc/*.cu`` (one process per
source, all started together; the headers ``csrc/*.cuh`` they include count
toward the cache key) and links the objects into one shared
library with a plain C interface for ``sm_90a`` (Hopper), which ``ctypes``
loads.  Nothing links against PyTorch, so a build takes seconds.  The
library lands in ``build/nvalchemiops_torch/`` beside the package, named by
a hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused.  Importing this module builds nothing; a missing
``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

import torch

from nvalchemiops_torch.types import KERNEL_DTYPE

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "nvalchemiops_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points and their argument types (pointers and the stream as
# c_void_p: ctypes would pass a bare Python int as a 32-bit int)
_SIGNATURES = {
    "nv_window_sweep": [_I, _P, _P, _P, _P, _P] + [_I] * 8 + [_F] * 9
                       + [_I] * 5 + [_P],
    "nv_window_sweep_occupancy": [_I, _I, _I, ctypes.POINTER(_I)],
    "nv_row_sweep": [_I] + [_P] * 6 + [_I] * 12 + [_F] * 8 + [_P],
    "nv_chunk_sweep": [_I] + [_P] * 6 + [_I] * 12 + [_F] * 9 + [_P],
    "nv_stencil_sweep": [_I] + [_P] * 3 + [_I] * 8 + [_F] * 3 + [_P],
    "nv_windowed_gather_grad": [_P] * 6 + [_I] * 4 + [_P],
    "nv_windowed_spread": [_P] * 3 + [_I] * 4 + [_P],
    "nv_dense_pairs": [_I] + [_P] * 4 + [_I] * 3 + [_F] * 7 + [_I] * 3
                      + [ctypes.POINTER(_I), _P],
    "nv_separable_spread": [_P] * 5 + [_I] * 10 + [_P],
    "nv_separable_gather": [_P] * 6 + [_I] * 8 + [_P],
    "nv_set_device": [_I],
}

def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default install prefix.  Raises if there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of nvalchemiops_torch are compiled at first use")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _headers() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def library_path(extra_flags=()) -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256()
    for flag in NVCC_FLAGS + tuple(extra_flags):
        h.update(flag.encode())
    for src in _sources() + _headers():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libnvalchemiops_torch_{h.hexdigest()[:16]}.so")


def build_library(extra_flags=()) -> tuple[str, str]:
    """Compile the sources unless an identical build exists.

    Returns ``(path, compiler_output)``; the output is empty when the
    cached build was reused.  ``extra_flags`` (e.g. ``("-Xptxas", "-v")``
    for register and spill counts) are part of the cache key.
    """
    path = library_path(extra_flags)
    if os.path.exists(path):
        return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    tmp = f"{path}.{os.getpid()}.tmp"
    jobs = []
    for src in _sources():
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    failed = None
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}"
    if failed is None:
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp,
               *(obj for _, obj, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             check=False)
        log.append(res.stdout + res.stderr)
        if res.returncode != 0:
            failed = (f"nvcc link failed ({res.returncode}): {' '.join(cmd)}"
                      f"\n{res.stdout}\n{res.stderr}")
    for _, obj, _ in jobs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed is not None:
        raise RuntimeError(failed)
    os.replace(tmp, path)
    return path, "".join(log)


@functools.cache
def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built and loaded on the first call; later
    calls return the same library without touching the sources)."""
    path, _ = build_library()
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launches_kernel(t: torch.Tensor) -> bool:
    """Whether a wrapper given ``t`` launches its CUDA kernel: for a CUDA
    tensor of ``KERNEL_DTYPE`` (float32), on any card.  A CPU tensor, or a
    CUDA tensor of another dtype, takes the plain version on its own
    device; any other device raises.  The route is decided by device and
    dtype alone, before any build: a failed build or launch raises, it is
    never rerouted."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.is_cuda and t.dtype == KERNEL_DTYPE


def check_cuda_tensors(name: str, *tensors) -> None:
    """Raise unless every tensor is a contiguous float32 tensor on the
    first tensor's CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        if t.dtype != KERNEL_DTYPE:
            raise ValueError(f"{name}: CUDA kernel takes {KERNEL_DTYPE}, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


@contextlib.contextmanager
def on_device(t: torch.Tensor):
    """Context of a launch for ``t``: ``t``'s card is PyTorch's current
    device and the library runtime's, so the launch and the runtime's
    calls before it (``cudaFuncSetAttribute`` for shared memory) act on
    that card, on its current stream."""
    with torch.cuda.device(t.device):
        index = torch.cuda.current_device()
        check_launch(f"cudaSetDevice({index})",
                     load_library().nv_set_device(index))
        yield


def current_stream(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device, for a launch."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(name: str, err: int) -> None:
    """Raise when a kernel launch returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")

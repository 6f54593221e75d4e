// SPDX-License-Identifier: Apache-2.0
//
// The library's own CUDA runtime (linked statically) keeps its own current
// device per host thread.  The Python wrappers call nv_set_device with the
// card of a launch's tensors before every launch (kernels/build.py:
// on_device), so the launch and cudaFuncSetAttribute (pair_bodies.cuh:
// allow_smem) act on that card, not on the device the runtime last used.
//
// Interface: C, for ctypes.  Returns the cudaError_t of cudaSetDevice, or 0
// where the runtime's current device already is that card (the usual case:
// one card, or many launches on one): cudaGetDevice reads the thread's state
// and costs less than setting it again.

#include <cuda_runtime.h>

extern "C" int nv_set_device(int device) {
  int current = -1;
  if (cudaGetDevice(&current) == cudaSuccess && current == device) return 0;
  return cudaSetDevice(device);
}

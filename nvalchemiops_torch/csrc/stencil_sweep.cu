// SPDX-License-Identifier: Apache-2.0
//
// Full-space voxel-stencil pair sweep, own side only (kernel 9).
//
// Replaces: nvalchemiops_tpu/pallas/stencil_sweep.py:stencil_sweep_fullspace
// (:46, the pallas_call at :107), which carries the stencil_* functions of
// stencil.py and passes 1 and 3 of the hybrid D3 engine.
//
// What it computes.  The occupancy-1 voxel grid keeps every field on flat
// planes: candidates ext [n_ext, Ez, F] with F = Ey*Ex + 2*pad and the (y, x)
// halo inline, pad = Ry*Ex + Rx, so a cell offset (dy, dx) is a column shift
// dy*Ex + dx; own planes [n_own, Cz, W0] with W0 = Ey*Ex (the halo columns
// of the own side parked at -DISPLACE, so ghost copies never act as own
// atoms).  Every own voxel visits all (2Rz+1)(2Ry+1)(2Rx+1) - 1 offsets and
// sums its own-side terms of both pair directions: no j-side scatter at all.
// Bodies (pair_bodies.cuh, own-side outputs): cn (own/ext: px, py, pz, rcov;
// out cn), chain (+ decn; out fx, fy, fz), coulomb (px, py, pz, q; out e,
// fx, fy, fz -- e is half the pair energy, as every pair is seen twice).
//
// What bounds it on the H100.  FP32-ALU and SFU work per pair inside the
// cutoff, at twice the pair visits of a half-space sweep; the bound counts
// each pair once, so the 2x shows as distance from it.  The candidate
// planes are a few MB and stay in the 50 MB L2.  Design: one thread per own
// voxel; neighbouring threads take neighbouring voxels, so every candidate
// read of an offset is one coalesced run; sums stay in registers and each
// output is written once, with no atomics.
//
// Interface: C, for ctypes.  Pointers are device pointers into contiguous
// float32 tensors allocated by the Python wrapper.  Returns the cudaError_t
// of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_bodies.cuh"

namespace {

using namespace pair_bodies;

constexpr int kThreads = 256;

template <class Body>
__global__ void __launch_bounds__(kThreads)
    stencil_kernel(const float* __restrict__ ext, const float* __restrict__ own,
                   float* __restrict__ out, int cz, int w0, int ez, int f_w,
                   int rz, int ry, int rx, int ex, int pad, Params p) {
  const int64_t n_own = static_cast<int64_t>(cz) * w0;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n_own) return;
  const int z = static_cast<int>(idx / w0);
  const int col = static_cast<int>(idx - static_cast<int64_t>(z) * w0);
  const int ext_plane = ez * f_w;
  float o[Body::kOwn];
#pragma unroll
  for (int f = 0; f < Body::kOwn; ++f) o[f] = own[f * n_own + idx];
  float acc[Body::kOut];
#pragma unroll
  for (int k = 0; k < Body::kOut; ++k) acc[k] = 0.0f;
  for (int dz = -rz; dz <= rz; ++dz) {
    for (int dy = -ry; dy <= ry; ++dy) {
      // candidate of offset (dz, dy, dx): ext[(rz + dz), pad + dy*ex + dx + col]
      const float* row = ext + (z + rz + dz) * f_w + pad + dy * ex + col;
      for (int dx = -rx; dx <= rx; ++dx) {
        if (dz == 0 && dy == 0 && dx == 0) continue;
        float po[Body::kOut], jo[Body::kJ];
        // feature f of this candidate is row[dx + f * ext_plane]
        if (!Body::pair(p, o, nullptr, row + dx, ext_plane, nullptr, 0, 0, po,
                        jo))
          continue;
#pragma unroll
        for (int k = 0; k < Body::kOut; ++k) acc[k] += po[k];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < Body::kOut; ++k) out[k * n_own + idx] = acc[k];
}

template <class Body>
cudaError_t launch(const float* ext, const float* own, float* out, int cz,
                   int w0, int ez, int f_w, int rz, int ry, int rx, int ex,
                   int pad, const Params& p, cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(cz) * w0;
  if (n == 0) return cudaSuccess;
  const int blocks = static_cast<int>((n + kThreads - 1) / kThreads);
  stencil_kernel<Body><<<blocks, kThreads, 0, stream>>>(
      ext, own, out, cz, w0, ez, f_w, rz, ry, rx, ex, pad, p);
  return cudaGetLastError();
}

}  // namespace

// body: 0 = CN, 1 = CN chain, 2 = Coulomb.
extern "C" int nv_stencil_sweep(int body, const float* ext, const float* own,
                                float* out, int cz, int w0, int ez, int f_w,
                                int rz, int ry, int rx, int ex, int pad,
                                float cutoff_sq, float k1, float alpha,
                                void* stream) {
  const Params p{cutoff_sq, 0.0f, 0.0f, 0.0f, 0.0f, k1, 0.0f, alpha, 0.0f, 0, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (body) {
    case 0:
      return launch<CnBody>(ext, own, out, cz, w0, ez, f_w, rz, ry, rx, ex, pad, p, st);
    case 1:
      return launch<ChainBody>(ext, own, out, cz, w0, ez, f_w, rz, ry, rx, ex, pad, p, st);
    case 2:
      return launch<CoulombBody>(ext, own, out, cz, w0, ez, f_w, rz, ry, rx, ex, pad, p, st);
    default:
      return cudaErrorInvalidValue;
  }
}

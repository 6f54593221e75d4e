// SPDX-License-Identifier: Apache-2.0
//
// Dense separable B-spline spread and gather for the dense PME path
// (spline.py dense_*_single, pme.py batched dense engine and the tile
// overflow fallback).
//
// Replaces: nvalchemiops_tpu/pallas/spread.py
//   - pallas_separable_spread (:45, pallas_call :60):
//       mesh[x, y, z] = sum_n qsx[n, x] sy[n, y] sz[n, z];
//   - pallas_separable_gather (:87, pallas_call :99):
//       out[n] = sum_xyz mesh[x, y, z] sx[n, x] sy[n, y] sz[n, z].
// The TPU kernels take the dense per-axis matrices [N, n_mesh] and
// contract them on the matrix unit with the whole mesh resident in VMEM.
// Each dense row is the one-hot expansion of the atom's order-point stencil
// (spline.py:284-289), so these kernels take the stencil itself, gidx [B, N,
// 3, order] (wrapped indices) and w [B, N, 3, order], with a leading system
// axis so the batched PME is one launch.  The gather with derivative
// weights dw computes the value and the three fractional-gradient gathers of
// dense_gather_gradient_single in one pass; each gradient component is the
// gather of kernel 6 with the weights of one axis swapped for their
// derivatives, so this is the function of four pallas_separable_gather
// calls.
//
// What bounds them on the H100.  Both touch order^3 = 64 mesh points per
// atom (order 4): the spread ~4 flops and one atomic per point, the gather
// ~2-8 flops per point.  At 2,000 atoms per 32^3 mesh, or 109,744 atoms on
// a 128^3 mesh, that is far below the FP32 roof; the limits are the
// scattered 4-byte accesses and, for the spread, the atomics into L2.  Mesh
// reads and writes are each counted once for the bound: 128 KB per 32^3
// mesh, 8 MB at 128^3.
//
// Design.  Spread: one thread per (atom, stencil point) adds q wx wy wz
// into its mesh point with a float atomicAdd; neighbouring threads hit
// neighbouring z points.  The order of the atomics varies from run to run,
// which sets the on-card tolerance against the plain version.  Gather: one
// thread per atom walks its order^3 points, summing z-rows first (value and
// z-derivative), then y, then x, as separable partial sums; each output
// has one writer, so the gather is deterministic.
//
// Interface: C, for ctypes.  Pointers are device pointers into contiguous
// tensors allocated by the Python wrapper (gidx int32, the rest float32);
// mesh must be zero on entry to the spread.  Returns the cudaError_t of the
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxOrder = 4;

__global__ void __launch_bounds__(256)
    spread_kernel(const int* __restrict__ gidx, const float* __restrict__ w,
                  const float* __restrict__ q, float* __restrict__ mesh, int N,
                  int order, int nx, int ny, int nz, int64_t total) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= total) return;
  const int o3 = order * order * order;
  const int64_t atom = tid / o3;  // b * N + n
  const int pt = static_cast<int>(tid - atom * o3);
  const int a = pt / (order * order);
  const int b = (pt / order) % order;
  const int c = pt % order;
  const int* g = gidx + atom * 3 * order;
  const float* ww = w + atom * 3 * order;
  const float val = q[atom] * ww[a] * (ww[order + b] * ww[2 * order + c]);
  if (val == 0.0f) return;
  const int64_t sys = atom / N;
  const int64_t at =
      ((sys * nx + g[a]) * ny + g[order + b]) * static_cast<int64_t>(nz) +
      g[2 * order + c];
  atomicAdd(&mesh[at], val);
}

template <bool kGrad>
__global__ void __launch_bounds__(256)
    gather_kernel(const float* __restrict__ mesh, const int* __restrict__ gidx,
                  const float* __restrict__ w, const float* __restrict__ dw,
                  float* __restrict__ val, float* __restrict__ grad,
                  int64_t n_atoms, int N, int order, int nx, int ny, int nz) {
  const int64_t atom = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (atom >= n_atoms) return;
  const int* g = gidx + atom * 3 * order;
  const float* ww = w + atom * 3 * order;
  const float* dd = kGrad ? dw + atom * 3 * order : nullptr;
  const float* m = mesh + (atom / N) * static_cast<int64_t>(nx) * ny * nz;
  float v = 0.0f, gx = 0.0f, gy = 0.0f, gz = 0.0f;
  for (int a = 0; a < order; ++a) {
    const float* plane = m + static_cast<int64_t>(g[a]) * ny * nz;
    float qv = 0.0f, qdy = 0.0f, qdz = 0.0f;
    for (int b = 0; b < order; ++b) {
      const float* row = plane + static_cast<int64_t>(g[order + b]) * nz;
      float r = 0.0f, rdz = 0.0f;
      for (int c = 0; c < order; ++c) {
        const float x = __ldg(row + g[2 * order + c]);
        r += ww[2 * order + c] * x;
        if (kGrad) rdz += dd[2 * order + c] * x;
      }
      qv += ww[order + b] * r;
      if (kGrad) {
        qdy += dd[order + b] * r;
        qdz += ww[order + b] * rdz;
      }
    }
    v += ww[a] * qv;
    if (kGrad) {
      gx += dd[a] * qv;
      gy += ww[a] * qdy;
      gz += ww[a] * qdz;
    }
  }
  val[atom] = v;
  if (kGrad) {
    grad[atom * 3] = gx;
    grad[atom * 3 + 1] = gy;
    grad[atom * 3 + 2] = gz;
  }
}

}  // namespace

extern "C" int nv_separable_spread(const int* gidx, const float* w,
                                   const float* q, float* mesh, int B, int N,
                                   int order, int nx, int ny, int nz,
                                   void* stream) {
  if (order < 1 || order > kMaxOrder) return cudaErrorInvalidValue;
  const int64_t total = static_cast<int64_t>(B) * N * order * order * order;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  spread_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(gidx, w, q, mesh, N,
                                                       order, nx, ny, nz, total);
  return cudaGetLastError();
}

extern "C" int nv_separable_gather(const float* mesh, const int* gidx,
                                   const float* w, const float* dw, float* val,
                                   float* grad, int B, int N, int order, int nx,
                                   int ny, int nz, void* stream) {
  if (order < 1 || order > kMaxOrder) return cudaErrorInvalidValue;
  const int64_t n_atoms = static_cast<int64_t>(B) * N;
  if (n_atoms == 0) return cudaSuccess;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n_atoms + threads - 1) / threads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dw != nullptr) {
    gather_kernel<true><<<blocks, threads, 0, st>>>(mesh, gidx, w, dw, val,
                                                    grad, n_atoms, N, order,
                                                    nx, ny, nz);
  } else {
    gather_kernel<false><<<blocks, threads, 0, st>>>(mesh, gidx, w, dw, val,
                                                     grad, n_atoms, N, order,
                                                     nx, ny, nz);
  }
  return cudaGetLastError();
}

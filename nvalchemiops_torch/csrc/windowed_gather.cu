// SPDX-License-Identifier: Apache-2.0
//
// Per-tile B-spline spread and gather-with-gradient for the tile-windowed
// PME path (spline_windowed.py).
//
// Replaces: nvalchemiops_tpu/pallas/windowed_gather.py
//   - _gather_grad_planes (kernel _kernel :31, pallas_call :99): for each
//     mesh tile, contract every slot's axis B-spline rows (Sx, Sy, Sz, dSx,
//     dSy, dSz) against the tile's W^3 potential window -> potential and
//     three fractional-gradient components per slot, four [t, cap] planes;
//   - _spread_windows (kernel _spread_kernel :111, pallas_call :151): the
//     per-tile spread window [W, W*W] = (q Sz)^T (Sy (x) Sx) over the tile's
//     slots, [t, W, W*W].
// The window extraction, the per-atom pick, the tiles.inv rotation and the
// parity fold of overlapping windows onto the mesh stay in torch, as they
// stayed in XLA.
//
// What bounds them on the H100.  Both are small per tile: a W^3 = 1,728
// float window (W = tile + 4 = 12) and cap slot rows of 6W floats.  At the
// main path's 128^3 mesh (4,096 tiles, cap ~40) the spread is ~0.3 GFMA
// and the gather reads ~28 MB of windows; both are far below the card's
// FP32 and HBM roofs, so launch shape and on-chip reuse matter more than
// tensor cores.  The TPU kernels built the (y (x) x) products with one-hot
// matmuls because Mosaic could not reshape [cap, W, W]; here each thread
// simply indexes.
//
// Design.  Gather: one block per tile stages the window in shared memory;
// one thread per slot keeps its six W-wide rows in registers and skips the
// (z, y) rows where its banded B-spline weights are zero (order 4 leaves 4
// of 12 non-zero per axis), so the dense contraction costs ~W*16 instead
// of W^3 multiply-adds per slot.  Spread: one block per tile stages q*Sz,
// Sy and Sx of all slots in shared memory; threads cover the W^3 outputs
// and loop over the slots.  Neither uses atomics: each tile's window and
// each slot's outputs have exactly one writer, so both are deterministic.
//
// Interface: C, for ctypes.  Pointers are device pointers into contiguous
// float32 tensors the Python wrapper allocated.  W is a template argument
// (tiles 4, 8, 16 -> W 8, 12, 20); the wrapper rejects other tiles.
// Returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int W>
__global__ void __launch_bounds__(64)
    gather_grad_kernel(const float* __restrict__ smat,
                       const float* __restrict__ win, float* __restrict__ val,
                       float* __restrict__ gx, float* __restrict__ gy,
                       float* __restrict__ gz, int cap, int kw) {
  constexpr int WW = W * W;
  __shared__ float sw[W * WW];  // window [z][y * W + x]
  const int64_t t = blockIdx.x;
  for (int k = threadIdx.x; k < W * WW; k += blockDim.x) sw[k] = win[t * W * WW + k];
  __syncthreads();
  for (int c = threadIdx.x; c < cap; c += blockDim.x) {
    const float* s = smat + (t * cap + c) * kw;
    float sx[W], sdx[W];
#pragma unroll
    for (int x = 0; x < W; ++x) {
      sx[x] = s[x];
      sdx[x] = s[3 * W + x];
    }
    float v = 0.0f, a = 0.0f, b = 0.0f, g = 0.0f;
    for (int z = 0; z < W; ++z) {
      const float sz = s[2 * W + z];
      const float dsz = s[5 * W + z];
      if (sz == 0.0f && dsz == 0.0f) continue;
      float q = 0.0f, qx = 0.0f, qy = 0.0f;
      for (int y = 0; y < W; ++y) {
        const float sy = s[W + y];
        const float dsy = s[4 * W + y];
        if (sy == 0.0f && dsy == 0.0f) continue;
        const float* row = sw + z * WW + y * W;
        float px = 0.0f, pdx = 0.0f;
#pragma unroll
        for (int x = 0; x < W; ++x) {
          px += sx[x] * row[x];
          pdx += sdx[x] * row[x];
        }
        q += sy * px;
        qx += sy * pdx;
        qy += dsy * px;
      }
      v += sz * q;
      a += sz * qx;
      b += sz * qy;
      g += dsz * q;
    }
    const int64_t o = t * cap + c;
    val[o] = v;
    gx[o] = a;
    gy[o] = b;
    gz[o] = g;
  }
}

template <int W>
__global__ void __launch_bounds__(256)
    spread_kernel(const float* __restrict__ smat, const float* __restrict__ q,
                  float* __restrict__ out, int cap, int kw) {
  constexpr int WW = W * W;
  extern __shared__ float rows[];  // [cap][3W]: q*Sz | Sy | Sx
  const int64_t t = blockIdx.x;
  for (int k = threadIdx.x; k < cap * 3 * W; k += blockDim.x) {
    const int c = k / (3 * W);
    const int r = k - c * 3 * W;
    const float* s = smat + (t * cap + c) * kw;
    float v;
    if (r < W) {
      v = q[t * cap + c] * s[2 * W + r];  // q * Sz
    } else if (r < 2 * W) {
      v = s[r];  // Sy
    } else {
      v = s[r - 2 * W];  // Sx
    }
    rows[k] = v;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < W * WW; k += blockDim.x) {
    const int z = k / WW;
    const int y = (k - z * WW) / W;
    const int x = k - z * WW - y * W;
    float acc = 0.0f;
    for (int c = 0; c < cap; ++c) {
      const float* r = rows + c * 3 * W;
      acc += r[z] * (r[W + y] * r[2 * W + x]);
    }
    out[t * W * WW + k] = acc;
  }
}

template <int W>
cudaError_t gather_launch(const float* smat, const float* win, float* val,
                          float* gx, float* gy, float* gz, int ntiles, int cap,
                          int kw, cudaStream_t stream) {
  gather_grad_kernel<W><<<ntiles, 64, 0, stream>>>(smat, win, val, gx, gy, gz,
                                                   cap, kw);
  return cudaGetLastError();
}

template <int W>
cudaError_t spread_launch(const float* smat, const float* q, float* out,
                          int ntiles, int cap, int kw, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(cap) * 3 * W;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        spread_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  spread_kernel<W><<<ntiles, 256, smem, stream>>>(smat, q, out, cap, kw);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nv_windowed_gather_grad(const float* smat, const float* win,
                                       float* val, float* gx, float* gy,
                                       float* gz, int ntiles, int cap, int kw,
                                       int w_win, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ntiles == 0 || cap == 0) return cudaSuccess;
  switch (w_win) {
    case 8:
      return gather_launch<8>(smat, win, val, gx, gy, gz, ntiles, cap, kw, st);
    case 12:
      return gather_launch<12>(smat, win, val, gx, gy, gz, ntiles, cap, kw, st);
    case 20:
      return gather_launch<20>(smat, win, val, gx, gy, gz, ntiles, cap, kw, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int nv_windowed_spread(const float* smat, const float* q, float* out,
                                  int ntiles, int cap, int kw, int w_win,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ntiles == 0) return cudaSuccess;
  switch (w_win) {
    case 8:
      return spread_launch<8>(smat, q, out, ntiles, cap, kw, st);
    case 12:
      return spread_launch<12>(smat, q, out, ntiles, cap, kw, st);
    case 20:
      return spread_launch<20>(smat, q, out, ntiles, cap, kw, st);
    default:
      return cudaErrorInvalidValue;
  }
}

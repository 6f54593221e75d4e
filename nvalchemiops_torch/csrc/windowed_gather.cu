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
// What bounds them on the H100.  Bytes: the spread reads q and the Sx | Sy
// | Sz columns of smat and writes the windows (at the main path's 128^3
// mesh, 4,096 tiles of cap 40 and W = 12: 24 MB + 28 MB, 0.016 ms at
// 3.35 TB/s); the gather reads smat and the windows.  The TPU kernels
// built the dense [W, cap] x [cap, W^2] product on the matrix unit (with
// one-hot matmuls, as Mosaic could not reshape [cap, W, W]).  Done densely
// here, the spread is bound by shared-memory loads: three per multiply-add,
// W^3 cap multiply-adds per tile, of which all but order^3 are exact zeros
// (an order-4 row has 4 of its W columns non-zero per axis).
//
// Design.  Gather: one block per tile stages the window in shared memory;
// one thread per slot keeps its six W-wide rows in registers and skips the
// (z, y) rows where its banded B-spline weights are zero, so the dense
// contraction costs ~W*16 instead of W^3 multiply-adds per slot.
// Spread: output-stationary and band-skipping.  A block holds whole tiles
// (4 of W = 8, 2 of W = 12, 1 of W = 20) and stages q*Sz, Sy and Sx of up
// to kStage slots per tile in shared memory (16-byte loads), with one
// packed pair of words per slot, found by scanning its rows (any row
// works, up to a dense one): the non-zero columns of Sy and of Sx as bit
// masks, and the first and last non-zero column of q*Sz.  Each thread owns
// one (y, x) column of one window and keeps its W z-sums in registers.
// Per slot it reads the pair (a broadcast) and, only if its Sy[y] and
// Sx[x] are non-zero, adds q Sz[z] * (Sy[y] Sx[x]) over the z band: as
// four fixed z when the band is at most four wide (order <= 4), else over
// the band.  A skipped term has a factor that is exactly +-0, so for
// finite inputs the sum equals the dense one.  Stores are z-major, so
// consecutive threads write consecutive (y, x).  Neither kernel uses
// atomics: every output has one writer that adds the slots in ascending
// order, so both are deterministic (two launches give equal bits).
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

constexpr int kStage = 64;           // slots per tile staged at a time

// tiles per block: whole tiles, and about 256-416 threads
template <int W>
__host__ __device__ constexpr int tiles_per_block() {
  return W == 8 ? 4 : (W == 12 ? 2 : 1);
}

template <int W>
__host__ __device__ constexpr int spread_threads() {
  return (tiles_per_block<W>() * W * W + 31) / 32 * 32;
}

// Bit j set where r[j] != 0, for a W-wide row (W <= 20).
template <int W>
__device__ unsigned nonzero_mask(const float* r) {
  unsigned m = 0u;
#pragma unroll
  for (int j = 0; j < W; ++j) m |= (r[j] != 0.0f ? 1u : 0u) << j;
  return m;
}

// acc[z] += r[z] p for z in [z4, z4 + 4): the slot's z band (at most four
// wide) lies there, and the other terms have an exact-zero factor.
template <int W>
__device__ inline void add_four(float (&acc)[W], const float* r, int z4,
                                float p) {
#pragma unroll
  for (int s = 0; s <= W - 4; ++s) {
    if (s == z4) {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[s + k] = fmaf(r[s + k], p, acc[s + k]);
    }
  }
}

template <int W>
__global__ void __launch_bounds__(spread_threads<W>())
    spread_kernel(const float* __restrict__ smat, const float* __restrict__ q,
                  float* __restrict__ out, int64_t ntiles, int cap, int kw) {
  constexpr int WW = W * W;
  constexpr int TPB = tiles_per_block<W>();
  constexpr int kRow = 3 * W;                // q*Sz | Sy | Sx
  __shared__ __align__(16) float rows[TPB][kStage][kRow];
  // per slot: the non-zero columns of Sy (.x, bits 0-19) and Sx (.y); the
  // first and last non-zero column of q*Sz in .x bits 20-24 and 25-29
  __shared__ uint2 band[TPB][kStage];
  const int lt = threadIdx.x / WW;           // tile of this block
  const int col = threadIdx.x - lt * WW;     // y * W + x
  const int y = col / W;
  const int x = col - y * W;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * TPB;
  const bool owner = lt < TPB && t0 + lt < ntiles;
  float acc[W];
#pragma unroll
  for (int z = 0; z < W; ++z) acc[z] = 0.0f;

  for (int c0 = 0; c0 < cap; c0 += kStage) {
    const int nc = min(kStage, cap - c0);
    __syncthreads();  // the previous stage is consumed
    // stage Sx | Sy | Sz of each slot (16-byte loads: W and kw are
    // multiples of 4) as q*Sz | Sy | Sx
    constexpr int kV = kRow / 4;             // float4s of a staged row
#pragma unroll 4
    for (int k = threadIdx.x; k < TPB * nc * kV; k += blockDim.x) {
      const int tl = k / (nc * kV);
      const int c = (k - tl * nc * kV) / kV;
      const int j = 4 * (k - (tl * nc + c) * kV);  // column in Sx | Sy | Sz
      const int64_t t = t0 + tl;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      int dst = j < W ? 2 * W + j : (j < 2 * W ? j : j - 2 * W);
      if (t < ntiles) {
        const int64_t slot = t * cap + c0 + c;
        v = __ldg(reinterpret_cast<const float4*>(smat + slot * kw + j));
        if (j >= 2 * W) {
          const float qs = __ldg(q + slot);
          v = make_float4(qs * v.x, qs * v.y, qs * v.z, qs * v.w);
        }
      }
      *reinterpret_cast<float4*>(&rows[tl][c][dst]) = v;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < TPB * nc; k += blockDim.x) {
      const int tl = k / nc;
      const int c = k - tl * nc;
      const unsigned mz = nonzero_mask<W>(rows[tl][c]);
      const unsigned my = nonzero_mask<W>(rows[tl][c] + W);
      const unsigned mx = nonzero_mask<W>(rows[tl][c] + 2 * W);
      const unsigned zlo = mz ? __ffs(mz) - 1 : 0u;
      const unsigned zhi = mz ? 31 - __clz(mz) : 0u;
      band[tl][c] = mz ? make_uint2(my | zlo << 20 | zhi << 25, mx)
                       : make_uint2(0u, 0u);
    }
    __syncthreads();
    if (!owner) continue;
    for (int c = 0; c < nc; ++c) {
      const uint2 b = band[lt][c];
      if (((b.x >> y) & (b.y >> x) & 1u) == 0u) continue;
      const int zlo = (b.x >> 20) & 31, zhi = (b.x >> 25) & 31;
      const float* r = rows[lt][c];
      const float p = r[W + y] * r[2 * W + x];
      if (zhi - zlo < 4) {
        add_four<W>(acc, r, min(zlo, W - 4), p);
      } else {
#pragma unroll
        for (int z = 0; z < W; ++z) {
          if (z >= zlo && z <= zhi) acc[z] = fmaf(r[z], p, acc[z]);
        }
      }
    }
  }
  if (owner) {
    float* o = out + (t0 + lt) * W * WW + col;
#pragma unroll
    for (int z = 0; z < W; ++z) o[z * WW] = acc[z];
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
  constexpr int TPB = tiles_per_block<W>();
  const unsigned blocks = static_cast<unsigned>((ntiles + TPB - 1) / TPB);
  spread_kernel<W><<<blocks, spread_threads<W>(), 0, stream>>>(
      smat, q, out, ntiles, cap, kw);
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

// SPDX-License-Identifier: Apache-2.0
//
// Half-space pair sweep over the halo atom grid, templated on a pass body.
//
// Replaces: nvalchemiops_tpu/pallas/window_sweep.py:window_sweep (the
// Mosaic kernel at :267, pallas_call at :417), which carries D3 passes 1-3
// (grid_d3.py:1380-1387, :1465-1534, :1612-1625) and the erfc Coulomb pass
// (grid.py:900-928), and the fused D3 + Coulomb pass 2 of grid_dftd3_coulomb
// (grid_d3.py:1535-1571, :1581-1605).  The pair bodies live in
// pair_bodies.cuh, shared with kernels 7-9.
//
// What it computes.  Every interior cell (z, y, x) of the grid meets the
// candidate windows of the pair-once enumeration: the home row (dz, dy) =
// (0, 0) and every half-space (dz, dy) (dz > 0, or dz == 0 and dy > 0),
// each over the 2*rx+1 x-cells [x - rx, x + rx].  In the home row cells left
// of centre are skipped and the centre cell keeps only slot pairs i < j
// (the mask of window_sweep.py:287-290).  Per pair the body returns
// own-side terms, summed into the interior planes [cz, cy, cx, cap], and
// j-side terms, summed into the extended planes [ez, ey, ex, cap] that the
// caller folds with grid.fold_halo.
//
// Layout.  Planes are stacked feature-major: own [n_own, cz, cy, cx, cap],
// candidates [n_cand, ez, ey, ex, cap].  Because x is the fastest cell axis
// and slots are innermost, the 2*rx+1 x-cells of one (z, y) candidate row
// form ONE contiguous run of (2*rx+1)*cap floats per feature, so the
// candidate window stages into shared memory with coalesced loads and the
// j-side flush writes one contiguous run.  None of the TPU's lane layout
// (128-lane windows, WINDOW_PARK pads, pre-windowed copies) is needed.
//
// What bounds it on the H100.  The pair bodies are FP32-ALU and SFU bound
// (rsqrt, exp, a divide per pair inside the cutoff); device-memory traffic
// is small (each candidate window is read once per own cell, ~1-2 KB).
// Design: one block per own cell, one warp per own slot (lanes stride the
// candidates, so the own-side sum is a register accumulator plus one warp
// shuffle reduction), j-side sums go to shared memory with atomics that
// never collide inside a warp, and are flushed once per offset with one
// global atomic per candidate slot.  Pairs outside the cutoff (most of the
// cube-vs-sphere overcount, and every parked empty slot) leave after the
// distance test.  The global j atomics make the j-side sum order vary from
// run to run; that sets the on-card tolerance against the plain version.
//
// Interface: C, for ctypes.  Every pointer is a device pointer into a
// contiguous float32 tensor allocated by the Python wrapper; j_out must be
// zero on entry.  Returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_bodies.cuh"

namespace {

using namespace pair_bodies;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
using D3CoulombSeparate = D3CoulombBody<false, false>;
using D3CoulombCombined = D3CoulombBody<false, true>;

template <class Body>
__global__ void __launch_bounds__(kThreads)
    sweep_kernel(const float* __restrict__ own, const float* __restrict__ cand,
                 float* __restrict__ own_out, float* __restrict__ j_out,
                 int cz, int cy, int cx, int rz, int ry, int rx, int cap,
                 int n_cand, const float* __restrict__ lf, Params p) {
  extern __shared__ float smem[];
  const int ncand = (2 * rx + 1) * cap;
  float* cs = smem;                             // [n_cand][ncand]
  float* jacc = cs + n_cand * ncand;            // [kJ][ncand]
  float* oacc = jacc + Body::kJ * ncand;        // [kOut][cap]

  const int cell = blockIdx.x;
  const int x = cell % cx;
  const int y = (cell / cx) % cy;
  const int z = cell / (cx * cy);
  const int ey = cy + 2 * ry;
  const int ex = cx + 2 * rx;
  const int64_t ext_plane = static_cast<int64_t>(cz + 2 * rz) * ey * ex * cap;
  const int64_t own_plane = static_cast<int64_t>(cz) * cy * cx * cap;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int t = threadIdx.x; t < Body::kOut * cap; t += blockDim.x) oacc[t] = 0.0f;

  // oi = -1 is the home row; then the half-space (dz, dy) offsets.  The
  // skip test is uniform across the block, so the barriers stay matched.
  const int nyo = 2 * ry + 1;
  for (int oi = -1; oi < (2 * rz + 1) * nyo; ++oi) {
    const bool home = oi < 0;
    const int dz = home ? 0 : oi / nyo - rz;
    const int dy = home ? 0 : oi % nyo - ry;
    if (!home && !(dz > 0 || (dz == 0 && dy > 0))) continue;
    // extended cell (z + rz + dz, y + ry + dy, x): the window's first slot
    const int64_t row_base =
        ((static_cast<int64_t>(z + rz + dz) * ey + (y + ry + dy)) * ex + x) * cap;

    __syncthreads();  // the previous offset is done with cs and jacc
    for (int t = threadIdx.x; t < n_cand * ncand; t += blockDim.x) {
      const int f = t / ncand;
      cs[t] = cand[f * ext_plane + row_base + (t - f * ncand)];
    }
    for (int t = threadIdx.x; t < Body::kJ * ncand; t += blockDim.x) jacc[t] = 0.0f;
    __syncthreads();

    const int j0 = home ? rx * cap : 0;  // home: cells left of centre skipped
    for (int i = warp; i < cap; i += kWarps) {
      const int64_t own_slot = static_cast<int64_t>(cell) * cap + i;
      float o[Body::kOwn];
#pragma unroll
      for (int f = 0; f < Body::kOwn; ++f) o[f] = own[f * own_plane + own_slot];
      const float* lrow = lf ? lf + own_slot * (2 * p.zm) : nullptr;
      float acc[Body::kOut];
#pragma unroll
      for (int k = 0; k < Body::kOut; ++k) acc[k] = 0.0f;
      for (int j = j0 + lane; j < ncand; j += 32) {
        if (home && j < (rx + 1) * cap && j - rx * cap <= i) continue;
        float out[Body::kOut], jo[Body::kJ];
        if (!Body::pair(p, o, lrow, cs, ncand, nullptr, 0, j, out, jo))
          continue;
#pragma unroll
        for (int k = 0; k < Body::kOut; ++k) acc[k] += out[k];
#pragma unroll
        for (int k = 0; k < Body::kJ; ++k) atomicAdd(&jacc[k * ncand + j], jo[k]);
      }
#pragma unroll
      for (int k = 0; k < Body::kOut; ++k) {
        float v = acc[k];
        for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
        if (lane == 0) oacc[k * cap + i] += v;
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < Body::kJ * ncand; t += blockDim.x) {
      const float v = jacc[t];
      const int k = t / ncand;
      if (v != 0.0f) atomicAdd(&j_out[k * ext_plane + row_base + (t - k * ncand)], v);
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < Body::kOut * cap; t += blockDim.x) {
    const int k = t / cap;
    own_out[k * own_plane + static_cast<int64_t>(cell) * cap + (t - k * cap)] = oacc[t];
  }
}

template <class Body>
cudaError_t launch(const float* own, const float* cand, float* own_out,
                   float* j_out, int cz, int cy, int cx, int rz, int ry, int rx,
                   int cap, int n_cand, const float* lf, const Params& p,
                   cudaStream_t stream) {
  const int ncells = cz * cy * cx;
  if (ncells == 0 || cap == 0) return cudaSuccess;
  const int ncand = (2 * rx + 1) * cap;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(n_cand + Body::kJ) * ncand +
                       static_cast<size_t>(Body::kOut) * cap);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sweep_kernel<Body>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  sweep_kernel<Body><<<ncells, kThreads, smem, stream>>>(
      own, cand, own_out, j_out, cz, cy, cx, rz, ry, rx, cap, n_cand, lf, p);
  return cudaGetLastError();
}

}  // namespace

// body: 0 = CN, 1 = D3 direct, 2 = CN chain, 3 = Coulomb, 4 = D3 direct +
// Coulomb (separate force channels), 5 = D3 direct + Coulomb (combined).
extern "C" int nv_window_sweep(int body, const float* own, const float* cand,
                               const float* lf, float* own_out, float* j_out,
                               int cz, int cy, int cx, int rz, int ry, int rx,
                               int cap, int n_cand, float cutoff_sq, float a1,
                               float a2, float s6, float s8, float k1, float k3,
                               float alpha, float ccutoff_sq, int zm, int mesh,
                               void* stream) {
  const Params p{cutoff_sq, a1, a2, s6, s8, k1, k3, alpha, ccutoff_sq, zm, mesh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(B) \
  launch<B>(own, cand, own_out, j_out, cz, cy, cx, rz, ry, rx, cap, n_cand, lf, p, st)
  switch (body) {
    case 0: return LAUNCH(CnBody);
    case 1: return LAUNCH(D3DirectBody<false>);
    case 2: return LAUNCH(ChainBody);
    case 3: return LAUNCH(CoulombBody);
    case 4: return LAUNCH(D3CoulombSeparate);
    case 5: return LAUNCH(D3CoulombCombined);
    default: return cudaErrorInvalidValue;
  }
#undef LAUNCH
}

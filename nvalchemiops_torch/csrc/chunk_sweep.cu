// SPDX-License-Identifier: Apache-2.0
//
// Super-chunk half-space pair sweep with zm-wide D3 features (kernel 8).
//
// Replaces: nvalchemiops_tpu/pallas/block_sweep.py:block_sweep (:101, the
// pallas_call at :308), which carries grid_dftd3(engine="block"), the fused
// D3 + Coulomb pass of grid_dftd3_coulomb (grid_d3.py:976-1267) and
// grid_coulomb_energy_forces(engine="block") (grid.py:800-862).
//
// What it computes.  A super-chunk is G consecutive own x-cells of one own
// (z, y) row: M = G * cap own slots.  For each row offset -- the home row
// (0, 0) first, then the half-space (dz, dy) -- the chunk meets one merged
// candidate window of W = (G + 2 * rx) * cap slots: extended x-cells
// [gG, gG + G + 2 rx) of row (z + dz, y + dy), which covers interior x-cells
// gG - rx .. gG + G - 1 + rx.  In the home offset only pairs whose flat
// candidate index exceeds the own index plus rx * cap are kept (cand_flat >
// own_flat + rx * cap, block_sweep.py:191-194): each pair once.  Pairs
// further than rx cells apart in x lie beyond the cutoff and fail the
// distance test, as on the TPU.  Bodies (pair_bodies.cuh): cn, d3_direct,
// d3_direct_coulomb (separate force channels), chain, coulomb.  The D3
// bodies take the JAX engine's inputs: own lf rows [.., 2 * zm] and the
// candidates' zm-wide rows (rf | rfdc).
//
// What bounds it on the H100.  The pair bodies are FP32-ALU and SFU bound;
// the three C6 contractions are f32 dot products of length zm on the CUDA
// cores (no TF32), zmax1 times kernel 1's.  The TPU kernel sized G for
// 16 MB of VMEM; here the chunk lives in shared memory: own scalars, own lf
// rows, candidate scalars, candidate zm-wide rows and the j sums, with the
// rows at an odd stride so lane-strided reads do not collide in the banks.
// The wrapper picks G (kernels/chunk_sweep.py:super_chunk_cells) so that
// this fits the 227 KB a block may use.  Design: one block per (own row,
// offset, chunk); one warp per own slot, lanes stride the candidates; row
// sums in registers (warp shuffle, then one global atomic per own slot and
// output, since the offsets run in different blocks), column sums through
// shared-memory atomics, then one global atomic per candidate slot and
// output into [n_j, ez, ey, ex, cap].
//
// Interface: C, for ctypes.  Pointers are device pointers into contiguous
// float32 tensors allocated by the Python wrapper; own_out and j_out must be
// zero on entry.  Returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_bodies.cuh"

namespace {

using namespace pair_bodies;

using D3CoulombSeparate = D3CoulombBody<true, false>;

template <class Body>
__host__ __device__ inline size_t chunk_smem_floats(int g, int cap, int rx,
                                                    int nf) {
  const size_t m = static_cast<size_t>(g) * cap;
  const size_t w = static_cast<size_t>(g + 2 * rx) * cap;
  const size_t fs = feat_stride(nf);
  return Body::kOwn * m + m * fs + Body::kCand * w + w * fs + Body::kJ * w;
}

template <class Body>
__global__ void __launch_bounds__(kWideThreads)
    chunk_kernel(const float* __restrict__ own, const float* __restrict__ cand,
                 const float* __restrict__ lf, const float* __restrict__ cfeat,
                 float* __restrict__ own_out, float* __restrict__ j_out,
                 int cz, int cy, int cx, int rz, int ry, int rx, int cap,
                 int g_cells, int nf, int n_off, Params p) {
  extern __shared__ float smem[];
  const int m = g_cells * cap;
  const int w = (g_cells + 2 * rx) * cap;
  const int fstride = feat_stride(nf);
  const int ey = cy + 2 * ry;
  const int ex = cx + 2 * rx;
  float* os = smem;                            // [kOwn][m]
  float* ls = os + Body::kOwn * m;             // [m][fstride]
  float* cs = ls + m * fstride;                // [kCand][w]
  float* cf = cs + Body::kCand * w;            // [w][fstride]
  float* jacc = cf + w * fstride;              // [kJ][w]

  const int n_chunks = cx / g_cells;
  const int chunk = blockIdx.x % n_chunks;
  const int oi = (blockIdx.x / n_chunks) % n_off;
  const int row = blockIdx.x / (n_chunks * n_off);
  const int y = row % cy;
  const int z = row / cy;
  const bool home = oi == 0;
  int dz = 0, dy = 0;
  if (!home) half_offset(oi - 1, ry, dz, dy);
  const int64_t ext_plane = static_cast<int64_t>(cz + 2 * rz) * ey * ex * cap;
  const int64_t own_plane = static_cast<int64_t>(cz) * cy * cx * cap;
  const int64_t own0 =
      ((static_cast<int64_t>(z) * cy + y) * cx + chunk * g_cells) * cap;
  const int64_t cand0 =
      ((static_cast<int64_t>(z + rz + dz) * ey + (y + ry + dy)) * ex +
       chunk * g_cells) * cap;
  const int warp = threadIdx.x >> 5;

  for (int t = threadIdx.x; t < Body::kOwn * m; t += blockDim.x) {
    const int f = t / m;
    os[t] = own[f * own_plane + own0 + (t - f * m)];
  }
  for (int t = threadIdx.x; t < Body::kCand * w; t += blockDim.x) {
    const int f = t / w;
    cs[t] = cand[f * ext_plane + cand0 + (t - f * w)];
  }
  if (Body::kWide) {
    for (int t = threadIdx.x; t < m * nf; t += blockDim.x) {
      const int r = t / nf;
      ls[r * fstride + (t - r * nf)] = lf[(own0 + r) * nf + (t - r * nf)];
    }
    for (int t = threadIdx.x; t < w * nf; t += blockDim.x) {
      const int r = t / nf;
      cf[r * fstride + (t - r * nf)] = cfeat[(cand0 + r) * nf + (t - r * nf)];
    }
  }
  for (int t = threadIdx.x; t < Body::kJ * w; t += blockDim.x) jacc[t] = 0.0f;
  __syncthreads();

  const int tri = rx * cap;  // home: keep cand_flat > own_flat + rx * cap
  for (int i = warp; i < m; i += kWideWarps) {
    float o[Body::kOwn];
#pragma unroll
    for (int f = 0; f < Body::kOwn; ++f) o[f] = os[f * m + i];
    warp_own_slot<Body>(p, o, ls + i * fstride, cs, w, cf, fstride,
                        home ? i + tri + 1 : 0, jacc, w, own_out, own_plane,
                        own0 + i);
  }
  flush_j<Body::kJ>(jacc, w, j_out, ext_plane, cand0);
}

template <class Body>
cudaError_t launch(const float* own, const float* cand, const float* lf,
                   const float* cfeat, float* own_out, float* j_out, int cz,
                   int cy, int cx, int rz, int ry, int rx, int cap, int g,
                   int nf, const Params& p, cudaStream_t stream) {
  if (g <= 0 || cx % g) return cudaErrorInvalidValue;
  const int n_off = 1 + ry + rz * (2 * ry + 1);
  const int blocks = cz * cy * n_off * (cx / g);
  if (blocks == 0 || cap == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * chunk_smem_floats<Body>(g, cap, rx, nf);
  const cudaError_t e = allow_smem(chunk_kernel<Body>, smem);
  if (e != cudaSuccess) return e;
  chunk_kernel<Body><<<blocks, kWideThreads, smem, stream>>>(
      own, cand, lf, cfeat, own_out, j_out, cz, cy, cx, rz, ry, rx, cap, g,
      nf, n_off, p);
  return cudaGetLastError();
}

}  // namespace

// body: 0 = CN, 1 = D3 direct (zm-wide), 2 = CN chain, 3 = Coulomb, 4 = D3
// direct + Coulomb (separate force channels).  nf = 2 * zm for the D3
// bodies (lf and cfeat rows), 0 otherwise; g = G, a divisor of cx.
extern "C" int nv_chunk_sweep(int body, const float* own, const float* cand,
                              const float* lf, const float* cfeat,
                              float* own_out, float* j_out, int cz, int cy,
                              int cx, int rz, int ry, int rx, int cap, int g,
                              int nf, float cutoff_sq, float a1, float a2,
                              float s6, float s8, float k1, float k3,
                              float alpha, float ccutoff_sq, void* stream) {
  const Params p{cutoff_sq, a1, a2, s6, s8, k1, k3, alpha, ccutoff_sq, nf / 2, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(B)                                                            \
  launch<B>(own, cand, lf, cfeat, own_out, j_out, cz, cy, cx, rz, ry, rx, cap, \
            g, nf, p, st)
  switch (body) {
    case 0: return LAUNCH(CnBody);
    case 1: return LAUNCH(D3DirectBody<true>);
    case 2: return LAUNCH(ChainBody);
    case 3: return LAUNCH(CoulombBody);
    case 4: return LAUNCH(D3CoulombSeparate);
    default: return cudaErrorInvalidValue;
  }
#undef LAUNCH
}

// SPDX-License-Identifier: Apache-2.0
//
// Per-row half-space pair sweep with zm-wide D3 features (kernel 7).
//
// Replaces: nvalchemiops_tpu/pallas/row_sweep.py:row_sweep (:89; the home
// pallas_call at :276, the offsets at :293), which carries the three passes
// of grid_dftd3(engine="pallas") (grid_d3.py:778-961).
//
// What it computes.  The pair-once enumeration of the halo grid, organised
// by own ROW: for each own (z, y) row and each row offset -- the home row
// (dz, dy) = (0, 0) and every half-space (dz, dy) -- the kernel walks the
// row's cx own cells; own cell x meets the candidate window of 2*rx+1
// x-cells [x - rx, x + rx] of row (z + dz, y + dy), or in the home row the
// rx+1 cells [x, x + rx] with the own cell keeping only slot pairs i < j.
// Bodies (pair_bodies.cuh): cn, d3_direct, chain.  The D3 direct body takes
// the JAX engine's inputs: own left features lf [.., cap, 2*zm] (l0 | l1c)
// and the candidates' zm-wide rows [.., cap, 2*zm] (rf | rfdc), so each
// pair contracts three f32 dots of length zm (zm = zmax1 * mesh), where
// kernel 1 contracts three of length mesh.
//
// What bounds it on the H100.  Like kernel 1, the pair bodies are FP32-ALU
// and SFU bound; the zm-wide dots multiply the D3 direct body's arithmetic
// by zmax1 (3 for compacted CsCl, 17 for zmax-16 tables).  Device-memory
// traffic: each candidate window is read once per own cell and offset.
// Design: one block per (own row, offset) -- home and the half-space
// offsets in ONE launch, block offset index 0 being the home row -- looping
// over x.  Each x stages its candidate window (scalars and zm-wide rows,
// the rows at an odd stride so lane-strided reads do not collide in the
// shared-memory banks) in shared memory; one warp per own slot, lanes stride
// the candidates, own lf rows are read through the read-only cache (a warp
// reads one row: broadcast).  The j-side sums of the whole extended row
// accumulate in shared memory and go out once per block with one global
// atomic per slot and output, straight into [n_j, ez, ey, ex, cap]: the
// TPU's per-offset j buffer (a workaround for having no scatter-add) is not
// needed.  Own-side sums are warp shuffles plus one global atomic per own
// slot, output and block, since the offsets of a row run in different
// blocks.
//
// Interface: C, for ctypes.  Pointers are device pointers into contiguous
// float32 tensors allocated by the Python wrapper; own_out and j_out must be
// zero on entry.  Returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_bodies.cuh"

namespace {

using namespace pair_bodies;

template <class Body>
__global__ void __launch_bounds__(kWideThreads)
    row_kernel(const float* __restrict__ own, const float* __restrict__ cand,
               const float* __restrict__ lf, const float* __restrict__ cfeat,
               float* __restrict__ own_out, float* __restrict__ j_out, int cz,
               int cy, int cx, int rz, int ry, int rx, int cap, int nf,
               int n_off, Params p) {
  extern __shared__ float smem[];
  const int wmax = (2 * rx + 1) * cap;
  const int fstride = feat_stride(nf);
  const int ey = cy + 2 * ry;
  const int ex = cx + 2 * rx;
  const int lrow_ext = ex * cap;
  float* cs = smem;                            // [kCand][wmax]
  float* cf = cs + Body::kCand * wmax;         // [wmax][fstride]
  float* jrow = cf + wmax * fstride;           // [kJ][ex * cap]

  const int oi = blockIdx.x % n_off;
  const int row = blockIdx.x / n_off;
  const int y = row % cy;
  const int z = row / cy;
  const bool home = oi == 0;
  int dz = 0, dy = 0;
  if (!home) half_offset(oi - 1, ry, dz, dy);
  const int64_t ext_plane = static_cast<int64_t>(cz + 2 * rz) * ey * ex * cap;
  const int64_t own_plane = static_cast<int64_t>(cz) * cy * cx * cap;
  // first slot of extended row (z + rz + dz, y + ry + dy)
  const int64_t ext_row =
      (static_cast<int64_t>(z + rz + dz) * ey + (y + ry + dy)) * lrow_ext;
  const int warp = threadIdx.x >> 5;

  for (int t = threadIdx.x; t < Body::kJ * lrow_ext; t += blockDim.x)
    jrow[t] = 0.0f;

  const int w = home ? (rx + 1) * cap : wmax;
  for (int x = 0; x < cx; ++x) {
    // window's first extended cell: the own cell itself (home) or x - rx
    const int s0 = (home ? x + rx : x) * cap;
    __syncthreads();  // the previous x is done with cs and cf
    for (int t = threadIdx.x; t < Body::kCand * w; t += blockDim.x) {
      const int f = t / w;
      const int jj = t - f * w;
      cs[f * w + jj] = cand[f * ext_plane + ext_row + s0 + jj];
    }
    if (Body::kWide) {
      for (int t = threadIdx.x; t < w * nf; t += blockDim.x) {
        const int jj = t / nf;
        cf[jj * fstride + (t - jj * nf)] =
            cfeat[(ext_row + s0 + jj) * nf + (t - jj * nf)];
      }
    }
    __syncthreads();

    const int64_t cell = (static_cast<int64_t>(z) * cy + y) * cx + x;
    for (int i = warp; i < cap; i += kWideWarps) {
      const int64_t own_slot = cell * cap + i;
      float o[Body::kOwn];
#pragma unroll
      for (int f = 0; f < Body::kOwn; ++f) o[f] = own[f * own_plane + own_slot];
      // home: the own cell keeps slot pairs i < j
      warp_own_slot<Body>(p, o, Body::kWide ? lf + own_slot * nf : nullptr, cs,
                          w, cf, fstride, home ? i + 1 : 0, jrow + s0,
                          lrow_ext, own_out, own_plane, own_slot);
    }
  }
  flush_j<Body::kJ>(jrow, lrow_ext, j_out, ext_plane, ext_row);
}

template <class Body>
cudaError_t launch(const float* own, const float* cand, const float* lf,
                   const float* cfeat, float* own_out, float* j_out, int cz,
                   int cy, int cx, int rz, int ry, int rx, int cap, int nf,
                   const Params& p, cudaStream_t stream) {
  const int n_off = 1 + ry + rz * (2 * ry + 1);
  const int blocks = cz * cy * n_off;
  if (blocks == 0 || cap == 0) return cudaSuccess;
  const size_t wmax = static_cast<size_t>(2 * rx + 1) * cap;
  const size_t smem =
      sizeof(float) * (Body::kCand * wmax + wmax * feat_stride(nf) +
                       static_cast<size_t>(Body::kJ) * (cx + 2 * rx) * cap);
  const cudaError_t e = allow_smem(row_kernel<Body>, smem);
  if (e != cudaSuccess) return e;
  row_kernel<Body><<<blocks, kWideThreads, smem, stream>>>(
      own, cand, lf, cfeat, own_out, j_out, cz, cy, cx, rz, ry, rx, cap, nf,
      n_off, p);
  return cudaGetLastError();
}

}  // namespace

// body: 0 = CN, 1 = D3 direct (zm-wide), 2 = CN chain.  nf = 2 * zm for the
// D3 direct body (lf and cfeat rows), 0 otherwise.
extern "C" int nv_row_sweep(int body, const float* own, const float* cand,
                            const float* lf, const float* cfeat,
                            float* own_out, float* j_out, int cz, int cy,
                            int cx, int rz, int ry, int rx, int cap, int nf,
                            float cutoff_sq, float a1, float a2, float s6,
                            float s8, float k1, float k3, void* stream) {
  const Params p{cutoff_sq, a1, a2, s6, s8, k1, k3, 0.0f, 0.0f, nf / 2, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(B) \
  launch<B>(own, cand, lf, cfeat, own_out, j_out, cz, cy, cx, rz, ry, rx, cap, nf, p, st)
  switch (body) {
    case 0: return LAUNCH(CnBody);
    case 1: return LAUNCH(D3DirectBody<true>);
    case 2: return LAUNCH(ChainBody);
    default: return cudaErrorInvalidValue;
  }
#undef LAUNCH
}

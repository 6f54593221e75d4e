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
// (dz, dy) = (0, 0) and every half-space (dz, dy) -- own cell x of the row
// meets the candidate window of 2*rx+1 x-cells [x - rx, x + rx] of row
// (z + dz, y + dy), or in the home row the rx+1 cells [x, x + rx] with the
// own cell keeping only slot pairs i < j.  Bodies (pair_bodies.cuh): cn,
// d3_direct, chain.  The D3 direct body takes the JAX engine's inputs: own
// left features lf [.., cap, 2*zm] (l0 | l1c) and the candidates' zm-wide
// rows [.., cap, 2*zm] (rf | rfdc), so each pair contracts three f32 dots
// of length zm (zm = zmax1 * mesh), where kernel 1 contracts three of
// length mesh.
//
// What bounds it on the H100.  Like kernel 1, the pair bodies are FP32-ALU
// and SFU bound; the zm-wide dots multiply the D3 direct body's arithmetic
// by zmax1 (3 for compacted CsCl, 17 for zmax-16 tables).  Only about one
// candidate in ten is a pair inside the cutoff, and a third of the grid's
// slots are empty: a warp whose lanes stride the candidates and run the
// body in place (this kernel's first design) spends nearly every warp step
// on the body at a few useful lanes, and restaging each own cell's window
// carried every zm-wide candidate row into shared memory 2*rx+1 times.
//
// Design: one block per (own row, offset) -- home and the half-space
// offsets in ONE launch, block offset index 0 being the home row; 32 warps
// for the zm-wide body, 16 for the others (kRowWarps).  The
// block stages the own row's scalars and lf rows and the whole extended
// candidate row's scalars and zm-wide rows once, the rows at an odd stride
// so lane-strided reads do not collide in the banks; where that exceeds
// the 227 KB a block may use (zmax-16 tables), it stages groups of G
// consecutive own x-cells with their merged window, one after another (the
// wrapper picks G: kernels/row_sweep.py:row_group_cells, with the budget
// row_smem_bytes written both there and here).  The sweep of a staged
// group is kernel 8's (pair_bodies.cuh: sweep_chunk): distance test first
// on the 2*rx+1 x-cells around each own slot, 32 candidates at a time; one
// warp queue across all of a warp's own slots; the bodies on 32 queued
// pairs at a time; own-side sums per slot by a segmented warp reduction in
// f64 into shared sums.  A parked own slot (|px| >= DISPLACE / 2: empty
// slots and padding atoms) is skipped with one warp-uniform compare where
// the wrapper has shown that it meets no candidate in reach.  The own sums
// of a group go out once with one global atomic per slot and output, since
// the offsets of a row run in different blocks; the j-side sums of the
// whole extended row stay in shared memory across the groups and go out
// once a block straight into [n_j, ez, ey, ex, cap]: the TPU's per-offset j
// buffer (a workaround for having no scatter-add) is not needed.
//
// Interface: C, for ctypes.  Pointers are device pointers into contiguous
// float32 tensors allocated by the Python wrapper; own_out and j_out must be
// zero on entry.  Returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_bodies.cuh"

namespace {

using namespace pair_bodies;

// Warps a block: 32 for the zm-wide body, whose staged row fills the SM's
// shared memory, so that one block keeps enough warps in flight (PERF.md,
// kernel 7: the D3 direct body read 0.980 ms at 16 warps, 0.693 at 32); 16
// for the others, several blocks an SM, which read faster for them.
template <class Body>
constexpr int kRowWarps = Body::kWide ? 32 : 16;

// Shared memory of one block: the j sums of the extended row, a staged
// group of g own cells (own scalars and lf rows, candidate scalars and
// zm-wide rows of its merged window), its own sums and the warps' queues.
template <class Body>
__host__ __device__ inline size_t row_smem_bytes(int g, int cx, int cap,
                                                 int rx, int nf) {
  const size_t m = static_cast<size_t>(g) * cap;
  const size_t w = static_cast<size_t>(g + 2 * rx) * cap;
  const size_t fs = feat_stride(nf);
  const size_t row = static_cast<size_t>(cx + 2 * rx) * cap;
  return sizeof(float) * (Body::kJ * row + Body::kOwn * m + m * fs +
                          Body::kCand * w + w * fs + Body::kOut * m) +
         sizeof(int) * kRowWarps<Body> * kQueue;
}

template <class Body>
__global__ void __launch_bounds__(32 * kRowWarps<Body>)
    row_kernel(const float* __restrict__ own, const float* __restrict__ cand,
               const float* __restrict__ lf, const float* __restrict__ cfeat,
               float* __restrict__ own_out, float* __restrict__ j_out, int cz,
               int cy, int cx, int rz, int ry, int rx, int cap, int g_cells,
               int nf, int n_off, float parked, Params p) {
  extern __shared__ float smem[];
  const int mmax = g_cells * cap;
  const int wmax = (g_cells + 2 * rx) * cap;
  const int fstride = feat_stride(nf);
  const int ey = cy + 2 * ry;
  const int ex = cx + 2 * rx;
  const int lrow_ext = ex * cap;
  float* jacc = smem;                          // [kJ][ex * cap]
  float* os = jacc + Body::kJ * lrow_ext;      // [kOwn][m]
  float* ls = os + Body::kOwn * mmax;          // [m][fstride]
  float* cs = ls + mmax * fstride;             // [kCand][w]
  float* cf = cs + Body::kCand * wmax;         // [w][fstride]
  float* oacc = cf + wmax * fstride;           // [kOut][m]
  int* queues = reinterpret_cast<int*>(oacc + Body::kOut * mmax);

  const int oi = blockIdx.x % n_off;
  const int row = blockIdx.x / n_off;
  const int y = row % cy;
  const int z = row / cy;
  const bool home = oi == 0;
  int dz = 0, dy = 0;
  if (!home) half_offset(oi - 1, ry, dz, dy);
  const int64_t ext_plane = static_cast<int64_t>(cz + 2 * rz) * ey * ex * cap;
  const int64_t own_plane = static_cast<int64_t>(cz) * cy * cx * cap;
  const int64_t own_row = (static_cast<int64_t>(z) * cy + y) * cx * cap;
  // first slot of extended row (z + rz + dz, y + ry + dy)
  const int64_t ext_row =
      (static_cast<int64_t>(z + rz + dz) * ey + (y + ry + dy)) * lrow_ext;
  int* qbuf = queues + (threadIdx.x >> 5) * kQueue;

  for (int t = threadIdx.x; t < Body::kJ * lrow_ext; t += blockDim.x)
    jacc[t] = 0.0f;
  for (int g0 = 0; g0 < cx; g0 += g_cells) {
    const int gn = min(g_cells, cx - g0);
    const int m = gn * cap;
    const int w = (gn + 2 * rx) * cap;
    const int64_t own0 = own_row + static_cast<int64_t>(g0) * cap;
    const int64_t cand0 = ext_row + static_cast<int64_t>(g0) * cap;
    __syncthreads();  // the previous group is done with the staged arrays
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
        cf[r * fstride + (t - r * nf)] =
            cfeat[(cand0 + r) * nf + (t - r * nf)];
      }
    }
    for (int t = threadIdx.x; t < Body::kOut * m; t += blockDim.x)
      oacc[t] = 0.0f;
    __syncthreads();

    // the window starts at extended x-cell g0 (own cell g0 - rx), so the
    // group's j sums are jacc[k][g0 * cap + c]
    sweep_chunk<Body, kRowWarps<Body>, true>(p, os, m, ls, cs, w, cf,
                                             fstride, cap, rx, home, parked,
                                             qbuf, oacc, jacc + g0 * cap,
                                             lrow_ext);
    __syncthreads();
    for (int t = threadIdx.x; t < Body::kOut * m; t += blockDim.x) {
      const float v = oacc[t];
      const int k = t / m;
      if (v != 0.0f)
        atomicAdd(&own_out[k * own_plane + own0 + (t - k * m)], v);
    }
  }
  flush_j<Body::kJ>(jacc, lrow_ext, j_out, ext_plane, ext_row);
}

template <class Body>
cudaError_t launch(const float* own, const float* cand, const float* lf,
                   const float* cfeat, float* own_out, float* j_out, int cz,
                   int cy, int cx, int rz, int ry, int rx, int cap, int g,
                   int nf, float parked, const Params& p,
                   cudaStream_t stream) {
  // queue entries pack (own index << 16 | candidate index)
  if (g <= 0 || g > cx || (g + 2 * rx) * cap > 0xffff)
    return cudaErrorInvalidValue;
  const int n_off = 1 + ry + rz * (2 * ry + 1);
  const int blocks = cz * cy * n_off;
  if (blocks == 0 || cap == 0) return cudaSuccess;
  const size_t smem = row_smem_bytes<Body>(g, cx, cap, rx, nf);
  const cudaError_t e = allow_smem(row_kernel<Body>, smem);
  if (e != cudaSuccess) return e;
  row_kernel<Body><<<blocks, 32 * kRowWarps<Body>, smem, stream>>>(
      own, cand, lf, cfeat, own_out, j_out, cz, cy, cx, rz, ry, rx, cap, g,
      nf, n_off, parked, p);
  return cudaGetLastError();
}

}  // namespace

// body: 0 = CN, 1 = D3 direct (zm-wide), 2 = CN chain.  nf = 2 * zm for the
// D3 direct body (lf and cfeat rows), 0 otherwise; g = own x-cells staged
// at once (cx: the whole row); own slots with |px| >= parked are skipped.
extern "C" int nv_row_sweep(int body, const float* own, const float* cand,
                            const float* lf, const float* cfeat,
                            float* own_out, float* j_out, int cz, int cy,
                            int cx, int rz, int ry, int rx, int cap, int g,
                            int nf, float cutoff_sq, float a1, float a2,
                            float s6, float s8, float k1, float k3,
                            float parked, void* stream) {
  const Params p{cutoff_sq, a1, a2, s6, s8, k1, k3, 0.0f, 0.0f, nf / 2, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(B)                                                            \
  launch<B>(own, cand, lf, cfeat, own_out, j_out, cz, cy, cx, rz, ry, rx, cap, \
            g, nf, parked, p, st)
  switch (body) {
    case 0: return LAUNCH(CnBody);
    case 1: return LAUNCH(D3DirectBody<true>);
    case 2: return LAUNCH(ChainBody);
    default: return cudaErrorInvalidValue;
  }
#undef LAUNCH
}

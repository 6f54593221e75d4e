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
// row_smem_bytes written both there and here).  Where one own cell and its
// window exceed it (a cell of thousands of slots, or zm-wide rows at a
// cap of ~100), G is 1 and the block stages slices (row_slices: m_s own
// slots over blocks along gridDim.z, w_s candidates one slice after
// another, each slice's j sums flushed before the next); the own sums go
// out with the same global atomics as the offsets' do.  The sweep of a staged
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
// Batches.  One launch sweeps the n_sys systems of a batched grid: blockIdx.y
// is the system, each system's planes follow the last system's (own, cand,
// lf, cfeat and the outputs); a single grid runs as n_sys = 1.
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

// Shared memory of one block: the j sums (of the whole extended row, or
// where the block stages slices, of one candidate slice), m_s staged own
// slots (scalars, lf rows, sums), w_s staged candidates (scalars, zm-wide
// rows) and the warps' queues.
template <class Body>
__host__ __device__ inline size_t row_smem_bytes(int m_s, int w_s, int cx,
                                                 int cap, int rx, int nf,
                                                 bool row_j) {
  const size_t fs = feat_stride(nf);
  const size_t row = static_cast<size_t>(cx + 2 * rx) * cap;
  return sizeof(float) * (Body::kJ * (row_j ? row : w_s) +
                          (Body::kOwn + fs + Body::kOut) * m_s +
                          (Body::kCand + fs) * w_s) +
         sizeof(int) * kRowWarps<Body> * kQueue;
}

template <class Body>
__global__ void __launch_bounds__(32 * kRowWarps<Body>)
    row_kernel(const float* __restrict__ own, const float* __restrict__ cand,
               const float* __restrict__ lf, const float* __restrict__ cfeat,
               float* __restrict__ own_out, float* __restrict__ j_out, int cz,
               int cy, int cx, int rz, int ry, int rx, int cap, int g_cells,
               int nf, int n_off, int m_s, int w_s, float parked, Params p) {
  extern __shared__ float smem[];
  const int fstride = feat_stride(nf);
  const int ey = cy + 2 * ry;
  const int ex = cx + 2 * rx;
  const int lrow_ext = ex * cap;
  // the whole group staged at once: the j sums of the extended row stay in
  // shared memory across the groups and go out once
  const bool row_j = m_s >= g_cells * cap && w_s >= (g_cells + 2 * rx) * cap;
  float* jacc = smem;                                    // [kJ][row or w_s]
  float* os = jacc + Body::kJ * (row_j ? lrow_ext : w_s);  // [kOwn][m_s]
  float* ls = os + Body::kOwn * m_s;           // [m_s][fstride]
  float* cs = ls + m_s * fstride;              // [kCand][w_s]
  float* cf = cs + Body::kCand * w_s;          // [w_s][fstride]
  float* oacc = cf + w_s * fstride;            // [kOut][m_s]
  int* queues = reinterpret_cast<int*>(oacc + Body::kOut * m_s);

  const int oi = blockIdx.x % n_off;
  const int row = blockIdx.x / n_off;
  const int y = row % cy;
  const int z = row / cy;
  const bool home = oi == 0;
  int dz = 0, dy = 0;
  if (!home) half_offset(oi - 1, ry, dz, dy);
  const int64_t ext_plane = static_cast<int64_t>(cz + 2 * rz) * ey * ex * cap;
  const int64_t own_plane = static_cast<int64_t>(cz) * cy * cx * cap;
  // this block's system: its planes follow those of the systems before it
  const int64_t sys = blockIdx.y;
  own += sys * Body::kOwn * own_plane;
  cand += sys * Body::kCand * ext_plane;
  if (Body::kWide) {
    lf += sys * own_plane * nf;
    cfeat += sys * ext_plane * nf;
  }
  own_out += sys * Body::kOut * own_plane;
  j_out += sys * Body::kJ * ext_plane;
  const int64_t own_row = (static_cast<int64_t>(z) * cy + y) * cx * cap;
  // first slot of extended row (z + rz + dz, y + ry + dy)
  const int64_t ext_row =
      (static_cast<int64_t>(z + rz + dz) * ey + (y + ry + dy)) * lrow_ext;
  int* qbuf = queues + (threadIdx.x >> 5) * kQueue;
  // blockIdx.z: this block's slice of each group's own slots
  const int i0 = blockIdx.z * m_s;

  if (row_j)
    for (int t = threadIdx.x; t < Body::kJ * lrow_ext; t += blockDim.x)
      jacc[t] = 0.0f;
  for (int g0 = 0; g0 < cx; g0 += g_cells) {
    const int gn = min(g_cells, cx - g0);
    if (i0 >= gn * cap) break;
    const int m = min(m_s, gn * cap - i0);
    const int w_all = (gn + 2 * rx) * cap;
    const int64_t own0 = own_row + static_cast<int64_t>(g0) * cap + i0;
    // the window starts at extended x-cell g0 (own cell g0 - rx)
    const int64_t cand0 = ext_row + static_cast<int64_t>(g0) * cap;
    __syncthreads();  // the previous group is done with the staged arrays
    stage_own<Body>(own, lf, own_plane, own0, m, nf, fstride, os, ls, oacc);
    for (int c0 = 0; c0 < w_all; c0 += w_s) {
      const int w = min(w_s, w_all - c0);
      if (c0 > 0) __syncthreads();  // the previous slice is flushed
      stage_cand<Body>(cand, cfeat, ext_plane, cand0 + c0, w, nf, fstride, cs,
                       cf);
      if (!row_j)
        for (int t = threadIdx.x; t < Body::kJ * w; t += blockDim.x)
          jacc[t] = 0.0f;
      __syncthreads();
      // row_j: the group's j sums are jacc[k][g0 * cap + c]
      sweep_chunk<Body, kRowWarps<Body>, true>(
          p, os, m, i0, ls, cs, w, c0, cf, fstride, cap, rx, home, parked,
          qbuf, oacc, row_j ? jacc + g0 * cap : jacc,
          row_j ? lrow_ext : w);
      if (!row_j) flush_j<Body::kJ>(jacc, w, j_out, ext_plane, cand0 + c0);
    }
    // the offsets of a row run in different blocks
    flush_own<Body::kOut>(oacc, m, own_out, own_plane, own0);
  }
  if (row_j) flush_j<Body::kJ>(jacc, lrow_ext, j_out, ext_plane, ext_row);
}

template <class Body>
cudaError_t launch(const float* own, const float* cand, const float* lf,
                   const float* cfeat, float* own_out, float* j_out, int cz,
                   int cy, int cx, int rz, int ry, int rx, int cap, int g,
                   int nf, int n_sys, int m_s, int w_s, float parked,
                   const Params& p, cudaStream_t stream) {
  if (g <= 0 || g > cx) return cudaErrorInvalidValue;
  const int n_off = 1 + ry + rz * (2 * ry + 1);
  const int blocks = cz * cy * n_off;
  if (blocks == 0 || cap == 0 || n_sys == 0) return cudaSuccess;
  // the staging plan (kernels/row_sweep.py:row_slices): at most a group's
  // own slots and its window's candidates
  m_s = min(m_s, g * cap);
  w_s = min(w_s, (g + 2 * rx) * cap);
  const int n_split = (g * cap + m_s - 1) / m_s;
  if (!plan_ok(n_sys, m_s, w_s, n_split)) return cudaErrorInvalidValue;
  const bool row_j = m_s == g * cap && w_s == (g + 2 * rx) * cap;
  const size_t smem = row_smem_bytes<Body>(m_s, w_s, cx, cap, rx, nf, row_j);
  const cudaError_t e = allow_smem(row_kernel<Body>, smem);
  if (e != cudaSuccess) return e;
  row_kernel<Body><<<dim3(blocks, n_sys, n_split), 32 * kRowWarps<Body>, smem,
                     stream>>>(own, cand, lf, cfeat, own_out, j_out, cz, cy,
                               cx, rz, ry, rx, cap, g, nf, n_off, m_s, w_s,
                               parked, p);
  return cudaGetLastError();
}

}  // namespace

// body: 0 = CN, 1 = D3 direct (zm-wide), 2 = CN chain.  nf = 2 * zm for the
// D3 direct body (lf and cfeat rows), 0 otherwise; g = own x-cells staged
// at once (cx: the whole row); n_sys systems of a batched grid (1 for one
// grid); m_s own slots and w_s candidates a block stages at once (the
// whole group and window: G * cap and (G + 2 rx) * cap); own slots with
// |px| >= parked are skipped.
extern "C" int nv_row_sweep(int body, const float* own, const float* cand,
                            const float* lf, const float* cfeat,
                            float* own_out, float* j_out, int cz, int cy,
                            int cx, int rz, int ry, int rx, int cap, int g,
                            int nf, int n_sys, int m_s, int w_s,
                            float cutoff_sq, float a1, float a2, float s6,
                            float s8, float k1, float k3, float parked,
                            void* stream) {
  const Params p{cutoff_sq, a1, a2, s6, s8, k1, k3, 0.0f, 0.0f, nf / 2, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(B)                                                            \
  launch<B>(own, cand, lf, cfeat, own_out, j_out, cz, cy, cx, rz, ry, rx, cap, \
            g, nf, n_sys, m_s, w_s, parked, p, st)
  switch (body) {
    case 0: return LAUNCH(CnBody);
    case 1: return LAUNCH(D3DirectBody<true>);
    case 2: return LAUNCH(ChainBody);
    default: return cudaErrorInvalidValue;
  }
#undef LAUNCH
}

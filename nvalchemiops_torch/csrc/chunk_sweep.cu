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
// cores (no TF32), zmax1 times kernel 1's.  Only about one candidate in ten
// is a pair inside the cutoff (PERF.md), so a warp whose lanes stride the
// candidates and run the body in place (this kernel's first design, and
// kernel 7's until it took up the same sweep) spends nearly every warp step
// on the body at a few useful lanes.  The TPU kernel sized G for 16 MB of
// VMEM; here the chunk lives in shared memory: own scalars, own lf rows,
// candidate scalars, candidate zm-wide rows, the own and j sums and the
// warps' queues, with the rows at an odd stride so lane-strided reads do
// not collide in the banks.  The wrapper picks G
// (kernels/chunk_sweep.py:super_chunk_cells) so that this fits the 227 KB
// a block may use; where one own cell and its window do not fit, G is 1 and
// the block stages slices (chunk_slices: m_s own slots over blocks along
// gridDim.z, w_s candidates one slice after another, each slice's j sums
// flushed before the next); a plan without slices runs an instantiation
// whose offsets fold to 0 (kSliced false).
//
// Design: distance test first (kernel 1's recipe, window_sweep.cu), in the
// steps kernel 7 shares (pair_bodies.cuh: sweep_chunk, run_queued).  One
// block per (own row, offset, chunk); one warp per own slot.  The warp
// tests the slot against 32 staged candidates at a time -- r^2 rounded as
// the plain version rounds it, against Body::reach_sq (the larger of the
// two cutoffs for the fused body); parked (empty or padding) slots lie far
// beyond it -- and queues the hits (WarpQueue: ballot and popcount prefix
// into shared memory); whenever 32 wait, each lane runs the body on one of
// them.  No C6 dot, exp, term or atomic is spent on a pair outside the
// reach.  Only the 2 rx + 1 x-cells around the own slot's cell are tested
// (merged-window cells gl .. gl + 2 rx for own cell gl of the chunk): the
// others lie beyond the cutoff, as in kernel 1.  An own slot meets only
// ~10 pairs an offset, so a queue drained at each slot's end would run the
// body at a third of the lanes: the warp's slots all feed one queue, an
// entry names its own slot.  The j-side terms go to shared-memory sums
// (atomics); the own-side terms are summed per slot over the pop's lanes
// (a segmented warp reduction, in f64) and then added to shared-memory
// sums.  Both are flushed once a block with one global atomic per slot
// and output (own into [n_out, cz, cy, cx, cap], j into [n_j, ez, ey, ex,
// cap]).
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

using D3CoulombSeparate = D3CoulombBody<true, false>;

// Shared memory of one block staging m_s own slots and w_s candidates: own
// scalars, rows and sums, candidate scalars, rows and j sums (floats) and
// the warps' queues (kQueue ints a warp).
template <class Body>
__host__ __device__ inline size_t chunk_smem_bytes(int m_s, int w_s, int nf) {
  const size_t fs = feat_stride(nf);
  return sizeof(float) * ((Body::kOwn + fs + Body::kOut) * m_s +
                          (Body::kCand + fs + Body::kJ) * w_s) +
         sizeof(int) * kWideWarps * kQueue;
}

// kSliced: a plan that stages the chunk or its window in slices.  Without
// it the own and candidate offsets fold to 0 and the window is one slice.
template <class Body, bool kSliced>
__global__ void __launch_bounds__(kWideThreads)
    chunk_kernel(const float* __restrict__ own, const float* __restrict__ cand,
                 const float* __restrict__ lf, const float* __restrict__ cfeat,
                 float* __restrict__ own_out, float* __restrict__ j_out,
                 int cz, int cy, int cx, int rz, int ry, int rx, int cap,
                 int g_cells, int nf, int n_off, int m_s, int w_s, Params p) {
  extern __shared__ float smem[];
  const int fstride = feat_stride(nf);
  const int ey = cy + 2 * ry;
  const int ex = cx + 2 * rx;
  float* os = smem;                            // [kOwn][m_s]
  float* ls = os + Body::kOwn * m_s;           // [m_s][fstride]
  float* cs = ls + m_s * fstride;              // [kCand][w_s]
  float* cf = cs + Body::kCand * w_s;          // [w_s][fstride]
  float* oacc = cf + w_s * fstride;            // [kOut][m_s]
  float* jacc = oacc + Body::kOut * m_s;       // [kJ][w_s]
  int* queues = reinterpret_cast<int*>(jacc + Body::kJ * w_s);

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
  // the chunk's own slots [i0, i0 + m) (blockIdx.z: a slice of them where
  // the chunk does not fit) against its window, w_s candidates at a time
  const int m_all = g_cells * cap;
  const int w_all = (g_cells + 2 * rx) * cap;
  const int i0 = kSliced ? blockIdx.z * m_s : 0;
  const int m = kSliced ? min(m_s, m_all - i0) : m_all;
  const int64_t own0 =
      ((static_cast<int64_t>(z) * cy + y) * cx + chunk * g_cells) * cap + i0;
  const int64_t cand0 =
      ((static_cast<int64_t>(z + rz + dz) * ey + (y + ry + dy)) * ex +
       chunk * g_cells) * cap;
  int* qbuf = queues + (threadIdx.x >> 5) * kQueue;
  stage_own<Body>(own, lf, own_plane, own0, m, nf, fstride, os, ls, oacc);
  // the window's slices (one without kSliced: c0 = 0, w = w_all)
  const int n_slices = kSliced ? (w_all + w_s - 1) / w_s : 1;
  for (int s = 0; s < n_slices; ++s) {
    const int c0 = kSliced ? s * w_s : 0;
    const int w = kSliced ? min(w_s, w_all - c0) : w_all;
    if (s > 0) __syncthreads();  // the previous slice is flushed
    stage_cand<Body>(cand, cfeat, ext_plane, cand0 + c0, w, nf, fstride, cs,
                     cf);
    for (int t = threadIdx.x; t < Body::kJ * w; t += blockDim.x)
      jacc[t] = 0.0f;
    __syncthreads();
    // kernel 8 tests every own slot, parked ones too
    sweep_chunk<Body, kWideWarps, false>(p, os, m, i0, ls, cs, w, c0, cf,
                                         fstride, cap, rx, home, 0.0f, qbuf,
                                         oacc, jacc, w);
    flush_j<Body::kJ>(jacc, w, j_out, ext_plane, cand0 + c0);
  }
  flush_own<Body::kOut>(oacc, m, own_out, own_plane, own0);
}

template <class Body>
cudaError_t launch(const float* own, const float* cand, const float* lf,
                   const float* cfeat, float* own_out, float* j_out, int cz,
                   int cy, int cx, int rz, int ry, int rx, int cap, int g,
                   int nf, int n_sys, int m_s, int w_s, const Params& p,
                   cudaStream_t stream) {
  if (g <= 0 || cx % g) return cudaErrorInvalidValue;
  const int n_off = 1 + ry + rz * (2 * ry + 1);
  const int blocks = cz * cy * n_off * (cx / g);
  if (blocks == 0 || cap == 0 || n_sys == 0) return cudaSuccess;
  // the staging plan (kernels/chunk_sweep.py:chunk_slices): at most the
  // chunk's own slots and its window's candidates
  m_s = min(m_s, g * cap);
  w_s = min(w_s, (g + 2 * rx) * cap);
  const int n_split = (g * cap + m_s - 1) / m_s;
  if (!plan_ok(n_sys, m_s, w_s, n_split)) return cudaErrorInvalidValue;
  const size_t smem = chunk_smem_bytes<Body>(m_s, w_s, nf);
  const bool sliced = m_s < g * cap || w_s < (g + 2 * rx) * cap;
  auto* kernel = sliced ? chunk_kernel<Body, true> : chunk_kernel<Body, false>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(blocks, n_sys, n_split), kWideThreads, smem, stream>>>(
      own, cand, lf, cfeat, own_out, j_out, cz, cy, cx, rz, ry, rx, cap, g, nf,
      n_off, m_s, w_s, p);
  return cudaGetLastError();
}

}  // namespace

// body: 0 = CN, 1 = D3 direct (zm-wide), 2 = CN chain, 3 = Coulomb, 4 = D3
// direct + Coulomb (separate force channels).  nf = 2 * zm for the D3
// bodies (lf and cfeat rows), 0 otherwise; g = G, a divisor of cx; n_sys
// systems of a batched grid (1 for one grid); m_s own slots and w_s
// candidates a block stages at once (the whole chunk and window: G * cap
// and (G + 2 rx) * cap).
extern "C" int nv_chunk_sweep(int body, const float* own, const float* cand,
                              const float* lf, const float* cfeat,
                              float* own_out, float* j_out, int cz, int cy,
                              int cx, int rz, int ry, int rx, int cap, int g,
                              int nf, int n_sys, int m_s, int w_s,
                              float cutoff_sq, float a1, float a2, float s6,
                              float s8, float k1, float k3, float alpha,
                              float ccutoff_sq, void* stream) {
  const Params p{cutoff_sq, a1, a2, s6, s8, k1, k3, alpha, ccutoff_sq, nf / 2, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(B)                                                            \
  launch<B>(own, cand, lf, cfeat, own_out, j_out, cz, cy, cx, rz, ry, rx, cap, \
            g, nf, n_sys, m_s, w_s, p, st)
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

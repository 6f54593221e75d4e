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
// candidates and run the body in place (this kernel's first design, as
// kernel 7 still does) spends nearly every warp step on the body at a few
// useful lanes.  The TPU kernel sized G for 16 MB of VMEM; here the chunk
// lives in shared memory: own scalars, own lf rows, candidate scalars,
// candidate zm-wide rows, the own and j sums and the warps' queues, with
// the rows
// at an odd stride so lane-strided reads do not collide in the banks.  The
// wrapper picks G (kernels/chunk_sweep.py:super_chunk_cells) so that this
// fits the 227 KB a block may use.
//
// Design: distance test first (kernel 1's recipe, window_sweep.cu).  One
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
// sums.  Both
// are flushed once a block with one global atomic per slot and output (own
// into [n_out, cz, cy, cx, cap], j into [n_j, ez, ey, ex, cap]).
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

// Shared memory of one block: the staged chunk, the own-side and j-side
// sums (floats) and the warps' queues (kQueue ints a warp).
template <class Body>
__host__ __device__ inline size_t chunk_smem_bytes(int g, int cap, int rx,
                                                   int nf) {
  const size_t m = static_cast<size_t>(g) * cap;
  const size_t w = static_cast<size_t>(g + 2 * rx) * cap;
  const size_t fs = feat_stride(nf);
  return sizeof(float) *
             (Body::kOwn * m + m * fs + Body::kCand * w + w * fs +
              Body::kOut * m + Body::kJ * w) +
         sizeof(int) * kWideWarps * kQueue;
}

// One pop of the warp's queue.  An entry is (own index << 16) | candidate
// index; each lane runs the body on its entry and adds the j-side terms to
// the shared sums jacc[k][w].  Entries come off the queue in push order,
// so the lanes of one own slot are contiguous: a segmented reduction over
// the warp sums each slot's own-side terms into its first lane, which adds
// them to oacc[k][m] (one shared atomic per slot and output instead of one
// per lane: the lanes of a slot would collide on its address).  The
// reduction runs in f64: summed in f32 it moved the block engine's Coulomb
// forces further from the window engine's than the cross-engine bar of
// chip_smoke.py allows; in f64 they stay inside it, at 2-9% more device
// time (PERF.md, kernel 8).
template <class Body>
__device__ __forceinline__ void run_queued(const Params& p, const float* os,
                                           int m, const float* ls,
                                           const float* cs, int w,
                                           const float* cf, int fstride,
                                           WarpQueue& queue, float* oacc,
                                           float* jacc) {
  const int lane = threadIdx.x & 31;
  const int e = queue.pop();
  const int i = e < 0 ? -1 : e >> 16;
  float out[Body::kOut];
#pragma unroll
  for (int k = 0; k < Body::kOut; ++k) out[k] = 0.0f;
  if (e >= 0) {
    const int c = e & 0xffff;
    float o[Body::kOwn];
#pragma unroll
    for (int f = 0; f < Body::kOwn; ++f) o[f] = os[f * m + i];
    float jo[Body::kJ];
    if (Body::pair(p, o, ls + i * fstride, cs, w, cf, fstride, c, out, jo)) {
#pragma unroll
      for (int k = 0; k < Body::kJ; ++k) atomicAdd(&jacc[k * w + c], jo[k]);
    } else {
#pragma unroll
      for (int k = 0; k < Body::kOut; ++k) out[k] = 0.0f;
    }
  }
  // entries are in queue order, so each own slot's lanes are contiguous:
  // a segmented reduction toward each slot's first lane, in f64, then one
  // atomic
  double od[Body::kOut];
#pragma unroll
  for (int k = 0; k < Body::kOut; ++k) od[k] = out[k];
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int ni = __shfl_down_sync(0xffffffffu, i, s);
    const bool same = lane + s < 32 && ni == i;
#pragma unroll
    for (int k = 0; k < Body::kOut; ++k) {
      const double v = __shfl_down_sync(0xffffffffu, od[k], s);
      if (same) od[k] += v;
    }
  }
  const int prev = __shfl_up_sync(0xffffffffu, i, 1);
  if (i >= 0 && (lane == 0 || prev != i)) {
#pragma unroll
    for (int k = 0; k < Body::kOut; ++k)
      if (od[k] != 0.0) atomicAdd(&oacc[k * m + i], static_cast<float>(od[k]));
  }
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
  float* oacc = cf + w * fstride;              // [kOut][m]
  float* jacc = oacc + Body::kOut * m;         // [kJ][w]
  int* queues = reinterpret_cast<int*>(jacc + Body::kJ * w);

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
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float reach = Body::reach_sq(p);
  WarpQueue queue{queues + warp * kQueue, 0};

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
  for (int t = threadIdx.x; t < Body::kOut * m + Body::kJ * w;
       t += blockDim.x)
    oacc[t] = 0.0f;  // oacc and jacc
  __syncthreads();

  // the warp's own slots one after another, all feeding one queue: a slot
  // meets ~10 pairs an offset, so pops span slots and run at full warps
  const int tri = rx * cap;  // home: keep cand_flat > own_flat + rx * cap
  for (int i = warp; i < m; i += kWideWarps) {
    const float ox = os[i], oy = os[m + i], oz = os[2 * m + i];
    // the 2 rx + 1 x-cells around the own slot's cell
    const int gl = i / cap;
    const int j0 = home ? i + tri + 1 : gl * cap;
    const int j1 = (gl + 2 * rx + 1) * cap;
    for (int c0 = j0; c0 < j1; c0 += 32) {
      const int c = c0 + lane;
      bool hit = false;
      if (c < j1) {
        const float d2 = dist2(cs[c] - ox, cs[w + c] - oy, cs[2 * w + c] - oz);
        hit = inside(d2, reach);
      }
      queue.push(hit, i << 16 | c);
      if (queue.full())
        run_queued<Body>(p, os, m, ls, cs, w, cf, fstride, queue, oacc, jacc);
    }
  }
  if (queue.n)
    run_queued<Body>(p, os, m, ls, cs, w, cf, fstride, queue, oacc, jacc);
  __syncthreads();
  // one global atomic per own slot and output: the offsets of a row run in
  // different blocks
  for (int t = threadIdx.x; t < Body::kOut * m; t += blockDim.x) {
    const float v = oacc[t];
    const int k = t / m;
    if (v != 0.0f) atomicAdd(&own_out[k * own_plane + own0 + (t - k * m)], v);
  }
  flush_j<Body::kJ>(jacc, w, j_out, ext_plane, cand0);
}

template <class Body>
cudaError_t launch(const float* own, const float* cand, const float* lf,
                   const float* cfeat, float* own_out, float* j_out, int cz,
                   int cy, int cx, int rz, int ry, int rx, int cap, int g,
                   int nf, const Params& p, cudaStream_t stream) {
  // queue entries pack (own index << 16 | candidate index)
  if (g <= 0 || cx % g || (g + 2 * rx) * cap > 0xffff)
    return cudaErrorInvalidValue;
  const int n_off = 1 + ry + rz * (2 * ry + 1);
  const int blocks = cz * cy * n_off * (cx / g);
  if (blocks == 0 || cap == 0) return cudaSuccess;
  const size_t smem = chunk_smem_bytes<Body>(g, cap, rx, nf);
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

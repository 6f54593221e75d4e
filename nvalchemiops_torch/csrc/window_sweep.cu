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
// What bounds it on the H100.  Instruction throughput.  Only about one
// candidate in ten is a pair inside the cutoff: on the 109,744-atom CsCl
// main path (16^3 cells, cap 40, mean occupancy 26.8, 9.6 A) an own slot
// meets 560 candidates (the home row's 80 and four half-space windows of
// 120), of which ~53 are in range.  A warp whose lanes stride the
// candidates and run the body in place runs the pair body (the D3 body's
// three C6 dots, a divide, ~100 instructions) in nearly every warp step for
// about one useful lane in ten: 100-240x its bound (PERF.md).
//
// Design: distance test first, the body only on compacted pairs inside the
// body's reach (reach_sq: the larger of the two cutoffs for the fused body).
// One block per own cell stages all its windows at once (the home row from
// the centre cell on, then every half-space row; ~45 KB for the D3 body at
// mesh 5), so a cell costs two barriers.  One warp per own slot tests all
// the staged candidates, 32 at a time, and queues the hits (WarpQueue:
// ballot and popcount prefix into shared memory); whenever 32 wait, each
// lane runs the body on one of them.  No body arithmetic, exp, C6 dot or
// atomic is spent on a pair outside the reach.  An empty own slot (parked
// far away) costs its distance tests and nothing else.  The own-side sum
// stays in registers, reduced with one warp shuffle per output and own slot;
// j-side sums go to shared memory (atomics) and are flushed once per cell
// with one global atomic per candidate slot and output.  Where the windows
// do not fit in 227 KB, the block stages them in groups that do.  The
// global j atomics make the j-side sum order vary from run to run; that sets
// the on-card tolerance against the plain version.  What bounds it now
// (PERF.md): the bodies run on full warps and are no longer most of
// the time; the per-cell work around them (staging, the distance tests,
// each own slot's drain and reduction) is.
//
// Interface: C, for ctypes.  Every pointer is a device pointer into a
// contiguous float32 tensor allocated by the Python wrapper; j_out must be
// zero on entry.  Returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_bodies.cuh"

namespace {

using namespace pair_bodies;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
using D3CoulombSeparate = D3CoulombBody<false, false>;
using D3CoulombCombined = D3CoulombBody<false, true>;

// Window w of own cell (z, y, x): w = 0 is the home row from the centre cell
// on ((rx+1)*cap slots), w >= 1 the half-space row offset w - 1 over its
// 2*rx+1 x-cells.  Gives the window's first extended slot and its length.
__device__ __forceinline__ int64_t window(int w, int z, int y, int x, int rz,
                                          int ry, int rx, int ey, int ex,
                                          int cap, int& len) {
  int dz = 0, dy = 0, x0 = x + rx;
  len = (rx + 1) * cap;
  if (w > 0) {
    half_offset(w - 1, ry, dz, dy);
    x0 = x;
    len = (2 * rx + 1) * cap;
  }
  return ((static_cast<int64_t>(z + rz + dz) * ey + (y + ry + dy)) * ex + x0) *
         cap;
}

// Where window w sits among the candidates of a group staged from window w0
// on.
__device__ __forceinline__ int staged_offset(int w, int w0, int rx, int cap) {
  return w0 == 0 && w > 0 ? (rx + 1) * cap + (w - 1) * (2 * rx + 1) * cap
                          : (w - w0) * (2 * rx + 1) * cap;
}

// One pop of the warp's queue: each lane runs the body on its entry (a
// staged candidate), adds the own-side terms to its registers and the j-side
// terms to the shared sums.
template <class Body>
__device__ __forceinline__ void run_queued(const Params& p, const float* o,
                                           const float* lrow, const float* cs,
                                           int ncs, WarpQueue& queue,
                                           float* acc, float* jacc) {
  const int c = queue.pop();
  if (c < 0) return;
  float out[Body::kOut], jo[Body::kJ];
  if (!Body::pair(p, o, lrow, cs, ncs, nullptr, 0, c, out, jo)) return;
#pragma unroll
  for (int k = 0; k < Body::kOut; ++k) acc[k] += out[k];
#pragma unroll
  for (int k = 0; k < Body::kJ; ++k) atomicAdd(&jacc[k * ncs + c], jo[k]);
}

template <class Body>
__global__ void __launch_bounds__(kThreads)
    sweep_kernel(const float* __restrict__ own, const float* __restrict__ cand,
                 float* __restrict__ own_out, float* __restrict__ j_out,
                 int cz, int cy, int cx, int rz, int ry, int rx, int cap,
                 int n_cand, const float* __restrict__ lf, Params p, int ncs) {
  extern __shared__ float smem[];
  float* cs = smem;                                // [n_cand][ncs]
  float* jacc = cs + n_cand * ncs;                 // [kJ][ncs]
  float* oacc = jacc + Body::kJ * ncs;             // [kOut][cap]
  int* queues = reinterpret_cast<int*>(oacc + Body::kOut * cap);

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
  const int n_win = 1 + ry + rz * (2 * ry + 1);
  const float reach = Body::reach_sq(p);
  WarpQueue queue{queues + warp * kQueue, 0};

  for (int t = threadIdx.x; t < Body::kOut * cap; t += kThreads) oacc[t] = 0.0f;

  // windows [w0, w1), staged back to back: all of them where they fit
  for (int w0 = 0, w1; w0 < n_win; w0 = w1) {
    int staged = 0, len;
    for (w1 = w0; w1 < n_win; ++w1) {
      window(w1, z, y, x, rz, ry, rx, ey, ex, cap, len);
      if (staged + len > ncs) break;
      staged += len;
    }
    const int nw = w1 - w0;
    __syncthreads();  // the previous group is done with cs and jacc
    for (int fw = warp; fw < n_cand * nw; fw += kWarps) {
      const int f = fw / nw;
      const int w = w0 + fw - f * nw;
      const int off = staged_offset(w, w0, rx, cap);
      const int64_t base = window(w, z, y, x, rz, ry, rx, ey, ex, cap, len);
      const float* src = cand + f * ext_plane + base;
      for (int l = lane; l < len; l += 32) cs[f * ncs + off + l] = src[l];
    }
    for (int t = threadIdx.x; t < Body::kJ * ncs; t += kThreads) jacc[t] = 0.0f;
    __syncthreads();

    // the home row's centre cell keeps only slot pairs i < j
    const int home_end = w0 == 0 ? cap : 0;
    for (int i = warp; i < cap; i += kWarps) {
      const int64_t own_slot = static_cast<int64_t>(cell) * cap + i;
      float o[Body::kOwn];
#pragma unroll
      for (int f = 0; f < Body::kOwn; ++f) o[f] = own[f * own_plane + own_slot];
      const float* lrow = lf ? lf + own_slot * (2 * p.zm) : nullptr;
      float acc[Body::kOut];
#pragma unroll
      for (int k = 0; k < Body::kOut; ++k) acc[k] = 0.0f;
      // rounds of 32 candidates; the last pass only drains the queue
      const int rounds = (staged + 31) / 32;
      for (int r = 0; r <= rounds; ++r) {
        if (r < rounds) {
          const int c = r * 32 + lane;
          bool hit = false;
          if (c < staged && !(c < home_end && c <= i)) {
            const float d2 = dist2(cs[c] - o[0], cs[ncs + c] - o[1],
                                   cs[2 * ncs + c] - o[2]);
            hit = inside(d2, reach);
          }
          queue.push(hit, c);
        }
        if (queue.full() || (r == rounds && queue.n))
          run_queued<Body>(p, o, lrow, cs, ncs, queue, acc, jacc);
      }
#pragma unroll
      for (int k = 0; k < Body::kOut; ++k) {
        float v = acc[k];
        for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
        if (lane == 0) oacc[k * cap + i] += v;
      }
    }
    __syncthreads();
    for (int kw = warp; kw < Body::kJ * nw; kw += kWarps) {
      const int k = kw / nw;
      const int w = w0 + kw - k * nw;
      const int off = staged_offset(w, w0, rx, cap);
      const int64_t base = window(w, z, y, x, rz, ry, rx, ey, ex, cap, len);
      for (int l = lane; l < len; l += 32) {
        const float v = jacc[k * ncs + off + l];
        if (v != 0.0f) atomicAdd(&j_out[k * ext_plane + base + l], v);
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < Body::kOut * cap; t += kThreads) {
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
  // every window staged at once where that fits, else the most that fits
  const int total = (rx + 1) * cap + (ry + rz * (2 * ry + 1)) * (2 * rx + 1) * cap;
  const size_t fixed =
      sizeof(float) * Body::kOut * cap + sizeof(int) * kWarps * kQueue;
  const size_t per = sizeof(float) * (n_cand + Body::kJ);
  int ncs = total;
  if (fixed + per * ncs > kMaxSmem) ncs = static_cast<int>((kMaxSmem - fixed) / per);
  const int n_win = 1 + ry + rz * (2 * ry + 1);
  if (ncs < (n_win > 1 ? 2 * rx + 1 : rx + 1) * cap)
    return cudaErrorInvalidConfiguration;  // one window must fit
  const size_t smem = fixed + per * ncs;
  const cudaError_t e = allow_smem(sweep_kernel<Body>, smem);
  if (e != cudaSuccess) return e;
  sweep_kernel<Body><<<ncells, kThreads, smem, stream>>>(
      own, cand, own_out, j_out, cz, cy, cx, rz, ry, rx, cap, n_cand, lf, p, ncs);
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

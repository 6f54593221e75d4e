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
// with one global atomic per candidate slot and output.  The global j
// atomics make the j-side sum order vary from run to run; that sets
// the on-card tolerance against the plain version.  What bounds it now
// (PERF.md): the bodies run on full warps and are no longer most of
// the time; the per-cell work around them (staging, the distance tests,
// each own slot's drain and reduction) is.
//
// Windows that overflow shared memory.  Where a cell's windows do not fit
// in 227 KB, the block stages them in groups of ncs slots one after
// another, each group flushed before the next: whole windows where each
// fits, and where one window alone exceeds ncs (a cell of thousands of
// slots: one cell a system at dims 1^3), slices of it, a group ending part
// of the way through a window and the next starting at that slot
// (tests/test_torch_pair_queue.py:window_groups mirrors the loop).  Across
// slices the home row's i < j rule is kept by absolute slot (hoff), each
// slice's j sums go to their own offset in j_out, and the own-side sums
// stay in oacc.  The wrapper computes the plan (window_plan: ncs and opb,
// the own slots a block takes); the launcher only checks that it fits, and
// runs a plan that needs no slice on an instantiation without the slice
// bookkeeping (kSliced false), as fast as a kernel that never slices.  Where a
// window overflows and the cells of the launch leave SMs idle (one cell
// of one system: one block, one SM), the cell's own slots are split over
// blocks along gridDim.z: each block writes its own slots' sums, and all
// add j sums with the same global atomics, so no new atomics are needed.
//
// Batches.  One launch sweeps the n_sys systems of a batched grid (the
// per-system grids of grid.batch_build_atom_grid, one geometry): block
// (cell, system) with blockIdx.y the system, each system's planes one
// after the other ([n_sys][n_own] own planes, [n_sys][n_cand] candidate
// planes, [n_sys] left rows, and the outputs likewise).  The scalar
// parameters are shared; each system's cell is already in its ghost
// positions.  Systems never meet, so a block reads and writes its own
// system's planes only.
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

// Where window w sits among the candidates of a group of whole windows
// staged from window w0 on.
__device__ __forceinline__ int staged_offset(int w, int w0, int rx, int cap) {
  return w0 == 0 && w > 0 ? (rx + 1) * cap + (w - 1) * (2 * rx + 1) * cap
                          : (w - w0) * (2 * rx + 1) * cap;
}

// Segment k of a staging group (tests/test_torch_pair_queue.py:
// window_groups): window w0 + k, whole, at staged_offset; with kSliced, k =
// 0 is window w0 from its slot l0 on (seg0 slots) and k >= 1 the whole
// window w0 + k after it (every window after the home row has (2*rx+1)*cap
// slots).  Gives the segment's first extended slot, its length and its
// offset among the group's staged candidates.
template <bool kSliced>
__device__ __forceinline__ int64_t segment(int k, int w0, int l0, int seg0,
                                           int z, int y, int x, int rz,
                                           int ry, int rx, int ey, int ex,
                                           int cap, int& len, int& off) {
  const int64_t base = window(w0 + k, z, y, x, rz, ry, rx, ey, ex, cap, len);
  if (!kSliced) {
    off = staged_offset(w0 + k, w0, rx, cap);
    return base;
  }
  if (k == 0) {
    len = seg0;
    off = 0;
    return base + l0;
  }
  off = seg0 + (k - 1) * len;
  return base;
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

// kSliced: a plan that splits the cell's own slots over blocks or cuts a
// window into slices.  Without it (every window fits and a block takes the
// whole cell) the block stages groups of whole windows with no slice
// bookkeeping (staged_offset, the home bound cap or 0): the slice offsets
// kept live across the sweep cost 3-15% a pass on the 109,744-atom main
// path (NVIDIA H100 80GB HBM3 at 700 W; PERF.md), the D3 direct body at
// 64 registers.
template <class Body, bool kSliced>
__global__ void __launch_bounds__(kThreads)
    sweep_kernel(const float* __restrict__ own, const float* __restrict__ cand,
                 float* __restrict__ own_out, float* __restrict__ j_out,
                 int cz, int cy, int cx, int rz, int ry, int rx, int cap,
                 int n_cand, const float* __restrict__ lf, Params p, int ncs,
                 int opb) {
  extern __shared__ float smem[];
  float* cs = smem;                                // [n_cand][ncs]
  float* jacc = cs + n_cand * ncs;                 // [kJ][ncs]
  float* oacc = jacc + Body::kJ * ncs;             // [kOut][opb]
  int* queues = reinterpret_cast<int*>(oacc + Body::kOut * opb);

  const int cell = blockIdx.x;
  const int x = cell % cx;
  const int y = (cell / cx) % cy;
  const int z = cell / (cx * cy);
  const int ey = cy + 2 * ry;
  const int ex = cx + 2 * rx;
  const int64_t ext_plane = static_cast<int64_t>(cz + 2 * rz) * ey * ex * cap;
  const int64_t own_plane = static_cast<int64_t>(cz) * cy * cx * cap;
  // this block's system: its planes follow those of the systems before it
  const int64_t sys = blockIdx.y;
  own += sys * Body::kOwn * own_plane;
  cand += sys * n_cand * ext_plane;
  if (lf) lf += sys * own_plane * 2 * p.zm;
  own_out += sys * Body::kOut * own_plane;
  j_out += sys * Body::kJ * ext_plane;
  // this block's own slots [i0, i1) of the cell, their sums oacc[k][i - i0]
  const int i0 = kSliced ? blockIdx.z * opb : 0;
  const int i1 = kSliced ? min(cap, i0 + opb) : cap;
  const int n_own = i1 - i0;
  const int ostride = kSliced ? opb : cap;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_win = 1 + ry + rz * (2 * ry + 1);
  const int win_len = (2 * rx + 1) * cap;  // every window after the home row
  const float reach = Body::reach_sq(p);
  WarpQueue queue{queues + warp * kQueue, 0};

  for (int t = threadIdx.x; t < Body::kOut * n_own; t += kThreads) {
    const int k = kSliced ? t / n_own : 0;
    oacc[kSliced ? k * ostride + (t - k * n_own) : t] = 0.0f;
  }

  // Staging groups of at most ncs slots: whole windows [w0, w1), as many
  // as fit; with kSliced, from window w0's slot l0 on, the rest of w0 (or,
  // where that exceeds ncs, a slice of ncs slots of it) and as many whole
  // windows after it as fit.
  for (int w0 = 0, l0 = 0; w0 < n_win;) {
    int len0, seg0 = 0, staged = 0, w1 = w0;
    if (kSliced) {
      window(w0, z, y, x, rz, ry, rx, ey, ex, cap, len0);
      seg0 = min(len0 - l0, ncs);
      staged = seg0;
      w1 = w0 + 1;
      if (l0 + seg0 == len0)
        for (; w1 < n_win && staged + win_len <= ncs; ++w1) staged += win_len;
    } else {
      for (; w1 < n_win; ++w1) {
        window(w1, z, y, x, rz, ry, rx, ey, ex, cap, len0);
        if (staged + len0 > ncs) break;
        staged += len0;
      }
    }
    const int nw = w1 - w0;
    __syncthreads();  // the previous group is done with cs and jacc
    for (int fw = warp; fw < n_cand * nw; fw += kWarps) {
      const int f = fw / nw;
      int len, off;
      const int64_t base = segment<kSliced>(fw - f * nw, w0, l0, seg0, z, y, x,
                                            rz, ry, rx, ey, ex, cap, len, off);
      const float* src = cand + f * ext_plane + base;
      for (int l = lane; l < len; l += 32) cs[f * ncs + off + l] = src[l];
    }
    for (int t = threadIdx.x; t < Body::kJ * ncs; t += kThreads) jacc[t] = 0.0f;
    __syncthreads();

    // the home row's centre cell (window 0's first cap slots) keeps only
    // slot pairs i < j: staged candidate c < home_end is home slot c + hoff
    const int hoff = w0 == 0 ? (kSliced ? l0 : 0) : cap;
    const int home_end = kSliced ? max(0, cap - hoff) : (w0 == 0 ? cap : 0);
    for (int i = i0 + warp; i < i1; i += kWarps) {
      const int ih = kSliced ? i - hoff : i;  // keep c + hoff > i
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
          if (c < staged && !(c < home_end && c <= ih)) {
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
        if (lane == 0) oacc[k * ostride + (i - i0)] += v;
      }
    }
    __syncthreads();
    for (int kw = warp; kw < Body::kJ * nw; kw += kWarps) {
      const int k = kw / nw;
      int len, off;
      const int64_t base = segment<kSliced>(kw - k * nw, w0, l0, seg0, z, y, x,
                                            rz, ry, rx, ey, ex, cap, len, off);
      for (int l = lane; l < len; l += 32) {
        const float v = jacc[k * ncs + off + l];
        if (v != 0.0f) atomicAdd(&j_out[k * ext_plane + base + l], v);
      }
    }
    if (kSliced && l0 + seg0 < len0) {
      l0 += seg0;  // the next group goes on in window w0
    } else {
      w0 = w1;
      l0 = 0;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < Body::kOut * n_own; t += kThreads) {
    const int k = t / n_own;
    const int i = t - k * n_own;
    own_out[k * own_plane + static_cast<int64_t>(cell) * cap + i0 + i] =
        oacc[k * ostride + i];
  }
}

template <class Body>
cudaError_t launch(const float* own, const float* cand, float* own_out,
                   float* j_out, int cz, int cy, int cx, int rz, int ry, int rx,
                   int cap, int n_cand, const float* lf, const Params& p,
                   int n_sys, int ncs, int opb, cudaStream_t stream) {
  const int ncells = cz * cy * cx;
  if (ncells == 0 || cap == 0 || n_sys == 0) return cudaSuccess;
  if (n_sys < 0 || ncs < 1 || opb < 1 || opb > cap)
    return cudaErrorInvalidValue;
  const int n_split = (cap + opb - 1) / opb;
  if (n_sys > 65535 || n_split > 65535) return cudaErrorInvalidValue;
  // the staging plan (kernels/window_sweep.py:window_plan): ncs slots a
  // group, opb own slots a block; allow_smem refuses more than 227 KB
  const size_t smem = sizeof(float) * ((n_cand + Body::kJ) * static_cast<size_t>(ncs) +
                                       Body::kOut * static_cast<size_t>(opb)) +
                      sizeof(int) * kWarps * kQueue;
  const int n_win = 1 + ry + rz * (2 * ry + 1);
  const bool sliced =
      opb < cap || ncs < (n_win > 1 ? 2 * rx + 1 : rx + 1) * cap;
  auto* kernel = sliced ? sweep_kernel<Body, true> : sweep_kernel<Body, false>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(ncells, n_sys, n_split), kThreads, smem, stream>>>(
      own, cand, own_out, j_out, cz, cy, cx, rz, ry, rx, cap, n_cand, lf, p, ncs,
      opb);
  return cudaGetLastError();
}

}  // namespace

// body: 0 = CN, 1 = D3 direct, 2 = CN chain, 3 = Coulomb, 4 = D3 direct +
// Coulomb (separate force channels), 5 = D3 direct + Coulomb (combined).
// n_sys: the systems of a batched grid swept by this launch (1 for one
// grid); ncs: candidate slots a staging group holds; opb: own slots a block
// takes (cap: the whole cell).
extern "C" int nv_window_sweep(int body, const float* own, const float* cand,
                               const float* lf, float* own_out, float* j_out,
                               int cz, int cy, int cx, int rz, int ry, int rx,
                               int cap, int n_cand, float cutoff_sq, float a1,
                               float a2, float s6, float s8, float k1, float k3,
                               float alpha, float ccutoff_sq, int zm, int mesh,
                               int n_sys, int ncs, int opb, void* stream) {
  const Params p{cutoff_sq, a1, a2, s6, s8, k1, k3, alpha, ccutoff_sq, zm, mesh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(B) \
  launch<B>(own, cand, own_out, j_out, cz, cy, cx, rz, ry, rx, cap, n_cand, lf, \
            p, n_sys, ncs, opb, st)
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

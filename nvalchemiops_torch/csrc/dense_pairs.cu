// SPDX-License-Identifier: Apache-2.0
//
// Batched triangle-block dense pair sweep for the dense DFT-D3 path
// (interactions/dispersion/dense_d3.py), templated on a pass body.
//
// Replaces: nvalchemiops_tpu/pallas/dense_sweep.py:dense_sweep (:64,
// pallas_call :208) with the three bodies of _dense_pallas_impl: CN
// (dense_d3.py:349-362), D3 direct (:388-438) and CN chain (:454-478).
//
// What it computes.  The atoms of every system are cut into 64-atom tiles.
// Every upper-triangle tile pair (bi <= bj) of every system is visited
// once; a diagonal pair keeps only j > i.  For each atom pair the body sums
// its terms over the image combos (minimum image, plus the second image on
// the axes of each combo's bit set, in the base + delta form of
// combo_carts, dense_d3.py:307-343) and returns i-side terms, summed into
// atom i's outputs, and j-side terms, summed into atom j's.  The direct
// body's j-side forces are the negated i-side ones (the "neg" convention of
// pallas/dense_sweep.py:146-156); its energy is summed on the i side only.
//
// What the TPU design did and what carries over.  The TPU kernel walked
// the triangle on a sequential grid, kept per-system sums in VMEM scratch
// and transposed them with an [8, n_pad] identity matmul at the end; its C6
// interpolation was three [block, zm] x [zm, block] MXU contractions per
// tile.  Here blocks run in any order and both sides' sums reach the
// outputs with one global atomicAdd per atom and output.  The C6
// contractions are not matmuls: the j features are one-hot in z_j, so each
// is a mesh-term dot of the i row [l0w | l1cw] at offset z_j * mesh against
// (ew_j, edcw_j), for any element count.
//
// What bounds it on the H100.  Instruction throughput, and how much of it
// goes to pairs in range.  At 128 x 2,000 atoms in 41.2 A boxes at 21.2 A
// (n_pad 2,048, 4 image combos) ~55% of the 268 M pairs have an image in
// range; at 9 A in 27 A boxes ~15%.  One thread per i atom stepping
// through 64 j, with the body in place, runs the direct body's C6 dots (ten
// loads through L1 at 32 different i rows per warp load) before the cutoff
// test, gives every live pair its shared atomics, in range or not, and
// runs the body's arithmetic whenever any lane of a warp has a combo in
// range: 18-50x off its bound (PERF.md).
//
// Design: distance test first, the body only on compacted in-range pairs.
// A block of 8 warps owns one i tile and up to kJTiles j tiles of one
// system, staged feature-major in shared memory (the direct body's i rows
// lw too, [64, 2 zm] at an odd stride, 43.8 KB at zm = 85; where they do
// not fit in 227 KB beside the block's other buffers the rows are read
// through L1).  Each warp owns 8 i rows and takes them one at a time, the
// row's features in registers.  It tests the block's j atoms 32 at a time:
// the minimum image and the r^2 of every combo (in an orthorhombic cell six
// squares and two adds a combo), and for CN and chain both atoms alive.  A
// pair with no combo in range leaves there: no C6 dot, exp, term or atomic.
// The others go into the warp's queue (WarpQueue, pair_bodies.cuh) as (j,
// combo mask); whenever 32 wait, and at the row's end, each lane runs the
// body on one of them, over the combos of its mask.  A pop holds one row,
// so the i-side sums stay in registers and leave once a row, with a warp
// reduction and a global atomic per output; the direct body's C6 dots read
// that one row's z_j bands, which never share a bank.  The j-side sums go
// to shared memory with atomics (a compare-and-swap loop for floats) and
// are flushed once per block.  The atomic sums make the output order
// run-dependent; that sets the on-card tolerance against the plain version.
//
// What bounds it now (PERF.md).  The distance test of every pair slot
// and the loop around it, which any order of the pairs pays, so the CN and
// chain bodies, whose arithmetic is small, gain least.  Then the direct
// body's shared-memory traffic per pair (the j features, the row bands and
// four compare-and-swap atomics share the SM's one shared-memory pipe).
// Tried on the card and dropped: pops spanning rows with a segmented warp
// scan for the i-side sums (the shuffles cost more than draining each
// row), two rows a warp at once (the registers cost more than the shared
// j loads it saved), 2 and 16 j tiles a block, 128 and 512 threads, and
// staging by cp.async (no change).
//
// Interface: C, for ctypes.  Pointers are device pointers into contiguous
// float32 tensors allocated by the Python wrapper, except combos (host, by
// value into the kernel parameters).  out [n_out, S, n_pad] must be zero on
// entry.  Returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_bodies.cuh"

namespace {

using pair_bodies::kMaxSmem;
using pair_bodies::kQueue;
using pair_bodies::WarpQueue;

constexpr int kTile = 64;
constexpr int kMaxCombos = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kJTiles = 8;            // j tiles per block
constexpr int kJW = kJTiles * kTile;  // j atoms per block
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  float cut2, a1, a2, s6, s8, k1, k3;
  int mesh, zm, n_combos;
  int combos[kMaxCombos];  // bit c set: second image on axis c
  const float* lw;         // direct: i rows [S, n_pad, 2 zm] = [l0w | l1cw]
};

// The block's atoms in shared memory, feature-major: feature f of i-tile
// atom i at ti[f * kTile + i], of j atom jj at tj[f * kJW + jj]; the direct
// body's i rows at rows + i * rstride.
struct Tiles {
  const float* ti;
  const float* tj;
  const float* rows;
  int rstride;

  __device__ float fi(int f, int i) const { return ti[f * kTile + i]; }
  __device__ float fj(int f, int jj) const { return tj[f * kJW + jj]; }
};

// The system's cell and the image combos, in every thread's registers.
struct Frame {
  float cell[9];  // cell rows
  int combos;     // combo k's axis bits at bits 3k .. 3k + 2
  int n_combos;
  bool ortho;     // every off-diagonal cell entry is zero
  bool images;    // some combo takes a second image
  float cut2;

  __device__ int bits(int k) const { return (combos >> (3 * k)) & 7; }
  __device__ bool in_range(float r2) const { return r2 < cut2 && r2 > 1e-20f; }
};

// Minimum-image cartesian displacement of one pair and its per-axis image
// signs.  The displacements and r^2 are rounded as the plain version rounds
// them, with no fused multiply-add, so both take the same pairs at the
// cutoff: D3 has no smooth cutoff, and a pair on the other side of it moves
// a force by the whole pair term.  In an orthorhombic cell every product
// with an off-diagonal entry is +-0, so the same rounding leaves one
// product per axis: base_a = ds_a L_a, and the second image on axis a is
// alt_a = base_a - sgn_a L_a whatever the other axes take.
struct Geom {
  float base[3], sgn[3], alt[3];

  __device__ Geom(const Frame& fr, const float* pi, const float* pj) {
    float ds[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float d = pj[c] - pi[c];
      ds[c] = d - rintf(d);
      sgn[c] = ds[c] >= 0.0f ? 1.0f : -1.0f;
    }
    if (fr.ortho) {
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        base[ax] = __fmul_rn(ds[ax], fr.cell[4 * ax]);
        if (fr.images)
          alt[ax] = __fsub_rn(base[ax], __fmul_rn(sgn[ax], fr.cell[4 * ax]));
      }
    } else {
#pragma unroll
      for (int ax = 0; ax < 3; ++ax)
        base[ax] = __fadd_rn(__fadd_rn(__fmul_rn(ds[0], fr.cell[ax]),
                                       __fmul_rn(ds[1], fr.cell[3 + ax])),
                             __fmul_rn(ds[2], fr.cell[6 + ax]));
    }
  }

  // Displacement of image combo `bits`; returns r^2.
  __device__ float combo(const Frame& fr, int bits, float* d) const {
    if (fr.ortho) {
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) d[ax] = (bits >> ax) & 1 ? alt[ax] : base[ax];
    } else {
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) d[ax] = base[ax];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if ((bits >> c) & 1) {
#pragma unroll
          for (int ax = 0; ax < 3; ++ax)
            d[ax] = __fsub_rn(d[ax], __fmul_rn(sgn[c], fr.cell[c * 3 + ax]));
        }
      }
    }
    return __fadd_rn(__fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1])),
                     __fmul_rn(d[2], d[2]));
  }

  // The distance test: bit k set where combo k is in range.  Orthorhombic:
  // the six squares once, then two adds a combo.
  __device__ unsigned mask(const Frame& fr) const {
    unsigned m = 0;
    if (fr.ortho) {
      float s0[3], s1[3];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) s0[ax] = __fmul_rn(base[ax], base[ax]);
      if (!fr.images)  // the minimum image alone
        return fr.in_range(__fadd_rn(__fadd_rn(s0[0], s0[1]), s0[2])) ? 1u : 0u;
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) s1[ax] = __fmul_rn(alt[ax], alt[ax]);
#pragma unroll
      for (int k = 0; k < kMaxCombos; ++k) {
        if (k >= fr.n_combos) break;
        const int b = fr.bits(k);
        const float r2 = __fadd_rn(__fadd_rn(b & 1 ? s1[0] : s0[0],
                                             b & 2 ? s1[1] : s0[1]),
                                   b & 4 ? s1[2] : s0[2]);
        if (fr.in_range(r2)) m |= 1u << k;
      }
    } else {
      for (int k = 0; k < fr.n_combos; ++k) {
        float d[3];
        if (fr.in_range(combo(fr, fr.bits(k), d))) m |= 1u << k;
      }
    }
    return m;
  }
};

__device__ __forceinline__ Geom pair_geom(const Frame& fr, const float* fi,
                                          const Tiles& t, int jj) {
  const float pj[3] = {t.fj(0, jj), t.fj(1, jj), t.fj(2, jj)};
  return Geom(fr, fi, pj);
}

// Bodies: pair(p, fr, t, fi, i, jj, mask, oi, oj) sums the pair's terms over
// the combos of `mask` (all in range) into i-side oi and j-side oj; false
// when the pair adds nothing.  fi holds the row's first kIF features (in
// registers: a warp works on one row at a time).  kAlive: feature 4 is the
// alive flag, tested with the distance.

// Pass 1: coordination numbers.  Features: fx fy fz rcov alive.
struct CnBody {
  static constexpr int kOut = 1, kJ0 = 0, kIF = 5;
  static constexpr bool kAlive = true, kRows = false;
  __device__ static bool pair(const Params& p, const Frame& fr,
                              const Tiles& t, const float* fi, int, int jj,
                              unsigned mask, float* oi, float* oj) {
    const float alive = fi[4] * t.fj(4, jj);
    const float rc = fi[3] + t.fj(3, jj);
    const Geom g = pair_geom(fr, fi, t, jj);
    float acc = 0.0f;
    for (unsigned m = mask; m; m &= m - 1) {
      float d[3];
      const float r2 = g.combo(fr, fr.bits(__ffs(m) - 1), d);
      const float inv_r = rsqrtf(r2);
      acc += alive / (1.0f + expf(-p.k1 * (rc * inv_r - 1.0f)));
    }
    oi[0] = acc;
    oj[0] = acc;
    return true;
  }
};

// Pass 2: BJ-damped energy, direct forces and dE/dCN.  Features: fx fy fz
// si z ew[mesh] edcw[mesh]; i rows lw = [l0w | l1cw].
struct DirectBody {
  static constexpr int kOut = 5, kJ0 = 1, kIF = 4;
  static constexpr bool kAlive = false, kRows = true;
  __device__ static bool pair(const Params& p, const Frame& fr,
                              const Tiles& t, const float* fi, int i, int jj,
                              unsigned mask, float* oi, float* oj) {
    const int mesh = p.mesh;
    const int zj = static_cast<int>(t.fj(4, jj));
    // one row for the whole warp: the lanes' z_j bands of it never share a
    // bank (mesh is odd), and equal z_j broadcast
    const float* l0 = t.rows + i * t.rstride + zj * mesh;
    const float* l1c = l0 + p.zm;
    float zacc = 0.0f, zdi = 0.0f, zdj = 0.0f;
    for (int m = 0; m < mesh; ++m) {
      const float a = l0[m];
      const float e = t.fj(5 + m, jj);
      zacc += a * e;
      zdi += l1c[m] * e;
      zdj += a * t.fj(5 + mesh + m, jj);
    }
    if (!(zacc >= 1e-12f)) return false;  // dead or unavailable: all zero
    const float c6m = zacc;
    const float zdiw = (-2.0f * p.k3) * zdi;
    const float zdjw = (-2.0f * p.k3) * zdj;
    const float tt = fi[3] * t.fj(3, jj);
    const float rr = tt * tt;
    const float r0 = p.a1 * tt + p.a2;
    const float r0_2 = r0 * r0;
    const float r0_6 = r0_2 * r0_2 * r0_2;
    const float r0_8 = r0_6 * r0_2;
    const Geom g = pair_geom(fr, fi, t, jj);
    float ds = 0.0f, fx = 0.0f, fy = 0.0f, fz = 0.0f;
    for (unsigned m = mask; m; m &= m - 1) {
      float d[3];
      const float r2 = g.combo(fr, fr.bits(__ffs(m) - 1), d);
      const float r4 = r2 * r2;
      const float r6 = r4 * r2;
      const float r8 = r4 * r4;
      const float den6 = r6 + r0_6;
      const float den8 = r8 + r0_8;
      const float rec = 1.0f / (den6 * den8);
      const float den6_inv = rec * den8;
      const float den8_inv = rec * den6;
      ds += p.s6 * den6_inv + p.s8 * rr * den8_inv;
      const float dd6 = -6.0f * p.s6 * r4 * den6_inv * den6_inv;
      const float dd8 = -8.0f * p.s8 * rr * r6 * den8_inv * den8_inv;
      const float coef = -c6m * (dd6 + dd8);
      fx += coef * d[0];
      fy += coef * d[1];
      fz += coef * d[2];
    }
    oi[0] = c6m * ds;
    oi[1] = ds * zdiw;
    oi[2] = fx;
    oi[3] = fy;
    oi[4] = fz;
    oj[1] = ds * zdjw;
    oj[2] = -fx;
    oj[3] = -fy;
    oj[4] = -fz;
    return true;
  }
};

// Pass 3: CN chain-rule forces.  Features: fx fy fz rcov alive de.
struct ChainBody {
  static constexpr int kOut = 3, kJ0 = 0, kIF = 6;
  static constexpr bool kAlive = true, kRows = false;
  __device__ static bool pair(const Params& p, const Frame& fr,
                              const Tiles& t, const float* fi, int, int jj,
                              unsigned mask, float* oi, float* oj) {
    const float alive = fi[4] * t.fj(4, jj);
    const float rc = fi[3] + t.fj(3, jj);
    const float de_pair = fi[5] + t.fj(5, jj);
    const Geom g = pair_geom(fr, fi, t, jj);
    float fx = 0.0f, fy = 0.0f, fz = 0.0f;
    for (unsigned m = mask; m; m &= m - 1) {
      float d[3];
      const float r2 = g.combo(fr, fr.bits(__ffs(m) - 1), d);
      const float inv_r = rsqrtf(r2);
      const float rrq = rc * inv_r;
      const float f3 = 1.0f / (1.0f + expf(-p.k1 * (rrq - 1.0f)));
      const float dcn = -f3 * (1.0f - f3) * p.k1 * rrq * inv_r * inv_r;
      const float coef = de_pair * dcn * alive;
      fx += coef * d[0];
      fy += coef * d[1];
      fz += coef * d[2];
    }
    oi[0] = fx;
    oi[1] = fy;
    oi[2] = fz;
    oj[0] = -fx;
    oj[1] = -fy;
    oj[2] = -fz;
    return true;
  }
};

// Queue entry: jj (10 bits) | combo mask (8 bits) << 16.
__device__ __forceinline__ int entry(int jj, unsigned mask) {
  return jj | static_cast<int>(mask << 16);
}

// One pop of the warp's queue, all of one row i: each lane runs the body on
// its entry, adds the i-side terms to its registers and the j-side terms to
// the shared sums (atomics: another warp may add to the same j at once).
template <class Body>
__device__ __forceinline__ void run_queued(const Params& p, const Frame& fr,
                                           const Tiles& t, const float* fi,
                                           int i, WarpQueue& queue, float* acc,
                                           float* jacc) {
  const int e = queue.pop();
  if (e < 0) return;
  const int jj = e & 1023;
  float oi[Body::kOut], oj[Body::kOut];
  if (!Body::pair(p, fr, t, fi, i, jj, static_cast<unsigned>(e) >> 16, oi,
                  oj))
    return;
#pragma unroll
  for (int o = 0; o < Body::kOut; ++o) acc[o] += oi[o];
#pragma unroll
  for (int o = Body::kJ0; o < Body::kOut; ++o)
    atomicAdd(&jacc[(o - Body::kJ0) * kJW + jj], oj[o]);
}

// Shared floats of a block besides the staged i rows.
__host__ __device__ inline int base_floats(int n_feat, int k_j) {
  return (kTile + kJW) * n_feat + k_j * kJW + 12 + kWarps * kQueue;
}

// Copies n atoms of n_feat features (atom-major, from src) into dst
// feature-major at stride `stride`.
__device__ __forceinline__ void stage_atoms(float* dst, int stride,
                                            const float* src, int n,
                                            int n_feat) {
  for (int a = threadIdx.x; a < n; a += kThreads)
    for (int f = 0; f < n_feat; ++f) dst[f * stride + a] = src[a * n_feat + f];
}

template <class Body, bool kStage>
__global__ void __launch_bounds__(kThreads)
    dense_pairs_kernel(const float* __restrict__ feats,
                       const float* __restrict__ cells,
                       float* __restrict__ out, int n_pad, int n_feat,
                       Params p) {
  constexpr int kJ = Body::kOut - Body::kJ0;
  extern __shared__ float smem[];
  float* ti = smem;                         // [n_feat][kTile]
  float* tj = ti + n_feat * kTile;          // [n_feat][kJW]
  float* jacc = tj + n_feat * kJW;          // [kJ][kJW]
  float* cell = jacc + kJ * kJW;            // [9] (12)
  int* queues = reinterpret_cast<int*>(cell + 12);  // [kWarps][kQueue]
  float* rows = smem + base_floats(n_feat, kJ);     // [kTile][rstride]

  // blockIdx.x -> (i tile bi, chunk of j tiles bj0 .. bj0 + kJTiles - 1),
  // chunks of the upper triangle bj >= bi, row-major
  const int nt = n_pad / kTile;
  int bi = 0, rem = blockIdx.x;
  for (;;) {
    const int chunks = (nt - bi + kJTiles - 1) / kJTiles;
    if (rem < chunks) break;
    rem -= chunks;
    ++bi;
  }
  const int bj0 = bi + rem * kJTiles;
  const int njw = min(kJTiles, nt - bj0) * kTile;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* fs = feats + static_cast<int64_t>(s) * n_pad * n_feat;
  stage_atoms(ti, kTile, fs + static_cast<int64_t>(bi) * kTile * n_feat,
              kTile, n_feat);
  stage_atoms(tj, kJW, fs + static_cast<int64_t>(bj0) * kTile * n_feat, njw,
              n_feat);
  for (int k = tid; k < kJ * kJW; k += kThreads) jacc[k] = 0.0f;
  if (tid < 9) cell[tid] = cells[s * 9 + tid];
  const int zm2 = 2 * p.zm;
  const float* lrows =
      Body::kRows ? p.lw + (static_cast<int64_t>(s) * n_pad + bi * kTile) * zm2
                  : nullptr;
  const int rstride = kStage ? (zm2 | 1) : zm2;
  if (kStage) {
    for (int a = warp; a < kTile; a += kWarps)
      for (int k = lane; k < zm2; k += 32)
        rows[a * rstride + k] = lrows[a * zm2 + k];
  }
  __syncthreads();

  const Tiles t{ti, tj, kStage ? rows : lrows, rstride};
  Frame fr;
#pragma unroll
  for (int k = 0; k < 9; ++k) fr.cell[k] = cell[k];
  fr.ortho = cell[1] == 0.0f && cell[2] == 0.0f && cell[3] == 0.0f &&
             cell[5] == 0.0f && cell[6] == 0.0f && cell[7] == 0.0f;
  fr.combos = 0;
#pragma unroll
  for (int k = 0; k < kMaxCombos; ++k)  // static indices: no param copy
    fr.combos |= (p.combos[k] & 7) << (3 * k);
  fr.n_combos = p.n_combos;
  fr.images = fr.combos != 0 || fr.n_combos > 1;
  fr.cut2 = p.cut2;

  // Each warp owns rows warp, warp + kWarps, ..; for each row it tests the
  // block's j atoms 32 at a time, from a chunk of its own so the warps
  // seldom add to the same j at once, and drains the queue at the row's
  // end: a pop
  // holds one row, whose i-side sums stay in registers and leave with one
  // warp reduction and one global atomic per output.  The last pass of k
  // only drains.
  const int n_chunks = njw / 32;
  const int first = warp % n_chunks;
  const int64_t plane = static_cast<int64_t>(gridDim.y) * n_pad;
  const int64_t i_row0 = static_cast<int64_t>(s) * n_pad + bi * kTile;
  WarpQueue queue{queues + warp * kQueue, 0};
  for (int i = warp; i < kTile; i += kWarps) {
    float fi[Body::kIF], acc[Body::kOut];
#pragma unroll
    for (int f = 0; f < Body::kIF; ++f) fi[f] = t.fi(f, i);
#pragma unroll
    for (int o = 0; o < Body::kOut; ++o) acc[o] = 0.0f;
    for (int k = 0; k <= n_chunks; ++k) {
      if (k < n_chunks) {
        const int c = k + first < n_chunks ? k + first : k + first - n_chunks;
        const int jj = c * 32 + lane;
        // j tile 0 is the i tile on the diagonal chunk: keep j > i
        const bool diag = bj0 == bi && jj < kTile;
        unsigned mask = 0;
        if (!(diag && jj <= i) &&
            !(Body::kAlive && fi[4] * t.fj(4, jj) == 0.0f)) {
          const float pj[3] = {t.fj(0, jj), t.fj(1, jj), t.fj(2, jj)};
          mask = Geom(fr, fi, pj).mask(fr);
        }
        queue.push(mask != 0, entry(jj, mask));
      }
      if (queue.full() || (k == n_chunks && queue.n))
        run_queued<Body>(p, fr, t, fi, i, queue, acc, jacc);
    }
#pragma unroll
    for (int o = 0; o < Body::kOut; ++o) {
      float v = acc[o];
      for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
      if (lane == 0 && v != 0.0f) atomicAdd(&out[o * plane + i_row0 + i], v);
    }
  }
  __syncthreads();

  const int64_t j_row = static_cast<int64_t>(s) * n_pad + bj0 * kTile;
  for (int k = tid; k < kJ * njw; k += kThreads) {
    const int o = k / njw;
    const float v = jacc[o * kJW + (k - o * njw)];
    if (v != 0.0f)
      atomicAdd(&out[(o + Body::kJ0) * plane + j_row + (k - o * njw)], v);
  }
}

template <class Body, bool kStage>
cudaError_t launch_as(const float* feats, const float* cells, float* out,
                      int S, int n_pad, int n_feat, const Params& p,
                      size_t smem, cudaStream_t stream) {
  const cudaError_t e =
      pair_bodies::allow_smem(dense_pairs_kernel<Body, kStage>, smem);
  if (e != cudaSuccess) return e;
  const int nt = n_pad / kTile;
  int blocks = 0;
  for (int bi = 0; bi < nt; ++bi) blocks += (nt - bi + kJTiles - 1) / kJTiles;
  dense_pairs_kernel<Body, kStage><<<dim3(blocks, S), kThreads, smem, stream>>>(
      feats, cells, out, n_pad, n_feat, p);
  return cudaGetLastError();
}

template <class Body>
cudaError_t launch(const float* feats, const float* cells, float* out, int S,
                   int n_pad, int n_feat, const Params& p,
                   cudaStream_t stream) {
  if (S == 0 || n_pad == 0) return cudaSuccess;
  if (n_pad % kTile) return cudaErrorInvalidValue;
  constexpr int kJ = Body::kOut - Body::kJ0;
  const size_t base = sizeof(float) * base_floats(n_feat, kJ);
  if constexpr (Body::kRows) {
    // the i rows in shared memory where they fit, else through L1
    const size_t rows = sizeof(float) * kTile * ((2 * p.zm) | 1);
    if (base + rows <= kMaxSmem)
      return launch_as<Body, true>(feats, cells, out, S, n_pad, n_feat, p,
                                   base + rows, stream);
  }
  return launch_as<Body, false>(feats, cells, out, S, n_pad, n_feat, p, base,
                                stream);
}

}  // namespace

// body: 0 = CN, 1 = D3 direct, 2 = CN chain.
extern "C" int nv_dense_pairs(int body, const float* feats, const float* cells,
                              const float* lw, float* out, int S, int n_pad,
                              int n_feat, float cut2, float a1, float a2,
                              float s6, float s8, float k1, float k3, int mesh,
                              int zm, int n_combos, const int* combos,
                              void* stream) {
  if (n_combos < 1 || n_combos > kMaxCombos) return cudaErrorInvalidValue;
  Params p{cut2, a1, a2, s6, s8, k1, k3, mesh, zm, n_combos, {0}, lw};
  for (int k = 0; k < n_combos; ++k) p.combos[k] = combos[k];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (body) {
    case 0:
      return launch<CnBody>(feats, cells, out, S, n_pad, n_feat, p, st);
    case 1:
      return launch<DirectBody>(feats, cells, out, S, n_pad, n_feat, p, st);
    case 2:
      return launch<ChainBody>(feats, cells, out, S, n_pad, n_feat, p, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// SPDX-License-Identifier: Apache-2.0
//
// Pair bodies shared by the pair-sweep kernels: window_sweep.cu (kernel 1),
// row_sweep.cu (kernel 7), chunk_sweep.cu (kernel 8) and stencil_sweep.cu
// (kernel 9), the steps kernels 7 and 8 share, and the warp queue of the
// distance-first sweeps (kernels 1, 4, 7 and 8).  Each body
// turns one (own, candidate) pair into own-side terms and j-side terms; the
// kernels differ only in how they enumerate pairs and where they sum the
// terms.  The math follows the JAX pass bodies term for
// term (grid_d3.py:1380-1387, :1465-1571, :1612-1625; grid.py:829-855;
// pallas/stencil_sweep.py:123-198) and the plain PyTorch versions in
// kernels/window_sweep.py.
//
// Candidate features live feature-major: feature f of candidate j is
// cs[f * ncand + j].  The zm-wide D3 bodies of kernels 7 and 8 also read the
// candidate's interpolation row cf[j * fstride + k] (k < zm: rf, k >= zm:
// rfdc) and the own row lrow[k] (k < zm: l0, k >= zm: l1c).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pair_bodies {

struct Params {
  float cutoff_sq, a1, a2, s6, s8, k1, k3, alpha, ccutoff_sq;
  int zm, mesh;
};

__device__ __forceinline__ float erfc_approx(float x) {
  // Abramowitz-Stegun 7.1.26, as mathops.math.erfc_approx
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * ax);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float y = poly * expf(-ax * ax);
  return x >= 0.0f ? y : 2.0f - y;
}

// r^2 rounded as the plain version rounds it, (dx^2 + dy^2) + dz^2 with no
// fused multiply-add, so both take the same pairs at the cutoff: D3 has no
// smooth cutoff, and a pair on the other side of it moves a force by the
// whole pair term.
__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ bool inside(float d2, float cut_sq) {
  return d2 > 1e-20f && d2 < cut_sq;
}

// CN logistic counting function of one pair (rc = rcov_i + rcov_j).
__device__ __forceinline__ float cn_term(float k1, float d2, float rc) {
  const float inv_r = rsqrtf(d2);
  return 1.0f / (1.0f + expf(-k1 * (rc * inv_r - 1.0f)));
}

// CN chain rule: the own-side force is coef * d (d = r_j - r_i).
__device__ __forceinline__ float chain_coef(float k1, float d2, float rc,
                                            float decn_sum) {
  const float inv_r = rsqrtf(d2);
  const float rrq = rc * inv_r;
  const float f = 1.0f / (1.0f + expf(-k1 * (rrq - 1.0f)));
  const float dcn = -f * (1.0f - f) * k1 * rrq * inv_r * inv_r;
  return decn_sum * dcn;
}

// erfc-damped (alpha > 0) or bare Coulomb: half the pair energy to each
// side, own-side force ncoef * d.
__device__ __forceinline__ void coulomb_terms(float alpha, float d2, float qq,
                                              float& e, float& ncoef) {
  const float inv_r = rsqrtf(d2);
  float phi, mag;
  if (alpha > 0.0f) {
    const float ar = alpha * (d2 * inv_r);
    const float erfc_ar = erfc_approx(ar);
    phi = erfc_ar * inv_r;
    mag = (erfc_ar * inv_r + 1.1283791670955126f * alpha * expf(-ar * ar)) *
          inv_r * inv_r;
  } else {
    phi = inv_r;
    mag = inv_r * inv_r * inv_r;
  }
  e = 0.5f * qq * phi;
  ncoef = -(qq * mag);
}

// BJ-damped C6/C8 pair from the three C6 contractions (zacc = l0 . rf,
// z_di = l1c . rf, z_dj = l0 . rfdc) and t = si_i * si_j: energy e, force
// coefficient coef (own force coef * d) and the dE/dCN terms.
__device__ __forceinline__ void d3_terms(const Params& p, float d2, float t,
                                         float w, float zacc, float z_di,
                                         float z_dj, float& e, float& coef,
                                         float& dei, float& dej) {
  const float w_inv = 1.0f / w;
  const float c6 = zacc * w_inv;
  const float rr = t * t;
  const float r0 = p.a1 * t + p.a2;
  const float r4 = d2 * d2;
  const float r6 = r4 * d2;
  const float r8 = r4 * r4;
  const float r0_2 = r0 * r0;
  const float r0_6 = r0_2 * r0_2 * r0_2;
  const float r0_8 = r0_6 * r0_2;
  const float den6 = r6 + r0_6;
  const float den8 = r8 + r0_8;
  const float rec = 1.0f / (den6 * den8);
  const float den6_inv = rec * den8;
  const float den8_inv = rec * den6;
  const float damp = p.s6 * den6_inv + p.s8 * rr * den8_inv;
  const float dd6 = -6.0f * p.s6 * r4 * den6_inv * den6_inv;
  const float dd8 = -8.0f * p.s8 * rr * r6 * den8_inv * den8_inv;
  const float m = (-2.0f * p.k3) * damp * w_inv;
  e = -c6 * damp;
  coef = -c6 * (dd6 + dd8);
  dei = m * z_di;
  dej = m * z_dj;
}

// The three C6 contractions against a zm-wide candidate row (kernels 7, 8):
// f32 dot products of length zm on the CUDA cores.
__device__ __forceinline__ void wide_dots(int zm, const float* lrow,
                                          const float* crow, float& zacc,
                                          float& z_di, float& z_dj) {
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  for (int k = 0; k < zm; ++k) {
    const float l0 = lrow[k];
    const float rf = crow[k];
    a0 += l0 * rf;
    a1 += lrow[zm + k] * rf;
    a2 += l0 * crow[zm + k];
  }
  zacc = a0;
  z_di = a1;
  z_dj = a2;
}

// The same contractions in kernel 1's factored form: with z_j known, each is
// a mesh-term dot of the own row's band z_j against the candidate's e / edc
// (features kE.. and kE + mesh..).
template <int kE>
__device__ __forceinline__ void mesh_dots(const Params& p, const float* lrow,
                                          const float* cs, int ncand, int j,
                                          int zj, float& zacc, float& z_di,
                                          float& z_dj) {
  const int mesh = p.mesh;
  const float* l0 = lrow + zj * mesh;
  const float* l1c = l0 + p.zm;
  const float* ej = cs + kE * ncand + j;
  const float* edcj = cs + (kE + mesh) * ncand + j;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  for (int q = 0; q < mesh; ++q) {
    const float a = __ldg(l0 + q);
    const float b = __ldg(l1c + q);
    const float e = ej[q * ncand];
    a0 += a * e;
    a1 += b * e;
    a2 += a * edcj[q * ncand];
  }
  zacc = a0;
  z_di = a1;
  z_dj = a2;
}

// ---------------------------------------------------------------------------
// Body structs: pair(p, o, lrow, cs, ncand, cf, fstride, j, out, jo) returns
// false when the pair contributes nothing; otherwise it writes kOut own-side
// and kJ j-side terms.  o holds the own slot's kOwn scalars.  reach_sq(p) is
// the squared distance beyond which the body adds nothing (the larger of the
// two cutoffs for the fused body): a sweep that tests it first runs pair()
// only on the pairs inside it.
// ---------------------------------------------------------------------------

#define CAND(f) cs[(f) * ncand + j]
#define BODY_ARGS                                                       \
  const Params &p, const float *o, const float *lrow, const float *cs, \
      int ncand, const float *cf, int fstride, int j, float *out, float *jo

// Pass 1: coordination numbers.  own/cand: px, py, pz, rcov.
struct CnBody {
  static constexpr int kOwn = 4, kCand = 4, kOut = 1, kJ = 1;
  static constexpr bool kWide = false;
  __device__ static float reach_sq(const Params& p) { return p.cutoff_sq; }
  __device__ static bool pair(BODY_ARGS) {
    const float dx = CAND(0) - o[0];
    const float dy = CAND(1) - o[1];
    const float dz = CAND(2) - o[2];
    const float d2 = dist2(dx, dy, dz);
    if (!inside(d2, p.cutoff_sq)) return false;
    out[0] = cn_term(p.k1, d2, o[3] + CAND(3));
    jo[0] = out[0];
    return true;
  }
};

// Pass 3: CN chain-rule forces.  own/cand: px, py, pz, rcov, decn.
struct ChainBody {
  static constexpr int kOwn = 5, kCand = 5, kOut = 3, kJ = 3;
  static constexpr bool kWide = false;
  __device__ static float reach_sq(const Params& p) { return p.cutoff_sq; }
  __device__ static bool pair(BODY_ARGS) {
    const float dx = CAND(0) - o[0];
    const float dy = CAND(1) - o[1];
    const float dz = CAND(2) - o[2];
    const float d2 = dist2(dx, dy, dz);
    if (!inside(d2, p.cutoff_sq)) return false;
    const float coef = chain_coef(p.k1, d2, o[3] + CAND(3), o[4] + CAND(4));
    out[0] = coef * dx;
    out[1] = coef * dy;
    out[2] = coef * dz;
    jo[0] = -out[0];
    jo[1] = -out[1];
    jo[2] = -out[2];
    return true;
  }
};

// Real-space Coulomb.  own/cand: px, py, pz, q.
struct CoulombBody {
  static constexpr int kOwn = 4, kCand = 4, kOut = 4, kJ = 4;
  static constexpr bool kWide = false;
  __device__ static float reach_sq(const Params& p) { return p.cutoff_sq; }
  __device__ static bool pair(BODY_ARGS) {
    const float dx = CAND(0) - o[0];
    const float dy = CAND(1) - o[1];
    const float dz = CAND(2) - o[2];
    const float d2 = dist2(dx, dy, dz);
    if (!inside(d2, p.cutoff_sq)) return false;
    float e, ncoef;
    coulomb_terms(p.alpha, d2, o[3] * CAND(3), e, ncoef);
    out[0] = e;
    out[1] = ncoef * dx;
    out[2] = ncoef * dy;
    out[3] = ncoef * dz;
    jo[0] = e;
    jo[1] = -out[1];
    jo[2] = -out[2];
    jo[3] = -out[3];
    return true;
  }
};

// Pass 2, D3 direct: energy, (dE/dr)/r forces, dE/dCN.
// own: px, py, pz, si, w.  Kernel 1 (kWide false): cand px, py, pz, si, w,
// z, e[mesh], edc[mesh].  Kernels 7, 8 (kWide true): cand px, py, pz, si, w
// and the zm-wide row cf.
template <bool Wide>
struct D3DirectBody {
  static constexpr int kOwn = 5, kCand = 5, kOut = 5, kJ = 4;
  static constexpr bool kWide = Wide;
  __device__ static float reach_sq(const Params& p) { return p.cutoff_sq; }
  __device__ static bool pair(BODY_ARGS) {
    const float dx = CAND(0) - o[0];
    const float dy = CAND(1) - o[1];
    const float dz = CAND(2) - o[2];
    const float d2 = dist2(dx, dy, dz);
    if (!inside(d2, p.cutoff_sq)) return false;
    const float w = o[4] * CAND(4);
    if (!(w > 1e-12f)) return false;  // every output is zero there
    float zacc, z_di, z_dj;
    if constexpr (Wide)
      wide_dots(p.zm, lrow, cf + j * fstride, zacc, z_di, z_dj);
    else
      mesh_dots<6>(p, lrow, cs, ncand, j, static_cast<int>(CAND(5)), zacc,
                   z_di, z_dj);
    float e, coef, dei, dej;
    d3_terms(p, d2, o[3] * CAND(3), w, zacc, z_di, z_dj, e, coef, dei, dej);
    out[0] = e;
    out[1] = coef * dx;
    out[2] = coef * dy;
    out[3] = coef * dz;
    out[4] = dei;
    jo[0] = -out[1];
    jo[1] = -out[2];
    jo[2] = -out[3];
    jo[3] = dej;
    return true;
  }
};

// Pass 2 with the real-space Coulomb pair on the same geometry, with its own
// cutoff (ccutoff_sq) and alpha (grid_d3.py:1535-1571).  own: px, py, pz,
// si, w, q.  Kernel 1: cand px, py, pz, si, w, z, q, e[mesh], edc[mesh];
// kernels 7, 8: cand px, py, pz, si, w, q and the zm-wide row.  Separate:
// own (e, fx, fy, fz, dei, ec, fcx, fcy, fcz), j (-fx, -fy, -fz, dej, ec,
// -fcx, -fcy, -fcz).  Combined: own (e, fx + fcx, .., dei, ec), j (-(fx +
// fcx), .., dej, ec).
template <bool Wide, bool Combine>
struct D3CoulombBody {
  static constexpr int kOwn = 6, kCand = 6;
  static constexpr int kOut = Combine ? 6 : 9, kJ = Combine ? 5 : 8;
  static constexpr bool kWide = Wide;
  __device__ static float reach_sq(const Params& p) {
    return fmaxf(p.cutoff_sq, p.ccutoff_sq);
  }
  __device__ static bool pair(BODY_ARGS) {
    constexpr int kQ = Wide ? 5 : 6;  // candidate charge feature
    const float dx = CAND(0) - o[0];
    const float dy = CAND(1) - o[1];
    const float dz = CAND(2) - o[2];
    const float d2 = dist2(dx, dy, dz);
    if (!(d2 > 1e-20f)) return false;
    const float w = o[4] * CAND(4);
    const bool d3ok = d2 < p.cutoff_sq && w > 1e-12f;
    const bool cok = d2 < p.ccutoff_sq;
    if (!d3ok && !cok) return false;
    float e = 0.0f, coef = 0.0f, dei = 0.0f, dej = 0.0f;
    if (d3ok) {
      float zacc, z_di, z_dj;
      if constexpr (Wide)
        wide_dots(p.zm, lrow, cf + j * fstride, zacc, z_di, z_dj);
      else
        mesh_dots<7>(p, lrow, cs, ncand, j, static_cast<int>(CAND(5)), zacc,
                     z_di, z_dj);
      d3_terms(p, d2, o[3] * CAND(3), w, zacc, z_di, z_dj, e, coef, dei, dej);
    }
    float ec = 0.0f, nc = 0.0f;
    if (cok) coulomb_terms(p.alpha, d2, o[5] * CAND(kQ), ec, nc);
    const float fx = coef * dx, fy = coef * dy, fz = coef * dz;
    const float gx = nc * dx, gy = nc * dy, gz = nc * dz;
    out[0] = e;
    out[4] = dei;
    out[5] = ec;
    jo[3] = dej;
    jo[4] = ec;
    if constexpr (Combine) {
      out[1] = fx + gx;
      out[2] = fy + gy;
      out[3] = fz + gz;
      jo[0] = -out[1];
      jo[1] = -out[2];
      jo[2] = -out[3];
    } else {
      out[1] = fx;
      out[2] = fy;
      out[3] = fz;
      out[6] = gx;
      out[7] = gy;
      out[8] = gz;
      jo[0] = -fx;
      jo[1] = -fy;
      jo[2] = -fz;
      jo[5] = -gx;
      jo[6] = -gy;
      jo[7] = -gz;
    }
    return true;
  }
};

#undef BODY_ARGS
#undef CAND

// ---------------------------------------------------------------------------
// A warp's queue of pair entries in shared memory, for sweeps that test the
// distance first and run a body only on the pairs inside it, at full warps
// (kernels 1, 4, 7 and 8).  push() appends the
// lanes' hits in lane order (ballot and popcount prefix); once 32 or more
// wait, pop() hands each lane one entry, in queue order, and keeps the rest.
// Entries are non-negative ints; pop() gives -1 to lanes past the end.
// ---------------------------------------------------------------------------

constexpr int kQueue = 64;  // < 32 waiting + one round of 32

struct WarpQueue {
  int* q;  // this warp's kQueue ints
  int n;   // entries waiting (uniform across the warp)

  __device__ void push(bool hit, int entry) {
    const unsigned lane = threadIdx.x & 31;
    const unsigned ball = __ballot_sync(0xffffffffu, hit);
    if (hit) q[n + __popc(ball & ((1u << lane) - 1u))] = entry;
    n += __popc(ball);
  }

  __device__ bool full() const { return n >= 32; }

  __device__ int pop() {
    const int lane = threadIdx.x & 31;
    __syncwarp();
    const int e = lane < n ? q[lane] : -1;
    __syncwarp();
    if (lane + 32 < n) q[lane] = q[lane + 32];
    __syncwarp();
    n = n > 32 ? n - 32 : 0;
    return e;
  }
};

// ---------------------------------------------------------------------------
// Shared by the zm-wide sweeps (row_sweep.cu, chunk_sweep.cu): block shape,
// shared-memory limit, half-space offset order, the rows' shared stride, the
// j flush, and the queued sweep of one staged chunk.
// ---------------------------------------------------------------------------

constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / 32;
constexpr size_t kMaxSmem = 232448;  // 227 KB per block on the H100

// Half-space (dz, dy) offset h in the order of halfspace_zy: (0, 1..ry),
// then dz = 1..rz with dy = -ry..ry.
__device__ __forceinline__ void half_offset(int h, int ry, int& dz, int& dy) {
  if (h < ry) {
    dz = 0;
    dy = h + 1;
  } else {
    const int k = h - ry;
    dz = 1 + k / (2 * ry + 1);
    dy = k % (2 * ry + 1) - ry;
  }
}

// Shared-memory stride of the zm-wide rows: odd, so lane-strided reads do
// not collide in the banks.
__host__ __device__ inline int feat_stride(int nf) { return nf ? (nf | 1) : 0; }

// Opts a kernel into smem bytes of dynamic shared memory (above 48 KB).
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// One pop of a warp's queue (kernels 7 and 8).  An entry is (own index <<
// 16) | candidate index into the staged own scalars os [kOwn][m] and rows ls
// [m][fstride] and candidates cs [kCand][w] and rows cf [w][fstride]; each
// lane runs the body on its entry and adds the j-side terms to the shared
// sums jacc[k * jstride + candidate].  Entries come off the queue in push
// order, so the lanes of one own slot are contiguous: a segmented reduction
// over the warp sums each slot's own-side terms into its first lane, which
// adds them to oacc[k][m] (one shared atomic per slot and output instead of
// one per lane: the lanes of a slot would collide on its address).  The
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
                                           float* jacc, int jstride) {
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
      for (int k = 0; k < Body::kJ; ++k)
        atomicAdd(&jacc[k * jstride + c], jo[k]);
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

// The distance-first sweep of one staged chunk (kernels 7 and 8): own slots
// of g consecutive own x-cells against their merged candidate window of
// (g + 2 rx) * cap slots (extended x-cells from the chunk's first own cell
// minus rx).  The block stages m own slots from the chunk's slot i0 on and
// w candidates from the window's slot c0 on: the whole chunk and window
// where they fit, slices of them where they do not (the wrappers' plans).
// The block's kWarps warps take the staged own slots in turn; a warp tests
// its slot (chunk slot i, cell gl = i / cap) against the staged candidates
// of the 2 rx + 1 x-cells around its cell (window cells gl .. gl + 2 rx),
// 32 at a time, r^2 rounded as the plain version rounds it against
// Body::reach_sq; the home row keeps candidates past the own slot (window
// slot > i + rx * cap: the own cell's later slots and the rx cells to its
// right).  Pairs further than rx cells apart in x lie beyond the cutoff.
// The hits of all of a warp's slots feed one queue (a slot meets only ~10
// pairs an offset), entries in staged indices, and whenever 32 wait each
// lane runs the body on one of them; the queue is drained before
// returning.  With kParked, an own slot with |px| >= parked is skipped
// without a test: the wrapper passes DISPLACE / 2 (grid.py: empty slots and
// padding atoms lie beyond it) only where such a slot can meet no candidate
// in reach, and +inf otherwise.
template <class Body, int kWarps, bool kParked>
__device__ __forceinline__ void sweep_chunk(const Params& p, const float* os,
                                            int m, int i0, const float* ls,
                                            const float* cs, int w, int c0,
                                            const float* cf, int fstride,
                                            int cap, int rx, bool home,
                                            float parked, int* qbuf,
                                            float* oacc, float* jacc,
                                            int jstride) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float reach = Body::reach_sq(p);
  const int tri = rx * cap;  // home: keep window slot > own slot + rx * cap
  WarpQueue queue{qbuf, 0};
  for (int ii = warp; ii < m; ii += kWarps) {
    const float ox = os[ii];
    if (kParked && !(fabsf(ox) < parked)) continue;  // warp-uniform
    const float oy = os[m + ii], oz = os[2 * m + ii];
    const int i = i0 + ii;
    const int gl = i / cap;
    // this slot's candidates, in staged indices
    const int j0 = max(home ? i + tri + 1 : gl * cap, c0) - c0;
    const int j1 = min((gl + 2 * rx + 1) * cap, c0 + w) - c0;
    for (int cr = j0; cr < j1; cr += 32) {
      const int c = cr + lane;
      bool hit = false;
      if (c < j1) {
        const float d2 = dist2(cs[c] - ox, cs[w + c] - oy, cs[2 * w + c] - oz);
        hit = inside(d2, reach);
      }
      queue.push(hit, ii << 16 | c);
      if (queue.full())
        run_queued<Body>(p, os, m, ls, cs, w, cf, fstride, queue, oacc, jacc,
                         jstride);
    }
  }
  if (queue.n)
    run_queued<Body>(p, os, m, ls, cs, w, cf, fstride, queue, oacc, jacc,
                     jstride);
}

// Stage m own slots from own slot own0 (scalars os [kOwn][m], and with the
// zm-wide body its rows ls [m][fstride] from lf) into shared memory and zero
// their sums oacc [kOut][m]; stage_cand likewise w candidates from extended
// slot cand0 (cs [kCand][w], rows cf [w][fstride] from cfeat).
template <class Body>
__device__ __forceinline__ void stage_own(const float* own, const float* lf,
                                          int64_t own_plane, int64_t own0,
                                          int m, int nf, int fstride,
                                          float* os, float* ls, float* oacc) {
  for (int t = threadIdx.x; t < Body::kOwn * m; t += blockDim.x) {
    const int f = t / m;
    os[t] = own[f * own_plane + own0 + (t - f * m)];
  }
  if (Body::kWide) {
    for (int t = threadIdx.x; t < m * nf; t += blockDim.x) {
      const int r = t / nf;
      ls[r * fstride + (t - r * nf)] = lf[(own0 + r) * nf + (t - r * nf)];
    }
  }
  for (int t = threadIdx.x; t < Body::kOut * m; t += blockDim.x) oacc[t] = 0.0f;
}

template <class Body>
__device__ __forceinline__ void stage_cand(const float* cand,
                                           const float* cfeat,
                                           int64_t ext_plane, int64_t cand0,
                                           int w, int nf, int fstride,
                                           float* cs, float* cf) {
  for (int t = threadIdx.x; t < Body::kCand * w; t += blockDim.x) {
    const int f = t / w;
    cs[t] = cand[f * ext_plane + cand0 + (t - f * w)];
  }
  if (Body::kWide) {
    for (int t = threadIdx.x; t < w * nf; t += blockDim.x) {
      const int r = t / nf;
      cf[r * fstride + (t - r * nf)] = cfeat[(cand0 + r) * nf + (t - r * nf)];
    }
  }
}

// After a barrier, adds the block's own sums oacc [kOut][m] into own_out[k *
// plane + base + t]: one global atomic per nonzero slot and output (the
// offsets of a row run in different blocks).
template <int kOut>
__device__ __forceinline__ void flush_own(const float* oacc, int m,
                                          float* own_out, int64_t plane,
                                          int64_t base) {
  __syncthreads();
  for (int t = threadIdx.x; t < kOut * m; t += blockDim.x) {
    const float v = oacc[t];
    const int k = t / m;
    if (v != 0.0f) atomicAdd(&own_out[k * plane + base + (t - k * m)], v);
  }
}

// Checks of a staging plan shared by kernels 7 and 8: queue entries pack
// (own index << 16 | candidate index), so the staged counts must stay below
// 2^15 and 2^16; at most 65,535 systems and own slices (grid y and z).
inline bool plan_ok(int n_sys, int m_s, int w_s, int n_split) {
  return n_sys >= 0 && n_sys <= 65535 && m_s >= 1 && m_s < 0x8000 &&
         w_s >= 1 && w_s <= 0xffff && n_split >= 1 && n_split <= 65535;
}

// After a barrier, adds the block's shared j sums jacc[kJ][n] into
// j_out[k * plane + base + t]: one global atomic per nonzero slot and output.
template <int kJ>
__device__ __forceinline__ void flush_j(const float* jacc, int n, float* j_out,
                                        int64_t plane, int64_t base) {
  __syncthreads();
  for (int t = threadIdx.x; t < kJ * n; t += blockDim.x) {
    const float v = jacc[t];
    const int k = t / n;
    if (v != 0.0f) atomicAdd(&j_out[k * plane + base + (t - k * n)], v);
  }
}

}  // namespace pair_bodies

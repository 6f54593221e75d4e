// SPDX-License-Identifier: Apache-2.0
//
// Half-space pair sweep over the halo atom grid, templated on a pass body.
//
// Replaces: nvalchemiops_tpu/pallas/window_sweep.py:window_sweep (the
// Mosaic kernel at :267, pallas_call at :417), which carries D3 passes 1-3
// (grid_d3.py:1380-1387, :1465-1534, :1612-1625) and the erfc Coulomb pass
// (grid.py:900-928).
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
// What bounds it on the H100.  The pair bodies are FP32-ALU and SFU bound
// (rsqrt, exp, a divide per pair inside the cutoff); device-memory traffic
// is small (each candidate window is read once per own cell, ~1-2 KB).
// Design: one block per own cell, one warp per own slot (lanes stride the
// candidates, so the own-side sum is a register accumulator plus one warp
// shuffle reduction), j-side sums go to shared memory with atomics that
// never collide inside a warp, and are flushed once per offset with one
// global atomic per candidate slot.  Pairs outside the cutoff (most of the
// cube-vs-sphere overcount, and every parked empty slot) leave after the
// distance test.  The global j atomics make the j-side sum order vary from
// run to run; that sets the on-card tolerance against the plain version.
//
// Interface: C, for ctypes.  Every pointer is a device pointer into a
// contiguous float32 tensor allocated by the Python wrapper; j_out must be
// zero on entry.  Returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

struct Params {
  float cutoff_sq, a1, a2, s6, s8, k1, k3, alpha;
  int zm, mesh;
  const float* lf;  // D3 direct: own left features [slots, 2 * zm]
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

// Candidate feature f of candidate j lives at cs[f * ncand + j].
#define CAND(f) cs[(f) * ncand + j]

// Pass 1: coordination-number logistic (grid_d3.py:1380-1387).
// own/cand features: px, py, pz, rcov.
struct CnBody {
  static constexpr int kOwn = 4, kOut = 1, kJ = 1;
  __device__ static bool pair(const Params& p, const float* o, int64_t,
                              const float* cs, int ncand, int j, float* out,
                              float* jo) {
    const float dx = CAND(0) - o[0];
    const float dy = CAND(1) - o[1];
    const float dz = CAND(2) - o[2];
    const float d2 = dist2(dx, dy, dz);
    if (!(d2 > 1e-20f && d2 < p.cutoff_sq)) return false;
    const float inv_r = rsqrtf(d2);
    const float rc = o[3] + CAND(3);
    const float f = 1.0f / (1.0f + expf(-p.k1 * (rc * inv_r - 1.0f)));
    out[0] = f;
    jo[0] = f;
    return true;
  }
};

// Pass 2: BJ-damped C6/C8 energy, (dE/dr)/r forces and dE/dCN
// (grid_d3.py:1465-1534).  own features: px, py, pz, si, w (+ the left
// feature row lf = [l0 | l1c] of width 2 * zm).  cand features: px, py, pz,
// si, w, z, e[mesh], edc[mesh].  The C6 interpolation needs no matmul: with
// z_j known, each bilinear is a mesh-term dot against the own row.
struct D3DirectBody {
  static constexpr int kOwn = 5, kOut = 5, kJ = 4;
  __device__ static bool pair(const Params& p, const float* o,
                              int64_t own_slot, const float* cs, int ncand,
                              int j, float* out, float* jo) {
    const float dx = CAND(0) - o[0];
    const float dy = CAND(1) - o[1];
    const float dz = CAND(2) - o[2];
    const float d2 = dist2(dx, dy, dz);
    if (!(d2 > 1e-20f && d2 < p.cutoff_sq)) return false;
    const float w = o[4] * CAND(4);
    if (!(w > 1e-12f)) return false;  // every output is zero there
    const int mesh = p.mesh;
    const int zj = static_cast<int>(CAND(5));
    const float* l0 = p.lf + own_slot * (2 * p.zm) + zj * mesh;
    const float* l1c = l0 + p.zm;
    const float* ej = cs + 6 * ncand + j;
    const float* edcj = cs + (6 + mesh) * ncand + j;
    float zacc = 0.0f, z_di = 0.0f, z_dj = 0.0f;
    for (int q = 0; q < mesh; ++q) {
      const float a = __ldg(l0 + q);
      const float b = __ldg(l1c + q);
      const float e = ej[q * ncand];
      zacc += a * e;
      z_di += b * e;
      z_dj += a * edcj[q * ncand];
    }
    const float w_inv = 1.0f / w;
    const float c6 = zacc * w_inv;
    const float t = o[3] * CAND(3);
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
    const float coef = -c6 * (dd6 + dd8);
    const float m = (-2.0f * p.k3) * damp * w_inv;
    out[0] = -c6 * damp;
    out[1] = coef * dx;
    out[2] = coef * dy;
    out[3] = coef * dz;
    out[4] = m * z_di;
    jo[0] = -out[1];
    jo[1] = -out[2];
    jo[2] = -out[3];
    jo[3] = m * z_dj;
    return true;
  }
};

// Pass 3: CN chain-rule forces (grid_d3.py:1612-1625).
// own/cand features: px, py, pz, rcov, decn.
struct ChainBody {
  static constexpr int kOwn = 5, kOut = 3, kJ = 3;
  __device__ static bool pair(const Params& p, const float* o, int64_t,
                              const float* cs, int ncand, int j, float* out,
                              float* jo) {
    const float dx = CAND(0) - o[0];
    const float dy = CAND(1) - o[1];
    const float dz = CAND(2) - o[2];
    const float d2 = dist2(dx, dy, dz);
    if (!(d2 > 1e-20f && d2 < p.cutoff_sq)) return false;
    const float inv_r = rsqrtf(d2);
    const float rrq = (o[3] + CAND(3)) * inv_r;
    const float f = 1.0f / (1.0f + expf(-p.k1 * (rrq - 1.0f)));
    const float dcn = -f * (1.0f - f) * p.k1 * rrq * inv_r * inv_r;
    const float coef = (o[4] + CAND(4)) * dcn;
    out[0] = coef * dx;
    out[1] = coef * dy;
    out[2] = coef * dz;
    jo[0] = -out[0];
    jo[1] = -out[1];
    jo[2] = -out[2];
    return true;
  }
};

// erfc-damped (alpha > 0) or bare (alpha == 0) Coulomb (grid.py:900-928).
// own/cand features: px, py, pz, q.
struct CoulombBody {
  static constexpr int kOwn = 4, kOut = 4, kJ = 4;
  __device__ static bool pair(const Params& p, const float* o, int64_t,
                              const float* cs, int ncand, int j, float* out,
                              float* jo) {
    const float dx = CAND(0) - o[0];
    const float dy = CAND(1) - o[1];
    const float dz = CAND(2) - o[2];
    const float d2 = dist2(dx, dy, dz);
    if (!(d2 > 1e-20f && d2 < p.cutoff_sq)) return false;
    const float inv_r = rsqrtf(d2);
    const float qq = o[3] * CAND(3);
    float phi, mag;
    if (p.alpha > 0.0f) {
      const float ar = p.alpha * (d2 * inv_r);
      const float erfc_ar = erfc_approx(ar);
      phi = erfc_ar * inv_r;
      mag = (erfc_ar * inv_r + 1.1283791670955126f * p.alpha * expf(-ar * ar)) *
            inv_r * inv_r;
    } else {
      phi = inv_r;
      mag = inv_r * inv_r * inv_r;
    }
    const float e = 0.5f * qq * phi;
    const float ncoef = -(qq * mag);
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

#undef CAND

template <class Body>
__global__ void __launch_bounds__(kThreads)
    sweep_kernel(const float* __restrict__ own, const float* __restrict__ cand,
                 float* __restrict__ own_out, float* __restrict__ j_out,
                 int cz, int cy, int cx, int rz, int ry, int rx, int cap,
                 int n_cand, Params p) {
  extern __shared__ float smem[];
  const int ncand = (2 * rx + 1) * cap;
  float* cs = smem;                             // [n_cand][ncand]
  float* jacc = cs + n_cand * ncand;            // [kJ][ncand]
  float* oacc = jacc + Body::kJ * ncand;        // [kOut][cap]

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

  for (int t = threadIdx.x; t < Body::kOut * cap; t += blockDim.x) oacc[t] = 0.0f;

  // oi = -1 is the home row; then the half-space (dz, dy) offsets.  The
  // skip test is uniform across the block, so the barriers stay matched.
  const int nyo = 2 * ry + 1;
  for (int oi = -1; oi < (2 * rz + 1) * nyo; ++oi) {
    const bool home = oi < 0;
    const int dz = home ? 0 : oi / nyo - rz;
    const int dy = home ? 0 : oi % nyo - ry;
    if (!home && !(dz > 0 || (dz == 0 && dy > 0))) continue;
    // extended cell (z + rz + dz, y + ry + dy, x): the window's first slot
    const int64_t row_base =
        ((static_cast<int64_t>(z + rz + dz) * ey + (y + ry + dy)) * ex + x) * cap;

    __syncthreads();  // the previous offset is done with cs and jacc
    for (int t = threadIdx.x; t < n_cand * ncand; t += blockDim.x) {
      const int f = t / ncand;
      cs[t] = cand[f * ext_plane + row_base + (t - f * ncand)];
    }
    for (int t = threadIdx.x; t < Body::kJ * ncand; t += blockDim.x) jacc[t] = 0.0f;
    __syncthreads();

    const int j0 = home ? rx * cap : 0;  // home: cells left of centre skipped
    for (int i = warp; i < cap; i += kWarps) {
      const int64_t own_slot = static_cast<int64_t>(cell) * cap + i;
      float o[Body::kOwn];
#pragma unroll
      for (int f = 0; f < Body::kOwn; ++f) o[f] = own[f * own_plane + own_slot];
      float acc[Body::kOut];
#pragma unroll
      for (int k = 0; k < Body::kOut; ++k) acc[k] = 0.0f;
      for (int j = j0 + lane; j < ncand; j += 32) {
        if (home && j < (rx + 1) * cap && j - rx * cap <= i) continue;
        float out[Body::kOut], jo[Body::kJ];
        if (!Body::pair(p, o, own_slot, cs, ncand, j, out, jo)) continue;
#pragma unroll
        for (int k = 0; k < Body::kOut; ++k) acc[k] += out[k];
#pragma unroll
        for (int k = 0; k < Body::kJ; ++k) atomicAdd(&jacc[k * ncand + j], jo[k]);
      }
#pragma unroll
      for (int k = 0; k < Body::kOut; ++k) {
        float v = acc[k];
        for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
        if (lane == 0) oacc[k * cap + i] += v;
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < Body::kJ * ncand; t += blockDim.x) {
      const float v = jacc[t];
      const int k = t / ncand;
      if (v != 0.0f) atomicAdd(&j_out[k * ext_plane + row_base + (t - k * ncand)], v);
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < Body::kOut * cap; t += blockDim.x) {
    const int k = t / cap;
    own_out[k * own_plane + static_cast<int64_t>(cell) * cap + (t - k * cap)] = oacc[t];
  }
}

template <class Body>
cudaError_t launch(const float* own, const float* cand, float* own_out,
                   float* j_out, int cz, int cy, int cx, int rz, int ry, int rx,
                   int cap, int n_cand, const Params& p, cudaStream_t stream) {
  const int ncells = cz * cy * cx;
  if (ncells == 0 || cap == 0) return cudaSuccess;
  const int ncand = (2 * rx + 1) * cap;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(n_cand + Body::kJ) * ncand +
                       static_cast<size_t>(Body::kOut) * cap);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sweep_kernel<Body>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  sweep_kernel<Body><<<ncells, kThreads, smem, stream>>>(
      own, cand, own_out, j_out, cz, cy, cx, rz, ry, rx, cap, n_cand, p);
  return cudaGetLastError();
}

}  // namespace

// body: 0 = CN, 1 = D3 direct, 2 = CN chain, 3 = Coulomb.
extern "C" int nv_window_sweep(int body, const float* own, const float* cand,
                               const float* lf, float* own_out, float* j_out,
                               int cz, int cy, int cx, int rz, int ry, int rx,
                               int cap, int n_cand, float cutoff_sq, float a1,
                               float a2, float s6, float s8, float k1, float k3,
                               float alpha, int zm, int mesh, void* stream) {
  const Params p{cutoff_sq, a1, a2, s6, s8, k1, k3, alpha, zm, mesh, lf};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (body) {
    case 0:
      return launch<CnBody>(own, cand, own_out, j_out, cz, cy, cx, rz, ry, rx,
                            cap, n_cand, p, st);
    case 1:
      return launch<D3DirectBody>(own, cand, own_out, j_out, cz, cy, cx, rz,
                                  ry, rx, cap, n_cand, p, st);
    case 2:
      return launch<ChainBody>(own, cand, own_out, j_out, cz, cy, cx, rz, ry,
                               rx, cap, n_cand, p, st);
    case 3:
      return launch<CoulombBody>(own, cand, own_out, j_out, cz, cy, cx, rz, ry,
                                 rx, cap, n_cand, p, st);
    default:
      return cudaErrorInvalidValue;
  }
}

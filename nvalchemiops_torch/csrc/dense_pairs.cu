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
// tile.  Here blocks run in any order: each CUDA block owns one (system,
// tile pair), its i-side sums stay in registers, its j-side sums go to
// shared memory, and both reach the outputs with one global atomicAdd per
// atom and output.  The C6 contractions are not matmuls: the j features are
// one-hot in z_j, so each is a mesh-term dot of the i row [l0w | l1cw] at
// offset z_j * mesh against (ew_j, edcw_j), for any element count.
//
// What bounds it on the H100.  FP32 ALU and SFU work: per pair and combo
// the BJ direct body does a divide and ~40 flops, the CN and chain bodies
// an exp and an rsqrt; device memory is read once per tile (64 atoms x F
// floats for each side).  Design: one thread per i atom, 64 threads per
// block; the j tile (and the i tile) stage in shared memory; at step k
// thread i meets j = (i + k) mod 64, so no two threads of the block touch
// the same j accumulator at once and the shared atomics never collide.
// The i rows of the direct body ([64, 2 zm] floats, 43 KB at zm = 85) are
// read through L1.  Atomic sums make the output order run-dependent; that
// sets the on-card tolerance against the plain version.
//
// Interface: C, for ctypes.  Pointers are device pointers into contiguous
// float32 tensors allocated by the Python wrapper, except combos (host, by
// value into the kernel parameters).  out [n_out, S, n_pad] must be zero on
// entry.  Returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kMaxCombos = 8;

struct Params {
  float cut2, a1, a2, s6, s8, k1, k3;
  int mesh, zm, n_combos;
  int combos[kMaxCombos];  // bit c set: second image on axis c
  const float* lw;         // direct: i rows [S, n_pad, 2 zm] = [l0w | l1cw]
};

// Feature f of tile atom a lives at tile[f * kTile + a].
struct Pair {
  const float* ti;  // i tile, feature-major
  const float* tj;  // j tile, feature-major
  int i, j;
  const float* cell;  // cell rows, [9]
  float base[3], sgn[3];

  __device__ float fi(int f) const { return ti[f * kTile + i]; }
  __device__ float fj(int f) const { return tj[f * kTile + j]; }

  // Minimum-image cartesian displacement and the per-axis image signs.  The
  // displacements and r^2 are rounded as the plain version rounds them, with
  // no fused multiply-add, so both take the same pairs at the cutoff: D3 has
  // no smooth cutoff, and a pair on the other side of it moves a force by
  // the whole pair term.
  __device__ void min_image() {
    float ds[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float d = fj(c) - fi(c);
      ds[c] = d - rintf(d);
      sgn[c] = ds[c] >= 0.0f ? 1.0f : -1.0f;
    }
#pragma unroll
    for (int ax = 0; ax < 3; ++ax)
      base[ax] = __fadd_rn(__fadd_rn(__fmul_rn(ds[0], cell[ax]),
                                     __fmul_rn(ds[1], cell[3 + ax])),
                           __fmul_rn(ds[2], cell[6 + ax]));
  }

  // Displacement of image combo `bits`; returns r^2.
  __device__ float combo(int bits, float* d) const {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) d[ax] = base[ax];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if ((bits >> c) & 1) {
#pragma unroll
        for (int ax = 0; ax < 3; ++ax)
          d[ax] = __fsub_rn(d[ax], __fmul_rn(sgn[c], cell[c * 3 + ax]));
      }
    }
    return __fadd_rn(__fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1])),
                     __fmul_rn(d[2], d[2]));
  }
};

__device__ __forceinline__ bool in_range(const Params& p, float r2) {
  return r2 < p.cut2 && r2 > 1e-20f;
}

// Pass 1: coordination numbers.  Features: fx fy fz rcov alive.
struct CnBody {
  static constexpr int kOut = 1, kJ0 = 0;
  __device__ static bool pair(const Params& p, Pair& q, int64_t, float* oi,
                              float* oj) {
    const float alive = q.fi(4) * q.fj(4);
    if (alive == 0.0f) return false;
    const float rc = q.fi(3) + q.fj(3);
    q.min_image();
    float acc = 0.0f;
    for (int k = 0; k < p.n_combos; ++k) {
      float d[3];
      const float r2 = q.combo(p.combos[k], d);
      if (!in_range(p, r2)) continue;
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
  static constexpr int kOut = 5, kJ0 = 1;
  __device__ static bool pair(const Params& p, Pair& q, int64_t i_row,
                              float* oi, float* oj) {
    const int mesh = p.mesh;
    const int zj = static_cast<int>(q.fj(4));
    const float* l0 = p.lw + i_row * (2 * p.zm) + zj * mesh;
    const float* l1c = l0 + p.zm;
    float zacc = 0.0f, zdi = 0.0f, zdj = 0.0f;
    for (int m = 0; m < mesh; ++m) {
      const float a = __ldg(l0 + m);
      const float e = q.fj(5 + m);
      zacc += a * e;
      zdi += __ldg(l1c + m) * e;
      zdj += a * q.fj(5 + mesh + m);
    }
    if (!(zacc >= 1e-12f)) return false;  // dead or unavailable: all zero
    const float c6m = zacc;
    const float zdiw = (-2.0f * p.k3) * zdi;
    const float zdjw = (-2.0f * p.k3) * zdj;
    const float t = q.fi(3) * q.fj(3);
    const float rr = t * t;
    const float r0 = p.a1 * t + p.a2;
    const float r0_2 = r0 * r0;
    const float r0_6 = r0_2 * r0_2 * r0_2;
    const float r0_8 = r0_6 * r0_2;
    q.min_image();
    float ds = 0.0f, fx = 0.0f, fy = 0.0f, fz = 0.0f;
    for (int k = 0; k < p.n_combos; ++k) {
      float d[3];
      const float r2 = q.combo(p.combos[k], d);
      if (!in_range(p, r2)) continue;
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
  static constexpr int kOut = 3, kJ0 = 0;
  __device__ static bool pair(const Params& p, Pair& q, int64_t, float* oi,
                              float* oj) {
    const float alive = q.fi(4) * q.fj(4);
    if (alive == 0.0f) return false;
    const float rc = q.fi(3) + q.fj(3);
    const float de_pair = q.fi(5) + q.fj(5);
    q.min_image();
    float fx = 0.0f, fy = 0.0f, fz = 0.0f;
    for (int k = 0; k < p.n_combos; ++k) {
      float d[3];
      const float r2 = q.combo(p.combos[k], d);
      if (!in_range(p, r2)) continue;
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

template <class Body>
__global__ void __launch_bounds__(kTile)
    dense_pairs_kernel(const float* __restrict__ feats,
                       const float* __restrict__ cells,
                       float* __restrict__ out, int n_pad, int n_feat,
                       Params p) {
  constexpr int kJ = Body::kOut - Body::kJ0;
  extern __shared__ float smem[];
  float* ti = smem;                     // [n_feat][kTile]
  float* tj = ti + n_feat * kTile;      // [n_feat][kTile]
  float* jacc = tj + n_feat * kTile;    // [kJ][kTile]
  float* cell = jacc + kJ * kTile;      // [9]

  // blockIdx.x -> upper-triangle tile pair (bi, bj), row-major
  const int nt = n_pad / kTile;
  int bi = 0, rem = blockIdx.x;
  while (rem >= nt - bi) {
    rem -= nt - bi;
    ++bi;
  }
  const int bj = bi + rem;
  const int s = blockIdx.y;
  const int t = threadIdx.x;
  const float* fs = feats + static_cast<int64_t>(s) * n_pad * n_feat;
  for (int k = t; k < n_feat * kTile; k += kTile) {
    const int a = k / n_feat;
    const int f = k - a * n_feat;
    ti[f * kTile + a] = fs[static_cast<int64_t>(bi * kTile + a) * n_feat + f];
    tj[f * kTile + a] = fs[static_cast<int64_t>(bj * kTile + a) * n_feat + f];
  }
  for (int k = t; k < kJ * kTile; k += kTile) jacc[k] = 0.0f;
  if (t < 9) cell[t] = cells[s * 9 + t];
  __syncthreads();

  const bool diag = bi == bj;
  const int64_t i_row = static_cast<int64_t>(s) * n_pad + bi * kTile + t;
  float acc[Body::kOut];
#pragma unroll
  for (int k = 0; k < Body::kOut; ++k) acc[k] = 0.0f;
  Pair q;
  q.ti = ti;
  q.tj = tj;
  q.i = t;
  q.cell = cell;
  for (int k = 0; k < kTile; ++k) {
    const int j = (t + k) & (kTile - 1);
    if (diag && j <= t) continue;
    q.j = j;
    float oi[Body::kOut], oj[Body::kOut];
    if (!Body::pair(p, q, i_row, oi, oj)) continue;
#pragma unroll
    for (int o = 0; o < Body::kOut; ++o) acc[o] += oi[o];
#pragma unroll
    for (int o = Body::kJ0; o < Body::kOut; ++o)
      atomicAdd(&jacc[(o - Body::kJ0) * kTile + j], oj[o]);
  }
  __syncthreads();

  const int64_t plane = static_cast<int64_t>(gridDim.y) * n_pad;
  const int64_t j_row = static_cast<int64_t>(s) * n_pad + bj * kTile + t;
#pragma unroll
  for (int o = 0; o < Body::kOut; ++o)
    if (acc[o] != 0.0f) atomicAdd(&out[o * plane + i_row], acc[o]);
#pragma unroll
  for (int o = Body::kJ0; o < Body::kOut; ++o) {
    const float v = jacc[(o - Body::kJ0) * kTile + t];
    if (v != 0.0f) atomicAdd(&out[o * plane + j_row], v);
  }
}

template <class Body>
cudaError_t launch(const float* feats, const float* cells, float* out, int S,
                   int n_pad, int n_feat, const Params& p,
                   cudaStream_t stream) {
  if (S == 0 || n_pad == 0) return cudaSuccess;
  if (n_pad % kTile) return cudaErrorInvalidValue;
  const int nt = n_pad / kTile;
  const int n_pairs = nt * (nt + 1) / 2;
  constexpr int kJ = Body::kOut - Body::kJ0;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(2 * n_feat + kJ) * kTile + 9);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dense_pairs_kernel<Body>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(n_pairs, S);
  dense_pairs_kernel<Body><<<grid, kTile, smem, stream>>>(feats, cells, out,
                                                          n_pad, n_feat, p);
  return cudaGetLastError();
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

// SPDX-License-Identifier: Apache-2.0
//
// Full-space voxel-stencil pair sweep, own side only (kernel 9).
//
// Replaces: nvalchemiops_tpu/pallas/stencil_sweep.py:stencil_sweep_fullspace
// (:46, the pallas_call at :107), which carries the stencil_* functions of
// stencil.py and passes 1 and 3 of the hybrid D3 engine.
//
// What it computes.  The occupancy-1 voxel grid keeps every field on flat
// planes: candidates ext [n_ext, Ez, F] with F = Ey*Ex + 2*pad and the (y, x)
// halo inline, pad = Ry*Ex + Rx, so a cell offset (dy, dx) is a column shift
// dy*Ex + dx; own planes [n_own, Cz, W0] with W0 = Ey*Ex (the halo columns
// of the own side parked at -DISPLACE, so ghost copies never act as own
// atoms).  Every own voxel visits all (2Rz+1)(2Ry+1)(2Rx+1) - 1 offsets and
// sums its own-side terms of both pair directions: no j-side scatter at all.
// Bodies (pair_bodies.cuh, own-side outputs): cn (own/ext: px, py, pz, rcov;
// out cn), chain (+ decn; out fx, fy, fz), coulomb (px, py, pz, q; out e,
// fx, fy, fz -- e is half the pair energy, as every pair is seen twice).
//
// What bounds it on the H100.  FP32-ALU and SFU work per pair inside the
// cutoff, at twice the pair visits of a half-space sweep (the bound counts
// each pair once, so the 2x shows as distance from it), and the instruction
// stream of the distance tests: ~340 offsets per own voxel at radius 3, a
// third of them in range.  The candidate planes are a few MB and stay in
// the 50 MB L2; loading each candidate once per own voxel that reaches it
// (this kernel's first design) was not what set its pace (PERF.md, kernel
// 9).
//
// Design: interior own voxels only (the halo columns of out are zero: the
// wrapper allocates it zeroed; a parked own voxel meets no pair).  A thread
// owns kTz consecutive own voxels of one (y, x) column, own column (y + Ry)
// * Ex + (x + Rx), with their features and sums in registers; the last
// segment of a column is ragged where kTz does not divide Cz.  For each
// (dy, dx) the thread streams the kTz + 2*Rz candidate rows of its column
// once, positions first and the other features only on a hit, and applies
// each row to the own voxels within Rz of it (skipping the self pair), so
// each candidate is loaded once per (dy, dx) instead of once per own voxel
// that reaches it.  At Rz = 3 the radius is a template argument, so the
// rows unroll and the dz tests fold away.  Neighbouring lanes take
// neighbouring interior columns, so each load of a warp is one coalesced
// run (two where a warp spans two y rows).  The (dy, dx) pairs are split
// over the warps of a block (up to kSlices), to keep the card full (only
// Cz*Cy*Cx / kTz threads own voxels); the slices' sums meet in shared
// memory and are added in slice order, so each output is written once with
// no atomics and equal bits run to run.  The wrapper picks kTz and the
// warps per body (kernels/stencil_sweep.py:PLAN).
//
// Interface: C, for ctypes.  Pointers are device pointers into contiguous
// float32 tensors allocated by the Python wrapper; out must be zero on
// entry (only the interior columns are written).  Returns the cudaError_t of
// the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_bodies.cuh"

namespace {

using namespace pair_bodies;

constexpr int kSlices = 16;  // most warps a block: slices of 32 columns

// Candidate row k of one (dy, dx) against a thread's own voxels t < nz:
// the pair (t, row k) has dz = k - rz - t and counts where |dz| <= rz, but
// the self pair.  Positions are loaded first, the other features only when
// some own voxel is in reach.
template <class Body, int kTz>
__device__ __forceinline__ void stencil_row(
    const Params& p, float reach, const float* cp, int64_t ext_plane, int k,
    int rz, int nz, bool centre, const float (&o)[kTz][Body::kOwn],
    float (&acc)[kTz][Body::kOut]) {
  float c[Body::kCand];
  c[0] = cp[0];
  c[1] = cp[ext_plane];
  c[2] = cp[2 * ext_plane];
  bool hit[kTz];
  bool any = false;
#pragma unroll
  for (int t = 0; t < kTz; ++t) {
    const int dz = k - rz - t;
    hit[t] = t < nz && dz >= -rz && dz <= rz && !(centre && dz == 0) &&
             inside(dist2(c[0] - o[t][0], c[1] - o[t][1], c[2] - o[t][2]),
                    reach);
    any |= hit[t];
  }
  if (!any) return;
#pragma unroll
  for (int f = 3; f < Body::kCand; ++f) c[f] = cp[f * ext_plane];
#pragma unroll
  for (int t = 0; t < kTz; ++t) {
    if (!hit[t]) continue;
    float po[Body::kOut], jo[Body::kJ];
    // feature f of this candidate is c[f]: one candidate, index 0
    if (!Body::pair(p, o[t], nullptr, c, 1, nullptr, 0, 0, po, jo)) continue;
#pragma unroll
    for (int q = 0; q < Body::kOut; ++q) acc[t][q] += po[q];
  }
}

// kRz > 0: the z radius at compile time, so the rows of a (dy, dx) unroll
// and the dz tests fold away (built for the radius 3 the stencil picks at
// three bins a cutoff); kRz = 0: rz at run time.
template <class Body, int kTz, int kRz>
__global__ void __launch_bounds__(32 * kSlices)
    stencil_kernel(const float* __restrict__ ext, const float* __restrict__ own,
                   float* __restrict__ out, int cz, int cy, int cx, int rz_run,
                   int ry, int rx, int n_chunks, Params p) {
  __shared__ float red[kSlices][kTz * Body::kOut][32];
  const int rz = kRz > 0 ? kRz : rz_run;
  const int ey = cy + 2 * ry;
  const int ex = cx + 2 * rx;
  const int w0 = ey * ex;
  const int pad = ry * ex + rx;
  const int f_w = w0 + 2 * pad;
  const int64_t n_own = static_cast<int64_t>(cz) * w0;
  const int64_t ext_plane = static_cast<int64_t>(cz + 2 * rz) * f_w;
  const int lane = threadIdx.x;
  const int slice = threadIdx.y;
  const int n_slices = blockDim.y;
  const int chunk = blockIdx.x % n_chunks;
  const int z0 = (blockIdx.x / n_chunks) * kTz;
  const int nz = min(kTz, cz - z0);
  const int ci = chunk * 32 + lane;  // interior column, y-major
  const bool active = ci < cy * cx;
  const int y = ci / cx;
  const int col = (y + ry) * ex + (ci - y * cx + rx);
  const float reach = Body::reach_sq(p);

  float o[kTz][Body::kOwn];
  float acc[kTz][Body::kOut];
#pragma unroll
  for (int t = 0; t < kTz; ++t) {
#pragma unroll
    for (int f = 0; f < Body::kOwn; ++f)
      o[t][f] = active && t < nz
                    ? own[f * n_own + static_cast<int64_t>(z0 + t) * w0 + col]
                    : 0.0f;
#pragma unroll
    for (int k = 0; k < Body::kOut; ++k) acc[t][k] = 0.0f;
  }
  // slice s of the block's warps takes the (dy, dx) pairs s, s + S, ...
  const int nxw = 2 * rx + 1;
  for (int pr = slice; active && pr < (2 * ry + 1) * nxw; pr += n_slices) {
    const int dy = pr / nxw - ry;
    const int dx = pr - (dy + ry) * nxw - rx;
    const bool centre = dy == 0 && dx == 0;
    // candidate row k of this (dy, dx) is ext row z0 + k
    const float* src =
        ext + static_cast<int64_t>(z0) * f_w + pad + dy * ex + dx + col;
    if constexpr (kRz > 0) {
#pragma unroll
      for (int k = 0; k < kTz + 2 * kRz; ++k)
        if (k < nz + 2 * kRz)
          stencil_row<Body, kTz>(p, reach, src + static_cast<int64_t>(k) * f_w,
                                 ext_plane, k, kRz, nz, centre, o, acc);
    } else {
      for (int k = 0; k < nz + 2 * rz; ++k)
        stencil_row<Body, kTz>(p, reach, src + static_cast<int64_t>(k) * f_w,
                               ext_plane, k, rz, nz, centre, o, acc);
    }
  }
#pragma unroll
  for (int t = 0; t < kTz; ++t)
#pragma unroll
    for (int q = 0; q < Body::kOut; ++q)
      red[slice][t * Body::kOut + q][lane] = acc[t][q];
  __syncthreads();
  // each output of the block's columns: the slices' sums in slice order
  for (int r = slice; r < kTz * Body::kOut; r += n_slices) {
    const int t = r / Body::kOut;
    const int q = r - t * Body::kOut;
    if (!active || t >= nz) continue;
    float v = 0.0f;
    for (int s = 0; s < n_slices; ++s) v += red[s][r][lane];
    out[q * n_own + static_cast<int64_t>(z0 + t) * w0 + col] = v;
  }
}

template <class Body, int kTz, int kRz>
cudaError_t launch(const float* ext, const float* own, float* out, int cz,
                   int cy, int cx, int rz, int ry, int rx, int slices,
                   const Params& p, cudaStream_t stream) {
  if (slices < 1 || slices > kSlices) return cudaErrorInvalidValue;
  const int n_chunks = (cy * cx + 31) / 32;
  const int64_t blocks =
      static_cast<int64_t>(n_chunks) * ((cz + kTz - 1) / kTz);
  if (blocks == 0) return cudaSuccess;
  stencil_kernel<Body, kTz, kRz><<<static_cast<unsigned>(blocks),
                                   dim3(32, slices), 0, stream>>>(
      ext, own, out, cz, cy, cx, rz, ry, rx, n_chunks, p);
  return cudaGetLastError();
}

template <class Body>
cudaError_t launch_tz(int tz, const float* ext, const float* own, float* out,
                      int cz, int cy, int cx, int rz, int ry, int rx,
                      int slices, const Params& p, cudaStream_t stream) {
#define LAUNCH(TZ, RZ)                                                      \
  launch<Body, TZ, RZ>(ext, own, out, cz, cy, cx, rz, ry, rx, slices, p, \
                       stream)
  if (tz == 2) return rz == 3 ? LAUNCH(2, 3) : LAUNCH(2, 0);
  if (tz == 4) return rz == 3 ? LAUNCH(4, 3) : LAUNCH(4, 0);
  return cudaErrorInvalidValue;
#undef LAUNCH
}

}  // namespace

// body: 0 = CN, 1 = CN chain, 2 = Coulomb; tz = own voxels a thread holds
// (2 or 4); slices = warps a block (1 .. 16).
extern "C" int nv_stencil_sweep(int body, const float* ext, const float* own,
                                float* out, int cz, int cy, int cx, int rz,
                                int ry, int rx, int tz, int slices,
                                float cutoff_sq, float k1, float alpha,
                                void* stream) {
  const Params p{cutoff_sq, 0.0f, 0.0f, 0.0f, 0.0f, k1, 0.0f, alpha, 0.0f, 0, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(B) \
  launch_tz<B>(tz, ext, own, out, cz, cy, cx, rz, ry, rx, slices, p, st)
  switch (body) {
    case 0: return LAUNCH(CnBody);
    case 1: return LAUNCH(ChainBody);
    case 2: return LAUNCH(CoulombBody);
    default: return cudaErrorInvalidValue;
  }
#undef LAUNCH
}

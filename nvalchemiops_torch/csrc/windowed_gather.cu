// SPDX-License-Identifier: Apache-2.0
//
// Per-tile B-spline spread and gather-with-gradient for the tile-windowed
// PME path (spline_windowed.py).
//
// Replaces: nvalchemiops_tpu/pallas/windowed_gather.py
//   - _gather_grad_planes (kernel _kernel :31, pallas_call :99): for each
//     mesh tile, contract every slot's axis B-spline rows (Sx, Sy, Sz, dSx,
//     dSy, dSz) against the tile's W^3 potential window -> potential and
//     three fractional-gradient components per slot, four [t, cap] planes;
//   - _spread_windows (kernel _spread_kernel :111, pallas_call :151): the
//     per-tile spread window [W, W*W] = (q Sz)^T (Sy (x) Sx) over the tile's
//     slots, [t, W, W*W].
// The window extraction, the per-atom pick, the tiles.inv rotation and the
// parity fold of overlapping windows onto the mesh stay in torch, as they
// stayed in XLA.
//
// What bounds them on the H100.  Bytes: the spread reads q and the Sx | Sy
// | Sz columns of smat and writes the windows (at the main path's 128^3
// mesh, 4,096 tiles of cap 40 and W = 12: 24 MB + 28 MB, 0.016 ms at
// 3.35 TB/s); the gather reads all of smat and the windows (47 MB + 28 MB,
// 0.023 ms) and writes four planes.  The TPU kernels built the dense [W,
// cap] x [cap, W^2] products on the matrix unit (with one-hot matmuls, as
// Mosaic could not reshape [cap, W, W]).  Done densely here, both are
// bound by shared-memory loads: W^3 cap multiply-adds per tile, of which
// all but order^3 per slot are exact zeros (an order-4 row has 4 of its W
// columns non-zero per axis).
//
// Gather design: band only, staged coalesced, four threads a slot.  A
// block takes up to 64 consecutive slots of one tile: the whole tile where
// the tiles give two blocks an SM (the main path's 4,096), else a tile's
// slots split over several blocks (the 64 tiles of the W = 20 batch), so
// the card fills at small t.  All threads stage the tile's window and the
// slots' smat rows into shared memory with 16-byte cp.async copies, then
// OR each slot's non-zero S | dS columns into one bit mask per axis (a
// shared atomicOr per float4).  Each mask gives the slot's band start:
// four columns (moved left at the window's edge), or every column the
// non-zero ones span where that is wider (any row works, up to a dense
// one).  Each of the slot's four threads then contracts one z row of the
// band against its 4 x 4 (y, x) window entries (16 window reads, ~50
// multiply-adds), and a butterfly shuffle over the four lanes sums the
// value and three gradient components; lane a writes plane a.  A skipped
// term has an exactly-zero factor, so for finite inputs the result equals
// the dense sum.
//
// Spread design: output-stationary and band-skipping.  A block holds whole
// tiles (4 of W = 8, 2 of W = 12, 1 of W = 20) and stages q*Sz, Sy and Sx of
// up to kStage slots per tile in shared memory (16-byte loads), with one
// packed pair of words per slot, found by scanning its rows (any row
// works, up to a dense one): the non-zero columns of Sy and of Sx as bit
// masks, and the first and last non-zero column of q*Sz.  Each thread owns
// one (y, x) column of one window and keeps its W z-sums in registers.
// Per slot it reads the pair (a broadcast) and, only if its Sy[y] and
// Sx[x] are non-zero, adds q Sz[z] * (Sy[y] Sx[x]) over the z band: as
// four fixed z when the band is at most four wide (order <= 4), else over
// the band.  A skipped term has a factor that is exactly +-0, so for
// finite inputs the sum equals the dense one.  Stores are z-major, so
// consecutive threads write consecutive (y, x).  Neither kernel uses
// atomics on its outputs: every output has one writer that adds in a fixed
// order, so both are deterministic (two launches give equal bits).
//
// Interface: C, for ctypes.  Pointers are device pointers into contiguous
// float32 tensors the Python wrapper allocated (16-byte aligned for the
// gather's copies).  W is a template argument
// (tiles 4, 8, 16 -> W 8, 12, 20); the wrapper rejects other tiles.
// Returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// Gather (kernel 2)
// ---------------------------------------------------------------------------

constexpr int kGatherMaxSlots = 64;  // slots a block takes, 4 threads each

// Shared stride of a staged smat row: 16-byte aligned, and the rows of the
// 8 slots a warp holds start on 8 different bank quads.
template <int W>
__host__ __device__ constexpr int gather_row_stride() {
  return 6 * W + 4;
}

template <int W>
__host__ __device__ constexpr size_t gather_smem_bytes(int slots) {
  const size_t rows = static_cast<size_t>(slots) * gather_row_stride<W>();
  return sizeof(float) * (static_cast<size_t>(W) * W * W + rows) +
         sizeof(unsigned) * 3 * slots;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// A slot's band on one axis from the bit mask of its non-zero S | dS
// columns: four columns from `start` (moved left at the window's edge) when
// the non-zero columns span at most four, else every column they span.
template <int W>
__device__ __forceinline__ void axis_band(unsigned m, int& start, int& len) {
  const int lo = __ffs(m) - 1;
  const int hi = 31 - __clz(m);
  if (hi - lo < 4) {
    start = min(lo, W - 4);
    len = 4;
  } else {
    start = lo;
    len = hi - lo + 1;
  }
}

// One thread's share of a slot: the band's z rows a, a + 4, ... against
// its y and x bands.  r is the slot's staged row (Sx | Sy | Sz | dSx | dSy
// | dSz); Fixed: every band four wide (order <= 4), loops fully unrolled.
template <int W, bool Fixed>
__device__ __forceinline__ void gather_share(const float* r, const float* sw,
                                             int a, int xs, int xn, int ys,
                                             int yn, int zs, int zn, float& v,
                                             float& gx, float& gy, float& gz) {
  constexpr int WW = W * W;
  if (Fixed) xn = yn = zn = 4;
  for (int z = zs + a; z < zs + zn; z += 4) {
    const float sz = r[2 * W + z];
    const float dsz = r[5 * W + z];
    if (sz == 0.0f && dsz == 0.0f) continue;
    float q = 0.0f, qx = 0.0f, qy = 0.0f;
#pragma unroll
    for (int b = 0; b < (Fixed ? 4 : yn); ++b) {
      const int y = ys + b;
      const float sy = r[W + y];
      const float dsy = r[4 * W + y];
      const float* row = sw + z * WW + y * W + xs;
      float px = 0.0f, pdx = 0.0f;
#pragma unroll
      for (int c = 0; c < (Fixed ? 4 : xn); ++c) {
        const float m = row[c];
        px = fmaf(r[xs + c], m, px);
        pdx = fmaf(r[3 * W + xs + c], m, pdx);
      }
      q = fmaf(sy, px, q);
      qx = fmaf(sy, pdx, qx);
      qy = fmaf(dsy, px, qy);
    }
    v = fmaf(sz, q, v);
    gx = fmaf(sz, qx, gx);
    gy = fmaf(sz, qy, gy);
    gz = fmaf(dsz, q, gz);
  }
}

// Block: `slots` consecutive slots of one tile (chunk blockIdx % chunks of
// tile blockIdx / chunks), 4 threads a slot.  Stages the tile's window and
// the slots' rows with cp.async, ORs each slot's non-zero columns into a
// mask per axis, then each thread contracts one z row of its slot's band;
// a butterfly over the slot's 4 lanes leaves every sum in every lane, and
// lane a writes output plane a.
template <int W>
__global__ void __launch_bounds__(4 * kGatherMaxSlots)
    gather_grad_kernel(const float* __restrict__ smat,
                       const float* __restrict__ win, float* __restrict__ val,
                       float* __restrict__ gx, float* __restrict__ gy,
                       float* __restrict__ gz, int cap, int slots,
                       int chunks) {
  constexpr int WW = W * W;
  constexpr int kWin = W * WW;
  constexpr int kStride = gather_row_stride<W>();
  constexpr int kV = 6 * W / 4;        // float4s of an smat row
  extern __shared__ __align__(16) float gsm[];
  float* sw = gsm;                     // window [z][y * W + x]
  float* rows = sw + kWin;             // [slots][kStride]
  unsigned* masks = reinterpret_cast<unsigned*>(rows + slots * kStride);

  const int tile = static_cast<int>(blockIdx.x) / chunks;
  const int c0 = (static_cast<int>(blockIdx.x) - tile * chunks) * slots;
  const int64_t t = tile;
  const int ns = min(slots, cap - c0);
  const float* wsrc = win + t * kWin;
  const float* rsrc = smat + (t * cap + c0) * (6 * W);
  for (int k = threadIdx.x; k < kWin / 4; k += blockDim.x)
    cp_async16(sw + 4 * k, wsrc + 4 * k);
  for (int k = threadIdx.x; k < ns * kV; k += blockDim.x) {
    const int s = k / kV;
    const int j = 4 * (k - s * kV);
    cp_async16(rows + s * kStride + j, rsrc + s * (6 * W) + j);
  }
  for (int k = threadIdx.x; k < 3 * slots; k += blockDim.x) masks[k] = 0u;
  cp_async_wait_all();
  __syncthreads();
  // band masks: the non-zero columns of S and dS of each axis (a float4
  // never straddles two axis blocks: W is a multiple of 4)
  for (int k = threadIdx.x; k < ns * kV; k += blockDim.x) {
    const int s = k / kV;
    const int j = 4 * (k - s * kV);
    const float4 e = *reinterpret_cast<const float4*>(rows + s * kStride + j);
    const unsigned m = (e.x != 0.0f ? 1u : 0u) | (e.y != 0.0f ? 2u : 0u) |
                       (e.z != 0.0f ? 4u : 0u) | (e.w != 0.0f ? 8u : 0u);
    const int blk = j / W;
    if (m) atomicOr(&masks[3 * s + blk % 3], m << (j - blk * W));
  }
  __syncthreads();

  const int s = threadIdx.x >> 2;
  const int a = threadIdx.x & 3;
  float v = 0.0f, sgx = 0.0f, sgy = 0.0f, sgz = 0.0f;
  if (s < ns) {
    const unsigned mx = masks[3 * s], my = masks[3 * s + 1];
    const unsigned mz = masks[3 * s + 2];
    // an all-zero axis puts a zero factor in every term
    if (mx && my && mz) {
      int xs, xn, ys, yn, zs, zn;
      axis_band<W>(mx, xs, xn);
      axis_band<W>(my, ys, yn);
      axis_band<W>(mz, zs, zn);
      const float* r = rows + s * kStride;
      if (xn == 4 && yn == 4 && zn == 4)
        gather_share<W, true>(r, sw, a, xs, xn, ys, yn, zs, zn, v, sgx, sgy,
                              sgz);
      else
        gather_share<W, false>(r, sw, a, xs, xn, ys, yn, zs, zn, v, sgx, sgy,
                               sgz);
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, o);
    sgx += __shfl_xor_sync(0xffffffffu, sgx, o);
    sgy += __shfl_xor_sync(0xffffffffu, sgy, o);
    sgz += __shfl_xor_sync(0xffffffffu, sgz, o);
  }
  if (s < ns) {
    float* dst = a == 0 ? val : (a == 1 ? gx : (a == 2 ? gy : gz));
    dst[t * cap + c0 + s] = a == 0 ? v : (a == 1 ? sgx : (a == 2 ? sgy : sgz));
  }
}

// ---------------------------------------------------------------------------
// Spread (kernel 3)
// ---------------------------------------------------------------------------

constexpr int kStage = 64;           // slots per tile staged at a time

// tiles per block: whole tiles, and about 256-416 threads
template <int W>
__host__ __device__ constexpr int tiles_per_block() {
  return W == 8 ? 4 : (W == 12 ? 2 : 1);
}

template <int W>
__host__ __device__ constexpr int spread_threads() {
  return (tiles_per_block<W>() * W * W + 31) / 32 * 32;
}

// Bit j set where r[j] != 0, for a W-wide row (W <= 20).
template <int W>
__device__ unsigned nonzero_mask(const float* r) {
  unsigned m = 0u;
#pragma unroll
  for (int j = 0; j < W; ++j) m |= (r[j] != 0.0f ? 1u : 0u) << j;
  return m;
}

// acc[z] += r[z] p for z in [z4, z4 + 4): the slot's z band (at most four
// wide) lies there, and the other terms have an exact-zero factor.
template <int W>
__device__ inline void add_four(float (&acc)[W], const float* r, int z4,
                                float p) {
#pragma unroll
  for (int s = 0; s <= W - 4; ++s) {
    if (s == z4) {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[s + k] = fmaf(r[s + k], p, acc[s + k]);
    }
  }
}

template <int W>
__global__ void __launch_bounds__(spread_threads<W>())
    spread_kernel(const float* __restrict__ smat, const float* __restrict__ q,
                  float* __restrict__ out, int64_t ntiles, int cap, int kw) {
  constexpr int WW = W * W;
  constexpr int TPB = tiles_per_block<W>();
  constexpr int kRow = 3 * W;                // q*Sz | Sy | Sx
  __shared__ __align__(16) float rows[TPB][kStage][kRow];
  // per slot: the non-zero columns of Sy (.x, bits 0-19) and Sx (.y); the
  // first and last non-zero column of q*Sz in .x bits 20-24 and 25-29
  __shared__ uint2 band[TPB][kStage];
  const int lt = threadIdx.x / WW;           // tile of this block
  const int col = threadIdx.x - lt * WW;     // y * W + x
  const int y = col / W;
  const int x = col - y * W;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * TPB;
  const bool owner = lt < TPB && t0 + lt < ntiles;
  float acc[W];
#pragma unroll
  for (int z = 0; z < W; ++z) acc[z] = 0.0f;

  for (int c0 = 0; c0 < cap; c0 += kStage) {
    const int nc = min(kStage, cap - c0);
    __syncthreads();  // the previous stage is consumed
    // stage Sx | Sy | Sz of each slot (16-byte loads: W and kw are
    // multiples of 4) as q*Sz | Sy | Sx
    constexpr int kV = kRow / 4;             // float4s of a staged row
#pragma unroll 4
    for (int k = threadIdx.x; k < TPB * nc * kV; k += blockDim.x) {
      const int tl = k / (nc * kV);
      const int c = (k - tl * nc * kV) / kV;
      const int j = 4 * (k - (tl * nc + c) * kV);  // column in Sx | Sy | Sz
      const int64_t t = t0 + tl;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      int dst = j < W ? 2 * W + j : (j < 2 * W ? j : j - 2 * W);
      if (t < ntiles) {
        const int64_t slot = t * cap + c0 + c;
        v = __ldg(reinterpret_cast<const float4*>(smat + slot * kw + j));
        if (j >= 2 * W) {
          const float qs = __ldg(q + slot);
          v = make_float4(qs * v.x, qs * v.y, qs * v.z, qs * v.w);
        }
      }
      *reinterpret_cast<float4*>(&rows[tl][c][dst]) = v;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < TPB * nc; k += blockDim.x) {
      const int tl = k / nc;
      const int c = k - tl * nc;
      const unsigned mz = nonzero_mask<W>(rows[tl][c]);
      const unsigned my = nonzero_mask<W>(rows[tl][c] + W);
      const unsigned mx = nonzero_mask<W>(rows[tl][c] + 2 * W);
      const unsigned zlo = mz ? __ffs(mz) - 1 : 0u;
      const unsigned zhi = mz ? 31 - __clz(mz) : 0u;
      band[tl][c] = mz ? make_uint2(my | zlo << 20 | zhi << 25, mx)
                       : make_uint2(0u, 0u);
    }
    __syncthreads();
    if (!owner) continue;
    for (int c = 0; c < nc; ++c) {
      const uint2 b = band[lt][c];
      if (((b.x >> y) & (b.y >> x) & 1u) == 0u) continue;
      const int zlo = (b.x >> 20) & 31, zhi = (b.x >> 25) & 31;
      const float* r = rows[lt][c];
      const float p = r[W + y] * r[2 * W + x];
      if (zhi - zlo < 4) {
        add_four<W>(acc, r, min(zlo, W - 4), p);
      } else {
#pragma unroll
        for (int z = 0; z < W; ++z) {
          if (z >= zlo && z <= zhi) acc[z] = fmaf(r[z], p, acc[z]);
        }
      }
    }
  }
  if (owner) {
    float* o = out + (t0 + lt) * W * WW + col;
#pragma unroll
    for (int z = 0; z < W; ++z) o[z * WW] = acc[z];
  }
}

// Slots a block takes: whole tiles where the tiles alone give two blocks an
// SM, else the tile's slots split over more blocks (multiples of 8 slots,
// so every warp is full).
inline int gather_slots(int ntiles, int cap) {
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      n_sm = 132;
  }
  const int max_chunks = (cap + 7) / 8;
  const int want = (2 * n_sm + ntiles - 1) / ntiles;
  const int chunks = want < 1 ? 1 : (want > max_chunks ? max_chunks : want);
  const int slots = ((cap + chunks - 1) / chunks + 7) / 8 * 8;
  return slots < kGatherMaxSlots ? slots : kGatherMaxSlots;
}

template <int W>
cudaError_t gather_launch(const float* smat, const float* win, float* val,
                          float* gx, float* gy, float* gz, int ntiles, int cap,
                          cudaStream_t stream) {
  const int slots = gather_slots(ntiles, cap);
  const int chunks = (cap + slots - 1) / slots;
  const size_t smem = gather_smem_bytes<W>(slots);
  static size_t opted = 48 * 1024;  // dynamic shared memory opted into
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        gather_grad_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    opted = smem;
  }
  gather_grad_kernel<W><<<ntiles * chunks, 4 * slots, smem, stream>>>(
      smat, win, val, gx, gy, gz, cap, slots, chunks);
  return cudaGetLastError();
}

template <int W>
cudaError_t spread_launch(const float* smat, const float* q, float* out,
                          int ntiles, int cap, int kw, cudaStream_t stream) {
  constexpr int TPB = tiles_per_block<W>();
  const unsigned blocks = static_cast<unsigned>((ntiles + TPB - 1) / TPB);
  spread_kernel<W><<<blocks, spread_threads<W>(), 0, stream>>>(
      smat, q, out, ntiles, cap, kw);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nv_windowed_gather_grad(const float* smat, const float* win,
                                       float* val, float* gx, float* gy,
                                       float* gz, int ntiles, int cap, int kw,
                                       int w_win, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ntiles == 0 || cap == 0) return cudaSuccess;
  if (kw != 6 * w_win) return cudaErrorInvalidValue;
  switch (w_win) {
    case 8:
      return gather_launch<8>(smat, win, val, gx, gy, gz, ntiles, cap, st);
    case 12:
      return gather_launch<12>(smat, win, val, gx, gy, gz, ntiles, cap, st);
    case 20:
      return gather_launch<20>(smat, win, val, gx, gy, gz, ntiles, cap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int nv_windowed_spread(const float* smat, const float* q, float* out,
                                  int ntiles, int cap, int kw, int w_win,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ntiles == 0) return cudaSuccess;
  switch (w_win) {
    case 8:
      return spread_launch<8>(smat, q, out, ntiles, cap, kw, st);
    case 12:
      return spread_launch<12>(smat, q, out, ntiles, cap, kw, st);
    case 20:
      return spread_launch<20>(smat, q, out, ntiles, cap, kw, st);
    default:
      return cudaErrorInvalidValue;
  }
}

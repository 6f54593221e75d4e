// SPDX-License-Identifier: Apache-2.0
//
// Dense separable B-spline spread and gather for the dense PME path
// (spline.py dense_*_single, pme.py batched dense engine and the tile
// overflow fallback).
//
// Replaces: nvalchemiops_tpu/pallas/spread.py
//   - pallas_separable_spread (:45, pallas_call :60):
//       mesh[x, y, z] = sum_n qsx[n, x] sy[n, y] sz[n, z];
//   - pallas_separable_gather (:87, pallas_call :99):
//       out[n] = sum_xyz mesh[x, y, z] sx[n, x] sy[n, y] sz[n, z].
// The TPU kernels take the dense per-axis matrices [N, n_mesh] and
// contract them on the matrix unit with the whole mesh resident in VMEM.
// Each dense row is the one-hot expansion of the atom's order-point stencil
// (spline.py:284-289), so these kernels take the stencil itself, gidx [B, N,
// 3, order] (wrapped indices) and w [B, N, 3, order], with a leading system
// axis so the batched PME is one launch.  The gather with derivative
// weights dw computes the value and the three fractional-gradient gathers of
// dense_gather_gradient_single in one pass; each gradient component is the
// gather of kernel 6 with the weights of one axis swapped for their
// derivatives, so this is the function of four pallas_separable_gather
// calls.
//
// What bounds them on the H100.  Bytes: the stencil and charges read once
// (52 bytes an atom at order 4) and the mesh written (spread) or read
// (gather) once: 128 KB per 32^3 mesh, 8 MB at 128^3; the flops (order^3
// points an atom) are far below the FP32 roof.  A spread that adds each
// (atom, point) into device memory with a float atomic is bound instead by
// the atomics' round trips to L2 (~65 G/s measured, 10-20x the byte
// bound); one that adds into shared memory by its atomics there and by
// the scan of the atoms each slab's block makes.  The gather reads order^3
// mesh points an atom, 16 z-rows of 4 points at order 4, scattered over
// its system's mesh: read through L2 they cost a 32-byte sector or two
// each, ~5x the bytes of the stencil when the atoms come in random order,
// and a gather that keeps too few stencil bytes in flight is bound by the
// latency of its loads instead.
//
// Design.  Spread: owner computes, with no global atomics.  The mesh is cut
// into slabs of whole x-planes (of y-rows where one plane does not fit),
// each owned by one block that accumulates it in shared memory and writes
// it once with coalesced stores, so the output needs no memset.  The slab
// plan (planes, rows, slabs) is kernels/separable_spline.py's spread_plan,
// which thins the slabs while the batch stays within one block per SM.  A
// block scans its system's atoms in rounds: each thread tests kScan atoms'
// x-points against its planes, from a compact copy of their x-bases (4
// bytes an atom, coalesced: the stencil is consecutive mod n along each
// axis, as spline._stencil builds it; loads in flight together, the next
// round's during this round's spread), and the warps append every (atom,
// x-point) inside to a list in shared memory (a ballot and one count
// atomic per warp and x-point).  Then one thread per pair adds that
// plane's order^2 (y, z) points q wx wy wz into the slab, a thin slab
// spreading no more than its share.  The slab holds 64-bit fixed-point
// sums (scale 2^e from the system's sum |q|, which bounds every mesh
// value): each term is exact in it to 2^-e, and is added with 32-bit
// integer atomics (native, where float atomics in shared memory are a
// compare-and-swap loop), so the result does not depend on the order of
// the adds: two launches give the same bits.  Each sum is rounded once to
// f32 when the slab is written.  (Thread-block clusters that shared the
// scan through distributed shared memory, float atomics, and warps that
// spread one atom's points across lanes measured slower; PERF.md.)
// Gather: the order is a template argument, so every loop unrolls and a
// thread loads its share of an atom's stencil once, 16-byte rows at order
// 4; it sums its rows as separable partial sums (z first: r and r_dz; then
// y; then x) and each output is written once in a fixed order, so two
// launches give the same bits.  Two paths, chosen by
// kernels/separable_spline.py's gather_plan from the mesh's size against
// shared memory and the atoms a block gets against the points it copies:
// - staged: block (system, slice) has the TMA copy the system's mesh into
//   shared memory in one bulk transfer behind an mbarrier while its
//   threads load their atoms' stencils, one atom a thread, then sums the
//   rows from there: HBM reads each mesh once and the 16 row reads of an
//   atom never leave the SM.  The slices fill the SMs (64 systems: two
//   each, 1,000 atoms a block).  Every block holds a whole mesh, so this
//   takes meshes up to ~38^3.
// - L2: rows read from device memory through L1/L2: one lane an atom, or,
//   for a batch too small to fill the card that way, a group of 16 lanes
//   (order 4) an atom, one (x, y) row a lane, summed by a fixed xor
//   butterfly and written by lanes 0-3.  The 128^3 fallback's atoms come
//   in lattice order, so their rows mostly hit L1.
// On the staged path one thread an atom read faster on an H100 (PERF.md)
// than groups of 16 or 4 lanes an atom fed a pass ahead, than a copy by
// 4-byte cp.async into rows padded against bank conflicts, and than
// blocks of one system's atoms reading their rows through L1.
//
// Interface: C, for ctypes.  Pointers are device pointers into contiguous
// tensors allocated by the Python wrapper (gidx int32, the rest float32).
// The spread also takes xbase [B, N] = gidx[:, :, 0, 0] contiguous and
// writes every mesh point; the gather takes gather_plan's lanes an atom
// and slices a system (0: the L2 path).  Returns the cudaError_t of the
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxOrder = 4;
constexpr int kThreads = 1024;        // spread block (spread_plan's threads)
constexpr int kScan = 8;              // atoms a thread tests per round
constexpr int kList = 8192;           // (atom, x-point) pairs a round holds
constexpr int kSmemLimit = 232448;    // shared memory a block may use
constexpr int kGatherThreads = 1024;  // staged gather block (gather_plan)
constexpr int kGatherL2Threads = 256; // L2 gather block
constexpr int kGatherStaticSmem = 16; // the staged block's barrier
constexpr unsigned kBulkBytes = 32768; // bytes of one bulk copy
constexpr unsigned kFull = 0xffffffffu;

// dynamic shared memory of a spread block: the slab's low and high words
// (each padded to whole int4s), then the pair list and its count
__host__ __device__ inline int slab_words(int px, int py, int nz) {
  return (px * py * nz + 3) & ~3;
}

__host__ __device__ inline size_t spread_smem(int px, int py, int nz) {
  return sizeof(int) * (2 * slab_words(px, py, nz) + kList + 4);
}

// v as a fixed-point integer of scale 2^e (exact: v 2^e is exact in f32
// and below 2^62 in magnitude), added into the 64-bit word (hi, lo) with a
// low-word atomic and, on a carry or a negative v, a high-word one.
// Integer addition is associative, so the sum does not depend on order.
__device__ inline void add_fixed(unsigned* lo, int* hi, float v, int e) {
  const long long f = __float2ll_rn(ldexpf(v, e));
  const unsigned flo = static_cast<unsigned>(f);
  const unsigned old = atomicAdd(lo, flo);
  const int h = static_cast<int>(f >> 32) + (old + flo < old ? 1 : 0);
  if (h != 0) atomicAdd(hi, h);
}

// One axis of an atom's stencil: O consecutive entries, 16-byte loads at
// order 4 (rows of 12 entries stay 16-byte aligned).
template <int O, typename T>
__device__ inline void load_axis(const T* p, T (&v)[O]) {
  if constexpr (O == 4) {
    using V = typename std::conditional<std::is_same<T, int>::value, int4,
                                        float4>::type;
    const V t = __ldg(reinterpret_cast<const V*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int k = 0; k < O; ++k) v[k] = __ldg(p + k);
  }
}

template <int O>
__global__ void __launch_bounds__(kThreads)
    spread_kernel(const int* __restrict__ gidx, const int* __restrict__ xbase,
                  const float* __restrict__ w, const float* __restrict__ q,
                  float* __restrict__ mesh, int N, int nx, int ny, int nz,
                  int px, int py, int x_slabs, int y_slabs, int round_atoms) {
  extern __shared__ int4 smem4[];
  const int nw = slab_words(px, py, nz);
  unsigned* lo = reinterpret_cast<unsigned*>(smem4);  // [px][py][nz] words
  int* hi = reinterpret_cast<int*>(lo + nw);
  int* list = hi + nw;
  int* count = list + kList;
  const int xs = blockIdx.x % x_slabs;
  const int ys = (blockIdx.x / x_slabs) % y_slabs;
  const int b = blockIdx.x / (x_slabs * y_slabs);
  const int x0 = xs * px;
  const int xw = max(0, min(px, nx - x0));
  const int y0 = ys * py;
  const int yw = min(py, ny - y0);
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < nw / 2; i += blockDim.x)
    smem4[i] = make_int4(0, 0, 0, 0);

  // the fixed-point scale: every mesh value is at most sum |q| (weights are
  // at most 1 and sum to 1 per axis), so with sum |q| < 2^k the scale 2^e,
  // e = 61 - k, keeps every partial sum below 2^62
  const int64_t sys = static_cast<int64_t>(b) * N;  // the system's atoms
  float qabs = 0.0f;
  for (int n = threadIdx.x; n < N; n += kThreads)
    qabs += fabsf(__ldg(q + sys + n));
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) qabs += __shfl_xor_sync(kFull, qabs, m);
  float* warp_sums = reinterpret_cast<float*>(list);
  if (lane == 0) warp_sums[threadIdx.x / 32] = qabs;
  __syncthreads();
  float qsum = 0.0f;
  for (int k = 0; k < kThreads / 32; ++k) qsum += warp_sums[k];
  int k2;
  frexpf(qsum * 1.0625f, &k2);  // margin for the rounding of the sum
  const int e = 61 - k2;
  __syncthreads();
  if (threadIdx.x == 0) *count = 0;
  __syncthreads();

  // x-bases of kScan atoms a thread, loaded a round ahead
  int gx[kScan];
  auto load_round = [&](int r0) {
    const int r1 = min(N, r0 + round_atoms);
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const int n = r0 + u * kThreads + threadIdx.x;
      gx[u] = n < r1 ? __ldg(xbase + sys + n) : -2 * O;
    }
  };
  load_round(0);
  for (int r0 = 0; r0 < N; r0 += round_atoms) {
    // scan: the warps append every (atom, x-point) inside the slab to the
    // list (x-point a of an atom is (base + a) mod nx), then the next
    // round's loads fly while this round spreads
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
#pragma unroll
      for (int a = 0; a < O; ++a) {
        int xa = gx[u] + a;
        // wrap once; a mesh narrower than the stencil needs the modulo
        xa = nx >= O ? (xa >= nx ? xa - nx : xa) : (xa < 0 ? xa : xa % nx);
        const bool hit =
            static_cast<unsigned>(xa - x0) < static_cast<unsigned>(xw);
        const unsigned mask = __ballot_sync(kFull, hit);
        if (mask == 0u) continue;
        const int leader = __ffs(mask) - 1;
        int at = 0;
        if (lane == leader) at = atomicAdd(count, __popc(mask));
        at = __shfl_sync(kFull, at, leader);
        if (hit)
          list[at + __popc(mask & ((1u << lane) - 1u))] =
              (r0 + u * kThreads + threadIdx.x) * O + a;
      }
    }
    __syncthreads();
    if (r0 + round_atoms < N) load_round(r0 + round_atoms);

    // spread: one thread per pair adds its x-plane's order^2 (y, z) points
    const int pairs = *count;
    for (int j = threadIdx.x; j < pairs; j += kThreads) {
      const int64_t atom = sys + list[j] / O;
      const int a = list[j] % O;
      const int* g = gidx + atom * 3 * O;
      const float* ww = w + atom * 3 * O;
      int sy[O], sz[O];
      float wy[O], wz[O];
      load_axis<O>(g + O, sy);
      load_axis<O>(g + 2 * O, sz);
      load_axis<O>(ww + O, wy);
      load_axis<O>(ww + 2 * O, wz);
      const int dx = __ldg(g + a) - x0;
      if (static_cast<unsigned>(dx) >= static_cast<unsigned>(xw)) continue;
      const float qx = __ldg(q + atom) * __ldg(ww + a);
      const int plane = dx * py * nz;
#pragma unroll
      for (int bb = 0; bb < O; ++bb) {
        const int y = sy[bb] - y0;
        if (static_cast<unsigned>(y) >= static_cast<unsigned>(yw)) continue;
        const float qxy = qx * wy[bb];
#pragma unroll
        for (int cc = 0; cc < O; ++cc) {
          const float v = qxy * wz[cc];
          if (v != 0.0f &&
              static_cast<unsigned>(sz[cc]) < static_cast<unsigned>(nz)) {
            const int at = plane + y * nz + sz[cc];
            add_fixed(lo + at, hi + at, v, e);
          }
        }
      }
    }
    __syncthreads();  // the list is spread
    if (threadIdx.x == 0) *count = 0;
    __syncthreads();
  }

  // write the slab: each 64-bit sum rounded once to f32 (NaN throughout
  // when the charges are not finite)
  float* dst = mesh + ((static_cast<int64_t>(b) * nx + x0) * ny + y0) * nz;
  const bool finite = isfinite(qsum);
  for (int i = threadIdx.x; i < xw * yw * nz; i += blockDim.x) {
    const int xi = i / (yw * nz);
    const int r = i - xi * yw * nz;  // y * nz + z within the slab's rows
    const int at = xi * py * nz + r;
    const long long f = (static_cast<long long>(hi[at]) << 32) |
                        static_cast<long long>(lo[at]);
    dst[static_cast<int64_t>(xi) * ny * nz + r] =
        finite ? ldexpf(__ll2float_rn(f), -e) : __int_as_float(0x7fc00000);
  }
}

template <int O>
cudaError_t spread_launch(const int* gidx, const int* xbase, const float* w,
                          const float* q, float* mesh, int B, int N, int nx,
                          int ny, int nz,
                          int px, int py, int x_slabs, int y_slabs,
                          cudaStream_t stream) {
  const size_t smem = spread_smem(px, py, nz);
  if (smem > static_cast<size_t>(kSmemLimit)) return cudaErrorInvalidValue;
  // an atom has at most min(O, px) x-points in a slab (O when the stencil
  // wraps a mesh narrower than itself): the round fits the list
  const int per_atom = nx >= O ? min(O, px) : O;
  const int round_atoms = min(kScan * kThreads, kList / per_atom);
  const cudaError_t e = cudaFuncSetAttribute(
      spread_kernel<O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  spread_kernel<O><<<static_cast<unsigned>(B) * x_slabs * y_slabs, kThreads,
                     smem, stream>>>(gidx, xbase, w, q, mesh, N, nx, ny, nz,
                                     px, py, x_slabs, y_slabs, round_atoms);
  return cudaGetLastError();
}

// ---- gather ---------------------------------------------------------------

// An atom's order^2 stencil rows (a, b) over a group of L lanes: L = 1, one
// lane all rows; L = kRowLanes<O>, lane j row (j / O, j % O) (order^2
// rounded up to a power of two, so the groups tile a warp and the
// butterfly is a fixed xor pattern).  NA x and NB y entries a lane.
template <int O>
constexpr int kRowLanes = O == 1 ? 1 : (O == 2 ? 4 : 16);

template <int O, int L, bool kGrad>
struct LaneStencil {
  static_assert(L == 1 || L == kRowLanes<O>, "lanes an atom: 1 or order^2");
  static constexpr int NA = L == 1 ? O : 1, NB = NA;
  int gx[NA] = {}, gy[NB] = {}, gz[O] = {};
  float wx[NA] = {}, wy[NB] = {}, wz[O] = {};
  float dx[NA] = {}, dy[NB] = {}, dz[O] = {};
  bool on = false;  // a live atom and a lane with a row
};

// N entries of one axis from entry `first` (N = O: the whole axis)
template <int O, int N, typename T>
__device__ inline void load_part(const T* p, int first, T (&v)[N]) {
  if constexpr (N == O)
    load_axis<O>(p, v);
  else
    v[0] = __ldg(p + first);
}

template <int O, int L, bool kGrad>
__device__ inline LaneStencil<O, L, kGrad> load_lane(
    const int* __restrict__ gidx, const float* __restrict__ w,
    const float* __restrict__ dw, int64_t atom, bool live, int j) {
  using S = LaneStencil<O, L, kGrad>;
  S s;
  if (!live || j >= O * O) return s;
  const int a0 = j / O, b0 = j % O;  // lane 0 of L = 1: the whole axes
  const int* g = gidx + atom * 3 * O;
  const float* ww = w + atom * 3 * O;
  s.on = true;
  load_part<O, S::NA>(g, a0, s.gx);
  load_part<O, S::NB>(g + O, b0, s.gy);
  load_axis<O>(g + 2 * O, s.gz);
  load_part<O, S::NA>(ww, a0, s.wx);
  load_part<O, S::NB>(ww + O, b0, s.wy);
  load_axis<O>(ww + 2 * O, s.wz);
  if constexpr (kGrad) {
    const float* dd = dw + atom * 3 * O;
    load_part<O, S::NA>(dd, a0, s.dx);
    load_part<O, S::NB>(dd + O, b0, s.dy);
    load_axis<O>(dd + 2 * O, s.dz);
  }
  return s;
}

// The lane's rows of the system's mesh m ([nx][ny][nz], from shared memory
// with kStaged, else through L1/L2) as separable partial sums: z first (r
// and r_dz), then y, then x; the terms (value, d/dx, d/dy, d/dz) summed
// over the group's lanes by a fixed xor butterfly, so every lane of the
// group holds the atom's four sums.
template <int O, int L, bool kGrad, bool kStaged>
__device__ inline void group_sums(const float* __restrict__ m, int ny, int nz,
                                  const LaneStencil<O, L, kGrad>& s,
                                  float (&t)[4]) {
  using S = LaneStencil<O, L, kGrad>;
  t[0] = t[1] = t[2] = t[3] = 0.0f;
  if (s.on) {
#pragma unroll
    for (int a = 0; a < S::NA; ++a) {
      float qv = 0.0f, qdy = 0.0f, qdz = 0.0f;
#pragma unroll
      for (int b = 0; b < S::NB; ++b) {
        const float* p = m + (s.gx[a] * ny + s.gy[b]) * nz;
        float r = 0.0f, rdz = 0.0f;
#pragma unroll
        for (int c = 0; c < O; ++c) {
          float x;
          if constexpr (kStaged)
            x = p[s.gz[c]];
          else
            x = __ldg(p + s.gz[c]);
          r += s.wz[c] * x;
          if constexpr (kGrad) rdz += s.dz[c] * x;
        }
        qv += s.wy[b] * r;
        if constexpr (kGrad) {
          qdy += s.dy[b] * r;
          qdz += s.wy[b] * rdz;
        }
      }
      t[0] += s.wx[a] * qv;
      if constexpr (kGrad) {
        t[1] += s.dx[a] * qv;
        t[2] += s.wx[a] * qdy;
        t[3] += s.wx[a] * qdz;
      }
    }
  }
#pragma unroll
  for (int k = L / 2; k > 0; k >>= 1) {
    t[0] += __shfl_xor_sync(kFull, t[0], k);
    if constexpr (kGrad) {
      t[1] += __shfl_xor_sync(kFull, t[1], k);
      t[2] += __shfl_xor_sync(kFull, t[2], k);
      t[3] += __shfl_xor_sync(kFull, t[3], k);
    }
  }
}

// lane j of the atom's group writes outputs j, j + L, ... (value, then
// the three gradient components): each output once
template <int L, bool kGrad>
__device__ inline void write_atom(float* __restrict__ val,
                                  float* __restrict__ grad, int64_t atom,
                                  int j, const float (&t)[4]) {
#pragma unroll
  for (int k0 = 0; k0 < (kGrad ? 4 : 1); k0 += L) {
    const int k = k0 + j;
    if (k == 0) val[atom] = t[0];
    if (kGrad && k >= 1 && k < 4)
      grad[atom * 3 + k - 1] = k == 1 ? t[1] : (k == 2 ? t[2] : t[3]);
  }
}

// Staged path: block (b, slice) has the TMA copy system b's mesh into shared
// memory in one bulk transfer (complete on an mbarrier) while its threads
// load their atoms' stencils, one atom a thread, then sums the atoms' rows
// out of shared memory; a slice of more atoms than threads takes more
// passes.
template <int O, bool kGrad>
__global__ void __launch_bounds__(kGatherThreads, 1)
    gather_staged_kernel(const float* __restrict__ mesh,
                         const int* __restrict__ gidx,
                         const float* __restrict__ w,
                         const float* __restrict__ dw, float* __restrict__ val,
                         float* __restrict__ grad, int N, int nx, int ny,
                         int nz, int slices) {
  extern __shared__ __align__(16) float staged[];
  __shared__ __align__(8) unsigned long long bar;
  const int b = blockIdx.x / slices;
  const int per = (N + slices - 1) / slices;
  const int n0 = (blockIdx.x % slices) * per;
  const int n1 = min(N, n0 + per);
  if (n0 >= n1) return;

  const unsigned bar_s = static_cast<unsigned>(__cvta_generic_to_shared(&bar));
  if (threadIdx.x == 0) {
    const unsigned bytes = 4u * nx * ny * nz;
    const char* src = reinterpret_cast<const char*>(
        mesh + static_cast<int64_t>(b) * nx * ny * nz);
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(staged));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_s));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                     "r"(bar_s), "r"(bytes)
                 : "memory");
    for (unsigned off = 0; off < bytes; off += kBulkBytes)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n" ::"r"(dst + off),
          "l"(src + off), "r"(min(kBulkBytes, bytes - off)), "r"(bar_s)
          : "memory");
  }
  const int64_t sys = static_cast<int64_t>(b) * N;
  int n = n0 + threadIdx.x;
  LaneStencil<O, 1, kGrad> s =
      load_lane<O, 1, kGrad>(gidx, w, dw, sys + n, n < n1, 0);
  __syncthreads();  // the barrier is initialised
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar_s)
      : "memory");
  for (; n < n1; n += blockDim.x) {
    float t[4];
    group_sums<O, 1, kGrad, true>(staged, ny, nz, s, t);
    write_atom<1, kGrad>(val, grad, sys + n, 0, t);
    const int next = n + blockDim.x;
    s = load_lane<O, 1, kGrad>(gidx, w, dw, sys + next, next < n1, 0);
  }
}

// L2 path: a group of L lanes an atom, 32 / L atoms a warp, rows read from
// the mesh in device memory through L1/L2.
template <int O, int L, bool kGrad>
__global__ void __launch_bounds__(kGatherL2Threads)
    gather_l2_kernel(const float* __restrict__ mesh,
                     const int* __restrict__ gidx, const float* __restrict__ w,
                     const float* __restrict__ dw, float* __restrict__ val,
                     float* __restrict__ grad, int64_t n_atoms, int N, int nx,
                     int ny, int nz) {
  const int lane = threadIdx.x & 31;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32 *
      (32 / L);
  if (first >= n_atoms) return;  // warp-uniform
  const int64_t atom = first + lane / L;
  const int j = lane % L;
  const bool live = atom < n_atoms;
  const LaneStencil<O, L, kGrad> s =
      load_lane<O, L, kGrad>(gidx, w, dw, atom, live, j);
  const int64_t points = static_cast<int64_t>(nx) * ny * nz;
  const float* m = mesh + (live ? atom / N : 0) * points;
  float t[4];
  group_sums<O, L, kGrad, false>(m, ny, nz, s, t);
  if (live) write_atom<L, kGrad>(val, grad, atom, j, t);
}

template <int O, bool kGrad>
cudaError_t gather_launch(const float* mesh, const int* gidx, const float* w,
                          const float* dw, float* val, float* grad, int B,
                          int N, int nx, int ny, int nz, int lanes, int slices,
                          cudaStream_t stream) {
  if (slices > 0) {
    const int smem = 4 * nx * ny * nz;
    const cudaError_t e = cudaFuncSetAttribute(
        gather_staged_kernel<O, kGrad>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    gather_staged_kernel<O, kGrad>
        <<<static_cast<unsigned>(B) * slices, kGatherThreads, smem, stream>>>(
            mesh, gidx, w, dw, val, grad, N, nx, ny, nz, slices);
    return cudaGetLastError();
  }
  if (lanes != 1 && lanes != kRowLanes<O>) return cudaErrorInvalidValue;
  const int64_t n_atoms = static_cast<int64_t>(B) * N;
  const int64_t blocks =
      (n_atoms * lanes + kGatherL2Threads - 1) / kGatherL2Threads;
  if (lanes == 1)
    gather_l2_kernel<O, 1, kGrad>
        <<<static_cast<unsigned>(blocks), kGatherL2Threads, 0, stream>>>(
            mesh, gidx, w, dw, val, grad, n_atoms, N, nx, ny, nz);
  else
    gather_l2_kernel<O, kRowLanes<O>, kGrad>
        <<<static_cast<unsigned>(blocks), kGatherL2Threads, 0, stream>>>(
            mesh, gidx, w, dw, val, grad, n_atoms, N, nx, ny, nz);
  return cudaGetLastError();
}

template <bool kGrad>
cudaError_t gather_order(int order, const float* mesh, const int* gidx,
                         const float* w, const float* dw, float* val,
                         float* grad, int B, int N, int nx, int ny, int nz,
                         int lanes, int slices, cudaStream_t st) {
  switch (order) {
    case 1:
      return gather_launch<1, kGrad>(mesh, gidx, w, dw, val, grad, B, N, nx,
                                     ny, nz, lanes, slices, st);
    case 2:
      return gather_launch<2, kGrad>(mesh, gidx, w, dw, val, grad, B, N, nx,
                                     ny, nz, lanes, slices, st);
    case 3:
      return gather_launch<3, kGrad>(mesh, gidx, w, dw, val, grad, B, N, nx,
                                     ny, nz, lanes, slices, st);
    default:
      return gather_launch<4, kGrad>(mesh, gidx, w, dw, val, grad, B, N, nx,
                                     ny, nz, lanes, slices, st);
  }
}

}  // namespace

extern "C" int nv_separable_spread(const int* gidx, const int* xbase,
                                   const float* w, const float* q, float* mesh,
                                   int B, int N,
                                   int order, int nx, int ny, int nz, int px,
                                   int py, int x_slabs, int y_slabs,
                                   void* stream) {
  if (order < 1 || order > kMaxOrder || px < 1 || py < 1 ||
      static_cast<int64_t>(x_slabs) * px < nx ||
      static_cast<int64_t>(y_slabs) * py < ny ||
      static_cast<int64_t>(N) * order >= (int64_t{1} << 31))
    return cudaErrorInvalidValue;
  if (static_cast<int64_t>(B) * nx * ny * nz == 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (order) {
    case 1:
      return spread_launch<1>(gidx, xbase, w, q, mesh, B, N, nx, ny, nz,
                              px, py, x_slabs, y_slabs, st);
    case 2:
      return spread_launch<2>(gidx, xbase, w, q, mesh, B, N, nx, ny, nz,
                              px, py, x_slabs, y_slabs, st);
    case 3:
      return spread_launch<3>(gidx, xbase, w, q, mesh, B, N, nx, ny, nz,
                              px, py, x_slabs, y_slabs, st);
    default:
      return spread_launch<4>(gidx, xbase, w, q, mesh, B, N, nx, ny, nz,
                              px, py, x_slabs, y_slabs, st);
  }
}

extern "C" int nv_separable_gather(const float* mesh, const int* gidx,
                                   const float* w, const float* dw, float* val,
                                   float* grad, int B, int N, int order, int nx,
                                   int ny, int nz, int lanes, int slices,
                                   void* stream) {
  if (order < 1 || order > kMaxOrder || slices < 0)
    return cudaErrorInvalidValue;
  // staged: one lane an atom, the mesh whole in 16-byte bulk units within
  // a block's shared memory beside its barrier
  const int64_t points = static_cast<int64_t>(nx) * ny * nz;
  if (slices > 0 && (lanes != 1 || points % 4 != 0 ||
                     4 * points + kGatherStaticSmem > kSmemLimit ||
                     reinterpret_cast<uintptr_t>(mesh) % 16 != 0))
    return cudaErrorInvalidValue;
  if (static_cast<int64_t>(B) * N == 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dw != nullptr
             ? gather_order<true>(order, mesh, gidx, w, dw, val, grad, B, N,
                                  nx, ny, nz, lanes, slices, st)
             : gather_order<false>(order, mesh, gidx, w, dw, val, grad, B, N,
                                   nx, ny, nz, lanes, slices, st);
}

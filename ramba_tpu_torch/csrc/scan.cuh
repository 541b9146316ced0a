// Fixed-order inclusive scan (cumsum, cumprod) of floats for Hopper (sm_90a),
// in one pass over the data.
//
// No Pallas kernel of ramba_tpu corresponds to it: XLA's scan gives the same
// bytes on every run, torch.cumsum on the card does not (its float scan's
// look-back order varies between calls).  This kernel repairs that fault of
// the port: the order of every operation is fixed by the tile index alone.
//
// What it computes: out[r, i] = x[r, 0] op x[r, 1] op ... op x[r, i] for
// each of `rows` contiguous rows of length n, op = + or *, in the
// accumulator type A (float for half and bfloat16 data, whose outputs are
// rounded from it once each; the data's own type otherwise).
//
// Design.  A row is cut into tiles of TILE = THREADS * ITEMS elements; a
// tile's thread t owns ITEMS consecutive elements.  Tile j of row r is tile
// g = r * tiles_per_row + j of the launch.  One launch: persistent CTAs take
// tiles in increasing g from a global counter (atomicAdd; the counter and
// the flags are cleared by a cudaMemsetAsync on the same stream first), so
// a tile only ever waits on tiles that running CTAs have already taken, and
// the lowest unfinished tile waits on nothing: this holds with any grid,
// a grid of 1 included.  Each tile, once:
//   1. is loaded into shared memory (coalesced, one pad slot per ITEMS
//      elements against bank conflicts in the chunk reads); each thread
//      folds its ITEMS elements left to right into registers (loc), and an
//      inclusive Kogge-Stone scan in shared memory over the THREADS thread
//      sums (log2(THREADS) fixed levels) gives each thread's exclusive
//      value and, last, the tile's total A_j;
//   2. publishes A_j (the value, then a release store of its flag), unless
//      it is a checkpoint;
//   3. gets its exclusive carry E_j, defined by the index alone (below);
//      one warp reads the published values, one thread folds them and
//      polls the checkpoint before it (acquire), and a __syncthreads hands
//      E_j to the CTA;
//   4. combines the thread's exclusive value and then E_j in front of each
//      of its outputs, and writes the tile out through shared memory.
// Out-of-range elements of a ragged last tile read the identity and come
// after every real element, so they change no real output.
//
// Carries.  Every tile j with j % K == K - 1 is a checkpoint.  Tile j's
// window starts at s = (j / K) * K, the tile after the last checkpoint
// c = s - 1 before it (s = 0: no checkpoint before it).  With
// L_j = A_s op A_{s+1} op ... op A_{j-1} folded left to right:
//   E_j = P_c op L_j   (P_c alone when j == s; L_j alone when s == 0),
// and a checkpoint publishes its inclusive prefix instead of its total:
//   P_j = P_c op (L_j op A_j)   ((L_j op A_j) alone when s == 0).
// So only checkpoints form a serial chain, tiles_per_row / K hops of one
// combine and one L2 round trip each; a tile reads at most K - 1 totals,
// all older than itself, and its window fold is done before it waits on
// P_c.  Rows of one tile wait on nothing.
//
// Sizing K.  At 2^28 float64 there are 65536 tiles of 32 KiB; the byte
// bound (1.2821 ms) leaves about 20 ns of card time per tile, so the data
// asks for about 51 tiles per microsecond.  The chain gives K tiles per hop:
// with a hop of some hundreds of ns up to about 1 us, K = 128 gives 512
// hops, about 0.5 ms at worst, inside the bound, and 128 tiles per hop;
// K = 32 would give 2048 hops, up to 2 ms, which would set the pace.  The
// tiles in flight (132 SMs x 4 CTAs = 528) exceed K, so a checkpoint waits
// on a hop rather than on loads.  A window's fold reads at most K - 1
// values (1 KB of float64 from L2 against the tile's 32 KiB).  The hop is
// measured on the card by scripts/scan_ab.py (a copy built with K = 1,
// where every tile is a checkpoint and the whole row one chain).
//
// Occupancy.  A CTA alternates between loading its tile and a stretch of
// barriers, look-back and stores, so the SM's bytes in flight grow with
// its CTAs.  Left alone, ptxas gives the float64 kernel 114 registers, 2
// CTAs an SM; MIN_CTAS = 4 caps it at 64 (a few bytes spilled), so 4 fit,
// with 37 KB of shared memory each.

// Bound on the H100: HBM bandwidth.  The least traffic is the data read
// once and the result written once, 2 * rows * n * sizeof(T) bytes at
// 3.35 TB/s; this design moves that, plus one value and one flag per tile
// and the counter (about 1 MB at 2^28 float64).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ramba {
namespace scan {
namespace {

constexpr int THREADS = 256;           // threads per CTA
constexpr int ITEMS = 16;              // consecutive elements per thread
constexpr int TILE = THREADS * ITEMS;  // elements per tile
constexpr int PADDED = TILE + TILE / ITEMS;
constexpr int K = 128;                 // tiles per checkpoint
constexpr int MIN_CTAS = 4;            // CTAs per SM the registers allow
constexpr int WARP = 32;
static_assert(K <= PADDED, "a window's values are staged in the tile buffer");

__device__ __forceinline__ int slot(int i) { return i + i / ITEMS; }

template <typename T> struct Acc { using type = T; };
template <> struct Acc<__half> { using type = float; };
template <> struct Acc<__nv_bfloat16> { using type = float; };

template <typename A, typename T> __device__ __forceinline__ A widen(T v) {
  return static_cast<A>(v);
}
template <> __device__ __forceinline__ float widen<float, __half>(__half v) {
  return __half2float(v);
}
template <> __device__ __forceinline__ float widen<float, __nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, typename A> __device__ __forceinline__ T narrow(A v) {
  return static_cast<T>(v);
}
template <> __device__ __forceinline__ __half narrow<__half, float>(float v) {
  return __float2half_rn(v);
}
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16, float>(
    float v) {
  return __float2bfloat16_rn(v);
}

struct OpSum {
  template <typename A> __device__ static A ident() { return A(0); }
  template <typename A> __device__ static A comb(A a, A b) { return a + b; }
};
struct OpProd {
  template <typename A> __device__ static A ident() { return A(1); }
  template <typename A> __device__ static A comb(A a, A b) { return a * b; }
};

// A tile's flag: 0 until its value is published.  The value is stored
// first, then the flag with release semantics at device scope; a reader
// polls with acquire and then reads the value past L1.
__device__ __forceinline__ void publish(unsigned* flag) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(flag), "r"(1u)
               : "memory");
}
__device__ __forceinline__ void wait_published(const unsigned* flag) {
  unsigned v;
  do {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                 : "=r"(v) : "l"(flag) : "memory");
  } while (v == 0);
}

// Inclusive Kogge-Stone scan of one value per thread: at level d every
// thread t >= d combines sh[t - d] in front of sh[t].  Leaves the scan in
// sh (synchronised), so sh[t - 1] is thread t's exclusive value and
// sh[THREADS - 1] the total.
template <typename A, class Op>
__device__ __forceinline__ void kogge_stone(A* sh, A v) {
  const int tid = threadIdx.x;
  sh[tid] = v;
  __syncthreads();
#pragma unroll
  for (int d = 1; d < THREADS; d <<= 1) {
    const A nv = tid >= d ? Op::comb(sh[tid - d], sh[tid]) : sh[tid];
    __syncthreads();
    sh[tid] = nv;
    __syncthreads();
  }
}

// One tile into shared memory, coalesced; the identity past the row's end.
template <typename T, typename A, class Op>
__device__ __forceinline__ void load_tile(const T* __restrict__ row, int64_t n,
                                          int64_t base, A* tile) {
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = k * THREADS + threadIdx.x;
    const int64_t g = base + i;
    tile[slot(i)] = g < n ? widen<A>(row[g]) : Op::template ident<A>();
  }
}

// Steps 2 and 3 for tile j (launch index g) of the row whose tile 0 is
// `row0`, run by warp 0.  `a` is the tile's total, `lb` K free slots of
// shared memory.  Returns E_j in lane 0 (unused when j == 0).
template <typename A, class Op>
__device__ __forceinline__ A look_back(A* val, unsigned* flag, int64_t row0,
                                       int64_t j, A a, A* lb) {
  const int lane = threadIdx.x;
  const int64_t g = row0 + j;
  const bool ckpt = j % K == K - 1;
  if (lane == 0 && !ckpt) {
    val[g] = a;
    publish(flag + g);
  }
  const int64_t s = j / K * K;
  const int m = (int)(j - s);  // totals in the window before j
  for (int q = lane; q < m; q += WARP) {
    wait_published(flag + row0 + s + q);
    lb[q] = __ldcg(val + row0 + s + q);
  }
  __syncwarp();
  A e = Op::template ident<A>();
  if (lane == 0) {
    A l = m > 0 ? lb[0] : Op::template ident<A>();
    for (int q = 1; q < m; ++q) l = Op::comb(l, lb[q]);
    const A mj = m > 0 ? Op::comb(l, a) : a;  // L_j op A_j
    if (s > 0) {
      wait_published(flag + row0 + s - 1);
      const A p = __ldcg(val + row0 + s - 1);
      e = m > 0 ? Op::comb(p, l) : p;
      if (ckpt) val[g] = Op::comb(p, mj);
    } else {
      e = l;
      if (ckpt) val[g] = mj;
    }
    if (ckpt) publish(flag + g);
  }
  return e;
}

template <typename T, class Op>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
scan_tiles(const T* __restrict__ x, typename Acc<T>::type* val,
           unsigned long long* next, unsigned* flag, T* __restrict__ out,
           int64_t n, int64_t tiles_per_row, int64_t num_tiles) {
  using A = typename Acc<T>::type;
  __shared__ A tile[PADDED];
  __shared__ A sh[THREADS];
  __shared__ int64_t taken;
  __shared__ A carry;
  const int tid = threadIdx.x;
  for (;;) {
    if (tid == 0) taken = (int64_t)atomicAdd(next, 1ull);
    __syncthreads();
    const int64_t g = taken;
    if (g >= num_tiles) break;
    const int64_t r = g / tiles_per_row;
    const int64_t j = g - r * tiles_per_row;
    load_tile<T, A, Op>(x + r * n, n, j * TILE, tile);
    __syncthreads();
    A loc[ITEMS];
    loc[0] = tile[slot(tid * ITEMS)];
#pragma unroll
    for (int k = 1; k < ITEMS; ++k)
      loc[k] = Op::comb(loc[k - 1], tile[slot(tid * ITEMS + k)]);
    kogge_stone<A, Op>(sh, loc[ITEMS - 1]);
    // the tile buffer is free until the outputs are written: the window's
    // values are staged in it
    if (tid < WARP) {
      const A e = look_back<A, Op>(val, flag, r * tiles_per_row, j,
                                   sh[THREADS - 1], tile);
      if (tid == 0) carry = e;
    }
    __syncthreads();
    const A e = tid > 0 ? sh[tid - 1] : Op::template ident<A>();
    const A cj = carry;
    // each thread rewrites only the slots of its own chunk
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const A w = tid > 0 ? Op::comb(e, loc[k]) : loc[k];
      tile[slot(tid * ITEMS + k)] = j > 0 ? Op::comb(cj, w) : w;
    }
    __syncthreads();
    T* row = out + r * n;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int i = k * THREADS + tid;
      const int64_t gi = j * TILE + i;
      if (gi < n) row[gi] = narrow<T, A>(tile[slot(i)]);
    }
    __syncthreads();  // tile, sh and taken are refilled for the next tile
  }
}

}  // namespace

// Bytes of the status buffer for `num_tiles` tiles: the tile counter, then
// one flag per tile.
inline long long status_bytes(long long num_tiles) {
  return (long long)sizeof(unsigned long long) +
         num_tiles * (long long)sizeof(unsigned);
}

// Host side, on the caller's stream: clear the status buffer, then the one
// launch.  `val` holds rows * ceil(n / TILE) accumulators, `status`
// status_bytes(...) bytes (8-byte aligned).  Returns the CUDA error (0 on
// success).
template <typename T, class Op>
int launch(const void* x, void* out, void* val, void* status, long long rows,
           long long n, int grid, void* stream) {
  using A = typename Acc<T>::type;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t tpr = (n + TILE - 1) / TILE;
  const int64_t num = rows * tpr;
  cudaError_t e = cudaMemsetAsync(status, 0, (size_t)status_bytes(num), st);
  if (e != cudaSuccess) return (int)e;
  const int ctas = (int)(num < grid ? num : grid);
  unsigned long long* next = static_cast<unsigned long long*>(status);
  scan_tiles<T, Op><<<ctas, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<A*>(val), next,
      reinterpret_cast<unsigned*>(next + 1), static_cast<T*>(out), (int64_t)n,
      tpr, num);
  return (int)cudaGetLastError();
}

}  // namespace scan
}  // namespace ramba

// Fixed-order inclusive scan (cumsum, cumprod) of floats for Hopper (sm_90a).
//
// No Pallas kernel of ramba_tpu corresponds to it: XLA's scan gives the same
// bytes on every run, torch.cumsum on the card does not (its float scan's
// look-back order varies between calls).  This kernel repairs that fault of
// the port: the order of every operation is fixed by the tiling alone.
//
// What it computes: out[r, i] = x[r, 0] op x[r, 1] op ... op x[r, i] for
// each of `rows` contiguous rows of length n, op = + or *, in the
// accumulator type A (float for half and bfloat16 data, whose outputs are
// rounded from it once each; the data's own type otherwise).
//
// Design.  A row is cut into tiles of TILE = THREADS * ITEMS elements; a
// tile's thread t owns ITEMS consecutive elements.  Three launches:
//   1. scan_totals: each tile's total.  Every thread folds its ITEMS
//      elements left to right; the CTA combines the THREADS thread sums by
//      an inclusive Kogge-Stone scan in shared memory (log2(THREADS) fixed
//      levels); the last element is the tile's total.
//   2. scan_carries: one CTA per row scans the row's tile totals in order.
//      Thread u folds C = ceil(tiles / THREADS) consecutive totals, a
//      Kogge-Stone scan combines the chunk sums, and each thread then
//      walks its chunk once more, writing each tile's exclusive carry.
//   3. scan_tiles: each tile scans itself as in 1 (the thread's running
//      fold, the exclusive Kogge-Stone value of the threads before it
//      combined in front) and combines its carry in front.
// Out-of-range elements of a ragged last tile read the identity and come
// after every real element, so they change no real output.  Tiles are
// walked grid-stride: the grid (CTAs on the card) changes nothing in the
// order, so the bytes do not depend on occupancy or the card.  Loads and
// stores go through a shared-memory tile (coalesced in device memory, one
// pad slot per ITEMS elements against bank conflicts in the chunk reads).
//
// Bound on the H100: HBM bandwidth.  The least traffic is the data read
// once and the result written once, 2 * rows * n * sizeof(T) bytes at
// 3.35 TB/s; this design reads the data twice (launches 1 and 3), so it
// moves 3 * rows * n * sizeof(T) bytes, plus the tile totals and carries
// (1/TILE of the data).  Rows of one tile skip launches 1 and 2.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ramba {
namespace scan {
namespace {

constexpr int THREADS = 256;           // threads per CTA, every launch
constexpr int ITEMS = 16;              // consecutive elements per thread
constexpr int TILE = THREADS * ITEMS;  // elements per tile
constexpr int PADDED = TILE + TILE / ITEMS;

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

template <typename T, class Op>
__global__ void __launch_bounds__(THREADS)
scan_totals(const T* __restrict__ x, typename Acc<T>::type* __restrict__ tot,
            int64_t n, int64_t tiles_per_row, int64_t num_tiles) {
  using A = typename Acc<T>::type;
  __shared__ A tile[PADDED];
  __shared__ A sh[THREADS];
  const int tid = threadIdx.x;
  for (int64_t g = blockIdx.x; g < num_tiles; g += gridDim.x) {
    const int64_t r = g / tiles_per_row;
    const int64_t j = g - r * tiles_per_row;
    load_tile<T, A, Op>(x + r * n, n, j * TILE, tile);
    __syncthreads();
    A s = tile[slot(tid * ITEMS)];
#pragma unroll
    for (int k = 1; k < ITEMS; ++k) s = Op::comb(s, tile[slot(tid * ITEMS + k)]);
    kogge_stone<A, Op>(sh, s);
    if (tid == 0) tot[g] = sh[THREADS - 1];
    __syncthreads();  // tile and sh are refilled for the next tile
  }
}

template <typename A, class Op>
__global__ void __launch_bounds__(THREADS)
scan_carries(const A* __restrict__ tot, A* __restrict__ carry,
             int64_t tiles_per_row, int64_t rows) {
  __shared__ A sh[THREADS];
  const int tid = threadIdx.x;
  const int64_t T = tiles_per_row;
  const int64_t C = (T + THREADS - 1) / THREADS;
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    const A* t = tot + r * T;
    A* c = carry + r * T;
    const int64_t j0 = (int64_t)tid * C;
    A cs = j0 < T ? t[j0] : Op::template ident<A>();
    for (int64_t q = 1; q < C; ++q)
      cs = Op::comb(cs, j0 + q < T ? t[j0 + q] : Op::template ident<A>());
    kogge_stone<A, Op>(sh, cs);
    A acc = tid > 0 ? sh[tid - 1] : Op::template ident<A>();
    bool have = tid > 0;
    for (int64_t q = 0; q < C; ++q) {
      const int64_t j = j0 + q;
      const A v = j < T ? t[j] : Op::template ident<A>();
      if (j < T) c[j] = acc;
      acc = have ? Op::comb(acc, v) : v;
      have = true;
    }
    __syncthreads();  // sh is refilled for the next row
  }
}

template <typename T, class Op>
__global__ void __launch_bounds__(THREADS)
scan_tiles(const T* __restrict__ x, const typename Acc<T>::type* __restrict__ carry,
           T* __restrict__ out, int64_t n, int64_t tiles_per_row,
           int64_t num_tiles) {
  using A = typename Acc<T>::type;
  __shared__ A tile[PADDED];
  __shared__ A sh[THREADS];
  const int tid = threadIdx.x;
  for (int64_t g = blockIdx.x; g < num_tiles; g += gridDim.x) {
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
    const A e = tid > 0 ? sh[tid - 1] : Op::template ident<A>();
    const A cj = j > 0 ? carry[g] : Op::template ident<A>();
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
    __syncthreads();  // tile and sh are refilled for the next tile
  }
}

}  // namespace

// Host side: the three launches on the caller's stream (launches 1 and 2
// only where a row has more than one tile).  `tot` and `carry` hold
// rows * ceil(n / TILE) accumulators each.  Returns the CUDA error of the
// launches (0 on success).
template <typename T, class Op>
int launch(const void* x, void* out, void* tot, void* carry, long long rows,
           long long n, int grid, void* stream) {
  using A = typename Acc<T>::type;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t tpr = (n + TILE - 1) / TILE;
  const int64_t num = rows * tpr;
  const int g_tiles = (int)(num < grid ? num : grid);
  if (tpr > 1) {
    scan_totals<T, Op><<<g_tiles, THREADS, 0, st>>>(
        static_cast<const T*>(x), static_cast<A*>(tot), (int64_t)n, tpr, num);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int g_rows = (int)(rows < grid ? rows : grid);
    scan_carries<A, Op><<<g_rows, THREADS, 0, st>>>(
        static_cast<const A*>(tot), static_cast<A*>(carry), tpr, (int64_t)rows);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  scan_tiles<T, Op><<<g_tiles, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const A*>(carry),
      static_cast<T*>(out), (int64_t)n, tpr, num);
  return (int)cudaGetLastError();
}

}  // namespace scan
}  // namespace ramba

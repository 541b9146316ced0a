// elemred for Hopper (sm_90a): a fused elementwise(+reduce) program on
// persistent CTAs fed by a ring of bulk copies.
//
// Replaces ramba_tpu/ops/pallas_backend.py::_build_elemred (pallas_call at
// :447).
//
// What it computes: a fused program of map (NumPy ufuncs), cast and round
// instructions over 1-D operands of one length n, optionally ending in
// whole-array sum/prod/min/max/mean reductions (mean is divided by n
// outside).  ops/elemred.py generates, per program and leaf signature, a
// struct P (below: "the program") from program.instrs and the NumPy cast
// plan, with every operation typed and cast explicitly
// (ops/cuda_expr.py), and instantiates this header's kernels with it.
//
// Bound on the H100: HBM bandwidth for most programs, each vector leaf
// read once and each vector output written once, at 3.35 TB/s; the
// main path's sin/cos chain in float64 reads 8 and writes 8 bytes per
// element and spends about 40 FP64-pipe instructions on them, which at
// 64 lanes per SM per clock stays under the byte time, but its ~100-150
// instructions per element of issue come close to it.  So the kernel must
// overlap its loads with its arithmetic inside every SM, and spend no
// issue slots on the loads: the design below.
//
// Design.  Tiles of TILE = NT * EPT elements; thread t owns, in a tile,
// EPT / V groups of V consecutive elements (V = 16 bytes over the widest
// vector operand's size), group j at element j*NT*V + t*V, so every
// group of every operand is one aligned access of at most 16 bytes, and a
// warp's groups are adjacent.  A persistent grid (occupancy x SMs CTAs,
// read from the device; never more CTAs than tiles) walks the tiles
// grid-stride: CTA b takes tiles b, b + grid, b + 2*grid, ..., so the
// CTAs on the card at once read one contiguous stretch of every operand.
// ops/elemred.py mirrors the schedule (schedule, tile_range,
// tile_elements).
//
// Two load paths, picked by Python before the launch (load_path):
//   PATH_BULK   every vector leaf 16-byte aligned.  Each CTA keeps a ring
//               of STAGES shared-memory stages, one tile of every vector
//               leaf each; one thread fills a stage with one 1-D bulk copy
//               (cp.async.bulk ... mbarrier::complete_tx::bytes) per leaf,
//               completing on the stage's mbarrier, so while the CTA
//               computes tile i the loads of tiles i+1 .. i+STAGES-1 are in
//               flight and the bytes in flight cost no registers and no
//               instructions.  A copy moves a multiple of 16 bytes; the
//               few elements of the last tile past the last 16-byte
//               boundary of n are read with plain loads.  Threads move
//               their groups from the stage into registers and compute;
//               then the CTA synchronises and one thread refills the
//               stage after a proxy fence.  The refill has to wait for the
//               arithmetic: a shared-memory load can still be in flight at
//               a barrier that follows it directly, and the bulk copy,
//               which writes through the async proxy, can overtake it.
//   PATH_PLAIN  anything else (a view at an odd offset): plain loads of
//               every element of a tile into registers, then the
//               arithmetic.
// Vector outputs go from registers to global memory with one store of up
// to 16 bytes per group.
//
// Reductions keep, in every thread, one accumulator per element position
// of its tile (EPT of them, independent, so the adds of a group overlap),
// across all its tiles; positions past n add the identity.  At the end a
// fixed-order tree folds each thread's accumulators, then the warp
// (shuffles), then the CTA (shared memory), and one partial per CTA is
// written; a second one-CTA launch per reduction folds the partials in a
// fixed order.  No atomics: a rerun gives the same bytes.  min and max
// propagate NaN; integer sums and products wrap.
//
// Host side: a plain C entry per generated library (ctypes), returning 0
// or a CUDA error (cudaGetLastError after each launch).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mbarrier.cuh"
#include "ufunc.cuh"  // the NumPy helpers the generated program calls

namespace ramba {
namespace elemred {
// internal linkage: every generated library keeps its own kernels and
// statics (see stencil_tile.cuh)
namespace {

constexpr int NT = 256;  // threads per CTA, in both kernels

// load paths (ops/elemred.py::PATHS)
constexpr int PATH_BULK = 0;
constexpr int PATH_PLAIN = 1;

constexpr int ERR_NO_FIT = 901;  // occupancy 0: the CTA does not fit

// V values of T in one aligned access
template <typename T, int V> struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// one 1-D bulk copy global -> shared of `bytes` (a multiple of 16, both
// addresses 16-byte aligned), completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the bytes of `count` elements of size ES a bulk copy moves
__device__ __forceinline__ uint32_t bulk_bytes(long long count, int es) {
  return (uint32_t)((count * es) & ~15LL);
}

// the elements [from, count) of one leaf's tile no bulk copy moved
template <typename T>
__device__ __forceinline__ void fill_tail(unsigned char* stage_leaf,
                                          const void* src, long long t0,
                                          long long count) {
  T* d = reinterpret_cast<T*>(stage_leaf);
  const T* s = static_cast<const T*>(src) + t0;
  const int from = (int)(bulk_bytes(count, (int)sizeof(T)) / sizeof(T));
  for (int e = from + (int)threadIdx.x; e < count; e += NT) d[e] = s[e];
}

// Combining ops: integer sums and products wrap (computed unsigned:
// signed overflow is undefined in C++); floats round as IEEE
// (--fmad=false); a NaN operand wins min and max.
template <typename A> __device__ __forceinline__ A wrap_add(A a, A b) { return a + b; }
template <> __device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
template <> __device__ __forceinline__ long long wrap_add(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}
template <typename A> __device__ __forceinline__ A wrap_mul(A a, A b) { return a * b; }
template <> __device__ __forceinline__ int wrap_mul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
template <> __device__ __forceinline__ long long wrap_mul(long long a, long long b) {
  return (long long)((unsigned long long)a * (unsigned long long)b);
}

struct OpSum {
  template <typename A> __device__ static A comb(A a, A b) { return wrap_add(a, b); }
};
struct OpProd {
  template <typename A> __device__ static A comb(A a, A b) { return wrap_mul(a, b); }
};
struct OpMin {
  template <typename A> __device__ static A comb(A a, A b) { return nan_min(a, b); }
};
struct OpMax {
  template <typename A> __device__ static A comb(A a, A b) { return nan_max(a, b); }
};

// Fixed-order tree over the CTA: each warp by shuffles (lane 0 ends with
// lanes 0..31, offsets 16, 8, 4, 2, 1), then warp 0 over the NT / 32 warp
// values.  The result is thread 0's.
template <class Op, typename A>
__device__ __forceinline__ A block_reduce(A v, A ident) {
  __shared__ A buf[NT / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = Op::comb(v, __shfl_down_sync(0xffffffffu, v, off));
  if (lane == 0) buf[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < NT / 32 ? buf[lane] : ident;
#pragma unroll
    for (int off = NT / 64; off > 0; off >>= 1)
      v = Op::comb(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  __syncthreads();  // buf is free for the next reduction
  return v;
}

// A thread's EPT accumulators folded by a fixed-order tree (pairs EPT/2
// apart, then EPT/4, ...), then the CTA's tree; thread 0 writes the
// CTA's partial.
template <class Op, typename A, int EPT>
__device__ __forceinline__ void write_partial(A (&acc)[EPT], A ident,
                                              void* part) {
#pragma unroll
  for (int s = EPT / 2; s > 0; s >>= 1) {
#pragma unroll
    for (int i = 0; i < s; ++i) acc[i] = Op::comb(acc[i], acc[i + s]);
  }
  const A v = block_reduce<Op, A>(acc[0], ident);
  if (threadIdx.x == 0) static_cast<A*>(part)[blockIdx.x] = v;
}

// The second pass for one reduction: thread t folds partials t, t + NT,
// ... in order, then the CTA's tree.
template <class Op, typename A>
__device__ __forceinline__ void fold(const void* part, void* out, int grid,
                                     A ident) {
  const A* p = static_cast<const A*>(part);
  A v = ident;
  for (int b = threadIdx.x; b < grid; b += NT) v = Op::comb(v, p[b]);
  v = block_reduce<Op, A>(v, ident);
  if (threadIdx.x == 0) *static_cast<A*>(out) = v;
}

// The program's kernel.  P (generated) provides EPT, V, STAGES, MIN_CTAS,
// STAGE_BYTES, SMEM_BYTES, NR, the types Params, Regs and Acc, and
//   init(Acc&)                                  identities
//   issue(p, stage, bar, t0, count)             arm bar, one bulk copy per leaf
//   fill_tail(p, stage, t0, count)              the elements no copy moved
//   load_stage(Regs&, stage)                    a thread's groups, from shared
//   load_global(Regs&, p, t0, count)            ... or from global memory
//   compute(p, Regs&, t0, count, Acc&)          the instructions; stores; adds
//   finish(p, Acc&)                             write_partial per reduction
//   fold(p, grid)                               fold per reduction (blockIdx.x)
template <class P, int PATH>
__global__ void __launch_bounds__(NT, P::MIN_CTAS)
elemred_kernel(const __grid_constant__ typename P::Params p) {
  constexpr long long TILE = (long long)NT * P::EPT;
  extern __shared__ __align__(128) unsigned char smem[];
  const long long n = p.n;
  const long long n_tiles = (n + TILE - 1) / TILE;
  const long long step = gridDim.x;
  // this CTA's tiles: blockIdx.x, blockIdx.x + grid, ... (elemred.tile_range)
  const long long mine =
      blockIdx.x < n_tiles ? (n_tiles - 1 - blockIdx.x) / step + 1 : 0;
  typename P::Acc acc;
  P::init(acc);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::STAGES * P::STAGE_BYTES);

  if constexpr (PATH == PATH_BULK) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < P::STAGES; ++s) mbar_init(&full[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {  // prologue: the first STAGES tiles in flight
      for (int s = 0; s < P::STAGES && s < mine; ++s) {
        const long long t0 = (blockIdx.x + s * step) * TILE;
        P::issue(p, smem + s * P::STAGE_BYTES, &full[s], t0, n - t0);
      }
    }
  }
  for (long long i = 0; i < mine; ++i) {
    const long long t0 = (blockIdx.x + i * step) * TILE;
    const long long count = n - t0;  // elements of the tile below n (may exceed TILE)
    typename P::Regs r;
    const int s = (int)(i % P::STAGES);
    unsigned char* stage = smem + s * P::STAGE_BYTES;
    if constexpr (PATH == PATH_BULK) {
      mbar_wait(&full[s], (uint32_t)((i / P::STAGES) & 1));
      if (count < TILE) {  // the last tile (uniform across the CTA)
        P::fill_tail(p, stage, t0, count);
        __syncthreads();
      }
      P::load_stage(r, stage);
    } else {
      P::load_global(r, p, t0, count);
    }
    P::compute(p, r, t0, count, acc);
    if constexpr (PATH == PATH_BULK) {
      // every thread has used its groups of stage s (the arithmetic above
      // consumed its loads); the proxy fence orders the refill's
      // async-proxy writes after those reads
      __syncthreads();
      if (threadIdx.x == 0 && i + P::STAGES < mine) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        const long long t1 = t0 + P::STAGES * step * TILE;
        P::issue(p, stage, &full[s], t1, n - t1);
      }
    }
  }
  P::finish(p, acc);
}

template <class P>
__global__ void __launch_bounds__(NT)
elemred_fold(const __grid_constant__ typename P::Params p, int grid) {
  P::fold(p, grid);
}

template <class P, int PATH> constexpr int smem_bytes() {
  return PATH == PATH_BULK ? P::SMEM_BYTES : 0;
}

// CTAs of the path's kernel one SM holds at once (0 on error).
template <class P, int PATH> int ctas_per_sm_path() {
  auto kern = elemred_kernel<P, PATH>;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes<P, PATH>()) != cudaSuccess)
    return 0;
  int occ = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ, kern, NT, smem_bytes<P, PATH>()) != cudaSuccess)
    return 0;
  return occ;
}

template <class P> int ctas_per_sm(int path) {
  if (path == PATH_BULK) return ctas_per_sm_path<P, PATH_BULK>();
  if (path == PATH_PLAIN) return ctas_per_sm_path<P, PATH_PLAIN>();
  return 0;
}

template <class P, int PATH>
int launch_path(const typename P::Params& p, int grid, cudaStream_t st) {
  static bool sized = false;  // the shared-memory limit, raised once
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        elemred_kernel<P, PATH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<P, PATH>());
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  elemred_kernel<P, PATH><<<grid, NT, smem_bytes<P, PATH>(), st>>>(p);
  return (int)cudaGetLastError();
}

// Host entry: the program's kernel on `grid` CTAs along `path`, then one
// fold CTA per reduction, on the caller's stream.  Returns 0 or a CUDA
// error.
template <class P>
int launch(int path, int grid, const typename P::Params& p, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (grid <= 0) return ERR_NO_FIT;
  int rc = (int)cudaErrorInvalidValue;
  if (path == PATH_BULK) rc = launch_path<P, PATH_BULK>(p, grid, st);
  if (path == PATH_PLAIN) rc = launch_path<P, PATH_PLAIN>(p, grid, st);
  if (rc != 0 || P::NR == 0) return rc;
  elemred_fold<P><<<P::NR, NT, 0, st>>>(p, grid);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace elemred
}  // namespace ramba

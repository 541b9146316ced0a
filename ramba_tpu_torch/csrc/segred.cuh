// Segment reduction (groupby) for Hopper (sm_90a).
//
// Replaces ramba_tpu/ops/pallas_backend.py::_build_segred (pallas_call at
// :532).
//
// What it computes: out[g] = reduce_{i : labels[i] == g} data[i] for every
// group g < G, in the accumulator type A (the output's dtype: int32 data
// sums in int64).  An empty group gets the reduction's identity, labels
// outside [0, G) are ignored, count reads only the labels.  min and max
// propagate NaN as jnp.min/jnp.max do; integer sums and products wrap.
//
// Design.  The TPU kernel accumulated (G, 128) lane partials in one output
// block across in-order grid steps; GPU blocks run in no order, and float
// atomics would make reruns differ in their last bits.  So:
//   1. segred_partials: grid-stride CTAs of THREADS threads.  Every thread
//      keeps its own G partials in shared memory (slot g * THREADS + tid:
//      no two threads ever touch one slot, so no atomics), folds its
//      elements into them in index order, then the CTA combines the
//      THREADS partials of each group by a fixed-order tree and writes one
//      (G,) row of the (num_blocks, G) partials buffer;
//   2. segred_fold: one CTA per group folds the rows in a fixed order.
// The grid depends on n only, so a rerun gives the same bytes.
//
// Bound on the H100: HBM bandwidth.  The least traffic is the data and the
// labels read once (the labels only, for count), n * (sizeof(D) + sizeof(L))
// bytes at 3.35 TB/s; the partials are G * num_blocks values.  Loads are
// coalesced and four elements are in flight per thread; the shared-memory
// read-modify-write per element is what the simple design pays for its
// determinism (warp-shuffle combines, vector loads and TMA come later).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ramba {
namespace segred {

constexpr int THREADS = 256;  // threads per CTA in both kernels
constexpr int UNROLL = 4;     // elements in flight per thread

// Integer sums and products wrap (computed unsigned: signed overflow is
// undefined in C++); float ones round as IEEE (built with --fmad=false).
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

template <typename A> struct Lim;
template <> struct Lim<float> {
  __device__ static float lo() { return -INFINITY; }
  __device__ static float hi() { return INFINITY; }
};
template <> struct Lim<double> {
  __device__ static double lo() { return -(double)INFINITY; }
  __device__ static double hi() { return (double)INFINITY; }
};
template <> struct Lim<int> {
  __device__ static int lo() { return (int)0x80000000u; }
  __device__ static int hi() { return 0x7fffffff; }
};
template <> struct Lim<long long> {
  __device__ static long long lo() { return (long long)0x8000000000000000ull; }
  __device__ static long long hi() { return 0x7fffffffffffffffll; }
};

struct OpSum {
  template <typename A> __device__ static A ident() { return A(0); }
  template <typename A> __device__ static A comb(A a, A b) { return wrap_add(a, b); }
};
struct OpProd {
  template <typename A> __device__ static A ident() { return A(1); }
  template <typename A> __device__ static A comb(A a, A b) { return wrap_mul(a, b); }
};
// a NaN operand wins, as in jnp.min/jnp.max (fminf/fmaxf would drop it)
struct OpMin {
  template <typename A> __device__ static A ident() { return Lim<A>::hi(); }
  template <typename A> __device__ static A comb(A a, A b) {
    return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
  }
};
struct OpMax {
  template <typename A> __device__ static A ident() { return Lim<A>::lo(); }
  template <typename A> __device__ static A comb(A a, A b) {
    return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
  }
};

template <typename D, typename A, bool COUNT>
__device__ __forceinline__ A value(const D* __restrict__ data, int64_t i) {
  if constexpr (COUNT) {
    return A(1);
  } else {
    return static_cast<A>(data[i]);
  }
}

template <typename D, typename A, typename L, class Op, bool COUNT>
__global__ void __launch_bounds__(THREADS)
segred_partials(const D* __restrict__ data, const L* __restrict__ labels,
                A* __restrict__ partials, int64_t n, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* acc = reinterpret_cast<A*>(smem_raw);  // G x THREADS
  const int tid = threadIdx.x;
  for (int g = 0; g < G; ++g) acc[g * THREADS + tid] = Op::template ident<A>();

  // each thread touches only its own slots until the tree below
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  int64_t i = (int64_t)blockIdx.x * THREADS + tid;
  for (; i + (UNROLL - 1) * stride < n; i += UNROLL * stride) {
    long long lab[UNROLL];
    A v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      lab[u] = (long long)labels[i + u * stride];
      v[u] = value<D, A, COUNT>(data, i + u * stride);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (lab[u] >= 0 && lab[u] < G) {
        A* slot = &acc[lab[u] * THREADS + tid];
        *slot = Op::comb(*slot, v[u]);
      }
    }
  }
  for (; i < n; i += stride) {  // the ragged tail
    const long long lab = (long long)labels[i];
    if (lab >= 0 && lab < G) {
      A* slot = &acc[lab * THREADS + tid];
      *slot = Op::comb(*slot, value<D, A, COUNT>(data, i));
    }
  }
  __syncthreads();

  // fixed-order tree over the THREADS partials of every group
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    for (int k = tid; k < G * s; k += THREADS) {
      const int g = k / s;
      A* a = &acc[g * THREADS + (k - g * s)];
      *a = Op::comb(*a, a[s]);
    }
    __syncthreads();
  }
  for (int g = tid; g < G; g += THREADS)
    partials[(int64_t)blockIdx.x * G + g] = acc[g * THREADS];
}

template <typename A, class Op>
__global__ void __launch_bounds__(THREADS)
segred_fold(const A* __restrict__ partials, A* __restrict__ out, int num_blocks,
            int G) {
  __shared__ A buf[THREADS];
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  A a = Op::template ident<A>();
  for (int b = tid; b < num_blocks; b += THREADS)
    a = Op::comb(a, partials[(int64_t)b * G + g]);
  buf[tid] = a;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) buf[tid] = Op::comb(buf[tid], buf[tid + s]);
    __syncthreads();
  }
  if (tid == 0) out[g] = buf[0];
}

// Host side: size the shared memory, launch both kernels on the caller's
// stream.  Returns the CUDA error of the launches (0 on success).
template <typename D, typename A, typename L, class Op, bool COUNT>
int launch(const void* data, const void* labels, void* partials, void* out,
           long long n, int G, int num_blocks, void* stream) {
  const size_t smem = sizeof(A) * (size_t)G * THREADS;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        segred_partials<D, A, L, Op, COUNT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  segred_partials<D, A, L, Op, COUNT><<<num_blocks, THREADS, smem, st>>>(
      static_cast<const D*>(data), static_cast<const L*>(labels),
      static_cast<A*>(partials), (int64_t)n, G);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  segred_fold<A, Op><<<G, THREADS, 0, st>>>(
      static_cast<const A*>(partials), static_cast<A*>(out), num_blocks, G);
  return (int)cudaGetLastError();
}

}  // namespace segred
}  // namespace ramba

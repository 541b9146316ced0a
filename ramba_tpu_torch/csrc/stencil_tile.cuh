// 2-D stencil tile template for Hopper (sm_90a).
//
// Replaces ramba_tpu/ops/stencil_pallas.py::_run_fast (pallas_call at :261)
// and ::_run_padded (pallas_call at :370): one kernel for every shape both
// of those accepted.  The TPU needed two because of its (8, 128) tiling
// rule; here the edges are masked loads.
//
// What it computes: out[i, j] = body(taps around (i, j)) for every cell
// whose whole neighbourhood [i-TOP, i+BOTTOM] x [j-LEFT, j+RIGHT] lies in
// the array, and 0 for the border cells that lack one (sstencil's
// semantics).  The body is generated per stencil from the traced tap
// expression (ops/stencil_kernel.py) as a struct with
//     template <class S> __device__ static C eval(const S& s)
// that reads taps through s.template tap<SLOT, DI, DJ>().
//
// Design.  One CTA of BX x BY threads owns a TILE_H x TILE_W block of
// outputs.  It stages that block plus its halo, for every array slot, in
// dynamic shared memory with coalesced row-wise loads (cells outside the
// array read as 0; they feed only border outputs, which are zeroed), then
// every thread evaluates the body for its outputs from shared memory.
// Arithmetic runs in float for float32 and in double for float64.  bfloat16
// is loaded and stored with the bf16 intrinsics and computed in float, with
// every operation's result rounded to bfloat16 by the generated body, as
// torch and the JAX package compute bf16 (one float op, then one rounding).
//
// Bound on the H100: HBM bandwidth.  The least traffic is every slot read
// once and the output written once, (slots + 1) * H * W * itemsize bytes,
// at 3.35 TB/s.  Staging the halo once per tile keeps each input byte's
// re-reads (one per tap) in shared memory; the halo rows and columns that
// neighbouring tiles share are the only extra reads, and those mostly hit
// L2.  No cp.async/TMA pipelining yet: loads and compute of one tile do
// not overlap inside a CTA, only across the CTAs resident on an SM.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ramba {

constexpr int BX = 32;       // threads along a row (one warp: coalesced)
constexpr int BY = 8;        // thread rows
constexpr int TILE_W = 64;   // output columns per CTA
constexpr int TILE_H = 32;   // output rows per CTA

// Storage type T -> compute type C, with the conversions at the edges.
template <typename T> struct Elem;

template <> struct Elem<float> {
  typedef float C;
  __device__ __forceinline__ static C load(float v) { return v; }
  __device__ __forceinline__ static float store(C v) { return v; }
};

template <> struct Elem<double> {
  typedef double C;
  __device__ __forceinline__ static C load(double v) { return v; }
  __device__ __forceinline__ static double store(C v) { return v; }
};

template <> struct Elem<__nv_bfloat16> {
  typedef float C;
  __device__ __forceinline__ static C load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  __device__ __forceinline__ static __nv_bfloat16 store(C v) {
    return __float2bfloat16_rn(v);
  }
};

// NumPy's semantics for the few ufuncs C spells differently.

template <typename X> __device__ __forceinline__ X nan_max(X a, X b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

template <typename X> __device__ __forceinline__ X nan_min(X a, X b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

template <typename X> __device__ __forceinline__ X sign(X a) {
  return (a != a) ? a : (a > X(0) ? X(1) : (a < X(0) ? X(-1) : X(0)));
}

// floored modulo: the result takes the divisor's sign
__device__ __forceinline__ float floor_mod(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((m < 0.0f) != (b < 0.0f))) m += b;
  return m;
}

__device__ __forceinline__ double floor_mod(double a, double b) {
  double m = fmod(a, b);
  if (m != 0.0 && ((m < 0.0) != (b < 0.0))) m += b;
  return m;
}

__device__ __forceinline__ long long floor_mod(long long a, long long b) {
  if (b == 0) return 0;  // integer x % 0 == 0, as in ramba_tpu
  long long m = a % b;
  if (m != 0 && ((m < 0) != (b < 0))) m += b;
  return m;
}

// floored division, as numpy's npy_divmod computes it for floats
__device__ __forceinline__ float floor_div(float a, float b) {
  if (b == 0.0f) return a / b;
  float m = fmodf(a, b);
  float d = (a - m) / b;
  if (m != 0.0f && ((m < 0.0f) != (b < 0.0f))) d -= 1.0f;
  if (d != 0.0f) {
    float f = floorf(d);
    if (d - f > 0.5f) f += 1.0f;
    return f;
  }
  return copysignf(0.0f, a / b);
}

__device__ __forceinline__ double floor_div(double a, double b) {
  if (b == 0.0) return a / b;
  double m = fmod(a, b);
  double d = (a - m) / b;
  if (m != 0.0 && ((m < 0.0) != (b < 0.0))) d -= 1.0;
  if (d != 0.0) {
    double f = floor(d);
    if (d - f > 0.5) f += 1.0;
    return f;
  }
  return copysign(0.0, a / b);
}

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  if (b == 0) return a == 0 ? -1 : -2;  // signed x // 0, as in ramba_tpu
  long long q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}

template <typename T, int NSLOT> struct Ptrs {
  const T* p[NSLOT];
};

// The view of the staged tiles one output cell's body reads.
template <typename T, int NSLOT, int TOP, int BOTTOM, int LEFT, int RIGHT>
struct Tile {
  static constexpr int SH = TILE_H + TOP + BOTTOM;
  static constexpr int SW = TILE_W + LEFT + RIGHT;
  const T* smem;  // NSLOT tiles of SH x SW, back to back
  int r, c;       // the output cell inside the tile

  template <int SLOT, int DI, int DJ>
  __device__ __forceinline__ typename Elem<T>::C tap() const {
    return Elem<T>::load(smem[(SLOT * SH + (r + TOP + DI)) * SW + (c + LEFT + DJ)]);
  }
};

template <typename T, int NSLOT, int TOP, int BOTTOM, int LEFT, int RIGHT,
          class Body>
__global__ void __launch_bounds__(BX * BY)
stencil_tile_kernel(Ptrs<T, NSLOT> in, T* __restrict__ out, int64_t H, int64_t W) {
  typedef Tile<T, NSLOT, TOP, BOTTOM, LEFT, RIGHT> TileT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const T zero = Elem<T>::store(typename Elem<T>::C(0));
  const int64_t row0 = (int64_t)blockIdx.y * TILE_H;
  const int64_t col0 = (int64_t)blockIdx.x * TILE_W;

  for (int s = 0; s < NSLOT; ++s) {
    const T* __restrict__ src = in.p[s];
    for (int i = threadIdx.y; i < TileT::SH; i += BY) {
      const int64_t gr = row0 - TOP + i;
      const bool row_ok = gr >= 0 && gr < H;
      for (int j = threadIdx.x; j < TileT::SW; j += BX) {
        const int64_t gc = col0 - LEFT + j;
        smem[(s * TileT::SH + i) * TileT::SW + j] =
            (row_ok && gc >= 0 && gc < W) ? src[gr * W + gc] : zero;
      }
    }
  }
  __syncthreads();

  TileT t;
  t.smem = smem;
  for (int i = threadIdx.y; i < TILE_H; i += BY) {
    const int64_t gr = row0 + i;
    if (gr >= H) break;
    const bool row_in = gr >= TOP && gr < H - BOTTOM;
    for (int j = threadIdx.x; j < TILE_W; j += BX) {
      const int64_t gc = col0 + j;
      if (gc >= W) break;
      t.r = i;
      t.c = j;
      const bool valid = row_in && gc >= LEFT && gc < W - RIGHT;
      out[gr * W + gc] = valid ? Elem<T>::store(Body::eval(t)) : zero;
    }
  }
}

// Host side: stage the pointers, size the shared memory, launch on the
// caller's stream.  Returns the CUDA error of the launch (0 on success).
template <typename T, int NSLOT, int TOP, int BOTTOM, int LEFT, int RIGHT,
          class Body>
int launch_stencil(const void* const* ins, void* out, long long H, long long W,
                   void* stream) {
  typedef Tile<T, NSLOT, TOP, BOTTOM, LEFT, RIGHT> TileT;
  Ptrs<T, NSLOT> p;
  for (int s = 0; s < NSLOT; ++s) p.p[s] = static_cast<const T*>(ins[s]);
  const size_t smem = sizeof(T) * NSLOT * TileT::SH * TileT::SW;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        stencil_tile_kernel<T, NSLOT, TOP, BOTTOM, LEFT, RIGHT, Body>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)((W + TILE_W - 1) / TILE_W),
            (unsigned)((H + TILE_H - 1) / TILE_H));
  dim3 block(BX, BY);
  stencil_tile_kernel<T, NSLOT, TOP, BOTTOM, LEFT, RIGHT, Body>
      <<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
          p, static_cast<T*>(out), (int64_t)H, (int64_t)W);
  return (int)cudaGetLastError();
}

}  // namespace ramba

// NumPy's semantics for the ufuncs C spells differently, as the port's
// plain PyTorch version computes them (ramba_tpu_torch/core/expr.py).
//
// Included by every kernel header whose body ops/cuda_expr.py emits
// (stencil_tile.cuh, elemred.cuh); the emitted code calls these as
// ramba::name.  Internal linkage, like the kernel headers: each generated
// library keeps its own copies.

#pragma once

#include <math.h>

namespace ramba {
namespace {

// maximum/minimum: a NaN operand wins (fmax/fmin would drop it)
template <typename X> __device__ __forceinline__ X nan_max(X a, X b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

template <typename X> __device__ __forceinline__ X nan_min(X a, X b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

// sign: NaN stays NaN and a zero keeps its sign (sign(-0.0) is -0.0, as in
// ramba_tpu; numpy gives 0.0)
template <typename X> __device__ __forceinline__ X sign(X a) {
  return (a != a) ? a : (a > X(0) ? X(1) : (a < X(0) ? X(-1) : a));
}

// A float to an integer type, saturating as ramba_tpu (XLA's convert)
// does: NaN gives 0, values at or beyond the range give its maximum or
// minimum, the rest truncate toward zero.  A C++ cast of an out-of-range
// float is undefined behaviour, so the limits are tested first.  `hi` is
// the type's maximum plus one and `lo` its minimum, both powers of two and
// exact in F.
template <typename I, typename F>
__device__ __forceinline__ I sat_cast(F x, F lo, F hi, I imin, I imax) {
  if (x != x) return I(0);
  if (x >= hi) return imax;
  if (x <= lo) return imin;
  return static_cast<I>(x);
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

// floored division: numpy's npy_divmod quotient, except that a zero
// quotient takes the divisor's sign, as in ramba_tpu (jnp divides
// a - fmod(a, b), which is +0 there, by b): -0.0 // 2.0 is 0.0 and
// -0.0 // -2.0 is -0.0, where numpy signs the zero by a / b
__device__ __forceinline__ float floor_div(float a, float b) {
  if (b == 0.0f) return a / b;
  float m = fmodf(a, b);
  float d = (a - m) / b;
  if (m != 0.0f && ((m < 0.0f) != (b < 0.0f))) d -= 1.0f;
  float q = d;
  if (d != 0.0f) {
    q = floorf(d);
    if (d - q > 0.5f) q += 1.0f;
  }
  return q == 0.0f ? copysignf(0.0f, b) : q;
}

__device__ __forceinline__ double floor_div(double a, double b) {
  if (b == 0.0) return a / b;
  double m = fmod(a, b);
  double d = (a - m) / b;
  if (m != 0.0 && ((m < 0.0) != (b < 0.0))) d -= 1.0;
  double q = d;
  if (d != 0.0) {
    q = floor(d);
    if (d - q > 0.5) q += 1.0;
  }
  return q == 0.0 ? copysign(0.0, b) : q;
}

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  if (b == 0) return a == 0 ? -1 : -2;  // signed x // 0, as in ramba_tpu
  long long q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}

// logaddexp and logaddexp2 as torch computes them: equal infinities give
// themselves, anything else max + log1p(exp(-|a - b|)) (scaled by 1/ln 2
// for base 2); a NaN operand gives NaN
template <typename X> __device__ __forceinline__ X logaddexp(X a, X b) {
  if (isinf(a) && a == b) return a;
  const X m = (a != a || b != b) ? a + b : (a > b ? a : b);
  return m + log1p(exp(-fabs(a - b)));
}

template <typename X> __device__ __forceinline__ X logaddexp2(X a, X b) {
  if (isinf(a) && a == b) return a;
  const X m = (a != a || b != b) ? a + b : (a > b ? a : b);
  return m + log1p(exp2(-fabs(a - b))) * X(1.4426950408889634);
}

}  // namespace
}  // namespace ramba

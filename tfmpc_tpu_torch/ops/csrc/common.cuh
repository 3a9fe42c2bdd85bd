// Shared helpers of the tfmpc CUDA kernels: dtype dispatch and scalar math
// overloaded for float and double, so each kernel is written once over
// scalar_t.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tfmpc {

// dtype codes of the C entries (ops/_build.py DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kFloat64 = 1;

__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dsin(float x) { return sinf(x); }
__device__ __forceinline__ double dsin(double x) { return sin(x); }
__device__ __forceinline__ bool dfinite(float x) { return isfinite(x); }
__device__ __forceinline__ bool dfinite(double x) { return isfinite(x); }
template <typename S>
__device__ __forceinline__ S dnan();
template <>
__device__ __forceinline__ float dnan<float>() { return __int_as_float(0x7fc00000); }
template <>
__device__ __forceinline__ double dnan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

template <typename S>
__device__ __forceinline__ S dinf();
template <>
__device__ __forceinline__ float dinf<float>() { return __int_as_float(0x7f800000); }
template <>
__device__ __forceinline__ double dinf<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

// clip that keeps NaN, as jnp.clip and torch.clamp do (fminf/fmaxf would
// return the bound for a NaN value)
template <typename S>
__device__ __forceinline__ S clip(S v, S lo, S hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

// Element (t, e, b) of a [T, E, B] array: scenarios on the fastest axis,
// so neighbouring threads (neighbouring b) read neighbouring addresses.
__device__ __forceinline__ int64_t at(int t, int e, int E, int b, int B) {
  return (static_cast<int64_t>(t) * E + e) * B + b;
}

inline int blocks_for(int64_t threads, int block) {
  return static_cast<int>((threads + block - 1) / block);
}

}  // namespace tfmpc

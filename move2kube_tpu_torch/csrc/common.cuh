// Helpers shared by the port's hand-written kernels: vector loads and
// stores that convert between the storage type (fp32 or bf16) and fp32
// registers, and the error-string export every kernel library carries.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace m2kt {

// Scores of masked positions; finite like the reference's -1e30 so that
// exp(score - max) is exactly 0 once a real score has set the max.
constexpr float kNegInf = -1e30f;

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

// Load N consecutive elements (N in {2, 4, 8}) as fp32. The pointer is
// aligned to N elements, so each call is one (or, for 8 fp32, two) vector
// load(s).
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (N == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  } else if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  } else {
    static_assert(N == 2, "load_vec: N must be 2, 4 or 8");
    const float2 a = *reinterpret_cast<const float2*>(p);
    out[0] = a.x; out[1] = a.y;
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  static_assert(N == 2 || N == 4 || N == 8, "load_vec: N must be 2, 4 or 8");
  __nv_bfloat162 h[N / 2];
  if constexpr (N == 8) {
    *reinterpret_cast<uint4*>(h) = *reinterpret_cast<const uint4*>(p);
  } else if constexpr (N == 4) {
    *reinterpret_cast<uint2*>(h) = *reinterpret_cast<const uint2*>(p);
  } else {
    h[0] = *reinterpret_cast<const __nv_bfloat162*>(p);
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
#pragma unroll
  for (int i = 0; i < N; ++i) p[i] = v[i];
}

template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  static_assert(N % 2 == 0, "store_vec: N must be even");
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    p2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  }
}

// A compiler memory barrier, free at run time. Placed between two loops
// that read the same shared-memory rows, it makes the second loop load them
// again: without it nvcc keeps the first loop's loads of a whole chunk of
// rows live in registers until the second loop and spills kilobytes a
// thread; a reload from shared memory is cheaper.
__device__ __forceinline__ void reload_barrier() {
  asm volatile("" ::: "memory");
}

__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

}  // namespace m2kt

// Every kernel library exports this, so the Python wrapper can name a
// failed launch's error instead of printing its number.
#define M2KT_EXPORT_ERROR_STRING                                   \
  extern "C" const char* m2kt_error_string(int code) {             \
    return cudaGetErrorString(static_cast<cudaError_t>(code));     \
  }

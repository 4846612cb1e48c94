// Row access helpers of the RMSNorm kernels (rmsnorm.cu, rmsnorm_bwd.cu):
// VEC elements of a row as one access (16 bytes: 8 bf16 or 4 f32, or one
// element), unpacked to and packed from f32, and the launchers' card and
// alignment queries.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

// --- VEC elements as one access, and as f32 ---------------------------------
template <typename T, int VEC>
struct Raw {
  using type = T;  // VEC = 1
};
template <>
struct Raw<__nv_bfloat16, 8> {
  using type = uint4;
};
template <>
struct Raw<float, 4> {
  using type = float4;
};

__device__ __forceinline__ void unpack(float t, float (&f)[1]) { f[0] = t; }
__device__ __forceinline__ void unpack(__nv_bfloat16 t, float (&f)[1]) {
  f[0] = __bfloat162float(t);
}
__device__ __forceinline__ void unpack(const float4& t, float (&f)[4]) {
  f[0] = t.x; f[1] = t.y; f[2] = t.z; f[3] = t.w;
}
__device__ __forceinline__ void unpack(const uint4& t, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(h[i]);
    f[2 * i] = a.x;
    f[2 * i + 1] = a.y;
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&f)[VEC]) {
  unpack(*reinterpret_cast<const typename Raw<T, VEC>::type*>(p), f);
}

__device__ __forceinline__ void store(float* p, const float (&f)[1]) { *p = f[0]; }
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&f)[1]) {
  *p = __float2bfloat16(f[0]);
}
__device__ __forceinline__ void store(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&f)[8]) {
  uint4 t;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = t;
}

template <typename R>
__device__ __forceinline__ R zero() {
  return R{};
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Hide a held access's value from the compiler between a row's sums and its
// store, so that it unpacks the held 16 bytes again instead of keeping the
// unpacked f32 values (twice the registers) alive across the shuffles.
__device__ __forceinline__ void opaque(uint4& t) {
  asm volatile("" : "+r"(t.x), "+r"(t.y), "+r"(t.z), "+r"(t.w));
}
__device__ __forceinline__ void opaque(float4& t) {
  asm volatile("" : "+f"(t.x), "+f"(t.y), "+f"(t.z), "+f"(t.w));
}
__device__ __forceinline__ void opaque(float&) {}
__device__ __forceinline__ void opaque(__nv_bfloat16&) {}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 0;
  }
  return n;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// Row RMSNorm forward for sm_90a: y = x * rsqrt(mean(x^2) + eps) * w, reduced
// in f32 and written in x's dtype.
//
// Replaces the Pallas TPU kernel `rmsnorm_fwd` (`_fwd_kernel`) of
// src/repro/kernels/rmsnorm/kernel.py.
//
// What bounds it on the H100: memory.  It reads each row once and writes it
// once (2 * N * D * itemsize bytes plus w), with ~4 flops per element, far
// below the ~295 flop/byte ridge.  The design therefore aims only at full-width
// memory transactions: one warp per row, 16-byte vector loads and stores
// (8 bf16 or 4 f32 per lane) whenever D allows, a shuffle reduction of the sum
// of squares, and a second pass over the row (served from L1/L2) to scale and
// store.  Rows of any length work; D = d_model (2048) and D = head_dim (64)
// are the serving shapes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int WARPS = 8;

// --- vector loads/stores of VEC elements as f32 ------------------------------
__device__ __forceinline__ void load(const float* p, float (&f)[1]) { f[0] = *p; }
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&f)[1]) {
  f[0] = __bfloat162float(*p);
}
__device__ __forceinline__ void load(const float* p, float (&f)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  f[0] = t.x; f[1] = t.y; f[2] = t.z; f[3] = t.w;
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(h[i]);
    f[2 * i] = a.x;
    f[2 * i + 1] = a.y;
  }
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

template <typename T, int VEC>
__global__ void __launch_bounds__(WARPS * 32)
    rmsnorm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                       long long n, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= n) return;  // uniform per warp
  const T* xr = x + row * d;
  T* yr = y + row * d;

  float ss = 0.f;
  for (int c = lane * VEC; c < d; c += 32 * VEC) {
    float f[VEC];
    load(xr + c, f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) ss += f[e] * f[e];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / (float)d + eps);

  for (int c = lane * VEC; c < d; c += 32 * VEC) {
    float f[VEC], g[VEC];
    load(xr + c, f);
    load(w + c, g);
#pragma unroll
    for (int e = 0; e < VEC; ++e) f[e] = f[e] * r * g[e];
    store(yr + c, f);
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* w, void* y, long long n, int d, float eps,
           cudaStream_t stream) {
  const long long blocks = (n + WARPS - 1) / WARPS;
  rmsnorm_fwd_kernel<T, VEC><<<(unsigned)blocks, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), n, d, eps);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// x, y: (n, d) row-major; w: (d,), all of one dtype (0 = float32,
// 1 = bfloat16).  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y, int dtype, long long n, int d,
                           float eps, void* stream) {
  if (n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec_ok = aligned16(x) && aligned16(w) && aligned16(y);
  if (dtype == 0) {
    if (vec_ok && d % 4 == 0) return launch<float, 4>(x, w, y, n, d, eps, st);
    return launch<float, 1>(x, w, y, n, d, eps, st);
  }
  if (dtype == 1) {
    if (vec_ok && d % 8 == 0) return launch<__nv_bfloat16, 8>(x, w, y, n, d, eps, st);
    return launch<__nv_bfloat16, 1>(x, w, y, n, d, eps, st);
  }
  return (int)cudaErrorInvalidValue;
}

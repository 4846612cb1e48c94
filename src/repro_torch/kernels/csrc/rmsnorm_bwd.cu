// Row RMSNorm backward for sm_90a: with r = rsqrt(mean(x^2) + eps) and
// x_hat = x * r,
//     dx = (dy * w - x_hat * mean(dy * w * x_hat)) * r      (in x's dtype)
//     dw = sum over rows of dy * x_hat                         (f32)
//
// Replaces the Pallas TPU kernel `rmsnorm_bwd` (`_bwd_kernel`) of
// src/repro/kernels/rmsnorm/kernel.py.  The TPU kernel carries dw in VMEM
// scratch across its sequential grid of row blocks; blocks on the GPU run in
// no order, so dw is formed in two stages instead: each block of the first
// kernel writes the f32 sum over its rows to its own row of a
// (n_blocks, D) buffer, and a second kernel sums that buffer down its columns
// in block order.  No atomics: the result is the same on every run.
//
// What bounds it on the H100: memory.  It reads x and dy once and writes dx
// once (3 * N * D * itemsize bytes, plus w and dw), with ~10 flops per
// element.  The first kernel gives each row to one warp with 16-byte vector
// accesses whenever D allows (8 bf16 or 4 f32 per lane), reduces the two row
// sums (x^2 and dy * w * x) with shuffles, and reads the row again (from
// L1/L2) to write dx and add dy * x_hat into the warp's own f32 slice of
// shared memory; the block then sums its warps' slices in a fixed order.
// The partial buffer costs 2 * n_blocks * D * 4 bytes of extra traffic
// (~4 MB at N = 4096, D = 2048 against ~50 MB for the rows).  D = d_model and
// D = head_dim (qk-norm) are the training shapes; any D whose eight warp
// slices fit in shared memory works, odd D included.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int REDUCE_THREADS = 256;

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

// Block b handles rows [b * rows_per_block, (b + 1) * rows_per_block); warp w
// of the block takes every WARPS-th of them.  partial[b, :] = the block's dw.
template <typename T, int VEC>
__global__ void __launch_bounds__(WARPS * 32)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ partial, long long n, int d, float eps,
                       long long rows_per_block) {
  extern __shared__ float slices[];  // [WARPS][d]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < WARPS * d; i += WARPS * 32) slices[i] = 0.f;
  __syncthreads();
  float* mine = slices + warp * d;

  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);
  for (long long row = r0 + warp; row < r1; row += WARPS) {  // uniform per warp
    const T* xr = x + row * d;
    const T* dyr = dy + row * d;
    T* dxr = dx + row * d;

    float ss = 0.f, sd = 0.f;
    for (int c = lane * VEC; c < d; c += 32 * VEC) {
      float f[VEC], g[VEC], wv[VEC];
      load(xr + c, f);
      load(dyr + c, g);
      load(w + c, wv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ss += f[e] * f[e];
        sd += g[e] * wv[e] * f[e];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      sd += __shfl_xor_sync(0xffffffffu, sd, off);
    }
    const float r = rsqrtf(ss / (float)d + eps);
    const float inner = sd * r / (float)d;  // mean(dy * w * x_hat)

    for (int c = lane * VEC; c < d; c += 32 * VEC) {
      float f[VEC], g[VEC], wv[VEC], out[VEC];
      load(xr + c, f);
      load(dyr + c, g);
      load(w + c, wv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xhat = f[e] * r;
        out[e] = (g[e] * wv[e] - xhat * inner) * r;
        mine[c + e] += g[e] * xhat;
      }
      store(dxr + c, out);
    }
  }
  __syncthreads();

  float* dst = partial + (long long)blockIdx.x * d;
  for (int c = threadIdx.x; c < d; c += WARPS * 32) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) s += slices[i * d + c];
    dst[c] = s;
  }
}

// dw[c] = sum over blocks, in block order, of partial[b, c].
__global__ void __launch_bounds__(REDUCE_THREADS)
    rmsnorm_dw_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                             int n_blocks, int d) {
  const int c = blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partial[(long long)b * d + c];
  dw[c] = s;
}

template <typename T, int VEC>
int launch(const void* x, const void* w, const void* dy, void* dx, float* partial, float* dw,
           long long n, int d, float eps, int n_blocks, long long rows_per_block,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * WARPS * (size_t)d;
  cudaError_t err = cudaFuncSetAttribute(
      rmsnorm_bwd_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  rmsnorm_bwd_kernel<T, VEC><<<n_blocks, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(dy),
      static_cast<T*>(dx), partial, n, d, eps, rows_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rmsnorm_dw_reduce_kernel<<<(d + REDUCE_THREADS - 1) / REDUCE_THREADS, REDUCE_THREADS, 0,
                             stream>>>(partial, dw, n_blocks, d);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// x, dy, dx: (n, d) row-major; w: (d,), all of one dtype (0 = float32,
// 1 = bfloat16).  partial: (n_blocks, d) f32 scratch; dw: (d,) f32.  The rows
// are cut into n_blocks blocks of rows_per_block rows (n_blocks *
// rows_per_block >= n).  Returns cudaGetLastError() after the launches (0 on
// success).
extern "C" int rmsnorm_bwd(const void* x, const void* w, const void* dy, void* dx,
                           void* partial, void* dw, int dtype, long long n, int d, float eps,
                           int n_blocks, long long rows_per_block, void* stream) {
  if (n <= 0 || d <= 0 || n_blocks <= 0 || (long long)n_blocks * rows_per_block < n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  float* dwf = static_cast<float*>(dw);
  const bool vec_ok = aligned16(x) && aligned16(w) && aligned16(dy) && aligned16(dx);
  if (dtype == 0) {
    if (vec_ok && d % 4 == 0)
      return launch<float, 4>(x, w, dy, dx, part, dwf, n, d, eps, n_blocks, rows_per_block, st);
    return launch<float, 1>(x, w, dy, dx, part, dwf, n, d, eps, n_blocks, rows_per_block, st);
  }
  if (dtype == 1) {
    if (vec_ok && d % 8 == 0)
      return launch<__nv_bfloat16, 8>(x, w, dy, dx, part, dwf, n, d, eps, n_blocks,
                                      rows_per_block, st);
    return launch<__nv_bfloat16, 1>(x, w, dy, dx, part, dwf, n, d, eps, n_blocks,
                                    rows_per_block, st);
  }
  return (int)cudaErrorInvalidValue;
}

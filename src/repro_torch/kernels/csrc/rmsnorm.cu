// Row RMSNorm forward for sm_90a: y = x * rsqrt(mean(x^2) + eps) * w, reduced
// in f32 and written in x's dtype.
//
// Replaces the Pallas TPU kernel `rmsnorm_fwd` (`_fwd_kernel`) of
// src/repro/kernels/rmsnorm/kernel.py.
//
// What bounds it on the H100: memory.  It reads each row once and writes it
// once (2 * N * D * itemsize bytes plus w), with ~4 flops per element, far
// below the ~295 flop/byte ridge.  The design reads each row from device
// memory once, in full-width transactions:
//  * 16-byte accesses (8 bf16 or 4 f32 a lane) whenever the row and the
//    pointers allow, one element a lane otherwise;
//  * rows of up to 512 accesses (D <= 4096 in bf16, 2048 in f32) stay in
//    registers between the sum of squares and the scaled store: a group of
//    G = 8, 16 or 32 lanes takes a row, lane l holding accesses j * G + l,
//    j < CH (16 accesses, 64 registers, at D = 4096 bf16).  A warp takes
//    32 / G rows at once, RG times over, and issues every load before the
//    first reduction, so each lane has at least four 16-byte loads in flight
//    (at D = 64 bf16: groups of 8 lanes, 16 rows a warp, none idle);
//  * the lane's columns of w are loaded with the rows and held too: read
//    after the reduction, their latency (from device memory on a cold L2)
//    came on top of the rows', and that chain set the time of a call of a
//    few rows;
//  * the sum of squares is a shuffle reduction inside each group (xor
//    offsets below G), f32 throughout;
//  * rows of 513 to 1024 16-byte accesses (D <= 8192 in bf16, 4096 in f32:
//    internvl2-26b's 6144) stay in registers too, held by a group of four
//    warps, at most 8 accesses of x and 8 of w a lane (6 each at D = 6144
//    bf16); each warp's shuffle-reduced sum of squares meets the group's
//    other three in shared memory, added in warp order by every lane, so a
//    row's scale does not depend on the launch;
//  * blocks shrink from 8 warps to as few as one (one group of four for the
//    wide rows) until there are as many blocks as SMs, so short calls still
//    spread over the card;
//  * wider rows, and unaligned rows past 512 elements (one element a lane),
//    take a looped kernel that reads each row a second time (from L1/L2) to
//    scale and store it.
// One launch a call.  D = d_model (1024, 2048, 4096, 6144) and D = head_dim
// (64: the rwkv6 group norm) are the path's widths.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int MAX_WARPS = 8;

// Rows of up to G * CH accesses of VEC elements, held in registers.  Group
// g = lane / G of warp w in block b takes rows
// ((b * warps + w) * RG + k) * (32 / G) + g, k < RG; its lane l = lane % G
// holds columns (j * G + l) * VEC + e, j < CH, e < VEC, of each.
template <typename T, int VEC, int G, int CH, int RG>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    rmsnorm_fwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            T* __restrict__ y, long long n, int d, float eps) {
  using R = typename Raw<T, VEC>::type;
  constexpr int GPW = 32 / G;  // row groups of a warp at once
  const int lane = threadIdx.x & 31;
  const int l = lane % G;
  const long long first =
      ((long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * RG * GPW + lane / G;

  // every load first; a group past the last row holds zeros and stores nothing
  R xr[RG][CH], wr[CH];
#pragma unroll
  for (int k = 0; k < RG; ++k) {
    const long long row = first + k * GPW;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int c = (j * G + l) * VEC;
      xr[k][j] = zero<R>();
      if (row < n && c < d) xr[k][j] = *reinterpret_cast<const R*>(x + row * d + c);
    }
  }
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int c = (j * G + l) * VEC;
    wr[j] = zero<R>();
    if (c < d) wr[j] = *reinterpret_cast<const R*>(w + c);
  }
  float r[RG];
#pragma unroll
  for (int k = 0; k < RG; ++k) {
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      float f[VEC];
      unpack(xr[k][j], f);
#pragma unroll
      for (int e = 0; e < VEC; ++e) ss += f[e] * f[e];
    }
    // uniform across the warp: every lane takes part in the shuffles
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    r[k] = rsqrtf(ss / (float)d + eps);
  }

#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int c = (j * G + l) * VEC;
    if (c < d) {
      opaque(wr[j]);
      float g[VEC];
      unpack(wr[j], g);
#pragma unroll
      for (int k = 0; k < RG; ++k) {
        const long long row = first + k * GPW;
        if (row < n) {
          opaque(xr[k][j]);
          float f[VEC];
          unpack(xr[k][j], f);
#pragma unroll
          for (int e = 0; e < VEC; ++e) f[e] = f[e] * r[k] * g[e];
          store(y + row * d + c, f);
        }
      }
    }
  }
}

// Rows of up to 32 * W * CH accesses, held in registers by a group of W
// warps: warp v = warp % W of group g = warp / W of block b takes
// row b * (warps / W) + g, its lane holding accesses j * 32 * W + 32 * v +
// lane, j < CH, and the lane's columns of w.  Each warp's sum of squares goes
// through shared memory, and every lane adds its group's W partials in
// warp order.
template <typename T, int VEC, int W, int CH>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    rmsnorm_fwd_group_kernel(const T* __restrict__ x, const T* __restrict__ w,
                             T* __restrict__ y, long long n, int d, float eps) {
  using R = typename Raw<T, VEC>::type;
  __shared__ float part[MAX_WARPS];
  const int warp = threadIdx.x >> 5;
  const int l = (warp % W) * 32 + (threadIdx.x & 31);
  const long long row = (long long)blockIdx.x * ((blockDim.x >> 5) / W) + warp / W;

  R xr[CH], wr[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int c = (j * 32 * W + l) * VEC;
    xr[j] = zero<R>();
    if (row < n && c < d) xr[j] = *reinterpret_cast<const R*>(x + row * d + c);
  }
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int c = (j * 32 * W + l) * VEC;
    wr[j] = zero<R>();
    if (c < d) wr[j] = *reinterpret_cast<const R*>(w + c);
  }
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    float f[VEC];
    unpack(xr[j], f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) ss += f[e] * f[e];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if ((threadIdx.x & 31) == 0) part[warp] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int v = 0; v < W; ++v) total += part[warp - warp % W + v];
  const float r = rsqrtf(total / (float)d + eps);
  if (row >= n) return;

#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int c = (j * 32 * W + l) * VEC;
    if (c < d) {
      opaque(wr[j]);
      opaque(xr[j]);
      float f[VEC], g[VEC];
      unpack(xr[j], f);
      unpack(wr[j], g);
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = f[e] * r * g[e];
      store(y + row * d + c, f);
    }
  }
}

// Rows wider than the register kernels take, and unaligned rows past 512
// elements: one warp a row, read twice (the second time from L1/L2).
template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    rmsnorm_fwd_loop_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            T* __restrict__ y, long long n, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= n) return;  // uniform per warp
  const T* xr = x + row * d;
  T* yr = y + row * d;

  float ss = 0.f;
#pragma unroll 4
  for (int c = lane * VEC; c < d; c += 32 * VEC) {
    float f[VEC];
    load<T, VEC>(xr + c, f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) ss += f[e] * f[e];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / (float)d + eps);

#pragma unroll 4
  for (int c = lane * VEC; c < d; c += 32 * VEC) {
    float f[VEC], g[VEC];
    load<T, VEC>(xr + c, f);
    load<T, VEC>(w + c, g);
#pragma unroll
    for (int e = 0; e < VEC; ++e) f[e] = f[e] * r * g[e];
    store(yr + c, f);
  }
}

template <typename T>
using KernelFn = void (*)(const T*, const T*, T*, long long, int, float);

enum Kind { ROWS = 0, GROUP = 1, LOOP = 2 };  // which kernel a plan runs

// Launch `kernel` over n rows, `rows` of them a group of `per` warps: 8
// warps a block, halved while there would be fewer blocks than SMs, down to
// one group (or, with `info`, report the plan: registers and local bytes a
// thread, threads and blocks, static shared memory a block, and its kind).
template <typename T>
int launch(KernelFn<T> kernel, Kind kind, long long rows, int per, const void* x,
           const void* w, void* y, long long n, int d, float eps, cudaStream_t stream,
           int* info) {
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  auto need = [&](int warps) { return (n * per + warps * rows - 1) / (warps * rows); };
  int warps = MAX_WARPS;
  while (warps > per && need(warps) < sms) warps /= 2;
  const long long blocks = need(warps);
  if (info != nullptr) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    info[0] = attr.numRegs;
    info[1] = (int)attr.localSizeBytes;
    info[2] = warps * 32;
    info[3] = (int)blocks;
    info[4] = (int)attr.sharedSizeBytes;
    info[5] = kind;
    return 0;
  }
  kernel<<<(unsigned)blocks, warps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), n, d, eps);
  return (int)cudaGetLastError();
}

template <typename T, int VEC, int G, int CH, int RG>
int rows_kernel(const void* x, const void* w, void* y, long long n, int d, float eps,
                cudaStream_t stream, int* info) {
  return launch<T>(rmsnorm_fwd_rows_kernel<T, VEC, G, CH, RG>, ROWS, (long long)RG * (32 / G),
                   1, x, w, y, n, d, eps, stream, info);
}

// the register kernel for rows of at most 512 accesses (at least four a
// lane in flight), groups of four warps a row for 16-byte rows of up to 1024
// accesses, the looped kernel beyond
template <typename T, int VEC>
int dispatch(const void* x, const void* w, void* y, long long n, int d, float eps,
             cudaStream_t st, int* info) {
  const int accesses = (d + VEC - 1) / VEC;
  if (accesses <= 8) return rows_kernel<T, VEC, 8, 1, 4>(x, w, y, n, d, eps, st, info);
  if (accesses <= 16) return rows_kernel<T, VEC, 16, 1, 4>(x, w, y, n, d, eps, st, info);
  if (accesses <= 32) return rows_kernel<T, VEC, 32, 1, 4>(x, w, y, n, d, eps, st, info);
  if (accesses <= 64) return rows_kernel<T, VEC, 32, 2, 2>(x, w, y, n, d, eps, st, info);
  if (accesses <= 128) return rows_kernel<T, VEC, 32, 4, 1>(x, w, y, n, d, eps, st, info);
  if (accesses <= 256) return rows_kernel<T, VEC, 32, 8, 1>(x, w, y, n, d, eps, st, info);
  if (accesses <= 512) return rows_kernel<T, VEC, 32, 16, 1>(x, w, y, n, d, eps, st, info);
  if constexpr (VEC > 1) {
    if (accesses <= 1024)
      return launch<T>(rmsnorm_fwd_group_kernel<T, VEC, 4, 8>, GROUP, 1, 4, x, w, y, n, d, eps,
                       st, info);
  }
  return launch<T>(rmsnorm_fwd_loop_kernel<T, VEC>, LOOP, 1, 1, x, w, y, n, d, eps, st, info);
}

int run(const void* x, const void* w, void* y, int dtype, long long n, int d, float eps,
        cudaStream_t st, int* info) {
  if (n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const bool vec_ok = aligned16(x) && aligned16(w) && aligned16(y);
  if (dtype == 0)
    return vec_ok && d % 4 == 0 ? dispatch<float, 4>(x, w, y, n, d, eps, st, info)
                                : dispatch<float, 1>(x, w, y, n, d, eps, st, info);
  if (dtype == 1)
    return vec_ok && d % 8 == 0 ? dispatch<__nv_bfloat16, 8>(x, w, y, n, d, eps, st, info)
                                : dispatch<__nv_bfloat16, 1>(x, w, y, n, d, eps, st, info);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, y: (n, d) row-major; w: (d,), all of one dtype (0 = float32,
// 1 = bfloat16).  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y, int dtype, long long n, int d,
                           float eps, void* stream) {
  return run(x, w, y, dtype, n, d, eps, static_cast<cudaStream_t>(stream), nullptr);
}

// What rmsnorm_fwd would launch for the same arguments (the pointers decide
// the access width): out[6] = registers and local (spill) bytes a thread,
// threads a block, blocks, static shared memory bytes a block, and the
// kernel (0: a row to a warp or less, 1: a row to four warps, 2: looped).
extern "C" int rmsnorm_fwd_info(const void* x, const void* w, const void* y, int dtype,
                                long long n, int d, int* out) {
  return run(x, w, const_cast<void*>(y), dtype, n, d, 0.f, nullptr, out);
}

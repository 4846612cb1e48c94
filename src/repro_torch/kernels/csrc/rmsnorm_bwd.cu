// Row RMSNorm backward for sm_90a: with r = rsqrt(mean(x^2) + eps) and
// x_hat = x * r,
//     dx = (dy * w - x_hat * mean(dy * w * x_hat)) * r      (in x's dtype)
//     dw = sum over rows of dy * x_hat                         (f32)
//
// Replaces the Pallas TPU kernel `rmsnorm_bwd` (`_bwd_kernel`) of
// src/repro/kernels/rmsnorm/kernel.py.  The TPU kernel carries dw in VMEM
// scratch across its sequential grid of row blocks; blocks on the GPU run in
// no order, so each block writes the f32 dw of its rows to its own row of a
// (n_blocks, D) buffer and a second kernel sums that buffer down its columns
// in a fixed order.  No atomics: the result is the same on every run.
//
// What bounds it on the H100: memory.  It reads x and dy once and writes dx
// once (3 * N * D * itemsize bytes, plus w and dw), with ~10 flops per
// element.  The design reads each row from device memory once:
//  * one warp per row (a group of 8 or 16 lanes per row, several rows a
//    warp, for rows of at most 16 accesses), 16-byte accesses whenever the
//    row and the pointers allow (8 bf16 or 4 f32 a lane);
//  * rows of up to 256 such accesses (D <= 2048 in bf16, 1024 in f32) stay
//    in registers between the two row sums (x^2 and dy * w * x, reduced with
//    shuffles) and the dx write, and every lane adds dy * x_hat for the
//    fixed columns it owns into f32 registers across all its warp's rows;
//    wider rows take a looped kernel that reads the row a second time (from
//    L1/L2) and adds into its warp's f32 slot in shared memory;
//  * the block's warps combine their dw once through shared memory, laid
//    out lane-fastest so that every access is free of bank conflicts, and
//    summed in warp order;
//  * the grid fills the card even at small N: blocks shrink to as few as one
//    warp until there are as many blocks as SMs, up to every SM's resident
//    blocks; a grid of one block writes dw itself (one launch);
//  * the column sum runs on ceil(D / 32) blocks of 32 warps, each warp
//    summing every 32nd partial row of 32 columns, the 32 sums then in order.
// D = d_model and D = head_dim (qk-norm) are the training shapes; any D
// whose eight warp slots fit in shared memory works, odd D included.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int MAX_WARPS = 8;
constexpr int REDUCE_WARPS = 32;
constexpr int SMEM_LIMIT = 232448;  // shared memory a block may use on an H100

// The block's dw: warp slot w holds, at position (j * VEC + e) * G + l, the
// sum for column (j * G + l) * VEC + e (lane-fastest, so the warps' writes
// and these reads are free of bank conflicts).  The slots are summed in warp
// order into row blockIdx.x of `partial`.
template <int VEC, int G>
__device__ __forceinline__ void block_dw(const float* slots, int slot, float* partial, int d) {
  const int warps = blockDim.x >> 5;
  float* dst = partial + (long long)blockIdx.x * d;
  for (int pos = threadIdx.x; pos < slot; pos += blockDim.x) {
    const int l = pos % G;
    const int je = pos / G;
    const int c = ((je / VEC) * G + l) * VEC + je % VEC;
    if (c < d) {
      float s = 0.f;
      for (int w = 0; w < warps; ++w) s += slots[w * slot + pos];
      dst[c] = s;
    }
  }
}

// Rows of up to G * CH accesses of VEC elements, held in registers.  A group
// of G lanes takes a row (32 / G rows a warp at once); lane l of the group
// owns columns (j * G + l) * VEC + e, j < CH, e < VEC, of every row, and
// adds their dw into registers.  Warp w of block b takes rows
// ((b * warps + w) + k * gridDim.x * warps) * 32 / G + group.
template <typename T, int VEC, int G, int CH>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    rmsnorm_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            const T* __restrict__ dy, T* __restrict__ dx,
                            float* __restrict__ partial, long long n, int d, float eps, int) {
  using R = typename Raw<T, VEC>::type;
  constexpr int RPW = 32 / G;         // rows a warp takes at once
  constexpr int SLOT = G * CH * VEC;  // dw columns of a warp slot (>= d)
  extern __shared__ float slots[];    // [warps][SLOT]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int l = lane % G;
  const int warps = blockDim.x >> 5;
  const long long stride = (long long)gridDim.x * warps * RPW;

  float acc[CH][VEC];
#pragma unroll
  for (int j = 0; j < CH; ++j)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[j][e] = 0.f;

  // the loop bound is uniform across the warp (the shuffles need all lanes);
  // a group past the last row loads zeros and stores nothing
  for (long long first = ((long long)blockIdx.x * warps + warp) * RPW; first < n;
       first += stride) {
    const long long row = first + lane / G;
    const bool live = row < n;
    R xr[CH], gr[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int c = (j * G + l) * VEC;
      xr[j] = zero<R>();
      gr[j] = zero<R>();
      if (live && c < d) {
        xr[j] = *reinterpret_cast<const R*>(x + row * d + c);
        gr[j] = *reinterpret_cast<const R*>(dy + row * d + c);
      }
    }
    float ss = 0.f, sd = 0.f;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int c = (j * G + l) * VEC;
      float f[VEC], g[VEC], wv[VEC];
      unpack(xr[j], f);
      unpack(gr[j], g);
      if (c < d) {
        load<T, VEC>(w + c, wv);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) wv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ss += f[e] * f[e];
        sd += g[e] * wv[e] * f[e];
      }
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      sd += __shfl_xor_sync(0xffffffffu, sd, off);
    }
    const float r = rsqrtf(ss / (float)d + eps);
    const float inner = sd * r / (float)d;  // mean(dy * w * x_hat)

#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int c = (j * G + l) * VEC;
      if (c < d) {
        opaque(xr[j]);
        opaque(gr[j]);
        float f[VEC], g[VEC], wv[VEC], out[VEC];
        unpack(xr[j], f);
        unpack(gr[j], g);
        load<T, VEC>(w + c, wv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xhat = f[e] * r;
          out[e] = (g[e] * wv[e] - xhat * inner) * r;
          acc[j][e] += g[e] * xhat;
        }
        if (live) store(dx + row * d + c, out);
      }
    }
  }

  // the warp's row groups hold sums of the same columns: combine them (a
  // butterfly, so every lane ends with the same bits), then one slot a warp
#pragma unroll
  for (int off = G; off < 32; off <<= 1)
#pragma unroll
    for (int j = 0; j < CH; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[j][e] += __shfl_xor_sync(0xffffffffu, acc[j][e], off);
  if (lane < G) {
#pragma unroll
    for (int j = 0; j < CH; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e) slots[warp * SLOT + (j * VEC + e) * G + l] = acc[j][e];
  }
  __syncthreads();
  block_dw<VEC, G>(slots, SLOT, partial, d);
}

// Rows wider than the register kernel takes: one warp a row, read twice
// (the second time from L1/L2), dw added into the warp's slot of `slot`
// floats in shared memory at position (j * VEC + e) * 32 + lane.
template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    rmsnorm_bwd_loop_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            const T* __restrict__ dy, T* __restrict__ dx,
                            float* __restrict__ partial, long long n, int d, float eps,
                            int slot) {
  extern __shared__ float slots[];  // [warps][slot]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* mine = slots + warp * slot;
  for (int i = lane; i < slot; i += 32) mine[i] = 0.f;
  __syncwarp();

  for (long long row = (long long)blockIdx.x * warps + warp; row < n;
       row += (long long)gridDim.x * warps) {  // uniform per warp
    const T* xr = x + row * d;
    const T* dyr = dy + row * d;
    T* dxr = dx + row * d;

    float ss = 0.f, sd = 0.f;
#pragma unroll 4
    for (int c = lane * VEC; c < d; c += 32 * VEC) {
      float f[VEC], g[VEC], wv[VEC];
      load<T, VEC>(xr + c, f);
      load<T, VEC>(dyr + c, g);
      load<T, VEC>(w + c, wv);
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
    const float inner = sd * r / (float)d;

#pragma unroll 4
    for (int c = lane * VEC, j = 0; c < d; c += 32 * VEC, ++j) {
      float f[VEC], g[VEC], wv[VEC], out[VEC];
      load<T, VEC>(xr + c, f);
      load<T, VEC>(dyr + c, g);
      load<T, VEC>(w + c, wv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xhat = f[e] * r;
        out[e] = (g[e] * wv[e] - xhat * inner) * r;
        mine[(j * VEC + e) * 32 + lane] += g[e] * xhat;
      }
      store(dxr + c, out);
    }
  }
  __syncthreads();
  block_dw<VEC, 32>(slots, slot, partial, d);
}

// dw[c] = the sum of partial[b, c] over b: warp k of the block sums rows
// b = k, k + 32, ... of its 32 columns, then the 32 sums are added in order.
__global__ void __launch_bounds__(REDUCE_WARPS * 32)
    rmsnorm_dw_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                             int n_blocks, int d) {
  __shared__ float sums[REDUCE_WARPS][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < d) {
#pragma unroll 4
    for (int b = warp; b < n_blocks; b += REDUCE_WARPS) s += partial[(long long)b * d + c];
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < d) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < REDUCE_WARPS; ++k) t += sums[k][lane];
    dw[c] = t;
  }
}

template <typename T>
using KernelFn = void (*)(const T*, const T*, const T*, T*, float*, long long, int, float, int);

template <typename T, int VEC, int G, int CH>  // CH = 0: the looped kernel
KernelFn<T> kernel_of() {
  if constexpr (CH == 0)
    return rmsnorm_bwd_loop_kernel<T, VEC>;
  else
    return rmsnorm_bwd_rows_kernel<T, VEC, G, CH>;
}

struct Call {
  const void* x;
  const void* w;
  const void* dy;
  void* dx;
  void* partial;
  void* dw;
  long long n;
  int d;
  float eps;
  int max_blocks;
  cudaStream_t stream;
};

// Plan the grid of one kernel instance and launch it (or, with `info`, report
// the plan instead): 8 warps a block (fewer where their dw slots would not
// fit in shared memory), halved while there would be fewer blocks than SMs;
// as many blocks as the rows need, at most every SM's resident blocks and
// max_blocks.  One block writes dw itself; more add the column sum.
template <typename T, int VEC, int G, int CH>
int launch(const Call& a, int* info) {
  const KernelFn<T> kernel = kernel_of<T, VEC, G, CH>();
  static bool configured = false;  // one attribute call per instance
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int chunk = (CH > 0 ? G * CH : 32) * VEC;  // columns a warp's pass covers
  const int slot = CH > 0 ? chunk : (a.d + chunk - 1) / chunk * chunk;
  const long long rows = CH > 0 ? 32 / G : 1;  // rows a warp takes at once
  auto need = [&](int warps) { return (a.n + warps * rows - 1) / (warps * rows); };
  int warps = MAX_WARPS;
  while (warps > 1 && warps * slot * 4 > SMEM_LIMIT) warps /= 2;
  if (need(warps) > 1)
    while (warps > 1 && need(warps) < sms) warps /= 2;
  const int smem = warps * slot * 4;
  int resident = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, warps * 32, smem);
  if (err != cudaSuccess) return (int)err;
  if (resident < 1 || warps * slot * 4 > SMEM_LIMIT) return (int)cudaErrorInvalidConfiguration;
  const long long cap = (long long)resident * sms < a.max_blocks ? (long long)resident * sms
                                                                  : (long long)a.max_blocks;
  const int blocks = (int)(need(warps) < cap ? need(warps) : cap);
  if (info != nullptr) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    info[0] = attr.numRegs;
    info[1] = (int)attr.localSizeBytes;
    info[2] = smem;
    info[3] = warps * 32;
    info[4] = blocks;
    info[5] = blocks > 1 ? 2 : 1;
    return 0;
  }
  float* dw = static_cast<float*>(a.dw);
  float* part = blocks > 1 ? static_cast<float*>(a.partial) : dw;
  kernel<<<blocks, warps * 32, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w), static_cast<const T*>(a.dy),
      static_cast<T*>(a.dx), part, a.n, a.d, a.eps, slot);
  err = cudaGetLastError();
  if (err != cudaSuccess || blocks == 1) return (int)err;
  rmsnorm_dw_reduce_kernel<<<(a.d + 31) / 32, REDUCE_WARPS * 32, 0, a.stream>>>(part, dw, blocks,
                                                                                a.d);
  return (int)cudaGetLastError();
}

// the register kernel for rows of at most 256 accesses, the looped one beyond
template <typename T, int VEC>
int dispatch(const Call& a, int* info) {
  const int accesses = (a.d + VEC - 1) / VEC;
  if (accesses <= 8) return launch<T, VEC, 8, 1>(a, info);
  if (accesses <= 16) return launch<T, VEC, 16, 1>(a, info);
  if (accesses <= 32) return launch<T, VEC, 32, 1>(a, info);
  if (accesses <= 64) return launch<T, VEC, 32, 2>(a, info);
  if (accesses <= 128) return launch<T, VEC, 32, 4>(a, info);
  if (accesses <= 256) return launch<T, VEC, 32, 8>(a, info);
  return launch<T, VEC, 32, 0>(a, info);
}

int run(const Call& a, int dtype, int* info) {
  if (a.n <= 0 || a.d <= 0 || a.max_blocks <= 0) return (int)cudaErrorInvalidValue;
  const bool vec_ok = aligned16(a.x) && aligned16(a.w) && aligned16(a.dy) && aligned16(a.dx);
  if (dtype == 0)
    return vec_ok && a.d % 4 == 0 ? dispatch<float, 4>(a, info) : dispatch<float, 1>(a, info);
  if (dtype == 1)
    return vec_ok && a.d % 8 == 0 ? dispatch<__nv_bfloat16, 8>(a, info)
                                  : dispatch<__nv_bfloat16, 1>(a, info);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, dy, dx: (n, d) row-major; w: (d,), all of one dtype (0 = float32,
// 1 = bfloat16).  partial: (max_blocks, d) f32 scratch; dw: (d,) f32.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int rmsnorm_bwd(const void* x, const void* w, const void* dy, void* dx,
                           void* partial, void* dw, int dtype, long long n, int d, float eps,
                           int max_blocks, void* stream) {
  const Call a{x, w, dy, dx, partial, dw, n, d, eps, max_blocks,
               static_cast<cudaStream_t>(stream)};
  return run(a, dtype, nullptr);
}

// What rmsnorm_bwd would launch for the same arguments (the pointers decide
// the access width): out[6] = registers and local (spill) bytes a thread,
// dynamic shared memory bytes and threads a block, and blocks of the row
// kernel, and launches (1, or 2 with the column sum).
extern "C" int rmsnorm_bwd_info(const void* x, const void* w, const void* dy, const void* dx,
                                int dtype, long long n, int d, int max_blocks, int* out) {
  const Call a{x, w, dy, const_cast<void*>(dx), nullptr, nullptr, n, d, 0.f, max_blocks,
               nullptr};
  return run(a, dtype, out);
}

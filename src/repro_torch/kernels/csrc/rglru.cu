// RG-LRU diagonal linear recurrence for sm_90a: h_t = a_t * h_{t-1} + b_t over
// (B, S, D), f32 state, y in a's dtype and the final state in f32.
//
// Replaces the Pallas TPU kernel `rglru_pallas` (`_rglru_kernel`) of
// src/repro/kernels/rglru/kernel.py.  There a (B, D/512, S/128) grid carries
// the (1, 512) f32 state in VMEM across its sequential chunk axis.
//
// What bounds it on the H100: memory.  Each element is read once from a and b
// and written once to y, with two flops per element, so at the model's shape
// (1, 2560, 4096) f32 it moves 126 MB: a bound of 37.5 us at 3.35 TB/s.
//
// Design:
//  * one thread per (batch row, channel) keeps h in a register; a loop over
//    time replaces the TPU's sequential chunk axis, and the chunk disappears
//    (any S works);
//  * neighbouring threads take neighbouring channels, so each step's loads of
//    a_t, b_t and store of y_t are coalesced across the warp;
//  * the loads do not depend on h, so each thread keeps a ring of PREFETCH
//    steps of (a_t, b_t) in registers, refilled PREFETCH steps ahead; without
//    it every step would wait one trip to memory;
//  * h = a * h + b is evaluated as a rounded product then a rounded sum (no
//    FMA contraction), the order of the plain PyTorch version, so in f32 the
//    kernel agrees with it bit for bit.
// Known weakness: at B = 1 the grid has only D threads (4,096 at the model's
// width) for 132 SMs, so it cannot keep enough loads in flight to reach the
// bound; a chunked two-pass scan is the later redesign (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr int PREFETCH = 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Params {
  const void* a;
  const void* b;
  const float* h0;  // (B, D) or null: zero initial state
  void* y;          // (B, S, D) contiguous
  float* h_out;     // (B, D)
  int S, D;
  long long sab, sas;  // a: batch and time strides (channel stride 1)
  long long sbb, sbs;  // b: the same
};

template <typename T>
__global__ void __launch_bounds__(THREADS) rglru_fwd_kernel(Params p) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const int bi = blockIdx.y;
  if (d >= p.D) return;
  const T* a = static_cast<const T*>(p.a) + bi * p.sab + d;
  const T* b = static_cast<const T*>(p.b) + bi * p.sbb + d;
  T* y = static_cast<T*>(p.y) + (long long)bi * p.S * p.D + d;
  float h = p.h0 ? p.h0[(long long)bi * p.D + d] : 0.f;

  float an[PREFETCH], bn[PREFETCH];
#pragma unroll
  for (int q = 0; q < PREFETCH; ++q) {
    if (q < p.S) {
      an[q] = to_f32(a[q * p.sas]);
      bn[q] = to_f32(b[q * p.sbs]);
    }
  }
  for (int t0 = 0; t0 < p.S; t0 += PREFETCH) {
#pragma unroll
    for (int q = 0; q < PREFETCH; ++q) {
      const int t = t0 + q;
      if (t >= p.S) break;
      const float at = an[q];
      const float bt = bn[q];
      const int tn = t + PREFETCH;
      if (tn < p.S) {
        an[q] = to_f32(a[tn * p.sas]);
        bn[q] = to_f32(b[tn * p.sbs]);
      }
      h = __fadd_rn(__fmul_rn(at, h), bt);
      y[(long long)t * p.D] = from_f32<T>(h);
    }
  }
  p.h_out[(long long)bi * p.D + d] = h;
}

template <typename T>
int launch(const Params& p, int B, cudaStream_t stream) {
  const dim3 grid((p.D + THREADS - 1) / THREADS, B);
  rglru_fwd_kernel<T><<<grid, THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b: (B, S, D) of one dtype (0 = float32, 1 = bfloat16), channel axis
// contiguous, batch/time strides in elements; h0: (B, D) f32 or null; y:
// (B, S, D) contiguous in a's dtype; h_out: (B, D) f32.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int rglru_fwd(const void* a, const void* b, const void* h0, void* y, void* h_out,
                         int dtype, int B, int S, int D,
                         long long sab, long long sas, long long sbb, long long sbs,
                         void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.a = a;
  p.b = b;
  p.h0 = static_cast<const float*>(h0);
  p.y = y;
  p.h_out = static_cast<float*>(h_out);
  p.S = S;
  p.D = D;
  p.sab = sab; p.sas = sas;
  p.sbb = sbb; p.sbs = sbs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, B, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, B, st);
  return (int)cudaErrorInvalidValue;
}

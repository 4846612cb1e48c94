// RWKV-6 WKV recurrence for sm_90a, per (batch row, head) with an f32 K x V
// state S:
//   y_t = r_t . (S + diag(u) k_t v_t^T),   S <- diag(w_t) S + k_t v_t^T
// r, k (B, S, H, K) and v (B, S, H, V) in the model dtype, w (B, S, H, K) in
// its own dtype (f32 on the model's path), u (H, K) f32, state (B, H, K, V)
// f32 -> y (B, S, H, V) in r's dtype and the final state in f32.
//
// Replaces the Pallas TPU kernel `wkv6_pallas` (`_wkv_kernel`) of
// src/repro/kernels/rwkv6/kernel.py.  There a (B*H, S/64) grid carries the
// state in VMEM across its sequential chunk axis, over inputs its wrapper
// first folds and transposes to (B*H, S, K).
//
// What bounds it on the H100: at the model's shape (1, 512, 32, 64) it moves
// ~13.6 MB (4.1 us at 3.35 TB/s) and does 4 f32 flops per state element and
// step, 268 MFLOP (4.0 us at 67 TFLOP/s): neither, in practice, since each
// (batch row, head) is one sequential chain of S steps and there are only
// B*H = 32 chains.  Latency per step is what the design attacks.
//
// Design:
//  * one block per (batch row, head); thread j owns column j of the state in
//    K registers (K = V; 64 on the model's path, 16 and 32 for small models);
//  * each step, the block stages r_t, k_t, w_t in shared memory (double
//    buffered, so one __syncthreads per step), and reduces the bonus scalar
//    sum_i r_i u_i k_i once with warp shuffles; then
//    y_j = sum_i r_i S_ij + bonus * v_j and S_ij <- w_i S_ij + k_i v_j;
//  * the inputs are read in the model's (B, S, H, K) layout through their
//    strides, so the reference wrapper's folds and transposes cost no copies,
//    and each in its own dtype (bf16 r/k/v beside f32 w; w is never rounded);
//  * the loads do not depend on the state: each thread keeps a ring of
//    PREFETCH steps of (r, k, w, v) in registers, refilled PREFETCH ahead;
//  * the state update is a rounded product plus a rounded product (no FMA
//    contraction), the plain PyTorch version's order, so the final state
//    agrees with it bit for bit in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int PREFETCH = 8;

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

enum { R = 0, KK = 1, VV = 2, W = 3 };

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;   // (H, K)
  const float* s0;  // (B, H, K, K) or null: zero initial state
  void* y;          // (B, S, H, K) contiguous
  float* s_out;     // (B, H, K, K)
  int S, H;
  long long st[4][3];  // r, k, v, w: batch, time and head strides (channel stride 1)
};

// threads of a block: one per state column, at least one full warp
__host__ __device__ constexpr int threads(int k) { return k < 32 ? 32 : k; }

template <typename T, typename TW, int K>
__global__ void __launch_bounds__(K < 32 ? 32 : K) wkv6_fwd_kernel(Params p) {
  constexpr int NT = threads(K);
  constexpr int WARPS = NT / 32;
  __shared__ float rs[2][K], ks[2][K], ws[2][K], part[2][WARPS];

  const int j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const bool active = j < K;
  const int c = active ? j : 0;  // idle lanes of a 32-lane block read channel 0

  const T* r = static_cast<const T*>(p.r) + b * p.st[R][0] + h * p.st[R][2] + c;
  const T* k = static_cast<const T*>(p.k) + b * p.st[KK][0] + h * p.st[KK][2] + c;
  const T* v = static_cast<const T*>(p.v) + b * p.st[VV][0] + h * p.st[VV][2] + c;
  const TW* w = static_cast<const TW*>(p.w) + b * p.st[W][0] + h * p.st[W][2] + c;
  const long long srs = p.st[R][1], sks = p.st[KK][1], svs = p.st[VV][1], sws = p.st[W][1];
  T* y = static_cast<T*>(p.y) + ((long long)b * p.S * p.H + h) * K + c;
  const long long sys = (long long)p.H * K;
  const long long state_base = ((long long)b * p.H + h) * K * K;

  float s[K];  // s[i] = S[i][j]
#pragma unroll
  for (int i = 0; i < K; ++i) s[i] = p.s0 ? p.s0[state_base + i * K + c] : 0.f;
  const float u = p.u[h * K + c];

  float rn[PREFETCH], kn[PREFETCH], wn[PREFETCH], vn[PREFETCH];
#pragma unroll
  for (int q = 0; q < PREFETCH; ++q) {
    if (q < p.S) {
      rn[q] = to_f32(r[q * srs]);
      kn[q] = to_f32(k[q * sks]);
      wn[q] = to_f32(w[q * sws]);
      vn[q] = to_f32(v[q * svs]);
    }
  }

  for (int t0 = 0; t0 < p.S; t0 += PREFETCH) {
#pragma unroll
    for (int q = 0; q < PREFETCH; ++q) {
      const int t = t0 + q;
      if (t >= p.S) break;  // uniform across the block
      const int buf = t & 1;
      const float rt = rn[q], kt = kn[q], wt = wn[q], vt = vn[q];
      const int tn = t + PREFETCH;
      if (tn < p.S) {
        rn[q] = to_f32(r[tn * srs]);
        kn[q] = to_f32(k[tn * sks]);
        wn[q] = to_f32(w[tn * sws]);
        vn[q] = to_f32(v[tn * svs]);
      }
      if (active) {
        rs[buf][j] = rt;
        ks[buf][j] = kt;
        ws[buf][j] = wt;
      }
      float ruk = active ? rt * u * kt : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ruk += __shfl_xor_sync(0xffffffffu, ruk, off);
      if (lane == 0) part[buf][warp] = ruk;
      __syncthreads();

      float bonus = 0.f;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) bonus += part[buf][i];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        acc = fmaf(rs[buf][i], s[i], acc);
        s[i] = __fadd_rn(__fmul_rn(ws[buf][i], s[i]), __fmul_rn(ks[buf][i], vt));
      }
      if (active) y[t * sys] = from_f32<T>(fmaf(bonus, vt, acc));
    }
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < K; ++i) p.s_out[state_base + i * K + j] = s[i];
  }
}

template <typename T, typename TW, int K>
int launch(const Params& p, int B, cudaStream_t stream) {
  wkv6_fwd_kernel<T, TW, K><<<B * p.H, threads(K), 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, typename TW>
int dispatch_k(const Params& p, int B, int K, cudaStream_t stream) {
  switch (K) {
    case 16: return launch<T, TW, 16>(p, B, stream);
    case 32: return launch<T, TW, 32>(p, B, stream);
    case 64: return launch<T, TW, 64>(p, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_w(const Params& p, int wdtype, int B, int K, cudaStream_t stream) {
  if (wdtype == 0) return dispatch_k<T, float>(p, B, K, stream);
  if (wdtype == 1) return dispatch_k<T, __nv_bfloat16>(p, B, K, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// r, k, v: one dtype (0 = float32, 1 = bfloat16); w: wdtype; channel axes
// contiguous; strides: 12 int64 (batch, time, head) for r, k, v, w in
// elements.  u: (H, K) f32; s0: (B, H, K, K) f32 or null; y: (B, S, H, K)
// contiguous in r's dtype; s_out: (B, H, K, K) f32.  K = V in {16, 32, 64}.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
                        const void* u, const void* s0, void* y, void* s_out,
                        int dtype, int wdtype, int B, int S, int H, int K,
                        const long long* strides, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.r = r;
  p.k = k;
  p.v = v;
  p.w = w;
  p.u = static_cast<const float*>(u);
  p.s0 = static_cast<const float*>(s0);
  p.y = y;
  p.s_out = static_cast<float*>(s_out);
  p.S = S;
  p.H = H;
  for (int x = 0; x < 4; ++x)
    for (int d = 0; d < 3; ++d) p.st[x][d] = strides[3 * x + d];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_w<float>(p, wdtype, B, K, st);
  if (dtype == 1) return dispatch_w<__nv_bfloat16>(p, wdtype, B, K, st);
  return (int)cudaErrorInvalidValue;
}

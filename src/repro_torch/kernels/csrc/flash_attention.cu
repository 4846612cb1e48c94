// Flash-attention forward for sm_90a: online-softmax GQA attention with causal
// and sliding-window masks, in the model's (B, S, H, hd) / (B, T, KV, hd)
// layout.
//
// Replaces the Pallas TPU kernel `flash_fwd` (`_fwd_kernel`) of
// src/repro/kernels/flash_attention/kernel.py.  Same function: f32 running
// max, denominator and accumulator; KV head h / group; scale hd**-0.5 applied
// to the f32 scores; out in the input dtype and lse = m + log(l) in f32.
//
// What bounds it on the H100: at the serving shapes (S = T = 512, 32 heads,
// hd 64) the work is ~1.1 GFLOP against ~5 MB of traffic, so a tensor-core
// kernel would be memory bound at ~1.6 us.  This first version does its
// products with f32 FMAs from shared memory (no mma/wgmma), so it is bound by
// shared-memory bandwidth and FMA throughput instead; see PERF.md for its measured time.
//
// Design:
//  * one block per (query tile of BQ = 32 rows, head, batch row); 128 threads,
//    four per query row (a "quad" of neighbouring lanes);
//  * the block walks only the key tiles the mask leaves (causal upper bound,
//    window lower bound), staging each BK = 64-key tile of K and V in shared
//    memory as f32; the TPU kernel's sequential grid axis becomes this loop;
//  * each quad lane scores 16 of the 64 keys, the quad reduces max and sum
//    with two shuffles, writes its probabilities to a shared tile, and then
//    each lane accumulates HD / 4 interleaved output columns;
//  * ragged S and T edges are masked here, so every prefill length runs
//    through the kernel (the reference's untiled fallback is not needed);
//  * shared-memory strides are padded (HD + 1, BK + 4) so the quad access
//    patterns are free of bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 32;
constexpr int BK = 64;
constexpr int THREADS = 4 * BQ;
constexpr int PSTRIDE = BK + 4;
constexpr float NEG = -1.0e30f;  // below any admissible score

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int S, T, H, group;
  long long sqb, sqs, sqh;
  long long skb, skt, skh;
  long long svb, svt, svh;
  long long sob, sos, soh;
  int causal;
  int window;  // <= 0: no window
  float scale;
};

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

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * PSTRIDE);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  float* Qs = smem;                // [BQ][HD + 1]
  float* Ks = Qs + BQ * (HD + 1);  // [BK][HD + 1]
  float* Vs = Ks + BK * (HD + 1);  // [BK][HD]
  float* Ps = Vs + BK * HD;        // [BQ][PSTRIDE]

  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int sub = tid & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / p.group;
  const int qpos = q0 + row;

  const T* q = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
  const T* k = static_cast<const T*>(p.k) + b * p.skb + kvh * p.skh;
  const T* v = static_cast<const T*>(p.v) + b * p.svb + kvh * p.svh;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    const int s = q0 + r;
    Qs[r * (HD + 1) + d] = s < p.S ? to_f32(q[s * p.sqs + d]) : 0.f;
  }

  float m = NEG;
  float l = 0.f;
  float acc[HD / 4];
#pragma unroll
  for (int c = 0; c < HD / 4; ++c) acc[c] = 0.f;

  // key tiles that intersect the mask support of this query tile
  int k_lo = 0;
  int k_hi = p.T;
  if (p.causal) k_hi = min(k_hi, q0 + BQ);
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);

  const float* qrow = Qs + row * (HD + 1);
  float* prow = Ps + row * PSTRIDE;

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // Q staged / previous K, V tile consumed
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int j = i / HD, d = i % HD;
      const int t = k0 + j;
      const bool in = t < p.T;
      Ks[j * (HD + 1) + d] = in ? to_f32(k[t * p.skt + d]) : 0.f;
      Vs[j * HD + d] = in ? to_f32(v[t * p.svt + d]) : 0.f;
    }
    __syncthreads();

    float s[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) s[i] += qd * Ks[(sub + 4 * i) * (HD + 1) + d];
    }

    float tile_max = NEG;
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const int t = k0 + sub + 4 * i;
      const bool ok = t < p.T && (!p.causal || t <= qpos) &&
                      (p.window <= 0 || t > qpos - p.window);
      s[i] = ok ? s[i] * p.scale : NEG;
      tile_max = fmaxf(tile_max, s[i]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);

    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const float pv = s[i] > NEG ? expf(s[i] - m_new) : 0.f;
      prow[sub + 4 * i] = pv;
      psum += pv;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // the quad's probabilities are visible to all four lanes

#pragma unroll
    for (int c = 0; c < HD / 4; ++c) acc[c] *= alpha;
    for (int j = 0; j < BK; ++j) {
      const float pj = prow[j];
#pragma unroll
      for (int c = 0; c < HD / 4; ++c) acc[c] += pj * Vs[j * HD + sub + 4 * c];
    }
  }

  if (qpos < p.S) {
    const float lsafe = fmaxf(l, 1e-30f);
    T* o = static_cast<T*>(p.o) + b * p.sob + h * p.soh + qpos * p.sos;
#pragma unroll
    for (int c = 0; c < HD / 4; ++c) o[sub + 4 * c] = from_f32<T>(acc[c] / lsafe);
    if (sub == 0) p.lse[((long long)b * p.H + h) * p.S + qpos] = m + logf(lsafe);
  }
}

template <typename T, int HD>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.S + BQ - 1) / BQ, p.H, B);
  flash_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const Params& p, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(p, B, stream);
    case 64: return launch<T, 64>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the head_dim
// axis of q, k, v and out must be contiguous.  window <= 0 means none.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                         int dtype, int B, int S, int T, int H, int KV, int hd,
                         long long sqb, long long sqs, long long sqh,
                         long long skb, long long skt, long long skh,
                         long long svb, long long svt, long long svh,
                         long long sob, long long sos, long long soh,
                         int causal, int window, float scale, void* stream) {
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = out;
  p.lse = static_cast<float*>(lse);
  p.S = S;
  p.T = T;
  p.H = H;
  p.group = H / KV;
  p.sqb = sqb; p.sqs = sqs; p.sqh = sqh;
  p.skb = skb; p.skt = skt; p.skh = skh;
  p.svb = svb; p.svt = svt; p.svh = svh;
  p.sob = sob; p.sos = sos; p.soh = soh;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_hd<float>(p, B, hd, st);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(p, B, hd, st);
  return (int)cudaErrorInvalidValue;
}

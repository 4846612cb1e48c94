// Flash-attention backward for sm_90a: dq, and dk/dv already reduced over the
// GQA group, in the model's (B, S, H, hd) / (B, T, KV, hd) layout.
//
// Replaces the Pallas TPU kernels `flash_bwd_dq` (`_dq_kernel`) and
// `flash_bwd_dkv` (`_dkv_kernel`) of src/repro/kernels/flash_attention/kernel.py.
// Same function: recompute p = exp(s * scale - lse) from the forward's f32
// log-sum-exp, ds = p * (dp - delta) with dp = do . v and delta = rowsum(do * out),
// then dq = sum_k ds . k * scale, dv = sum_q p^T . do, dk = sum_q ds^T . q * scale,
// all accumulated in f32 and written in the input dtype.
//
// What bounds it on the H100: at the training shape (B = 4, S = T = 1024,
// 32/8 heads, hd 64, causal) dq needs 25.8 GFLOP and dkv 34.4 GFLOP against
// ~60 and ~51 MB of traffic, so a tensor-core version would be bound by
// operations (~26 and ~35 us).  This first version does its products with f32
// FMAs from shared memory (no mma/wgmma), like the forward kernel, so it is
// bound by shared-memory bandwidth and FMA throughput instead (PERF.md has its
// time).
//
// Design:
//  * dq: one block per (query tile of 32 rows, head, batch row), 128 threads,
//    four per query row.  The block walks only the key tiles of 64 that the
//    causal/window mask leaves (the TPU kernel's sequential grid axis becomes
//    this loop), recomputes scores and dp for its 16 keys per lane, writes ds
//    to a shared row and accumulates hd / 4 interleaved dq columns per lane.
//  * dkv: one block per (key tile of 32 keys, KV head, batch row), four
//    threads per key.  It loops over the group's query heads and, for each,
//    over the query tiles of 64 the mask leaves.  dk and dv of the whole GQA
//    group accumulate in f32 registers of the block, so they come out reduced
//    to (B, T, KV, hd) with no atomics and no per-head buffer; the reference
//    rounds each head's dk/dv to the input dtype before its wrapper sums them.
//  * ragged S and T edges are masked here (rows and keys past the end count
//    as inadmissible), so every sequence length runs through the kernels.
//  * shared-memory rows are padded (hd + 1, tile + 4) so that the quad access
//    patterns are free of bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum { Q = 0, K = 1, V = 2, DO = 3, DQ = 4, DK = 5, DV = 6, N_TENSORS = 7 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B, H, S) f32, contiguous
  const float* delta;  // (B, H, S) f32, contiguous
  void* dq;
  void* dk;
  void* dv;
  int S, T, H, group;
  long long st[N_TENSORS][3];  // (batch, sequence, head) strides in elements
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

__device__ __forceinline__ bool admissible(const Params& p, int qpos, int t) {
  return qpos < p.S && t < p.T && (!p.causal || t <= qpos) &&
         (p.window <= 0 || t > qpos - p.window);
}

// Stage rows [r0, r0 + ROWS) of a (B, L, heads, HD) tensor as f32, zero past L.
template <typename T, int ROWS, int HD, int THREADS>
__device__ __forceinline__ void stage(float* dst, const T* src, long long row_stride, int r0,
                                      int len, int tid) {
  for (int i = tid; i < ROWS * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    const int pos = r0 + r;
    dst[r * (HD + 1) + d] = pos < len ? to_f32(src[pos * row_stride + d]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

constexpr int DQ_BQ = 32;
constexpr int DQ_BK = 64;
constexpr int DQ_THREADS = 4 * DQ_BQ;
constexpr int DQ_PSTRIDE = DQ_BK + 4;

template <int HD>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * DQ_BQ * (HD + 1) + 2 * DQ_BK * (HD + 1) + DQ_BQ * DQ_PSTRIDE);
}

template <typename T, int HD>
__global__ void __launch_bounds__(DQ_THREADS) flash_bwd_dq_kernel(Params p) {
  extern __shared__ float smem[];
  float* Qs = smem;                     // [BQ][HD + 1]
  float* Os = Qs + DQ_BQ * (HD + 1);    // dO [BQ][HD + 1]
  float* Ks = Os + DQ_BQ * (HD + 1);    // [BK][HD + 1]
  float* Vs = Ks + DQ_BK * (HD + 1);    // [BK][HD + 1]
  float* Ss = Vs + DQ_BK * (HD + 1);    // ds [BQ][PSTRIDE]

  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int sub = tid & 3;
  const int q0 = blockIdx.x * DQ_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / p.group;
  const int qpos = q0 + row;

  const T* q = static_cast<const T*>(p.q) + b * p.st[Q][0] + h * p.st[Q][2];
  const T* dout = static_cast<const T*>(p.dout) + b * p.st[DO][0] + h * p.st[DO][2];
  const T* k = static_cast<const T*>(p.k) + b * p.st[K][0] + kvh * p.st[K][2];
  const T* v = static_cast<const T*>(p.v) + b * p.st[V][0] + kvh * p.st[V][2];

  stage<T, DQ_BQ, HD, DQ_THREADS>(Qs, q, p.st[Q][1], q0, p.S, tid);
  stage<T, DQ_BQ, HD, DQ_THREADS>(Os, dout, p.st[DO][1], q0, p.S, tid);

  float lse = 0.f, delta = 0.f;
  if (qpos < p.S) {
    const long long at = ((long long)b * p.H + h) * p.S + qpos;
    lse = p.lse[at];
    delta = p.delta[at];
  }

  float acc[HD / 4];
#pragma unroll
  for (int c = 0; c < HD / 4; ++c) acc[c] = 0.f;

  // key tiles that intersect the mask support of this query tile
  int k_lo = 0;
  int k_hi = p.T;
  if (p.causal) k_hi = min(k_hi, q0 + DQ_BQ);
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);

  const float* qrow = Qs + row * (HD + 1);
  const float* orow = Os + row * (HD + 1);
  float* srow = Ss + row * DQ_PSTRIDE;

  for (int k0 = (k_lo / DQ_BK) * DQ_BK; k0 < k_hi; k0 += DQ_BK) {
    __syncthreads();  // Q, dO staged / previous K, V tile consumed
    stage<T, DQ_BK, HD, DQ_THREADS>(Ks, k, p.st[K][1], k0, p.T, tid);
    stage<T, DQ_BK, HD, DQ_THREADS>(Vs, v, p.st[V][1], k0, p.T, tid);
    __syncthreads();

    float s[DQ_BK / 4], dp[DQ_BK / 4];
#pragma unroll
    for (int i = 0; i < DQ_BK / 4; ++i) {
      s[i] = 0.f;
      dp[i] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float qd = qrow[d];
      const float od = orow[d];
#pragma unroll
      for (int i = 0; i < DQ_BK / 4; ++i) {
        const int j = (sub + 4 * i) * (HD + 1) + d;
        s[i] += qd * Ks[j];
        dp[i] += od * Vs[j];
      }
    }
#pragma unroll
    for (int i = 0; i < DQ_BK / 4; ++i) {
      const int t = k0 + sub + 4 * i;
      const float pr = admissible(p, qpos, t) ? expf(s[i] * p.scale - lse) : 0.f;
      srow[sub + 4 * i] = pr * (dp[i] - delta);
    }
    __syncwarp();  // the quad's ds row is visible to all four lanes

    for (int j = 0; j < DQ_BK; ++j) {
      const float dsj = srow[j];
#pragma unroll
      for (int c = 0; c < HD / 4; ++c) acc[c] += dsj * Ks[j * (HD + 1) + sub + 4 * c];
    }
  }

  if (qpos < p.S) {
    T* dq = static_cast<T*>(p.dq) + b * p.st[DQ][0] + h * p.st[DQ][2] + qpos * p.st[DQ][1];
#pragma unroll
    for (int c = 0; c < HD / 4; ++c) dq[sub + 4 * c] = from_f32<T>(acc[c] * p.scale);
  }
}

// ---------------------------------------------------------------------------
// dk, dv (summed over the GQA group in the block)
// ---------------------------------------------------------------------------

constexpr int KV_BK = 32;
constexpr int KV_BQ = 64;
constexpr int KV_THREADS = 4 * KV_BK;
constexpr int KV_PSTRIDE = KV_BQ + 4;

template <int HD>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) *
         (2 * KV_BK * (HD + 1) + 2 * KV_BQ * (HD + 1) + 2 * KV_BQ + 2 * KV_BK * KV_PSTRIDE);
}

template <typename T, int HD>
__global__ void __launch_bounds__(KV_THREADS) flash_bwd_dkv_kernel(Params p) {
  extern __shared__ float smem[];
  float* Ks = smem;                     // [BK][HD + 1]
  float* Vs = Ks + KV_BK * (HD + 1);    // [BK][HD + 1]
  float* Qs = Vs + KV_BK * (HD + 1);    // [BQ][HD + 1]
  float* Os = Qs + KV_BQ * (HD + 1);    // dO [BQ][HD + 1]
  float* Ls = Os + KV_BQ * (HD + 1);    // lse [BQ]
  float* Es = Ls + KV_BQ;               // delta [BQ]
  float* Ps = Es + KV_BQ;               // p [BK][PSTRIDE]
  float* Ds = Ps + KV_BK * KV_PSTRIDE;  // ds [BK][PSTRIDE]

  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int sub = tid & 3;
  const int k0 = blockIdx.x * KV_BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tpos = k0 + row;

  const T* k = static_cast<const T*>(p.k) + b * p.st[K][0] + kvh * p.st[K][2];
  const T* v = static_cast<const T*>(p.v) + b * p.st[V][0] + kvh * p.st[V][2];
  stage<T, KV_BK, HD, KV_THREADS>(Ks, k, p.st[K][1], k0, p.T, tid);
  stage<T, KV_BK, HD, KV_THREADS>(Vs, v, p.st[V][1], k0, p.T, tid);

  float dk[HD / 4], dv[HD / 4];
#pragma unroll
  for (int c = 0; c < HD / 4; ++c) {
    dk[c] = 0.f;
    dv[c] = 0.f;
  }

  // query tiles that intersect the mask support of this key tile
  int q_lo = 0;
  int q_hi = p.S;
  if (p.causal) q_lo = min(k0, p.S);
  if (p.window > 0) q_hi = min(q_hi, k0 + KV_BK - 1 + p.window);

  const float* krow = Ks + row * (HD + 1);
  const float* vrow = Vs + row * (HD + 1);
  float* prow = Ps + row * KV_PSTRIDE;
  float* dsrow = Ds + row * KV_PSTRIDE;

  for (int g = 0; g < p.group; ++g) {
    const int h = kvh * p.group + g;
    const T* q = static_cast<const T*>(p.q) + b * p.st[Q][0] + h * p.st[Q][2];
    const T* dout = static_cast<const T*>(p.dout) + b * p.st[DO][0] + h * p.st[DO][2];
    const long long lrow = ((long long)b * p.H + h) * p.S;

    for (int q0 = (q_lo / KV_BQ) * KV_BQ; q0 < q_hi; q0 += KV_BQ) {
      __syncthreads();  // K, V staged / previous Q, dO, p, ds tiles consumed
      stage<T, KV_BQ, HD, KV_THREADS>(Qs, q, p.st[Q][1], q0, p.S, tid);
      stage<T, KV_BQ, HD, KV_THREADS>(Os, dout, p.st[DO][1], q0, p.S, tid);
      for (int i = tid; i < KV_BQ; i += KV_THREADS) {
        const int pos = q0 + i;
        Ls[i] = pos < p.S ? p.lse[lrow + pos] : 0.f;
        Es[i] = pos < p.S ? p.delta[lrow + pos] : 0.f;
      }
      __syncthreads();

      float s[KV_BQ / 4], dp[KV_BQ / 4];
#pragma unroll
      for (int i = 0; i < KV_BQ / 4; ++i) {
        s[i] = 0.f;
        dp[i] = 0.f;
      }
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        const float kd = krow[d];
        const float vd = vrow[d];
#pragma unroll
        for (int i = 0; i < KV_BQ / 4; ++i) {
          const int j = (sub + 4 * i) * (HD + 1) + d;
          s[i] += kd * Qs[j];
          dp[i] += vd * Os[j];
        }
      }
#pragma unroll
      for (int i = 0; i < KV_BQ / 4; ++i) {
        const int j = sub + 4 * i;
        const float pr = admissible(p, q0 + j, tpos) ? expf(s[i] * p.scale - Ls[j]) : 0.f;
        prow[j] = pr;
        dsrow[j] = pr * (dp[i] - Es[j]);
      }
      __syncwarp();  // the quad's p and ds rows are visible to all four lanes

      for (int j = 0; j < KV_BQ; ++j) {
        const float pj = prow[j];
        const float dsj = dsrow[j];
#pragma unroll
        for (int c = 0; c < HD / 4; ++c) {
          const int at = j * (HD + 1) + sub + 4 * c;
          dv[c] += pj * Os[at];
          dk[c] += dsj * Qs[at];
        }
      }
    }
  }

  if (tpos < p.T) {
    T* dkp = static_cast<T*>(p.dk) + b * p.st[DK][0] + kvh * p.st[DK][2] + tpos * p.st[DK][1];
    T* dvp = static_cast<T*>(p.dv) + b * p.st[DV][0] + kvh * p.st[DV][2] + tpos * p.st[DV][1];
#pragma unroll
    for (int c = 0; c < HD / 4; ++c) {
      dkp[sub + 4 * c] = from_f32<T>(dk[c] * p.scale);
      dvp[sub + 4 * c] = from_f32<T>(dv[c]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int HD>
int launch_dq(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.S + DQ_BQ - 1) / DQ_BQ, p.H, B);
  flash_bwd_dq_kernel<T, HD><<<grid, DQ_THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_dkv(const Params& p, int B, int KV, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.T + KV_BK - 1) / KV_BK, KV, B);
  flash_bwd_dkv_kernel<T, HD><<<grid, KV_THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(bool dkv, const Params& p, int B, int KV, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return dkv ? launch_dkv<T, 32>(p, B, KV, stream) : launch_dq<T, 32>(p, B, stream);
    case 64: return dkv ? launch_dkv<T, 64>(p, B, KV, stream) : launch_dq<T, 64>(p, B, stream);
    case 128: return dkv ? launch_dkv<T, 128>(p, B, KV, stream) : launch_dq<T, 128>(p, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int run(bool dkv, const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dq, void* dk, void* dv, int dtype, int B,
        int S, int T, int H, int KV, int hd, const long long* strides, int causal, int window,
        float scale, void* stream) {
  if (KV <= 0 || H % KV != 0 || B <= 0 || S <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.S = S;
  p.T = T;
  p.H = H;
  p.group = H / KV;
  for (int t = 0; t < N_TENSORS; ++t)
    for (int a = 0; a < 3; ++a) p.st[t][a] = strides[3 * t + a];
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(dkv, p, B, KV, hd, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(dkv, p, B, KV, hd, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, do and the gradients).  lse and
// delta are contiguous (B, H, S) float32.  `strides` holds 21 element strides,
// (batch, sequence, head) for q, k, v, do, dq, dk, dv in that order; the
// head_dim axis of every tensor must be contiguous.  window <= 0 means none.
// Each entry point returns cudaGetLastError() after its launch (0 on success).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int dtype, int B,
                            int S, int T, int H, int KV, int hd, const long long* strides,
                            int causal, int window, float scale, void* stream) {
  return run(false, q, k, v, dout, lse, delta, dq, nullptr, nullptr, dtype, B, S, T, H, KV, hd,
             strides, causal, window, scale, stream);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int dtype,
                             int B, int S, int T, int H, int KV, int hd,
                             const long long* strides, int causal, int window, float scale,
                             void* stream) {
  return run(true, q, k, v, dout, lse, delta, nullptr, dk, dv, dtype, B, S, T, H, KV, hd,
             strides, causal, window, scale, stream);
}

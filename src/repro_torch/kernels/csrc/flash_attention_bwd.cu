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
// ~60 and ~51 MB of traffic, so both are bound by the tensor cores (~26 and
// ~35 us at 989 TFLOP/s).  At recurrentgemma-9b's training shape (B = 1,
// S = T = 4096, 16/1 heads, hd 256, causal, window 2048) dq needs 154.6 and
// dkv 206.2 GFLOP against ~70 MB: tensor cores again (~156 and ~209 us).
//
// In bf16 both run on the tensor cores (`wgmma.mma_async`, both products'
// operands in shared memory or, for the second product, the first one's
// rounded accumulator as the register-A operand), two warpgroups of 128
// threads a block, with thread 0 issuing every TMA load (128-byte swizzle;
// 64-byte at hd 32; rows past S or T read as zeros) into a ring of
// STAGES stages guarded by full/empty mbarriers, STAGES - 1 tiles ahead of
// the compute (a producer warp would cap the registers at 168, see
// flash_attention.cu).  Each kernel runs
// the element mask only on tiles that cut the causal diagonal, the window
// edge or a ragged edge, skips tiles that no row of a warpgroup sees, and
// orders its grid with the most causal work first.
//
// dq in bf16 (`flash_bwd_dq_tc_kernel`): the forward's structure with a
// second score product and no online softmax.  One block per (query tile of
// 128 rows, head, batch row), each warpgroup owning 64 rows; the heads of a
// batch row are adjacent block indices, so a GQA group's blocks read the
// same K/V tiles from L2:
//  * thread 0 loads the block's Q and dO tiles once, then streams the K and
//    V tiles of 64 keys that the causal/window mask leaves;
//  * S = Q K^T and dP = dO V^T (both operands K-major), issued together and
//    waited for once; P = exp2(S * scale * log2 e - lse * log2 e) and
//    dS = P (dP - delta) on the f32 accumulators, with each thread's two
//    rows' lse and delta read once per block;
//  * dS, rounded to bf16, is wgmma's register-A operand for dQ += dS K,
//    which reads the same K stage in the transposed-B (MN-major) mode;
//  * dQ accumulates in f32 registers over the whole key walk and leaves
//    once, scaled, in bf16, with no atomics;
//  * key tiles of 64, and of 32 at hd 256: there the block's Q and dO take
//    128 KB of shared memory, so two stages of 64-key K and V tiles would
//    pass the 227 KB a block may have; the dQ accumulator is then 128
//    registers a thread, beside 16 each for S and dP.
//
// dkv in bf16 at hd 32-256 (`flash_bwd_dkv_wg_kernel`, described above it).
// One block per key tile of 64 keys, KV head and batch row; its two
// warpgroups own the same 64 keys, warpgroup 0 dV and warpgroup 1 dK (one
// f32 accumulator a warpgroup: 64 keys' dK and dV together would take 256
// registers a thread in one warpgroup at hd 256, and 128 at hd 128, which
// would leave room only for 32-row query tiles), and P^T passes from the
// first to the second through shared memory:
//  * thread 0 loads the block's K and V once, then streams Q and dO tiles
//    of 64 rows of the group's query heads x the query tiles the mask
//    leaves, each with its 64 lse and delta values, all by TMA;
//  * the scores are computed transposed, keys as wgmma's M dimension:
//    S^T = K Q^T and dP^T = V dO^T (m64n64, K-major), one a warpgroup; P^T
//    and dS^T, rounded to bf16, are wgmma's register-A operand for dV +=
//    P^T dO and dK += dS^T Q, which read dO and Q in the transposed-B
//    (MN-major) mode;
//  * at hd <= 64 two blocks share an SM (<= 128 registers a thread, two
//    stages of ~84 KB), at hd 128 one block with three stages, at hd 256
//    one with two (230 KB).
// Where that grid is under one wave of SMs (a batch row or two: the
// pipeline's microbatch, a rank's shard, recurrentgemma-9b's MQA) the
// wrapper's planner splits the GQA group's heads over SPLIT blocks a key
// tile (the least divisor of the group that makes two waves), each writing
// its scaled f32 dK and dV to its own plane of a workspace
// [2][SPLIT][B][T][KV][HD], and `dkv_split_sum_kernel` adds the planes in
// split order and writes bf16, so the result is the same on every run.
// SPLIT = 1 writes bf16 from the block, in one launch.
//  Rounding P and dS to bf16 before their products is the rounding the f32
//  reference does not make (tests/test_torch_flash_tc.py holds an emulation
//  of it against the reference at the bf16 gradient tolerance).
//
// In f32, and in bf16 at hd 16 (the smoke configs' head_dim, which no timed
// path runs; a 16-column tile is below the tensor-core kernels' 64-byte
// swizzle slab) -- CUDA-core FMAs from shared memory, head dims 16 to 256
// (at hd 256 dq takes 206,080 B of shared memory a block and dkv 215,296 B,
// and a dkv thread holds 64 + 64 accumulators):
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

#include "hopper.cuh"

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

// f32 (and bf16 at hd 16, in `run`): bf16 dq and dk/dv at hd >= 32 run the
// tensor-core kernels below
int dispatch_dq_f32(const Params& p, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_dq<float, 16>(p, B, stream);
    case 32: return launch_dq<float, 32>(p, B, stream);
    case 64: return launch_dq<float, 64>(p, B, stream);
    case 128: return launch_dq<float, 128>(p, B, stream);
    case 256: return launch_dq<float, 256>(p, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch_dkv_f32(const Params& p, int B, int KV, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_dkv<float, 16>(p, B, KV, stream);
    case 32: return launch_dkv<float, 32>(p, B, KV, stream);
    case 64: return launch_dkv<float, 64>(p, B, KV, stream);
    case 128: return launch_dkv<float, 128>(p, B, KV, stream);
    case 256: return launch_dkv<float, 256>(p, B, KV, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// dk, dv in bf16: tensor cores (wgmma) fed by TMA
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int BQ = 128;       // dq: query rows of a block, two warpgroups of 64
constexpr int THREADS = 256;  // two warpgroups; thread 0 also issues the TMA loads
constexpr float LOG2E = 1.4426950408889634f;

// dkv in bf16 (`flash_bwd_dkv_wg_kernel`): one block per (key tile of 64
// keys, split of the GQA group's heads, KV head, batch row).  The two
// warpgroups own the same 64 keys and one accumulator each (HD / 2
// registers a thread: 16 at hd 32 ... 128 at hd 256):
//  * warpgroup 0 computes S^T = K Q^T, P^T = exp2(S^T scale log2 e - lse
//    log2 e) (masked), writes P^T in f32 to a shared-memory slot of its
//    stage, and accumulates dV += P^T dO;
//  * warpgroup 1 computes dP^T = V dO^T at the same time, waits for P^T
//    (an mbarrier of 128 arrivals per stage), forms dS^T = P^T (dP^T -
//    delta) and accumulates dK += dS^T Q.
// The m64n64 accumulators of S^T and dP^T have the same layout in both
// warpgroups, so thread i of warpgroup 1 reads the 32 values that thread i
// of warpgroup 0 wrote, laid out thread-fastest (no bank conflicts): no
// product is done twice and the exchange is 16 KB a tile in one direction.
// A stage's P^T slot is written again only after the stage's next tile has
// landed, which waits for both warpgroups to release the stage.  The tile's
// 64 lse and delta values land by TMA with its Q and dO (1-d maps over the
// (B, H, S) rows, each box 68 values from the 16-byte boundary at or below
// the tile's first: TMA reads a box only from such a boundary), so no
// global read waits inside the loop.  Warpgroup 1's first thread issues
// the loads, each into the stage that warpgroup 1 has just released:
// warpgroup 0, which releases a stage first, never waits for warpgroup 1
// at the top of a tile, and so runs up to a tile ahead of it (its S^T and
// softmax of tile it + 1 beside warpgroup 1's dS^T and dK of tile it).
template <int HD>
struct DkvTiles {
  // Q/dO (and P^T, lse, delta) ring depth: three where one block holds an
  // SM (hd 128; at hd 256 a third would not fit), two where two blocks share
  // it (hd <= 64: ~85 KB each; four stages at one block an SM measured
  // slower)
  static constexpr int STAGES = HD == 128 ? 3 : 2;
  // blocks an SM holds: two at hd <= 64, where a thread needs at most 128
  // registers, so one block's softmax overlaps the other's products
  static constexpr int BLOCKS_PER_SM = HD <= 64 ? 2 : 1;
  static constexpr int BK = 64;  // keys of a block, shared by both warpgroups
  // query rows per streamed tile: the score products are m64n64 (128 rows,
  // m64n128, measured slower at hd 64)
  static constexpr int BQ = 64;
  static constexpr int SPAN = HD < 64 ? HD : 64;  // columns of one swizzled slab
  static constexpr int SLABS = HD / SPAN;
  static constexpr int ROWB = 2 * SPAN;          // bytes of a slab row = swizzle span
  static constexpr int KV_BYTES = BK * HD * 2;   // the block's K or V
  static constexpr int Q_BYTES = BQ * HD * 2;    // one Q or dO tile
  static constexpr int P_VALUES = BQ / 2;        // P^T values a thread exchanges a tile
  static constexpr int P_BYTES = 128 * P_VALUES * 4;
  static constexpr int ROW_BOX = BQ + 4;         // lse or delta values a tile loads
  static constexpr int ROW_SLOT = 96;            // floats of their 128-byte-aligned slot
  static constexpr int SMEM = 1024 + 2 * KV_BYTES +
                              STAGES * (2 * Q_BYTES + P_BYTES + 2 * ROW_SLOT * 4) +
                              8 * (1 + 3 * STAGES);
};

struct DkvParams {
  CUtensorMap tk, tv, tq, tdo;
  CUtensorMap tlse, tdelta;  // (B, H, S) f32 as one vector each
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* ws;  // split > 1: f32 partial dK, dV planes [2][split][B][T][KV][HD]
  int S, T, H, KV, B, group;
  int split;  // blocks a key tile is split into over the group's query heads
  long long sdk[3], sdv[3];  // (batch, sequence, head) element strides
  int causal;
  int window;  // <= 0: no window
  float scale;
  float scale_log2;
};

// PARTIAL: the block walks its split's group / split heads and writes f32
// partial sums to the workspace; otherwise the whole group, and bf16 dK, dV
template <int HD, bool PARTIAL>
__global__ void __launch_bounds__(THREADS, DkvTiles<HD>::BLOCKS_PER_SM)
    flash_bwd_dkv_wg_kernel(const __grid_constant__ DkvParams p) {
  using C = DkvTiles<HD>;
  constexpr int BQ = C::BQ, BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sk = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sv = sk + C::KV_BYTES;
  uint8_t* sqd = sv + C::KV_BYTES;  // [STAGES][Q tile, dO tile], each [SLABS][BQ][SPAN]
  float* sp = reinterpret_cast<float*>(sqd + C::STAGES * 2 * C::Q_BYTES);  // [STAGES][P][128]
  float* srow = sp + C::STAGES * C::P_VALUES * 128;  // [STAGES][lse, delta][ROW_SLOT]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(srow + C::STAGES * 2 * C::ROW_SLOT);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + C::STAGES;
  uint64_t* p_full = empty + C::STAGES;

  // key tiles with the most causal work first, then the splits of a key
  // tile's group side by side
  // (a key tile's blocks side by side, sharing Q and dO in L2, measured
  // 30-40% slower under the causal mask)
  const int split = PARTIAL ? p.split : 1;
  const int kb = p.KV * p.B * split;
  const int k0 = (int)(blockIdx.x / kb) * BK;
  const int part = (int)(blockIdx.x % kb) % split;
  const int kvh = (int)(blockIdx.x % kb) / split % p.KV;
  const int b = (int)(blockIdx.x % kb) / split / p.KV;
  // this block's query heads: h0 .. h0 + heads - 1
  const int heads = p.group / split;
  const int h0 = kvh * p.group + part * heads;

  // query tiles that intersect the mask support of this key tile
  int q_lo = 0;
  int q_hi = p.S;
  if (p.causal) q_lo = min(k0, p.S);
  if (p.window > 0) q_hi = min(q_hi, k0 + BK - 1 + p.window);
  const int qt0 = q_lo / BQ;
  const int n_qt = q_hi > q_lo ? (q_hi + BQ - 1) / BQ - qt0 : 0;
  const int n_it = heads * n_qt;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2 * 128);  // every thread releases the stage
      mbar_init(p_full + s, 128);     // warpgroup 0's threads publish P^T
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Warpgroup 1's first thread issues every TMA load: K and V and Q/dO
  // tiles (with their lse and delta) 0 .. STAGES - 1 here, tile it + STAGES
  // at the end of iteration it, into the stage that tile it has released.
  const bool issuer = threadIdx.x == 128;
  auto load_q = [&](int it) {
    const int s = it % C::STAGES;
    const int h = h0 + it / n_qt;
    const int q0 = (qt0 + it % n_qt) * BQ;
    uint8_t* st = sqd + s * 2 * C::Q_BYTES;
    mbar_wait(empty + s, ((it / C::STAGES) & 1) ^ 1);
    mbar_expect_tx(full + s, 2 * C::Q_BYTES + 2 * C::ROW_BOX * 4);
    for (int j = 0; j < C::SLABS; ++j) {
      tma_load_4d(st + j * BQ * C::ROWB, &p.tq, full + s, j * C::SPAN, q0, h, b);
      tma_load_4d(st + C::Q_BYTES + j * BQ * C::ROWB, &p.tdo, full + s, j * C::SPAN, q0, h, b);
    }
    const int row = ((b * p.H + h) * p.S + q0) & ~3;  // from a 16-byte boundary
    tma_load_1d(srow + s * 2 * C::ROW_SLOT, &p.tlse, full + s, row);
    tma_load_1d(srow + (s * 2 + 1) * C::ROW_SLOT, &p.tdelta, full + s, row);
  };
  if (issuer) {
    mbar_expect_tx(kv_full, 2 * C::KV_BYTES);
    for (int j = 0; j < C::SLABS; ++j) {
      tma_load_4d(sk + j * BK * C::ROWB, &p.tk, kv_full, j * C::SPAN, k0, kvh, b);
      tma_load_4d(sv + j * BK * C::ROWB, &p.tv, kv_full, j * C::SPAN, k0, kvh, b);
    }
    for (int j = 0; j < C::STAGES && j < n_it; ++j) load_q(j);
  }
  __syncwarp();

  // warpgroup 0: scores against Q, then dV against dO; warpgroup 1: dP
  // against dO, then dK against Q
  const int wg = warpgroup_idx();
  const int tid = threadIdx.x % 128;
  const int t0 = k0 + 16 * (tid / 32) + (tid % 32) / 4;  // this thread's keys: t0, t0 + 8
  const int col = 2 * (tid % 4);                         // its first query column of each 8
  // K-major descriptors of the block's K (warpgroup 0) or V rows and of
  // stage 0's Q (or dO) tile; an MN-major one of stage 0's dO (or Q) tile
  const uint32_t first = wg == 0 ? 0 : C::Q_BYTES;  // the score product's tile
  const uint64_t kv_desc = make_desc(wg == 0 ? sk : sv, 0, 8 * C::ROWB, C::ROWB);
  const uint64_t q_desc = make_desc(sqd + first, 0, 8 * C::ROWB, C::ROWB);
  const uint64_t qt_desc = make_desc(sqd + (C::Q_BYTES - first), BQ * C::ROWB, 8 * C::ROWB,
                                     C::ROWB);
  // lse (warpgroup 0) or delta (warpgroup 1) of stage 0's tile
  const float* lv0 = srow + wg * C::ROW_SLOT + col;

  float acc[HD / 2];  // dV (warpgroup 0) or dK (warpgroup 1) of this thread's keys
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % C::STAGES;
    const uint32_t phase = (it / C::STAGES) & 1;
    const int h = h0 + it / n_qt;
    const int q0 = (qt0 + it % n_qt) * BQ;
    // no key of the block is seen by a row of the tile / some element is masked
    const bool skip = k0 >= p.T || (p.causal && q0 + BQ - 1 < k0) ||
                      (p.window > 0 && k0 + BK - 1 <= q0 - p.window);
    const bool edge = q0 + BQ > p.S || k0 + BK > p.T || (p.causal && q0 < k0 + BK - 1) ||
                      (p.window > 0 && q0 + BQ - 1 >= k0 + p.window);
    float* slot = sp + s * C::P_VALUES * 128 + tid;  // this thread's P^T values, stride 128
    // lse or delta of its query columns, lv[8 i + e], past the box's offset
    const float* lv = lv0 + s * 2 * C::ROW_SLOT + (((b * p.H + h) * p.S + q0) & 3);

    mbar_wait(full + s, phase);
    if (!skip) {
      float sc[BQ / 2];  // S^T (warpgroup 0) or dP^T (warpgroup 1)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int slab = kk / (C::SPAN / 16);
        const int off = (kk % (C::SPAN / 16)) * 32;
        wgmma_ss<BQ>(sc, desc_at(kv_desc, slab * BK * C::ROWB + off),
                     desc_at(q_desc, s * 2 * C::Q_BYTES + slab * BQ * C::ROWB + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < BQ / 8; ++i) {
          const float lse2[2] = {lv[8 * i] * LOG2E, lv[8 * i + 1] * LOG2E};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float pv = exp2f(fmaf(sc[4 * i + e], p.scale_log2, -lse2[e & 1]));
            if (edge) {
              const int t = t0 + 8 * (e >> 1);
              const int q = q0 + 8 * i + col + (e & 1);
              const bool ok = q < p.S && t < p.T && (!p.causal || t <= q) &&
                              (p.window <= 0 || t > q - p.window);
              if (!ok) pv = 0.f;
            }
            sc[4 * i + e] = pv;
            slot[(4 * i + e) * 128] = pv;
          }
        }
        mbar_arrive(p_full + s);
      } else {
        mbar_wait(p_full + s, phase);
#pragma unroll
        for (int i = 0; i < BQ / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[4 * i + e] = slot[(4 * i + e) * 128] * (sc[4 * i + e] - lv[8 * i + (e & 1)]);
      }
      // P^T or dS^T, rounded to bf16: the register-A operand of the product
      uint32_t a[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          a[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<HD>(acc, a[kk], desc_at(qt_desc, s * 2 * C::Q_BYTES + kk * 16 * C::ROWB));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    } else if (wg == 0) {
      mbar_arrive(p_full + s);  // the P^T barrier completes a phase every tile
    }
    mbar_arrive(empty + s);
    if (issuer && it + C::STAGES < n_it) load_q(it + C::STAGES);
    __syncwarp();
  }

  // warpgroup 0 writes dV, warpgroup 1 dK (scaled)
  const float mul = wg == 0 ? 1.f : p.scale;
  if constexpr (PARTIAL) {
    const long long plane = (long long)p.B * p.T * p.KV * HD;  // floats of one split's dK
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + 8 * r;
      if (t < p.T) {
        float* dst = p.ws + (wg == 0 ? split * plane : 0) +
                     (((long long)part * p.B + b) * p.T + t) * p.KV * HD + (long long)kvh * HD +
                     col;
#pragma unroll
        for (int i = 0; i < HD / 8; ++i)
          *reinterpret_cast<float2*>(dst + 8 * i) =
              make_float2(acc[4 * i + 2 * r] * mul, acc[4 * i + 2 * r + 1] * mul);
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + 8 * r;
      if (t < p.T) {
        __nv_bfloat16* dst =
            wg == 0 ? p.dv + b * p.sdv[0] + kvh * p.sdv[2] + (long long)t * p.sdv[1] + col
                    : p.dk + b * p.sdk[0] + kvh * p.sdk[2] + (long long)t * p.sdk[1] + col;
#pragma unroll
        for (int i = 0; i < HD / 8; ++i)
          *reinterpret_cast<uint32_t*>(dst + 8 * i) =
              pack_bf16(acc[4 * i + 2 * r] * mul, acc[4 * i + 2 * r + 1] * mul);
      }
    }
  }
}

constexpr int SUM_THREADS = 256;

// dK and dV from the split kernel's f32 planes: thread i of plane `which`
// (blockIdx.y: 0 dK, 1 dV) adds columns 4 (i % (HD / 4)) .. + 3 of row
// i / (HD / 4) = (b T + t) KV + kvh over the splits in order, then writes
// them in bf16 through the output's strides.
template <int HD>
__global__ void __launch_bounds__(SUM_THREADS)
    dkv_split_sum_kernel(const float* __restrict__ ws, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int split, int T, int KV,
                         long long rows, long long sdk0, long long sdk1, long long sdk2,
                         long long sdv0, long long sdv1, long long sdv2) {
  const long long i = (long long)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (i >= rows * (HD / 4)) return;
  const int which = blockIdx.y;
  const long long plane = rows * (HD / 4);  // float4s of one split's plane
  const float4* src = reinterpret_cast<const float4*>(ws) + (long long)which * split * plane + i;
  float4 s = __ldg(src);
  for (int k = 1; k < split; ++k) {
    const float4 t = __ldg(src + k * plane);
    s.x += t.x;
    s.y += t.y;
    s.z += t.z;
    s.w += t.w;
  }
  const long long row = i / (HD / 4);
  const int c = (int)(i % (HD / 4)) * 4;
  const int kvh = (int)(row % KV);
  const int t = (int)(row / KV % T);
  const long long b = row / KV / T;
  __nv_bfloat16* out = which == 0 ? dk + b * sdk0 + (long long)t * sdk1 + kvh * sdk2 + c
                                  : dv + b * sdv0 + (long long)t * sdv1 + kvh * sdv2 + c;
  reinterpret_cast<uint32_t*>(out)[0] = pack_bf16(s.x, s.y);
  reinterpret_cast<uint32_t*>(out)[1] = pack_bf16(s.z, s.w);
}

template <int HD>
int launch_dkv(const Params& p, int B, int KV, int split, float* ws, cudaStream_t stream) {
  using C = DkvTiles<HD>;
  if (split < 1 || p.group % split != 0 || (split > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  DkvParams d;
  int err = make_tile_map(&d.tk, p.k, B, p.T, KV, HD, p.st[K][0], p.st[K][1], p.st[K][2], C::BK,
                          C::SPAN);
  if (!err)
    err = make_tile_map(&d.tv, p.v, B, p.T, KV, HD, p.st[V][0], p.st[V][1], p.st[V][2], C::BK,
                        C::SPAN);
  if (!err)
    err = make_tile_map(&d.tq, p.q, B, p.S, p.H, HD, p.st[Q][0], p.st[Q][1], p.st[Q][2], C::BQ,
                        C::SPAN);
  if (!err)
    err = make_tile_map(&d.tdo, p.dout, B, p.S, p.H, HD, p.st[DO][0], p.st[DO][1], p.st[DO][2],
                        C::BQ, C::SPAN);
  // a box may not be longer than its vector: the wrapper pads lse and
  // delta to at least one box
  const long long rows = max((long long)B * p.H * p.S, (long long)C::ROW_BOX);
  if (!err) err = make_vector_map(&d.tlse, p.lse, rows, C::ROW_BOX);
  if (!err) err = make_vector_map(&d.tdelta, p.delta, rows, C::ROW_BOX);
  if (err) return err;
  d.dk = static_cast<__nv_bfloat16*>(p.dk);
  d.dv = static_cast<__nv_bfloat16*>(p.dv);
  d.ws = ws;
  d.S = p.S;
  d.T = p.T;
  d.H = p.H;
  d.KV = KV;
  d.B = B;
  d.group = p.group;
  d.split = split;
  for (int a = 0; a < 3; ++a) {
    d.sdk[a] = p.st[DK][a];
    d.sdv[a] = p.st[DV][a];
  }
  d.causal = p.causal;
  d.window = p.window;
  d.scale = p.scale;
  d.scale_log2 = p.scale * LOG2E;
  const int blocks = (p.T + C::BK - 1) / C::BK * KV * B * split;
  // set on every launch: the attribute holds for the current device only
  const auto kernel =
      split > 1 ? flash_bwd_dkv_wg_kernel<HD, true> : flash_bwd_dkv_wg_kernel<HD, false>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, THREADS, C::SMEM, stream>>>(d);
  e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return (int)e;
  const long long kv_rows = (long long)B * p.T * KV;
  const dim3 grid((unsigned)((kv_rows * (HD / 4) + SUM_THREADS - 1) / SUM_THREADS), 2);
  dkv_split_sum_kernel<HD><<<grid, SUM_THREADS, 0, stream>>>(
      ws, d.dk, d.dv, split, p.T, KV, kv_rows, d.sdk[0], d.sdk[1], d.sdk[2], d.sdv[0], d.sdv[1],
      d.sdv[2]);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dq in bf16: tensor cores (wgmma) fed by TMA
// ---------------------------------------------------------------------------

template <int HD>
struct DqTiles {
  static constexpr int STAGES = 2;  // K/V ring depth
  // keys per streamed tile: at hd 256 the block's Q and dO take 128 KB, and
  // two stages of 64-key K and V tiles another 128 KB, past the 227 KB a
  // block may have, so 32-key tiles (two stages, 64 KB)
  static constexpr int BK = HD == 256 ? 32 : 64;
  static constexpr int SPAN = HD < 64 ? HD : 64;  // columns of one swizzled slab
  static constexpr int SLABS = HD / SPAN;
  static constexpr int ROWB = 2 * SPAN;           // bytes of a slab row = swizzle span
  static constexpr int Q_BYTES = BQ * HD * 2;     // the block's Q or dO
  static constexpr int KV_BYTES = BK * HD * 2;    // one K or V tile
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 2 * STAGES);
};

struct DqParams {
  CUtensorMap tq, tdo, tk, tv;
  const float* lse;    // (B, H, S) f32, contiguous
  const float* delta;  // (B, H, S) f32, contiguous
  __nv_bfloat16* dq;
  int S, T, H, B, group, n_qt;
  long long sdq[3];  // (batch, sequence, head) element strides
  int causal;
  int window;  // <= 0: no window
  float scale;
  float scale_log2;
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_tc_kernel(const __grid_constant__ DqParams p) {
  using C = DqTiles<HD>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sdo = sq + C::Q_BYTES;
  uint8_t* skv = sdo + C::Q_BYTES;  // [STAGES][K tile, V tile], each [SLABS][BK][SPAN]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(skv + C::STAGES * 2 * C::KV_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + C::STAGES;

  const int bh = p.H * p.B;
  const int q0 = (p.n_qt - 1 - (int)(blockIdx.x / bh)) * BQ;  // longest causal tiles first
  const int h = (int)(blockIdx.x % bh) % p.H;  // a GQA group's heads side by side
  const int b = (int)(blockIdx.x % bh) / p.H;
  const int kvh = h / p.group;

  // key tiles that intersect the mask support of this query tile
  int k_lo = 0;
  int k_hi = p.T;
  if (p.causal) k_hi = min(k_hi, q0 + BQ);
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  const int kt0 = k_lo / BK;
  const int n_kt = k_hi > k_lo ? (k_hi + BK - 1) / BK - kt0 : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2 * 128);  // every thread releases the stage
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Thread 0 issues every TMA load: Q, dO and K/V tiles 0 .. STAGES - 2
  // here, tile it + STAGES - 1 at the top of iteration it, into the stage
  // that tile it - 1 has released, so tiles load while another is computed.
  const bool issuer = threadIdx.x == 0;
  auto load_kv = [&](int it) {
    const int s = it % C::STAGES;
    const int k0 = (kt0 + it) * BK;
    uint8_t* st = skv + s * 2 * C::KV_BYTES;
    mbar_wait(empty + s, ((it / C::STAGES) & 1) ^ 1);
    mbar_expect_tx(full + s, 2 * C::KV_BYTES);
    for (int j = 0; j < C::SLABS; ++j) {
      tma_load_4d(st + j * BK * C::ROWB, &p.tk, full + s, j * C::SPAN, k0, kvh, b);
      tma_load_4d(st + C::KV_BYTES + j * BK * C::ROWB, &p.tv, full + s, j * C::SPAN, k0, kvh, b);
    }
  };
  if (issuer) {
    mbar_expect_tx(q_full, 2 * C::Q_BYTES);
    for (int j = 0; j < C::SLABS; ++j) {
      tma_load_4d(sq + j * BQ * C::ROWB, &p.tq, q_full, j * C::SPAN, q0, h, b);
      tma_load_4d(sdo + j * BQ * C::ROWB, &p.tdo, q_full, j * C::SPAN, q0, h, b);
    }
    for (int j = 0; j < C::STAGES - 1 && j < n_kt; ++j) load_kv(j);
  }

  // each warpgroup owns 64 query rows
  const int wg = warpgroup_idx();
  const int tid = threadIdx.x % 128;
  const int qa = q0 + 64 * wg;                             // first row of this warpgroup
  const int row0 = qa + 16 * (tid / 32) + (tid % 32) / 4;  // this thread's rows: row0, row0 + 8
  const int col = 2 * (tid % 4);                           // its first column of each 8
  // K-major descriptors of this warpgroup's Q and dO rows and of stage 0's
  // K tile; an MN-major one of stage 0's K tile (V lies KV_BYTES after K)
  const uint64_t q_desc = make_desc(sq + 64 * wg * C::ROWB, 0, 8 * C::ROWB, C::ROWB);
  const uint64_t do_desc = make_desc(sdo + 64 * wg * C::ROWB, 0, 8 * C::ROWB, C::ROWB);
  const uint64_t k_desc = make_desc(skv, 0, 8 * C::ROWB, C::ROWB);
  const uint64_t kt_desc = make_desc(skv, BK * C::ROWB, 8 * C::ROWB, C::ROWB);

  // lse (base 2) and delta of this thread's two rows, read while Q lands
  float lse2[2], del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row0 + 8 * r;
    const long long at = ((long long)b * p.H + h) * p.S + q;
    lse2[r] = q < p.S ? __ldg(p.lse + at) * LOG2E : 0.f;
    del[r] = q < p.S ? __ldg(p.delta + at) : 0.f;
  }

  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_kt; ++it) {
    if (issuer && it + C::STAGES - 1 < n_kt) load_kv(it + C::STAGES - 1);
    __syncwarp();
    const int s = it % C::STAGES;
    const uint32_t phase = (it / C::STAGES) & 1;
    const int k0 = (kt0 + it) * BK;
    // no row of this warpgroup sees a key of the tile / some element is masked
    // (rows past S need no mask: their dq is never written)
    const bool skip = qa >= p.S || (p.causal && k0 > qa + 63) ||
                      (p.window > 0 && k0 + BK - 1 <= qa - p.window);
    const bool edge = k0 + BK > p.T || (p.causal && k0 + BK - 1 > qa) ||
                      (p.window > 0 && k0 <= qa + 63 - p.window);

    const uint64_t dk = desc_at(k_desc, s * 2 * C::KV_BYTES);
    const uint64_t dv = desc_at(k_desc, s * 2 * C::KV_BYTES + C::KV_BYTES);
    const uint64_t dkt = desc_at(kt_desc, s * 2 * C::KV_BYTES);

    mbar_wait(full + s, phase);
    if (!skip) {
      float sc[BK / 2], dp[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int slab = kk / (C::SPAN / 16);
        const int off = (kk % (C::SPAN / 16)) * 32;
        wgmma_ss<BK>(sc, desc_at(q_desc, slab * BQ * C::ROWB + off),
                     desc_at(dk, slab * BK * C::ROWB + off), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int slab = kk / (C::SPAN / 16);
        const int off = (kk % (C::SPAN / 16)) * 32;
        wgmma_ss<BK>(dp, desc_at(do_desc, slab * BQ * C::ROWB + off),
                     desc_at(dv, slab * BK * C::ROWB + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float pv = exp2f(fmaf(sc[4 * i + e], p.scale_log2, -lse2[r]));
          if (edge) {
            const int t = k0 + 8 * i + col + (e & 1);
            const int q = row0 + 8 * r;
            const bool ok = t < p.T && (!p.causal || t <= q) &&
                            (p.window <= 0 || t > q - p.window);
            if (!ok) pv = 0.f;
          }
          dp[4 * i + e] = pv * (dp[4 * i + e] - del[r]);
        }
      uint32_t da[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          da[kk][j] = pack_bf16(dp[8 * kk + 2 * j], dp[8 * kk + 2 * j + 1]);

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<HD>(dq, da[kk], desc_at(dkt, kk * 16 * C::ROWB));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
    }
    mbar_arrive(empty + s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row0 + 8 * r;
    if (q < p.S) {
      __nv_bfloat16* dqp = p.dq + b * p.sdq[0] + h * p.sdq[2] + (long long)q * p.sdq[1] + col;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
        *reinterpret_cast<uint32_t*>(dqp + 8 * i) =
            pack_bf16(dq[4 * i + 2 * r] * p.scale, dq[4 * i + 2 * r + 1] * p.scale);
    }
  }
}

template <int HD>
int launch_dq(const Params& p, int B, int KV, cudaStream_t stream) {
  using C = DqTiles<HD>;
  DqParams d;
  int err = make_tile_map(&d.tq, p.q, B, p.S, p.H, HD, p.st[Q][0], p.st[Q][1], p.st[Q][2], BQ,
                          C::SPAN);
  if (!err)
    err = make_tile_map(&d.tdo, p.dout, B, p.S, p.H, HD, p.st[DO][0], p.st[DO][1], p.st[DO][2],
                        BQ, C::SPAN);
  if (!err)
    err = make_tile_map(&d.tk, p.k, B, p.T, KV, HD, p.st[K][0], p.st[K][1], p.st[K][2], C::BK,
                        C::SPAN);
  if (!err)
    err = make_tile_map(&d.tv, p.v, B, p.T, KV, HD, p.st[V][0], p.st[V][1], p.st[V][2], C::BK,
                        C::SPAN);
  if (err) return err;
  d.lse = p.lse;
  d.delta = p.delta;
  d.dq = static_cast<__nv_bfloat16*>(p.dq);
  d.S = p.S;
  d.T = p.T;
  d.H = p.H;
  d.B = B;
  d.group = p.group;
  d.n_qt = (p.S + BQ - 1) / BQ;
  for (int a = 0; a < 3; ++a) d.sdq[a] = p.st[DQ][a];
  d.causal = p.causal;
  d.window = p.window;
  d.scale = p.scale;
  d.scale_log2 = p.scale * LOG2E;
  // set on every launch: the attribute holds for the current device only
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_tc_kernel<HD><<<d.n_qt * p.H * B, THREADS, C::SMEM, stream>>>(d);
  return (int)cudaGetLastError();
}

inline int dispatch_hd(bool dkv, const Params& p, int B, int KV, int hd, int split, float* ws,
                       cudaStream_t st) {
  switch (hd) {
    case 32: return dkv ? launch_dkv<32>(p, B, KV, split, ws, st) : launch_dq<32>(p, B, KV, st);
    case 64: return dkv ? launch_dkv<64>(p, B, KV, split, ws, st) : launch_dq<64>(p, B, KV, st);
    case 128:
      return dkv ? launch_dkv<128>(p, B, KV, split, ws, st) : launch_dq<128>(p, B, KV, st);
    case 256:
      return dkv ? launch_dkv<256>(p, B, KV, split, ws, st) : launch_dq<256>(p, B, KV, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc

int run(bool dkv, const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dq, void* dk, void* dv, int dtype, int B,
        int S, int T, int H, int KV, int hd, const long long* strides, int causal, int window,
        float scale, int split, void* ws, void* stream) {
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
  const bool tensor_cores = dtype == 1 && hopper::tensor_core_hd(hd);
  if (split != 1 && !tensor_cores) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dkv ? dispatch_dkv_f32(p, B, KV, hd, st) : dispatch_dq_f32(p, B, hd, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (tensor_cores) return tc::dispatch_hd(dkv, p, B, KV, hd, split, static_cast<float*>(ws), st);
  if (hd != 16) return (int)cudaErrorInvalidValue;
  return dkv ? launch_dkv<__nv_bfloat16, 16>(p, B, KV, st)
             : launch_dq<__nv_bfloat16, 16>(p, B, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, do and the gradients); bf16
// at hd >= 32 runs the tensor-core kernels, which need 16-byte-aligned pointers and
// q, k, v, do strides that are multiples of 8 elements (TMA; the wrapper
// checks).  lse and delta are contiguous (B, H, S) float32.  `strides` holds 21 element strides,
// (batch, sequence, head) for q, k, v, do, dq, dk, dv in that order; the
// head_dim axis of every tensor must be contiguous.  window <= 0 means none.
// Each entry point returns cudaGetLastError() after its launches (0 on success).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int dtype, int B,
                            int S, int T, int H, int KV, int hd, const long long* strides,
                            int causal, int window, float scale, void* stream) {
  return run(false, q, k, v, dout, lse, delta, dq, nullptr, nullptr, dtype, B, S, T, H, KV, hd,
             strides, causal, window, scale, 1, nullptr, stream);
}

// split: blocks a key tile's work is split into over the GQA group's query
// heads, a divisor of H / KV; above 1 only for the bf16 tensor-core
// instances (hd >= 32), which then need `ws`, 2 * split * B * T * KV * hd
// f32 of scratch, and make two launches (the split kernel, then the
// fixed-order sum).  The dkv tensor-core instances read lse and delta by
// TMA: both need a 16-byte-aligned base and at least 68 elements (zeros
// past B * H * S).
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int dtype,
                             int B, int S, int T, int H, int KV, int hd,
                             const long long* strides, int causal, int window, float scale,
                             int split, void* ws, void* stream) {
  return run(true, q, k, v, dout, lse, delta, nullptr, dk, dv, dtype, B, S, T, H, KV, hd,
             strides, causal, window, scale, split, ws, stream);
}

namespace {

// the dkv tensor-core instance at HD: its attributes and dynamic shared memory
template <int HD>
cudaError_t dkv_tc_attributes(cudaFuncAttributes* a, bool partial, int* smem) {
  *smem = tc::DkvTiles<HD>::SMEM;
  return partial ? cudaFuncGetAttributes(a, tc::flash_bwd_dkv_wg_kernel<HD, true>)
                 : cudaFuncGetAttributes(a, tc::flash_bwd_dkv_wg_kernel<HD, false>);
}

// registers and local (spill) bytes a thread, dynamic shared memory and
// threads a block, of the kernel instance that a launch of (dtype, hd) runs,
// and whether it is a tensor-core kernel
template <int HD>
int info(bool dkv, int dtype, bool partial, int* out) {
  constexpr bool tc_hd = hopper::tensor_core_hd(HD);
  cudaFuncAttributes a;
  cudaError_t err;
  int smem = 0;
  if (dtype == 0)
    err = dkv ? cudaFuncGetAttributes(&a, flash_bwd_dkv_kernel<float, HD>)
              : cudaFuncGetAttributes(&a, flash_bwd_dq_kernel<float, HD>);
  else if constexpr (tc_hd)
    err = dkv ? dkv_tc_attributes<HD>(&a, partial, &smem)
              : cudaFuncGetAttributes(&a, tc::flash_bwd_dq_tc_kernel<HD>);
  else
    err = dkv ? cudaFuncGetAttributes(&a, flash_bwd_dkv_kernel<__nv_bfloat16, HD>)
              : cudaFuncGetAttributes(&a, flash_bwd_dq_kernel<__nv_bfloat16, HD>);
  if (err != cudaSuccess) return (int)err;
  const bool tensor_cores = dtype == 1 && tc_hd;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  if (tensor_cores) {
    out[2] = dkv ? smem : tc::DqTiles<HD>::SMEM;
    out[3] = tc::THREADS;
  } else {
    out[2] = (int)(dkv ? dkv_smem_bytes<HD>() : dq_smem_bytes<HD>());
    out[3] = dkv ? KV_THREADS : DQ_THREADS;
  }
  out[4] = tensor_cores;
  return 0;
}

int info_hd(bool dkv, int dtype, int hd, bool partial, int* out) {
  switch (hd) {
    case 16: return info<16>(dkv, dtype, partial, out);
    case 32: return info<32>(dkv, dtype, partial, out);
    case 64: return info<64>(dkv, dtype, partial, out);
    case 128: return info<128>(dkv, dtype, partial, out);
    case 256: return info<256>(dkv, dtype, partial, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// out[5] = registers a thread, local bytes a thread, dynamic shared memory
// bytes and threads a block of the kernel that (dtype, hd) launches, and 1
// if it is a tensor-core kernel (the wrapper then checks strides for TMA);
// for dkv with split > 1, of the bf16 instance that writes partials
extern "C" int flash_bwd_dq_info(int dtype, int hd, int* out) {
  return info_hd(false, dtype, hd, false, out);
}

extern "C" int flash_bwd_dkv_info(int dtype, int hd, int split, int* out) {
  return info_hd(true, dtype, hd, split > 1, out);
}

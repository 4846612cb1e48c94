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
// ~13.6 MB (4.1 us at 3.35 TB/s) and the recurrence does 5 f32 flops per
// state element and step, 336 MFLOP (5.0 us at 67 TFLOP/s).  A walk over
// time cannot come near either: B*H = 32 chains of 512 dependent steps give
// 32 blocks for 132 SMs.
//
// Design: the chunked form of kernels/rwkv6/ops.py (`_chunk_body`), in three
// launches, so the grid is (time chunk, batch row x head): 16 x 32 = 512
// blocks at the model's shape with CHUNK = 32.  Within a chunk, with L_t the
// inclusive prefix sum of log2 w over the chunk's steps and Lx_t = L_{t-1}
// (Lx_0 = 0):
//  1. `wkv6_chunk_kernel`, per (chunk, b, h): the chunk's decay d = 2^L_last
//     and its state contribution U = sum_m (2^(L_last - L_m) * k_m) v_m^T,
//     into f32 scratch (B*H, chunks, K, V) and (B*H, chunks, K);
//  2. `wkv6_carry_kernel`, one thread per state element (B*H*K*V of them):
//     S_{c+1} = d_c * S_c + U_c over the chunks in order, all loads of a
//     batch of 8 chunks in flight at once; it overwrites U_c with the state
//     entering chunk c and writes the final state;
//  3. `wkv6_out_kernel`, per (chunk, b, h):
//       y_t = (r_t * 2^Lx_t) . S_in + sum_{m<t} A_tm v_m + (r_t . (u * k_t)) v_t,
//       A_tm = sum_i r_ti k_mi 2^(Lx_ti - L_mi),
//     A in shared memory: inside each 16-row half from pairwise decays (a
//     half-warp takes the row pair (j, 15 - j), 15 of its lanes one (t, m)
//     each), and the block t >= 16 > m as the product of r_t 2^(Lx_t - L_15)
//     and k_m 2^(L_15 - L_m), both exponents <= 0, which costs 2 exp2 per
//     element of r and k instead of 64 per (t, m); then y as two products
//     from shared memory, each thread 8 rows x 1 column with float4
//     broadcasts.  A block's loads are all issued before any is used.
// Fusing 2 into 3 (each block walking the chunks before it) would cost
// O(chunks^2) reads of 16 KB states; a decoupled look-back would chain 16
// latencies of a 16 KB state; the carry's one pass over 8 MB in L2 is cheaper.
// Every exponent is a difference of prefix sums that is <= 0 (clamped so
// rounding cannot make it positive) -- between two steps, or a step and the
// reference row L_15 that lies between them -- never a factor 2^L against
// 2^-L, so nothing overflows whatever the decays: underflow to 0 is the exact
// limit, and a factor that underflows bounds the product it stands for.  log2 w is clamped at 1e-38, as `wkv6_chunked` clamps log w.
// Precision: the prefix sums run in f64, since the difference of two f32
// sums near -100 keeps only ~1e-5 of a small exponent; A's 64-term sums are
// Kahan-compensated, since they dominate y's remaining rounding.  All
// products are f32 FMAs on the CUDA cores (y and the state are held to 2e-5
// in f32), and the inputs are read in the model's (B, S, H, K) layout
// through their strides, each in its own dtype (bf16 r/k/v beside f32 w; w
// is never rounded).  Rows past S are masked (r = k = v = 0, w = 1).  Because the sums
// run in another order than the step-by-step loop, y and the final state are
// not bit-equal to the plain version; they agree within the f32 tolerance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 32;     // steps of a chunk
constexpr int THREADS = 256;  // every kernel
constexpr int HALF = CHUNK / 2;
constexpr int BATCH = 8;      // chunks whose loads the carry keeps in flight

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
  float* states;    // (B*H, chunks, K, K): U_c, then the state entering chunk c
  float* decay;     // (B*H, chunks, K)
  int S, H, chunks;
  long long st[4][3];  // r, k, v, w: batch, time and head strides (channel stride 1)
};

// N consecutive floats of shared memory (16-byte aligned for N % 4 == 0,
// 8-byte for N == 2) into registers, in as few loads as the width allows
template <int N>
__device__ __forceinline__ void load_run(float (&dst)[N], const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(src)[q];
      dst[4 * q] = x.x;
      dst[4 * q + 1] = x.y;
      dst[4 * q + 2] = x.z;
      dst[4 * q + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(src);
    dst[0] = x.x;
    dst[1] = x.y;
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) dst[q] = src[q];
  }
}

// N (even) consecutive doubles of 16-byte-aligned shared memory
template <int N>
__device__ __forceinline__ void load_run(double (&dst)[N], const double* src) {
#pragma unroll
  for (int q = 0; q < N / 2; ++q) {
    const double2 x = reinterpret_cast<const double2*>(src)[q];
    dst[2 * q] = x.x;
    dst[2 * q + 1] = x.y;
  }
}

// A thread's share of rows [t0, t0 + CHUNK) of one head of a (B, S, H, K)
// input: element e = threadIdx.x + q * THREADS of the chunk for q < PER, read
// into registers as f32, rows past S as `pad`.  Every load of a thread is
// issued before any is used, so a block's loads are all in flight at once.
template <int K>
constexpr int PER = CHUNK * K / THREADS;

template <typename T, int K>
__device__ __forceinline__ void fetch(float (&dst)[PER<K>], const Params& p, int x, int b, int h,
                                      int t0, float pad) {
  const T* src = static_cast<const T*>(x == R ? p.r : x == KK ? p.k : x == VV ? p.v : p.w) +
                 b * p.st[x][0] + h * p.st[x][2];
  const long long ts = p.st[x][1];
#pragma unroll
  for (int q = 0; q < PER<K>; ++q) {
    const int e = threadIdx.x + q * THREADS;
    const int t = t0 + e / K;
    dst[q] = t < p.S ? to_f32(src[t * ts + e % K]) : pad;
  }
}

// Those values into a [CHUNK][ld] array of D in shared memory, or their log2
// (clamped at 1e-38) with `log2w`.
template <int K, typename D>
__device__ __forceinline__ void put(D* dst, int ld, const float (&src)[PER<K>],
                                    bool log2w = false) {
#pragma unroll
  for (int q = 0; q < PER<K>; ++q) {
    const int e = threadIdx.x + q * THREADS;
    dst[(e / K) * ld + e % K] = log2w ? log2f(fmaxf(src[q], 1e-38f)) : src[q];
  }
}

// Inclusive prefix sums down the rows of each of the K columns, in place, in f64.
template <int K>
__device__ __forceinline__ void scan_columns(double* L, int ld) {
  if (threadIdx.x < K) {
    double acc = 0.0;
    for (int row = 0; row < CHUNK; ++row) {
      acc += L[row * ld + threadIdx.x];
      L[row * ld + threadIdx.x] = acc;
    }
  }
}

// Padded rows (K + 4 floats, K + 2 doubles: an odd number of 16-byte units),
// so 16-byte reads of neighbouring rows by neighbouring lanes hit other banks.
template <int K>
struct ChunkSmem {
  static constexpr int LD = K + 4, LDD = K + 2;
  // L [CHUNK][LDD] f64, kd [CHUNK][LD], v [CHUNK][K]
  static constexpr int BYTES = 8 * CHUNK * LDD + 4 * (CHUNK * LD + CHUNK * K);
};

// 1. the chunk's decay and state contribution
template <typename T, typename TW, int K>
__global__ void __launch_bounds__(THREADS) wkv6_chunk_kernel(Params p) {
  using C = ChunkSmem<K>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* L = reinterpret_cast<double*>(smem_raw);           // [CHUNK][LDD]: log2 w, then its prefix sums
  float* kd = reinterpret_cast<float*>(L + CHUNK * C::LDD);  // [CHUNK][LD]: k, then k * 2^(L_last - L)
  float* vs = kd + CHUNK * C::LD;                            // [CHUNK][K]

  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int t0 = c * CHUNK;
  {
    float kr[PER<K>], vr[PER<K>], wr[PER<K>];
    fetch<T, K>(kr, p, KK, b, h, t0, 0.f);
    fetch<T, K>(vr, p, VV, b, h, t0, 0.f);
    fetch<TW, K>(wr, p, W, b, h, t0, 1.f);
    put<K>(kd, C::LD, kr);
    put<K>(vs, K, vr);
    put<K>(L, C::LDD, wr, true);
  }
  __syncthreads();
  scan_columns<K>(L, C::LDD);
  __syncthreads();
  const double* last = L + (CHUNK - 1) * C::LDD;
  if (threadIdx.x < K)
    p.decay[((long long)bh * p.chunks + c) * K + threadIdx.x] = exp2f((float)last[threadIdx.x]);
  for (int e = threadIdx.x; e < CHUNK * K; e += THREADS) {
    const int row = e / K, col = e % K;
    kd[row * C::LD + col] *= exp2f((float)fmin(last[col] - L[row * C::LDD + col], 0.0));
  }
  __syncthreads();

  // U[i][j] = sum_m kd[m][i] v[m][j]: a thread owns a TILE x TILE block
  // (4 x 4, or 2 x 2 at K = 16), reading a float4 of kd and one of v a step
  constexpr int TILE = K * K / THREADS >= 16 ? 4 : 2, SPAN = K / TILE;
  const int i0 = (threadIdx.x / SPAN) * TILE, j0 = (threadIdx.x % SPAN) * TILE;
  float acc[TILE][TILE] = {};
  if (i0 < K) {
    for (int m = 0; m < CHUNK; ++m) {
      float kr[TILE], vr[TILE];
      load_run<TILE>(kr, kd + m * C::LD + i0);
      load_run<TILE>(vr, vs + m * K + j0);
#pragma unroll
      for (int a = 0; a < TILE; ++a)
#pragma unroll
        for (int q = 0; q < TILE; ++q) acc[a][q] = fmaf(kr[a], vr[q], acc[a][q]);
    }
    float* U = p.states + ((long long)bh * p.chunks + c) * K * K;
#pragma unroll
    for (int a = 0; a < TILE; ++a)
#pragma unroll
      for (int q = 0; q < TILE; ++q) U[(i0 + a) * K + j0 + q] = acc[a][q];
  }
}

// 2. the state entering each chunk, and the final state
template <int K>
__global__ void __launch_bounds__(THREADS) wkv6_carry_kernel(Params p, long long n) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= n) return;
  const long long bh = e / (K * K);
  const int ij = (int)(e % (K * K)), i = ij / K;
  float s = p.s0 ? p.s0[e] : 0.f;
  float* U = p.states + bh * p.chunks * K * K + ij;
  const float* d = p.decay + bh * p.chunks * K + i;
  for (int c0 = 0; c0 < p.chunks; c0 += BATCH) {
    float uc[BATCH], dc[BATCH];
#pragma unroll
    for (int q = 0; q < BATCH; ++q) {
      if (c0 + q < p.chunks) {
        uc[q] = U[(long long)(c0 + q) * K * K];
        dc[q] = d[(long long)(c0 + q) * K];
      }
    }
#pragma unroll
    for (int q = 0; q < BATCH; ++q) {
      if (c0 + q < p.chunks) {
        U[(long long)(c0 + q) * K * K] = s;
        s = fmaf(dc[q], s, uc[q]);
      }
    }
  }
  p.s_out[e] = s;
}

// sum_i r_i k_i 2^(lx_i - lm_i) (or sum_i r_i k_i without exponents), over
// 16-byte-aligned rows of shared memory, Kahan-compensated
template <int K>
__device__ __forceinline__ float scores(const float* r, const float* k, const double* lx,
                                        const double* lm) {
  float acc = 0.f, comp = 0.f;  // acc - comp is the running sum
  for (int i = 0; i < K; i += 4) {
    float rr[4], kk[4], dec[4] = {1.f, 1.f, 1.f, 1.f};
    load_run<4>(rr, r + i);
    load_run<4>(kk, k + i);
    if (lx) {
      double xx[4], ll[4];
      load_run<4>(xx, lx + i);
      load_run<4>(ll, lm + i);
#pragma unroll
      for (int q = 0; q < 4; ++q) dec[q] = exp2f((float)fmin(xx[q] - ll[q], 0.0));
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float term = __fmul_rn(rr[q] * kk[q], dec[q]) - comp;
      const float sum = __fadd_rn(acc, term);
      comp = __fsub_rn(__fsub_rn(sum, acc), term);
      acc = sum;
    }
  }
  return acc;
}

template <int K>
struct OutSmem {
  // rdecT rows of CHUNK + 4: its transposed writes (neighbouring lanes on
  // neighbouring rows) would all hit one bank at a stride of CHUNK
  static constexpr int LD = K + 4, LDD = K + 2, RD = CHUNK + 4;
  // L [CHUNK][LDD] f64 (it holds S_in [K][K] once A is formed); r, k
  // [CHUNK][LD], v [CHUNK][K], rdecT [K][RD], AT [CHUNK][CHUNK], u [K]
  static constexpr int BYTES =
      8 * CHUNK * LDD + 4 * (2 * CHUNK * LD + CHUNK * K + K * RD + CHUNK * CHUNK + K);
  static_assert(K * K <= 2 * CHUNK * LDD, "S_in must fit where L was");
  static_assert(CHUNK == 32 && THREADS == 256, "A's thread mapping: 8 warps, two 16-row halves");
};

// 3. the chunk's outputs
// at most 64 registers a thread, so 4 blocks share an SM and the 512 blocks
// of the model's shape run in one wave
template <typename T, typename TW, int K>
__global__ void __launch_bounds__(THREADS, 4) wkv6_out_kernel(Params p) {
  using C = OutSmem<K>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* L = reinterpret_cast<double*>(smem_raw);           // [CHUNK][LDD]: log2 w, then its prefix sums
  float* rs = reinterpret_cast<float*>(L + CHUNK * C::LDD);  // [CHUNK][LD]
  float* ks = rs + CHUNK * C::LD;    // [CHUNK][LD]
  float* vs = ks + CHUNK * C::LD;    // [CHUNK][K]
  float* rdT = vs + CHUNK * K;       // [K][RD]: r_ti 2^Lx_ti, transposed
  float* AT = rdT + K * C::RD;       // [CHUNK][CHUNK]: AT[m][t] = A_tm, 0 above t
  float* us = AT + CHUNK * CHUNK;    // [K]
  float* Sin = reinterpret_cast<float*>(L);  // [K][K], over L once A is formed

  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int t0 = c * CHUNK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  {
    float rr[PER<K>], kr[PER<K>], vr[PER<K>], wr[PER<K>];
    fetch<T, K>(rr, p, R, b, h, t0, 0.f);
    fetch<T, K>(kr, p, KK, b, h, t0, 0.f);
    fetch<T, K>(vr, p, VV, b, h, t0, 0.f);
    fetch<TW, K>(wr, p, W, b, h, t0, 1.f);
    put<K>(rs, C::LD, rr);
    put<K>(ks, C::LD, kr);
    put<K>(vs, K, vr);
    put<K>(L, C::LDD, wr, true);
  }
  for (int e = threadIdx.x; e < CHUNK * CHUNK; e += THREADS) AT[e] = 0.f;
  if (threadIdx.x < K) us[threadIdx.x] = p.u[h * K + threadIdx.x];
  __syncthreads();
  scan_columns<K>(L, C::LDD);
  __syncthreads();

  // r_t * 2^Lx_t, transposed; the diagonal bonus r_t . (u * k_t) into AT[t][t]
  for (int e = threadIdx.x; e < CHUNK * K; e += THREADS) {
    const int t = e / K, i = e % K;
    const double lx = t > 0 ? L[(t - 1) * C::LDD + i] : 0.0;
    rdT[i * C::RD + t] = rs[t * C::LD + i] * exp2f((float)fmin(lx, 0.0));
  }
  if (threadIdx.x < CHUNK) {
    const int t = threadIdx.x;
    float acc = 0.f;
    for (int i = 0; i < K; i += 4) {
      float rr[4], kk[4], uu[4];
      load_run<4>(rr, rs + t * C::LD + i);
      load_run<4>(kk, ks + t * C::LD + i);
      load_run<4>(uu, us + i);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc = fmaf(rr[q] * uu[q], kk[q], acc);
    }
    AT[t * CHUNK + t] = acc;
  }
  // A_tm for m < t within each 16-row half (the diagonal blocks), from
  // pairwise decays: half-warp `pair` = 2 * warp + lane / 16 takes the rows
  // (j, 15 - j), j = pair % 8, of half pair / 8; lane l < j computes (j, l),
  // lane l in [j, 15) computes (15 - j, l - j)
  {
    const int pair = 2 * warp + lane / 16, l = lane % 16, j = pair % 8;
    const int base = HALF * (pair / 8);
    if (l < HALF - 1) {
      const int t = base + (l < j ? j : HALF - 1 - j);
      const int m = base + (l < j ? l : l - j);
      AT[m * CHUNK + t] = scores<K>(rs + t * C::LD, ks + m * C::LD, L + (t - 1) * C::LDD,
                                    L + m * C::LDD);
    }
  }
  __syncthreads();

  // the off-diagonal block (t >= 16 > m) factors through the reference row
  // L_15, with both exponents <= 0: A_tm = (r_t * 2^(Lx_t - L_15)) . (k_m *
  // 2^(L_15 - L_m)); the factors overwrite r_t (t >= 16) and k_m (m < 16)
  const double* ref = L + (HALF - 1) * C::LDD;
  for (int e = threadIdx.x; e < CHUNK * K; e += THREADS) {
    const int row = e / K, i = e % K;
    if (row >= HALF)
      rs[row * C::LD + i] *= exp2f((float)fmin(L[(row - 1) * C::LDD + i] - ref[i], 0.0));
    else
      ks[row * C::LD + i] *= exp2f((float)fmin(ref[i] - L[row * C::LDD + i], 0.0));
  }
  __syncthreads();
  {
    const int t = HALF + threadIdx.x / HALF, m = threadIdx.x % HALF;
    AT[m * CHUNK + t] = scores<K>(rs + t * C::LD, ks + m * C::LD, nullptr, nullptr);
  }
  // S_in over L, which nothing reads any more
  const float* S_in = p.states + ((long long)bh * p.chunks + c) * K * K;
  for (int e = threadIdx.x; e < K * K / 4; e += THREADS)
    reinterpret_cast<float4*>(Sin)[e] = __ldcg(reinterpret_cast<const float4*>(S_in) + e);
  __syncthreads();

  // y[t][j] = sum_i rdT[i][t] S_in[i][j] + sum_{m <= t} AT[m][t] v[m][j]:
  // a thread owns 4 rows x 4 columns (2 x 2 at K = 16), a float4 of rdT and
  // one of S_in a step; the threads past CHUNK * K / 16 (half of them at
  // K = 64) have no tile
  constexpr int TILE = K >= 32 ? 4 : 2, SPAN = K / TILE;
  const int ta = (threadIdx.x / SPAN) * TILE, ja = (threadIdx.x % SPAN) * TILE;
  if (ta >= CHUNK) return;
  float acc[TILE][TILE] = {};
  for (int i = 0; i < K; ++i) {
    float rr[TILE], ss[TILE];
    load_run<TILE>(rr, rdT + i * C::RD + ta);
    load_run<TILE>(ss, Sin + i * K + ja);
#pragma unroll
    for (int a = 0; a < TILE; ++a)
#pragma unroll
      for (int q = 0; q < TILE; ++q) acc[a][q] = fmaf(rr[a], ss[q], acc[a][q]);
  }
  for (int m = 0; m < ta + TILE; ++m) {
    float aa[TILE], vv[TILE];
    load_run<TILE>(aa, AT + m * CHUNK + ta);
    load_run<TILE>(vv, vs + m * K + ja);
#pragma unroll
    for (int a = 0; a < TILE; ++a)
#pragma unroll
      for (int q = 0; q < TILE; ++q) acc[a][q] = fmaf(aa[a], vv[q], acc[a][q]);
  }
#pragma unroll
  for (int a = 0; a < TILE; ++a) {
    if (t0 + ta + a >= p.S) break;
    T* y = static_cast<T*>(p.y) + (((long long)b * p.S + t0 + ta + a) * p.H + h) * K + ja;
#pragma unroll
    for (int q = 0; q < TILE; ++q) y[q] = from_f32<T>(acc[a][q]);
  }
}

template <typename T, typename TW, int K>
int launch(const Params& p, int B, cudaStream_t stream) {
  // set on every launch: the attribute holds for the current device only
  cudaError_t err = cudaFuncSetAttribute(wkv6_chunk_kernel<T, TW, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         ChunkSmem<K>::BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wkv6_out_kernel<T, TW, K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, OutSmem<K>::BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.chunks, B * p.H);  // B * H <= 65535: the wrapper checks
  wkv6_chunk_kernel<T, TW, K><<<grid, THREADS, ChunkSmem<K>::BYTES, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)B * p.H * K * K;
  wkv6_carry_kernel<K><<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, stream>>>(p, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv6_out_kernel<T, TW, K><<<grid, THREADS, OutSmem<K>::BYTES, stream>>>(p);
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

// f32 scratch values the caller allocates for (B, S, H, K): the chunk states
// and decays
long long scratch_values(int B, int S, int H, int K) {
  const long long chunks = (S + CHUNK - 1) / CHUNK;
  return (long long)B * H * chunks * K * (K + 1);
}

template <int K>
void plan(int B, int S, int H, int* out) {
  const int chunks = (S + CHUNK - 1) / CHUNK;
  const long long n = (long long)B * H * K * K;
  const int per_chunk[3] = {chunks * B * H, (int)((n + THREADS - 1) / THREADS), chunks * B * H};
  const int smem[3] = {ChunkSmem<K>::BYTES, 0, OutSmem<K>::BYTES};
  for (int x = 0; x < 3; ++x) {
    out[3 * x] = per_chunk[x];
    out[3 * x + 1] = THREADS;
    out[3 * x + 2] = smem[x];
  }
}

}  // namespace

// out[9] = blocks, threads a block and dynamic shared memory bytes a block of
// the three launches (chunk states, carry, chunk outputs) for (B, S, H, K)
extern "C" int wkv6_fwd_grid(int B, int S, int H, int K, int* out) {
  switch (K) {
    case 16: plan<16>(B, S, H, out); return 0;
    case 32: plan<32>(B, S, H, out); return 0;
    case 64: plan<64>(B, S, H, out); return 0;
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" long long wkv6_fwd_scratch(int B, int S, int H, int K) {
  return scratch_values(B, S, H, K);
}

// r, k, v: one dtype (0 = float32, 1 = bfloat16); w: wdtype; channel axes
// contiguous; strides: 12 int64 (batch, time, head) for r, k, v, w in
// elements.  u: (H, K) f32; s0: (B, H, K, K) f32 or null; y: (B, S, H, K)
// contiguous in r's dtype; s_out: (B, H, K, K) f32; scratch: as sized by
// `wkv6_fwd_scratch`.  K = V in {16, 32, 64}.  Three launches on `stream`.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
                        const void* u, const void* s0, void* y, void* s_out, void* scratch,
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
  p.chunks = (S + CHUNK - 1) / CHUNK;
  p.states = static_cast<float*>(scratch);
  p.decay = p.states + (long long)B * H * p.chunks * K * K;
  for (int x = 0; x < 4; ++x)
    for (int d = 0; d < 3; ++d) p.st[x][d] = strides[3 * x + d];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_w<float>(p, wdtype, B, K, st);
  if (dtype == 1) return dispatch_w<__nv_bfloat16>(p, wdtype, B, K, st);
  return (int)cudaErrorInvalidValue;
}

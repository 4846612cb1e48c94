// Flash-attention forward for sm_90a: online-softmax GQA attention with causal
// and sliding-window masks, in the model's (B, S, H, hd) / (B, T, KV, hd)
// layout.
//
// Replaces the Pallas TPU kernel `flash_fwd` (`_fwd_kernel`) of
// src/repro/kernels/flash_attention/kernel.py.  Same function: f32 running
// max, denominator and accumulator; KV head h / group; scale hd**-0.5 applied
// to the f32 scores; out in the input dtype and lse = m + log(l) in f32
// (natural log).  Head dims 16 (the smoke configs), 32, 64, 128 and 256
// (recurrentgemma-9b's MQA heads).
//
// What bounds it on the H100: at the training shapes it is the tensor
// cores (llama, B = 4, S = T = 1024, 32/8 heads of 64, causal: 17.2 GFLOP
// against ~34 MB, 17.4 us at 989 TFLOP/s; internvl2-26b, B = 4, S = T =
// 1280, 48/8 heads of 128: 80.7 GFLOP, 81.6 us); at the serving shape
// (B = 1, S = T = 512) its ~5 MB of traffic (~1.6 us).
//
// Two designs, chosen by dtype:
//
// bf16 -- tensor cores (`flash_fwd_tc_kernel`, `Tiles<HD>`).  One block per
// (query tile, head, batch row), one warpgroup of 128 threads per 64 query
// rows: one at hd 32 and 64 (four blocks an SM), two at hd 128 and 256 (one
// block an SM):
//  * loads: TMA (`cp.async.bulk.tensor`) reads the model layout through a 4-d
//    tensor map (hd, S, heads, batch) into 128-byte-swizzled shared memory
//    (64-byte at hd 32; hd 128 and 256 in 64-column slabs), filling rows past
//    S or T with zeros.  The last warpgroup's first thread issues them: Q
//    once, then K and V as two rings of two stages, each slot guarded by a
//    "full" mbarrier (TMA completes it with the bytes it wrote) and an
//    "empty" one (every thread releases it).  K_i's slot is released as
//    soon as S_i is computed and V_i's after P_i V_i, and the issuer loads
//    tile i + 2 into a slot right after its own warpgroup's release, so no
//    warpgroup waits for another's products;
//  * per key tile: S = Q K^T with `wgmma.mma_async` m64nBKk16 (both operands
//    in shared memory, K-major), the online softmax on the f32 accumulator in
//    registers (a row lives on a quad of lanes: two shuffles per max;
//    exponentials by `ex2.approx.ftz`, one MUFU instruction each), P rounded
//    to bf16 and fed back as wgmma's register-A operand for O += P V, with V
//    read from shared memory in the transposed-B (MN-major) mode -- V is
//    never transposed in memory;
//  * step i issues S_i and P_{i-1} V_{i-1} together and waits for S_i alone
//    (`wgmma_wait<1>`) before its softmax, which needs a second score
//    buffer (P_{i-1} in bf16 beside S_i);
//  * key tiles: 128 keys at hd 128 (64-key tiles measured 18% slower), 64
//    elsewhere.  The block visits only the tiles the causal and window masks
//    leave, a warpgroup releases a tile its rows cannot see without its
//    products, and the element mask (one row range per row) runs only on
//    tiles that cut the causal diagonal, the window edge or the ragged T
//    edge;
//  * the epilogue writes O, normalised, in bf16 into the warpgroup's own rows
//    of the Q tile (free once its last S product is done) in the swizzled
//    layout and stores it with TMA, which clips rows past S; lse in f32
//    straight from the registers;
//  * registers: 96-224 a thread, no spills (`tools/kernel_report.py`;
//    chip_smoke.py prints them).
//  Measured and dropped (PERF.md): the two warpgroups issuing their products
//  in turn by named barriers (ping-pong: no faster at hd 128, 4-6% slower
//  at hd 64), three warpgroups a block at hd 128 (64-key tiles, 145
//  registers: 4% slower), one-warpgroup blocks at hd 128 (13% slower), two
//  warpgroups a block at hd <= 64 (3-10% slower; encdec training within
//  1%), a persistent grid walking tiles with the next tile's Q and K/V
//  loaded ahead (15-64% slower: its static tile order balanced worse than
//  the block scheduler, and its load bookkeeping cost registers), deeper
//  rings (no faster), and O stored straight from the registers (9% slower
//  at hd 128).  The phase counters (tools/flash_phases.py) show why the
//  overlap buys little: a warpgroup's `wgmma` issue returns only as fast as
//  the tensor cores take the products, so its softmax cannot run under its
//  own products, only under the other warpgroup's.  A dedicated producer
//  warp was not tried again: ptxas (CUDA 12.9) counts a block of 2
//  warpgroups and a warp as 3 warpgroups, caps it at 168 registers a thread
//  and does not allocate above the launch count after `setmaxnreg.inc`, so
//  that layout spilled the P fragments at hd 128 and 256 before.
//  Rounding P to bf16 before P V is the one rounding the f32 reference does
//  not make (tests/test_torch_flash_tc.py holds an emulation of it against
//  the reference at the bf16 tolerance).
//
// f32 -- CUDA-core FMAs (`flash_fwd_kernel`, kept for the f32 checks, which a
// bf16 or TF32 tensor core cannot meet at 2e-5; it also serves bf16 at hd 16,
// the smoke configs' head_dim, which no timed path runs): one block per (query tile
// of 32 rows, head, batch row), 128 threads, four per query row (a "quad");
// K and V tiles of 64 keys staged in shared memory as f32, each quad lane
// scoring 16 keys and accumulating hd / 4 output columns; shared-memory
// strides padded (HD + 1, BK + 4) against bank conflicts.  At hd 256 it needs
// 172,928 B of shared memory and 64 accumulators a thread.
//
// Both mask ragged S and T edges in the kernel, so every prefill length runs
// through them (the reference's untiled fallback is not needed).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

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
    case 16: return launch<T, 16>(p, B, stream);
    case 32: return launch<T, 32>(p, B, stream);
    case 64: return launch<T, 64>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    case 256: return launch<T, 256>(p, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma) fed by TMA
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr float LN2 = 0.6931471805599453f;

// The tensor-core kernel's tiles by head_dim, each the fastest measured
// (PERF.md): warpgroups a block (64 query rows each), keys a K/V tile, K/V
// ring depth and blocks an SM.  At hd <= 64 a block is one warpgroup and
// four share an SM (<= 128 registers a thread), so one block's first
// loads and its epilogue overlap the others' products; at hd 128 two
// warpgroups share 128-key tiles (one block an SM, ~195 registers); at hd
// 256 the O accumulator alone is 128 registers a thread.
template <int HD>
struct Tiles {
  static constexpr int WGS = HD <= 64 ? 1 : 2;
  static constexpr int BQ = 64 * WGS;              // query rows of a block
  static constexpr int THREADS = 128 * WGS;
  static constexpr int BK = HD == 128 ? 128 : 64;  // keys a tile
  static constexpr int STAGES = 2;                 // K and V ring depth
  static constexpr int BLOCKS = HD <= 64 ? 4 : 1;  // blocks an SM
  static constexpr int SPAN = HD < 64 ? HD : 64;   // columns of one swizzled slab
  static constexpr int SLABS = HD / SPAN;
  static constexpr int ROWB = 2 * SPAN;            // bytes of a slab row = swizzle span
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;     // one K or V tile
  // 1024 bytes of slack to align the tiles to the 128-byte swizzle's period
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 4 * STAGES);
};

struct FwdParams {
  CUtensorMap tq, tk, tv, to;
  float* lse;
  int S, T, H, B, group, n_qt;
  int causal;
  int window;  // <= 0: no window
  float scale_log2;  // hd**-0.5 * log2(e): the softmax runs in base 2
};

// S = Q K^T of one key tile: HD / 16 products of m64nBKk16
template <int HD>
__device__ __forceinline__ void score_product(float (&sc)[Tiles<HD>::BK / 2], uint64_t q_desc,
                                              uint64_t dk) {
  using C = Tiles<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int slab = kk / (C::SPAN / 16);
    const int off = (kk % (C::SPAN / 16)) * 32;
    wgmma_ss<C::BK>(sc, desc_at(q_desc, slab * C::BQ * C::ROWB + off),
                    desc_at(dk, slab * C::BK * C::ROWB + off), kk > 0);
  }
}

// O += P V of one key tile, P the bf16 register fragments
template <int HD>
__device__ __forceinline__ void value_product(float (&o)[HD / 2],
                                              const uint32_t (&pa)[Tiles<HD>::BK / 16][4],
                                              uint64_t dv) {
  using C = Tiles<HD>;
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk) wgmma_rs<HD>(o, pa[kk], desc_at(dv, kk * 16 * C::ROWB));
}

// The online softmax of one key tile of scores, in place: masks the
// elements outside the causal / window / T edge where `edge`, updates the
// running max m (base 2) and this lane's share of the denominator l, and
// leaves the unrounded probabilities in sc and the factor by which the
// output accumulated so far must be scaled in alpha.
template <int BK>
__device__ __forceinline__ void online_softmax(float (&sc)[BK / 2], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], bool edge, int k0, int row0,
                                               int col, const FwdParams& p) {
  if (edge) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // row qpos admits keys [lo, hi); relative to this lane's first key
      // column, c = 8 i + j of the tile's keys k0 + col + c
      const int qpos = row0 + 8 * r;
      const int hi = (p.causal ? min(p.T, qpos + 1) : p.T) - k0 - col;
      const int lo = (p.window > 0 ? qpos - p.window + 1 : -(1 << 30)) - k0 - col;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (8 * i + j >= hi || 8 * i + j < lo) sc[4 * i + 2 * r + j] = -INFINITY;
    }
  }
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    tmax[0] = fmaxf(tmax[0], fmaxf(sc[4 * i], sc[4 * i + 1]));
    tmax[1] = fmaxf(tmax[1], fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
  }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
    const float m_new = fmaxf(m[r], tmax[r] * p.scale_log2);
    base[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing admissible yet
    alpha[r] = exp2_ftz(m[r] - base[r]);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < BK / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pv = exp2_ftz(fmaf(sc[4 * i + e], p.scale_log2, -base[e >> 1]));
      sc[4 * i + e] = pv;
      l[e >> 1] += pv;
    }
}

// O *= alpha (row-wise), then P = sc rounded to bf16 as wgmma's A fragments
template <int HD, int BK>
__device__ __forceinline__ void rescale_and_pack(float (&o)[HD / 2], const float (&alpha)[2],
                                                 const float (&sc)[BK / 2],
                                                 uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    o[4 * i] *= alpha[0];
    o[4 * i + 1] *= alpha[0];
    o[4 * i + 2] *= alpha[1];
    o[4 * i + 3] *= alpha[1];
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
}

// Phase counters of a diagnostic build (-DFLASH_FWD_PHASES; run by
// tools/flash_phases.py): each warpgroup's first thread adds the SM cycles
// since its last mark to one counter of its warpgroup, and counts blocks
// and main-loop steps.  The plain build compiles the marks to nothing.
enum Phase { PROLOGUE, Q_WAIT, FIRST_STEP, DATA_WAIT, ISSUE_S, ISSUE_PV, S_WAIT, SOFTMAX,
             PV_WAIT, RESCALE, LAST_STEP, EPILOGUE, N_PHASES };
#ifdef FLASH_FWD_PHASES
__device__ unsigned long long fwd_phases[2][N_PHASES + 2];
#define PHASES_START unsigned long long phase_t = clock64(), phase_sum[N_PHASES] = {};
#define PHASE(c)                                    \
  {                                                 \
    const unsigned long long now_ = clock64();      \
    phase_sum[c] += now_ - phase_t;                 \
    phase_t = now_;                                 \
  }
#define PHASES_END(wg, tid, steps)                                               \
  if ((tid) == 0 && (wg) < 2) {                                                  \
    for (int c_ = 0; c_ < N_PHASES; ++c_) atomicAdd(&fwd_phases[wg][c_], phase_sum[c_]); \
    atomicAdd(&fwd_phases[wg][N_PHASES], 1ull);                                  \
    atomicAdd(&fwd_phases[wg][N_PHASES + 1], (unsigned long long)(steps));       \
  }
#else
#define PHASES_START
#define PHASE(c)
#define PHASES_END(wg, tid, steps)
#endif

template <int HD>
__global__ void __launch_bounds__(Tiles<HD>::THREADS, Tiles<HD>::BLOCKS)
    flash_fwd_tc_kernel(const __grid_constant__ FwdParams p) {
  using C = Tiles<HD>;
  PHASES_START
  constexpr int ST = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // [SLABS][BQ][SPAN]
  uint8_t* sk = sq + C::Q_BYTES;         // [ST][SLABS][BK][SPAN]
  uint8_t* sv = sk + ST * C::KV_BYTES;   // [ST][SLABS][BK][SPAN]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sv + ST * C::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + ST;
  uint64_t* k_empty = v_full + ST;
  uint64_t* v_empty = k_empty + ST;

  const int bh = p.H * p.B;
  const int q0 = (p.n_qt - 1 - (int)(blockIdx.x / bh)) * C::BQ;  // longest causal tiles first
  const int h = (int)(blockIdx.x % bh) % p.H;
  const int b = (int)(blockIdx.x % bh) / p.H;
  const int kvh = h / p.group;

  // key tiles that intersect the mask support of this query tile
  int k_lo = 0;
  int k_hi = p.T;
  if (p.causal) k_hi = min(k_hi, q0 + C::BQ);
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  const int kt0 = k_lo / C::BK;
  const int n_kt = k_hi > k_lo ? (k_hi + C::BK - 1) / C::BK - kt0 : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, C::THREADS);  // every thread releases the slot
      mbar_init(v_empty + s, C::THREADS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // The last warpgroup's first thread issues every TMA load: Q and the
  // first ST K and V tiles here; then each release of K_i or V_i by its
  // warpgroup loads K or V tile i + ST into the slot it frees, once any
  // other warpgroup has released it too.
  const bool issuer = threadIdx.x == C::THREADS - 128;
  auto load = [&](int j, const CUtensorMap* map, uint8_t* ring, uint64_t* full,
                  uint64_t* empty) {
    const int s = j % ST;
    mbar_wait(empty + s, ((j / ST) & 1) ^ 1);
    mbar_expect_tx(full + s, C::KV_BYTES);
    for (int slab = 0; slab < C::SLABS; ++slab)
      tma_load_4d(ring + s * C::KV_BYTES + slab * C::BK * C::ROWB, map, full + s,
                  slab * C::SPAN, (kt0 + j) * C::BK, kvh, b);
  };
  auto refill_k = [&](int i) {  // after K_i's release
    if (issuer && i + ST < n_kt) load(i + ST, &p.tk, sk, k_full, k_empty);
    __syncwarp();
  };
  auto refill_v = [&](int i) {  // after V_i's release
    if (issuer && i + ST < n_kt) load(i + ST, &p.tv, sv, v_full, v_empty);
    __syncwarp();
  };
  if (issuer) {
    mbar_expect_tx(q_full, C::Q_BYTES);
    for (int j = 0; j < C::SLABS; ++j)
      tma_load_4d(sq + j * C::BQ * C::ROWB, &p.tq, q_full, j * C::SPAN, q0, h, b);
    for (int j = 0; j < ST && j < n_kt; ++j) {
      load(j, &p.tk, sk, k_full, k_empty);
      load(j, &p.tv, sv, v_full, v_empty);
    }
  }
  __syncwarp();

  // each warpgroup owns 64 query rows
  const int wg = C::WGS == 1 ? 0 : warpgroup_idx();
  const int tid = threadIdx.x % 128;
  const int qa = q0 + 64 * wg;                             // first row of this warpgroup
  const int row0 = qa + 16 * (tid / 32) + (tid % 32) / 4;  // this thread's rows: row0, row0 + 8
  const int col = 2 * (tid % 4);                           // its first column of each 8
  const uint64_t q_desc = make_desc(sq + 64 * wg * C::ROWB, 0, 8 * C::ROWB, C::ROWB);
  const uint64_t k_desc = make_desc(sk, 0, 8 * C::ROWB, C::ROWB);
  const uint64_t v_desc = make_desc(sv, C::BK * C::ROWB, 8 * C::ROWB, C::ROWB);

  // this warpgroup's key tiles [a, e): the causal mask ends them early for
  // warpgroup 0, the window starts them late for warpgroup 1
  auto unseen = [&](int j) {
    const int k0 = (kt0 + j) * C::BK;
    return (p.causal && k0 > qa + 63) || (p.window > 0 && k0 + C::BK - 1 <= qa - p.window);
  };
  auto edge = [&](int j) {  // some element of the tile is masked for these rows
    const int k0 = (kt0 + j) * C::BK;
    return k0 + C::BK > p.T || (p.causal && k0 + C::BK - 1 > qa) ||
           (p.window > 0 && k0 <= qa + 63 - p.window);
  };
  int a = 0, e = n_kt;
  while (a < e && unseen(a)) ++a;
  while (e > a && unseen(e - 1)) --e;
  // a tile outside [a, e): released once it has landed, in tile order
  auto pass = [&](int j) {
    const int s = j % ST;
    const uint32_t ph = (j / ST) & 1;
    mbar_wait(k_full + s, ph);
    mbar_arrive(k_empty + s);
    refill_k(j);
    mbar_wait(v_full + s, ph);
    mbar_arrive(v_empty + s);
    refill_v(j);
  };

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float sc[C::BK / 2];
  uint32_t pa[C::BK / 16][4];
  float m[2] = {-INFINITY, -INFINITY};  // running max of the base-2 scores
  float l[2] = {0.f, 0.f};              // this lane's share of the running denominator
  float alpha[2];

  PHASE(PROLOGUE)
  mbar_wait(q_full, 0);
  for (int i = 0; i < a; ++i) pass(i);
  PHASE(Q_WAIT)
  if (a < e) {
    {  // step a: the first score product alone
      const int s = a % ST;
      mbar_wait(k_full + s, (a / ST) & 1);
      wgmma_fence();
      score_product<HD>(sc, q_desc, desc_at(k_desc, s * C::KV_BYTES));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(k_empty + s);
      refill_k(a);
      online_softmax<C::BK>(sc, m, l, alpha, edge(a), (kt0 + a) * C::BK, row0, col, p);
      rescale_and_pack<HD, C::BK>(o, alpha, sc, pa);
      PHASE(FIRST_STEP)
    }
    for (int i = a + 1; i < e; ++i) {
      // step i: S_i and P_{i-1} V_{i-1} issued together; the softmax of S_i
      // runs while P_{i-1} V_{i-1} is still on the tensor cores
      const int s = i % ST, sp = (i - 1) % ST;
      mbar_wait(k_full + s, (i / ST) & 1);
      mbar_wait(v_full + sp, ((i - 1) / ST) & 1);
      PHASE(DATA_WAIT)
      wgmma_fence();
      score_product<HD>(sc, q_desc, desc_at(k_desc, s * C::KV_BYTES));
      wgmma_commit();
      PHASE(ISSUE_S)
      value_product<HD>(o, pa, desc_at(v_desc, sp * C::KV_BYTES));
      wgmma_commit();
      PHASE(ISSUE_PV)
      wgmma_wait<1>();
      fence_regs(sc);
      PHASE(S_WAIT)
      mbar_arrive(k_empty + s);
      refill_k(i);
      online_softmax<C::BK>(sc, m, l, alpha, edge(i), (kt0 + i) * C::BK, row0, col, p);
      PHASE(SOFTMAX)
      wgmma_wait<0>();
      fence_regs(o);
      PHASE(PV_WAIT)
      mbar_arrive(v_empty + sp);
      refill_v(i - 1);
      rescale_and_pack<HD, C::BK>(o, alpha, sc, pa);
      PHASE(RESCALE)
    }
    {  // step e: the last P V
      const int sp = (e - 1) % ST;
      mbar_wait(v_full + sp, ((e - 1) / ST) & 1);
      wgmma_fence();
      value_product<HD>(o, pa, desc_at(v_desc, sp * C::KV_BYTES));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(v_empty + sp);
      refill_v(e - 1);
    }
  }
  for (int i = e; i < n_kt; ++i) pass(i);
  PHASE(LAST_STEP)

  // lse from the registers; O, normalised, into this warpgroup's rows of
  // the Q tile (its products are done with them) in the swizzled layout,
  // then out by TMA, which leaves rows past S unwritten
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    const int qpos = row0 + 8 * r;
    if (col == 0 && qpos < p.S)
      p.lse[((long long)b * p.H + h) * p.S + qpos] = m[r] * LN2 + logf(l[r]);
  }
  const int lr = 64 * wg + 16 * (tid / 32) + (tid % 32) / 4;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i8 = 0; i8 < HD / 8; ++i8) {
      const int slab = i8 / (C::SPAN / 8);
      const uint32_t off = slab * C::BQ * C::ROWB + (lr + 8 * r) * C::ROWB +
                           16 * (i8 % (C::SPAN / 8)) + 2 * col;
      *reinterpret_cast<uint32_t*>(sq + swizzled<C::SPAN>(off)) =
          pack_bf16(o[4 * i8 + 2 * r] * inv[r], o[4 * i8 + 2 * r + 1] * inv[r]);
    }
  fence_async_smem();
  if (wg == 0) named_sync<1, 128>();
  else named_sync<2, 128>();
  if (tid == 0) {
    for (int j = 0; j < C::SLABS; ++j)
      tma_store_4d(&p.to, sq + j * C::BQ * C::ROWB + 64 * wg * C::ROWB, j * C::SPAN, qa, h, b);
    tma_store_wait();
  }
  PHASE(EPILOGUE)
  PHASES_END(wg, tid, e > a ? e - a - 1 : 0)
}

template <int HD>
int launch(const Params& p, int B, int KV, cudaStream_t stream) {
  using C = Tiles<HD>;
  FwdParams f;
  int err = make_tile_map(&f.tq, p.q, B, p.S, p.H, HD, p.sqb, p.sqs, p.sqh, C::BQ, C::SPAN);
  if (!err) err = make_tile_map(&f.tk, p.k, B, p.T, KV, HD, p.skb, p.skt, p.skh, C::BK, C::SPAN);
  if (!err) err = make_tile_map(&f.tv, p.v, B, p.T, KV, HD, p.svb, p.svt, p.svh, C::BK, C::SPAN);
  if (!err) err = make_tile_map(&f.to, p.o, B, p.S, p.H, HD, p.sob, p.sos, p.soh, 64, C::SPAN);
  if (err) return err;
  f.lse = p.lse;
  f.S = p.S;
  f.T = p.T;
  f.H = p.H;
  f.B = B;
  f.group = p.group;
  f.n_qt = (p.S + C::BQ - 1) / C::BQ;
  f.causal = p.causal;
  f.window = p.window;
  f.scale_log2 = p.scale * 1.4426950408889634f;
  // set on every launch: the attribute holds for the current device only
  const cudaError_t e = cudaFuncSetAttribute(flash_fwd_tc_kernel<HD>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_tc_kernel<HD><<<f.n_qt * p.H * B, C::THREADS, C::SMEM, stream>>>(f);
  return (int)cudaGetLastError();
}

inline int dispatch_hd(const Params& p, int B, int KV, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<32>(p, B, KV, stream);
    case 64: return launch<64>(p, B, KV, stream);
    case 128: return launch<128>(p, B, KV, stream);
    case 256: return launch<256>(p, B, KV, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor-core kernel,
// or the CUDA-core one at hd 16).  Strides are in elements; the head_dim axis
// of q, k, v and out must be contiguous, and for the tensor-core kernel the
// pointers 16-byte aligned and the strides of q, k, v multiples of 8 elements
// (TMA; the wrapper checks).  window <= 0 means none.
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
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (hopper::tensor_core_hd(hd)) return tc::dispatch_hd(p, B, KV, hd, st);
  return hd == 16 ? launch<__nv_bfloat16, 16>(p, B, st) : (int)cudaErrorInvalidValue;
}

namespace {

// registers and local (spill) bytes a thread, dynamic shared memory and
// threads a block, of the kernel instance that a launch of (dtype, hd) runs,
// and whether it is a tensor-core kernel
template <int HD>
int info(int dtype, int* out) {
  constexpr bool tc_hd = hopper::tensor_core_hd(HD);
  cudaFuncAttributes a;
  cudaError_t err;
  if (dtype == 0) err = cudaFuncGetAttributes(&a, flash_fwd_kernel<float, HD>);
  else if constexpr (tc_hd) err = cudaFuncGetAttributes(&a, tc::flash_fwd_tc_kernel<HD>);
  else err = cudaFuncGetAttributes(&a, flash_fwd_kernel<__nv_bfloat16, HD>);
  if (err != cudaSuccess) return (int)err;
  const bool tensor_cores = dtype == 1 && tc_hd;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = tensor_cores ? tc::Tiles<HD>::SMEM : (int)(smem_bytes<HD>());
  out[3] = tensor_cores ? tc::Tiles<HD>::THREADS : THREADS;
  out[4] = tensor_cores;
  return 0;
}

}  // namespace

#ifdef FLASH_FWD_PHASES
// out[2][N_PHASES + 2]: the diagnostic build's cycles by phase, blocks and
// main-loop steps, by warpgroup (reset to 0 after the read if `reset`)
extern "C" int flash_fwd_phases(unsigned long long* out, int reset) {
  static const unsigned long long zeros[2 * (tc::N_PHASES + 2)] = {};
  cudaError_t e = cudaMemcpyFromSymbol(out, tc::fwd_phases, sizeof(zeros));
  if (e == cudaSuccess && reset) e = cudaMemcpyToSymbol(tc::fwd_phases, zeros, sizeof(zeros));
  return (int)e;
}
#endif

// out[5] = registers a thread, local bytes a thread, dynamic shared memory
// bytes and threads a block of the kernel that (dtype, hd) launches, and 1
// if it is a tensor-core kernel (the wrapper then checks strides for TMA)
extern "C" int flash_fwd_info(int dtype, int hd, int* out) {
  switch (hd) {
    case 16: return info<16>(dtype, out);
    case 32: return info<32>(dtype, out);
    case 64: return info<64>(dtype, out);
    case 128: return info<128>(dtype, out);
    case 256: return info<256>(dtype, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// RG-LRU diagonal linear recurrence for sm_90a: h_t = a_t * h_{t-1} + b_t over
// (B, S, D), f32 state, y in a's dtype and the final state in f32.
//
// Replaces the Pallas TPU kernel `rglru_pallas` (`_rglru_kernel`) of
// src/repro/kernels/rglru/kernel.py.  There a (B, D/512, S/128) grid carries
// the (1, 512) f32 state in VMEM across its sequential chunk axis.
//
// What bounds it on the H100: memory.  Each element is read once from a and b
// and written once to y, with two flops per element, so at the model's shape
// (1, 2560, 4096) f32 it moves 126 MB: a bound of 37.5 us at 3.35 TB/s.  To
// come near it the card needs tens of MB of loads in flight, so the grid has
// to cover every SM at B = 1 -- which a walk over time by one thread per
// channel (4,096 threads at the model's width) cannot.
//
// Design: one pass, chunked over time and channels, with a decoupled
// look-back (Merrill and Garland's single-pass scan) carrying the state
// across chunks.  The recurrence is the composition of affine maps
// h -> a h + b, so a stretch of steps is one map (A, H) = (prod a, the
// stretch's h from a zero state), and maps compose in order.
//  * a block covers CHUNK = 128 steps x SLAB = 32 channels; its 8 warps take
//    16-step sub-chunks, a lane one channel, so each warp-wide load or store
//    is one row of 32 neighbouring channels.  At the model's shape the grid
//    is 20 chunks x 128 slabs = 2,560 blocks;
//  * a block takes a ticket from an atomic counter and works on the chunk the
//    ticket names (chunk-major), so every chunk it may wait for belongs to a
//    block that is already running: no deadlock whatever order the card
//    schedules blocks in;
//  * each thread issues all 32 of its loads (16 steps of a and b) at once
//    into registers, then folds its sub-chunk into one map; warp 0 composes
//    the 8 sub-chunk maps into the chunk's map and the map to each
//    sub-chunk's entry;
//  * each lane of warp 0 publishes its channel's map of the chunk (status
//    AGGREGATE), then looks back: it composes the maps of the chunks before
//    it until it meets one whose inclusive state is published (status
//    PREFIX) or passes chunk 0 (h0), then publishes its own inclusive state.
//    A value and its status share one 64-bit word, written and read as one
//    access, so publishing takes no fence (the tile status of CUB's
//    single-pass scan); a lane publishes A and H in two words and reads A
//    only after H says AGGREGATE.  A wait traps after 2^26 polls instead of
//    hanging the card;
//  * each warp then walks its 16 steps from the state entering its
//    sub-chunk, from the registers, and writes y; the warp that holds the
//    last step writes the final state.
// a and b are read once and y written once (126 MB at the model's shape);
// the look-back words are ~1.3 MB, cleared by a memset before the launch.
// Ragged S and D are masked: steps past S are the identity map, channels past
// D load nothing.
// The state is f32 throughout, for both dtypes.  Because maps are composed
// in another order than the step-by-step loop, y and the final state are
// not bit-equal to the plain version; they agree within the f32 tolerance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;              // sub-chunks of a block
constexpr int THREADS = 32 * WARPS;
constexpr int STEPS = 16;             // steps of a sub-chunk, held in registers
constexpr int CHUNK = WARPS * STEPS;  // steps of a block
constexpr int SLAB = 32;              // channels of a block, one a lane
constexpr unsigned EMPTY = 0, AGGREGATE = 1, PREFIX = 2;
constexpr long long MAX_POLLS = 1ll << 26;

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

// a look-back word: a float in the low half, its status in the high half
__device__ __forceinline__ void publish(unsigned long long* word, float value, unsigned status) {
  const unsigned long long w = ((unsigned long long)status << 32) | __float_as_uint(value);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(word), "l"(w) : "memory");
}

// the word once its status is not EMPTY
__device__ __forceinline__ unsigned long long poll(const unsigned long long* word) {
  unsigned long long w;
  for (long long polls = 0;; ++polls) {
    asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(w) : "l"(word) : "memory");
    if (w >> 32 != EMPTY) return w;
    if (polls > MAX_POLLS) __trap();
    __nanosleep(32);
  }
}

__device__ __forceinline__ float value(unsigned long long w) {
  return __uint_as_float((unsigned)w);
}

struct Params {
  const void* a;
  const void* b;
  const float* h0;  // (B, D) or null: zero initial state
  void* y;          // (B, S, D) contiguous
  float* h_out;     // (B, D)
  // [0]: the ticket counter; then (n_chunks, n_slabs, SLAB, 2) look-back
  // words: the chunk's A, then its H or (once PREFIX) h at its end; zeroed
  unsigned long long* words;
  int S, D, slabs_per_row, n_slabs;  // n_slabs = B * slabs_per_row
  long long sab, sas;  // a: batch and time strides (channel stride 1)
  long long sbb, sbs;  // b: the same
};

// a lane of warp 0: publish the chunk's map (ca, ch) of its channel, find
// the state entering the chunk, publish the state at its end; returns the
// entering state
__device__ float look_back(const Params& p, int chunk, int slab, int lane, float ca, float ch,
                           float h0) {
  unsigned long long* mine =
      p.words + 1 + 2 * (((long long)chunk * p.n_slabs + slab) * SLAB + lane);
  float h_in = h0;
  if (chunk > 0) {
    publish(mine, ca, AGGREGATE);
    publish(mine + 1, ch, AGGREGATE);
    // (la, lh): the map from the end of chunk j to the end of chunk - 1
    float la = 1.f, lh = 0.f;
    for (int j = chunk - 1;; --j) {
      if (j < 0) {
        h_in = fmaf(la, h0, lh);
        break;
      }
      const unsigned long long* theirs = mine - 2ll * (chunk - j) * p.n_slabs * SLAB;
      const unsigned long long hw = poll(theirs + 1);
      if (hw >> 32 == PREFIX) {
        h_in = fmaf(la, value(hw), lh);
        break;
      }
      lh = fmaf(la, value(hw), lh);
      la *= value(poll(theirs));
    }
  }
  publish(mine + 1, fmaf(ca, h_in, ch), PREFIX);
  return h_in;
}

// at most 64 registers a thread, so 4 blocks share an SM: more loads in
// flight while other blocks look back
template <typename T>
__global__ void __launch_bounds__(THREADS, 4) rglru_fwd_kernel(Params p) {
  __shared__ int s_ticket;
  __shared__ float sub_a[WARPS][SLAB], sub_h[WARPS][SLAB];

  if (threadIdx.x == 0) s_ticket = (int)atomicAdd(p.words, 1ull);
  __syncthreads();
  const int chunk = s_ticket / p.n_slabs;
  const int slab = s_ticket % p.n_slabs;
  const int bi = slab / p.slabs_per_row;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = (slab % p.slabs_per_row) * SLAB + lane;
  const bool live = d < p.D;
  const int t0 = chunk * CHUNK + warp * STEPS;

  const T* a = static_cast<const T*>(p.a) + bi * p.sab + (live ? d : 0);
  const T* b = static_cast<const T*>(p.b) + bi * p.sbb + (live ? d : 0);
  float av[STEPS], bv[STEPS];
#pragma unroll
  for (int q = 0; q < STEPS; ++q) {
    const int t = t0 + q;
    const bool in = live && t < p.S;
    av[q] = in ? to_f32(a[(long long)t * p.sas]) : 1.f;  // the identity past S
    bv[q] = in ? to_f32(b[(long long)t * p.sbs]) : 0.f;
  }

  // this sub-chunk as one map h -> A h + H
  float A = 1.f, H = 0.f;
#pragma unroll
  for (int q = 0; q < STEPS; ++q) {
    H = fmaf(av[q], H, bv[q]);
    A *= av[q];
  }
  sub_a[warp][lane] = A;
  sub_h[warp][lane] = H;
  __syncthreads();

  if (warp == 0) {
    // the maps from the chunk's entry to each sub-chunk's entry, and the chunk's map
    float ca = 1.f, ch = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wa = sub_a[w][lane], wh = sub_h[w][lane];
      sub_a[w][lane] = ca;
      sub_h[w][lane] = ch;
      ch = fmaf(wa, ch, wh);
      ca *= wa;
    }
    const float h0 = p.h0 && live ? p.h0[(long long)bi * p.D + d] : 0.f;
    const float h_in = look_back(p, chunk, slab, lane, ca, ch, h0);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sub_h[w][lane] = fmaf(sub_a[w][lane], h_in, sub_h[w][lane]);
  }
  __syncthreads();

  float h = sub_h[warp][lane];
  T* y = static_cast<T*>(p.y) + (long long)bi * p.S * p.D + d;
#pragma unroll
  for (int q = 0; q < STEPS; ++q) {
    h = fmaf(av[q], h, bv[q]);
    if (live && t0 + q < p.S) y[(long long)(t0 + q) * p.D] = from_f32<T>(h);
  }
  if (live && t0 < p.S && p.S <= t0 + STEPS) p.h_out[(long long)bi * p.D + d] = h;
}

}  // namespace

// 64-bit words of scratch the caller allocates for (B, S, D): the ticket
// counter and the look-back words (zeroed here, on the stream, before the
// launch)
extern "C" long long rglru_fwd_scratch(int B, int S, int D) {
  const long long chunks = (S + CHUNK - 1) / CHUNK;
  return 1 + 2 * chunks * B * ((D + SLAB - 1) / SLAB) * SLAB;
}

// blocks and threads a block of the launch for (B, S, D)
extern "C" int rglru_fwd_grid(int B, int S, int D, int* out) {
  out[0] = (S + CHUNK - 1) / CHUNK * B * ((D + SLAB - 1) / SLAB);
  out[1] = THREADS;
  return 0;
}

// a, b: (B, S, D) of one dtype (0 = float32, 1 = bfloat16), channel axis
// contiguous, batch/time strides in elements; h0: (B, D) f32 or null; y:
// (B, S, D) contiguous in a's dtype; h_out: (B, D) f32; scratch as sized
// above.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int rglru_fwd(const void* a, const void* b, const void* h0, void* y, void* h_out,
                         void* scratch, int dtype, int B, int S, int D,
                         long long sab, long long sas, long long sbb, long long sbs,
                         void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.a = a;
  p.b = b;
  p.h0 = static_cast<const float*>(h0);
  p.y = y;
  p.h_out = static_cast<float*>(h_out);
  const int chunks = (S + CHUNK - 1) / CHUNK;
  p.slabs_per_row = (D + SLAB - 1) / SLAB;
  p.n_slabs = B * p.slabs_per_row;
  p.words = static_cast<unsigned long long*>(scratch);
  p.S = S;
  p.D = D;
  p.sab = sab; p.sas = sas;
  p.sbb = sbb; p.sbs = sbs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(scratch, 0, 8 * rglru_fwd_scratch(B, S, D), st);
  if (err != cudaSuccess) return (int)err;
  const int blocks = chunks * p.n_slabs;
  if (dtype == 0) rglru_fwd_kernel<float><<<blocks, THREADS, 0, st>>>(p);
  else if (dtype == 1) rglru_fwd_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(p);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

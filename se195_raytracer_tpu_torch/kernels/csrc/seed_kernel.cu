// The seed init of K1/K2's lane state on Hopper, bitwise numpy.
//
// Replaces no TPU kernel: the JAX package draws a render's seeds with numpy
// on the host (se195_raytracer_tpu/core/rng.py:63-72 init_mwc_state,
// :94-107 init_counter_state) and lays them out in lane order
// (kernels/pt_kernel.py:897-906, render_pallas). This computes the same
// words on the card, straight into the lane layout, for any lane range.
//
// MWC seeds: Generator(PCG64(seed)).integers(2, 2**31 - 1, size=(2, n),
// dtype=uint32). Flat draw k (s0 of pixel p is draw p, s1 draw n + p) comes
// from the 32-bit words of PCG64's 64-bit outputs, low word first: Lemire's
// m = u * (2**31 - 3), the value (m >> 32) + 2, and a word whose low product
// word is below 6 ((2**32 - R) mod R) rejected, which moves every later draw
// one word on. Two kernels:
//   * scan: each thread jumps to its first output and steps through
//     kScanChunk of them, listing the rejected words in [0, 2n + capacity)
//     (atomicAdd; the count stays exact past the list's capacity, and the
//     host raises when it does);
//   * draw: one thread per lane. A draw k is word w, the least fixed point
//     of w = k + #(listed rejections <= w), reached by jump-ahead to output
//     w >> 1 (numpy's pcg_advance_lcg_128: square and multiply of the LCG,
//     applied straight to the state) and XSL-RR taken after the step, as
//     numpy's pcg64_random_r takes it.
// Counter keys: init_counter_state's hash of the absolute pixel id, counter
// 0. A lane holds pixel pix[l] (K2's blocked layout) or lane_offset + l
// (K1's, and a shard's range); a pixel at or past n is a pad lane, 2 in both
// words, as render_pallas pads.
//
// What bounds it on this card: the 8 bytes a lane written, 0.6 us at 512^2.
// The arithmetic is 64-bit integer products (a 128-bit LCG step is three
// of them and a __umul64hi), about 20 jump steps a draw. What the design does
// about it: the jump tables (the LCG's 2^i-step multiplier and increment)
// are built once per block in shared memory by one thread, so a draw costs
// one product per set bit of its jump, not three per bit; the scan steps
// sequentially after one jump, one product per output. In practice the
// time is the two launches and the host's one-word read of the count.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (kernels/_build.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Outputs a scan thread steps through after its jump.
constexpr int kScanChunk = 8;
// Jump table entries: a jump below 2^kMaxBits outputs.
constexpr int kMaxBits = 48;
constexpr uint64_t kMultHi = 0x2360ED051FC65DA4ULL;
constexpr uint64_t kMultLo = 0x4385DF649FCCF645ULL;
constexpr uint64_t kRange = 2147483645ULL;  // 2**31 - 3
constexpr uint32_t kRejectBelow = 6u;       // (2**32 - kRange) % kRange
constexpr uint32_t kLow = 2u;
constexpr uint32_t kPad = 2u;

struct U128 {
  uint64_t hi, lo;
};

// a * m + c mod 2^128.
__device__ __forceinline__ U128 mul_add(U128 a, U128 m, U128 c) {
  const uint64_t lo = a.lo * m.lo;
  uint64_t hi = __umul64hi(a.lo, m.lo) + a.lo * m.hi + a.hi * m.lo;
  const uint64_t sum = lo + c.lo;
  hi += c.hi + (sum < lo ? 1ULL : 0ULL);
  return U128{hi, sum};
}

__device__ __forceinline__ U128 plus_one(U128 a) {
  const uint64_t lo = a.lo + 1ULL;
  return U128{a.hi + (lo == 0ULL ? 1ULL : 0ULL), lo};
}

// Thread 0 fills the block's jump tables: mult[i], plus[i] take the state
// 2^i outputs on (state * mult[i] + plus[i]). Every thread waits for them.
__device__ void jump_tables(U128 inc, int bits, U128* mult, U128* plus) {
  if (threadIdx.x == 0) {
    U128 m{kMultHi, kMultLo};
    U128 p = inc;
    const U128 zero{0ULL, 0ULL};
    for (int i = 0; i < bits; ++i) {
      mult[i] = m;
      plus[i] = p;
      p = mul_add(plus_one(m), p, zero);
      m = mul_add(m, m, zero);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ U128 advance(U128 state, uint64_t delta, int bits,
                                        const U128* mult, const U128* plus) {
  for (int i = 0; i < bits && delta != 0ULL; ++i, delta >>= 1) {
    if (delta & 1ULL) state = mul_add(state, mult[i], plus[i]);
  }
  return state;
}

__device__ __forceinline__ uint64_t xsl_rr(U128 s) {
  const unsigned rot = unsigned(s.hi >> 58);
  const uint64_t x = s.hi ^ s.lo;
  return (x >> rot) | (x << ((64u - rot) & 63u));
}

__device__ __forceinline__ uint32_t word_of(uint64_t out, uint64_t w) {
  return (w & 1ULL) ? uint32_t(out >> 32) : uint32_t(out);
}

__device__ __forceinline__ bool rejected(uint32_t u) {
  return uint32_t(uint64_t(u) * kRange) < kRejectBelow;
}

// Pass 1: the rejected words in [0, limit) of the stream; outputs j in
// [0, (limit + 1) / 2), kScanChunk a thread.
__global__ void __launch_bounds__(kThreads)
scan_kernel(U128 state, U128 inc, uint64_t limit, int bits,
            unsigned int* count, long long* listed, int capacity) {
  __shared__ U128 mult[kMaxBits];
  __shared__ U128 plus[kMaxBits];
  jump_tables(inc, bits, mult, plus);
  const uint64_t outputs = (limit + 1ULL) / 2ULL;
  const uint64_t j0 =
      (uint64_t(blockIdx.x) * kThreads + threadIdx.x) * uint64_t(kScanChunk);
  if (j0 >= outputs) return;
  U128 s = advance(state, j0, bits, mult, plus);
  const U128 step{kMultHi, kMultLo};
  for (int i = 0; i < kScanChunk; ++i) {
    const uint64_t j = j0 + uint64_t(i);
    if (j >= outputs) break;
    s = mul_add(s, step, inc);
    const uint64_t out = xsl_rr(s);
    for (uint64_t half = 0; half < 2ULL; ++half) {
      const uint64_t w = 2ULL * j + half;
      if (w < limit && rejected(word_of(out, w))) {
        const unsigned int slot = atomicAdd(count, 1u);
        if (slot < unsigned(capacity)) listed[slot] = (long long)w;
      }
    }
  }
}

__device__ __forceinline__ uint32_t draw(U128 state, uint64_t k, int bits,
                                         const U128* mult, const U128* plus,
                                         const long long* listed, int n_listed) {
  // The least fixed point of w = k + #(listed <= w), reached from below.
  uint64_t w = k;
  for (;;) {
    uint64_t c = 0;
    for (int i = 0; i < n_listed; ++i) c += uint64_t(listed[i]) <= w ? 1ULL : 0ULL;
    if (k + c == w) break;
    w = k + c;
  }
  const U128 s = advance(state, (w >> 1) + 1ULL, bits, mult, plus);
  const uint64_t m = uint64_t(word_of(xsl_rr(s), w)) * kRange;
  return uint32_t(m >> 32) + kLow;
}

__device__ __forceinline__ long long lane_pixel(const int* pix, long long lane_offset,
                                                long long l) {
  return pix != nullptr ? (long long)pix[l] : lane_offset + l;
}

// Pass 2: s0 = draw p, s1 = draw n + p of lane l's pixel p.
__global__ void __launch_bounds__(kThreads)
mwc_lanes_kernel(U128 state, U128 inc, long long n, int bits, const int* pix,
                 long long lane_offset, long long lanes, const unsigned int* count,
                 const long long* listed, int capacity, uint32_t* s0, uint32_t* s1) {
  __shared__ U128 mult[kMaxBits];
  __shared__ U128 plus[kMaxBits];
  jump_tables(inc, bits, mult, plus);
  const long long l = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (l >= lanes) return;
  const long long p = lane_pixel(pix, lane_offset, l);
  if (p < 0 || p >= n) {
    s0[l] = kPad;
    s1[l] = kPad;
    return;
  }
  const int n_listed = int(min(*count, unsigned(capacity)));
  s0[l] = draw(state, uint64_t(p), bits, mult, plus, listed, n_listed);
  s1[l] = draw(state, uint64_t(n + p), bits, mult, plus, listed, n_listed);
}

__global__ void __launch_bounds__(kThreads)
counter_lanes_kernel(uint32_t seed_word, long long n, const int* pix,
                     long long lane_offset, long long lanes, uint32_t* key,
                     uint32_t* ctr) {
  const long long l = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (l >= lanes) return;
  const long long p = lane_pixel(pix, lane_offset, l);
  if (p < 0 || p >= n) {
    key[l] = kPad;
    ctr[l] = kPad;
    return;
  }
  uint32_t k = uint32_t(p) * 0x9E3779B1u ^ seed_word;
  k ^= k >> 16;
  k *= 0x7FEB352Du;
  k ^= k >> 15;
  key[l] = k;
  ctr[l] = 0u;
}

unsigned int blocks_for(uint64_t threads) {
  return unsigned((threads + kThreads - 1) / kThreads);
}

}  // namespace

// MWC seeds of lanes [0, lanes): state/inc: PCG64's 128-bit state and
// increment after its seeding (numpy's PCG64(seed).state); n: the frame's
// pixels; bits: the jump tables' length, enough for output (2n + capacity)
// / 2 + 1; pix: [lanes] int32 pixel ids or null (then lane_offset + l);
// count: [1] scratch, listed: [capacity] int64 scratch, which hold the
// scan's rejection count and list after the call. Returns the launch error.
extern "C" int seed_mwc_lanes_cuda(
    uint64_t state_hi, uint64_t state_lo, uint64_t inc_hi, uint64_t inc_lo,
    long long n, int bits, const int* pix, long long lane_offset, long long lanes,
    unsigned int* count, long long* listed, int capacity, uint32_t* s0, uint32_t* s1,
    void* stream) {
  if (bits < 1 || bits > kMaxBits || n < 0 || lanes < 0 || capacity < 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const U128 state{state_hi, state_lo};
  const U128 inc{inc_hi, inc_lo};
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(unsigned int), st);
  if (err != cudaSuccess) return int(err);
  const uint64_t limit = 2ULL * uint64_t(n) + uint64_t(capacity);
  const uint64_t scan_threads =
      ((limit + 1ULL) / 2ULL + kScanChunk - 1) / uint64_t(kScanChunk);
  if (scan_threads > 0) {
    scan_kernel<<<blocks_for(scan_threads), kThreads, 0, st>>>(
        state, inc, limit, bits, count, listed, capacity);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  if (lanes > 0) {
    mwc_lanes_kernel<<<blocks_for(uint64_t(lanes)), kThreads, 0, st>>>(
        state, inc, n, bits, pix, lane_offset, lanes, count, listed, capacity, s0, s1);
  }
  return int(cudaGetLastError());
}

// Counter keys of lanes [0, lanes): seed_word = (seed * 0x85EBCA6B +
// 0x165667B1) mod 2^32; pix and lane_offset as above.
extern "C" int seed_counter_lanes_cuda(uint32_t seed_word, long long n, const int* pix,
                                       long long lane_offset, long long lanes,
                                       uint32_t* key, uint32_t* ctr, void* stream) {
  if (n < 0 || lanes < 0) return int(cudaErrorInvalidValue);
  if (lanes > 0) {
    counter_lanes_kernel<<<blocks_for(uint64_t(lanes)), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        seed_word, n, pix, lane_offset, lanes, key, ctr);
  }
  return int(cudaGetLastError());
}

// The seed init of K1/K2's lane state on Hopper, bitwise numpy.
//
// Replaces no TPU kernel: the JAX package draws a render's seeds with numpy
// on the host (se195_raytracer_tpu/core/rng.py:63-72 init_mwc_state,
// :94-107 init_counter_state) and lays them out in lane order
// (kernels/pt_kernel.py:897-906, render_pallas). This computes the same
// words on the card, straight into the lane layout, for any lane range.
//
// MWC seeds: Generator(PCG64(seed)).integers(2, 2**31 - 1, size=(2, n),
// dtype=uint32). Flat draw d (s0 of pixel p is draw p, s1 draw n + p) comes
// from the 32-bit words of PCG64's 64-bit outputs, low word first: Lemire's
// m = u * (2**31 - 3), the value (m >> 32) + 2, and a word whose low product
// word is below 6 ((2**32 - R) mod R) rejected, which moves every later draw
// one word on. So accepted word w is draw d = w - R(w), R(w) the rejected
// words before w. One pass, mwc_pass_kernel, finds every draw in
// [0, draws):
//   * a thread owns a run of kRun consecutive outputs (2 kRun words). It
//     jumps once to the run's start (numpy's pcg_advance_lcg_128: the
//     2^i-step multipliers and increments come from the host as a kernel
//     parameter, so nobody builds them on the card) and then steps one
//     128-bit multiply-add per output;
//   * it counts its rejected words; a block scan of the counts (warp
//     shuffles) and a decoupled look-back across blocks (each block
//     publishes its count, then its inclusive count, in a status word tagged
//     with the launch's epoch, so the buffer needs no reset) give R before
//     each word;
//   * the block's accepted words are staged in shared memory at their draw
//     index and written out in draw order: into the lane range (K1's
//     layout), or into a flat [draws] scratch that a gather puts in pix
//     order (K2's layout; it measured faster than writing the lanes through
//     K2's inverse table in the pass);
//   * the pass covers words [0, draws + slack). If more than slack of them
//     are rejected, the block that holds the end of the stream steps on, on
//     the device, until every draw is found. So every seed is exact, nothing
//     overflows and the host reads nothing back.
// Counter keys: init_counter_state's hash of the absolute pixel id, counter
// 0. A lane holds pixel pix[l] (K2's blocked layout) or lane_offset + l
// (K1's, and a shard's range); a pixel at or past n is a pad lane, 2 in both
// words, as render_pallas pads.
//
// What bounds it on this card: the 8 bytes a lane written, 0.6 us at 512^2.
// The arithmetic is 64-bit integer products (a 128-bit LCG step is three
// of them and a __umul64hi): one jump of about 18 bits (9 steps on
// average) and kRun steps a run of 2 kRun words, where a jump a draw would
// cost about 10 steps a word. What is left is the launch and one wave's
// latency of a jump, a run and the look-back.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (kernels/_build.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Outputs a thread steps through after its jump (seed_kernel.RUN).
constexpr int kRun = 8;
constexpr int kRunWords = 2 * kRun;
constexpr int kBlockWords = kThreads * kRunWords;  // seed_kernel.BLOCK_WORDS
// Jump table entries: a jump below 2^kMaxBits outputs.
constexpr int kMaxBits = 48;
constexpr uint64_t kMultHi = 0x2360ED051FC65DA4ULL;
constexpr uint64_t kMultLo = 0x4385DF649FCCF645ULL;
constexpr uint64_t kRange = 2147483645ULL;  // 2**31 - 3
constexpr uint32_t kRejectBelow = 6u;       // (2**32 - kRange) % kRange
constexpr uint32_t kLow = 2u;
constexpr uint32_t kPad = 2u;
// A block's status word: the launch's epoch in bits 34-63, the flag in bits
// 32-33, the count in bits 0-31.
constexpr int kEpochShift = 34;
constexpr unsigned long long kFlagMask = 3ULL << 32;
constexpr unsigned long long kAggregate = 1ULL << 32;  // the block's own count
constexpr unsigned long long kInclusive = 2ULL << 32;  // the count up to its end

struct U128 {
  uint64_t hi, lo;
};

// mult[i], plus[i] take the state 2^i outputs on: state * mult[i] + plus[i].
struct JumpTables {
  U128 mult[kMaxBits];
  U128 plus[kMaxBits];
};

// Where the draws go: the lane range (K1's layout: lane l holds pixel
// lane_offset + l), or a flat [draws] scratch for the gather (flat != null).
struct Out {
  long long n, lane_offset, lanes;
  uint32_t* flat;
  uint32_t *s0, *s1;
};

// a * m + c mod 2^128.
__device__ __forceinline__ U128 mul_add(U128 a, U128 m, U128 c) {
  const uint64_t lo = a.lo * m.lo;
  uint64_t hi = __umul64hi(a.lo, m.lo) + a.lo * m.hi + a.hi * m.lo;
  const uint64_t sum = lo + c.lo;
  hi += c.hi + (sum < lo ? 1ULL : 0ULL);
  return U128{hi, sum};
}

__device__ __forceinline__ U128 step(U128 s, U128 inc) {
  return mul_add(s, U128{kMultHi, kMultLo}, inc);
}

// The state delta outputs on.
__device__ __forceinline__ U128 jump(const JumpTables& t, U128 s, uint64_t delta) {
#pragma unroll
  for (int i = 0; i < kMaxBits; ++i) {
    if ((delta >> i) == 0ULL) break;
    if ((delta >> i) & 1ULL) s = mul_add(s, t.mult[i], t.plus[i]);
  }
  return s;
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

__device__ __forceinline__ uint32_t value_of(uint32_t u) {
  return uint32_t((uint64_t(u) * kRange) >> 32) + kLow;
}

// Draw d goes to its place: s0 of pixel d, or s1 of pixel d - n.
__device__ __forceinline__ void emit(const Out& o, uint64_t d, uint32_t v) {
  if (o.flat != nullptr) {
    o.flat[d] = v;
    return;
  }
  const bool first = (long long)d < o.n;
  const long long l = (first ? (long long)d : (long long)d - o.n) - o.lane_offset;
  if (l >= 0 && l < o.lanes) (first ? o.s0 : o.s1)[l] = v;
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// Warp 0 of block b: publishes the block's count, finds the rejections
// before the block by looking back over its predecessors' status words (32
// at a time, each lane one; it stops at the nearest inclusive count), and
// publishes the inclusive count. Every lane of warp 0 returns the prefix.
__device__ unsigned long long look_back(unsigned long long* status, unsigned b,
                                        unsigned long long total,
                                        unsigned long long epoch) {
  const int lane = threadIdx.x & 31;
  const unsigned long long tag = epoch << kEpochShift;
  if (lane == 0) atomicExch(status + b, tag | (b == 0 ? kInclusive : kAggregate) | total);
  unsigned long long prefix = 0;
  for (long long end = b; end > 0; end -= 32) {
    const long long j = end - 32 + lane;
    unsigned long long st = tag | kInclusive;  // before block 0: nothing
    if (j >= 0) {
      do {
        st = load_status(status + j);
      } while ((st >> kEpochShift) != epoch || (st & kFlagMask) == 0ULL);
    }
    const unsigned inclusive = __ballot_sync(0xFFFFFFFFu, (st & kFlagMask) == kInclusive);
    // The nearest inclusive count and every count after it.
    const int from = inclusive ? 31 - __clz(inclusive) : 0;
    unsigned long long v = lane >= from ? (st & 0xFFFFFFFFULL) : 0ULL;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
    prefix += v;
    if (inclusive) break;
  }
  if (lane == 0 && b > 0) atomicExch(status + b, tag | kInclusive | (prefix + total));
  return prefix;
}

// The pad lanes of K1's layout (a pixel outside [0, n): 2 in both words),
// thread t of `stride` taking every stride-th; the gather pads K2's.
__device__ __forceinline__ void pad_lanes(const Out& o, uint64_t t, uint64_t stride) {
  if (o.flat != nullptr) return;
  const long long a = o.lane_offset < 0 ? (-o.lane_offset < o.lanes ? -o.lane_offset : o.lanes)
                                        : 0LL;
  const long long end = o.n - o.lane_offset;
  const long long b = end < a ? a : end > o.lanes ? o.lanes : end;
  const uint64_t pads = uint64_t(a + o.lanes - b);
  for (uint64_t i = t; i < pads; i += stride) {
    const long long l = (long long)i < a ? (long long)i : b + ((long long)i - a);
    o.s0[l] = kPad;
    o.s1[l] = kPad;
  }
}

// The one pass: words [0, words) of the stream, draws [0, draws) written.
__global__ void __launch_bounds__(kThreads)
mwc_pass_kernel(const __grid_constant__ JumpTables tab, U128 state, U128 inc,
                unsigned long long words, unsigned long long draws,
                unsigned long long* status, unsigned long long epoch, Out o) {
  __shared__ uint32_t staged[kBlockWords];
  __shared__ uint32_t warp_counts[kWarps];
  __shared__ unsigned long long block_prefix;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint64_t block_first = uint64_t(blockIdx.x) * kBlockWords;
  const uint64_t first = block_first + uint64_t(threadIdx.x) * kRunWords;
  uint64_t out[kRun];
  uint32_t rej = 0u;  // bit k: word first + k is rejected
  if (first < words) {
    U128 s = jump(tab, state, first / 2ULL);
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      s = step(s, inc);
      out[k] = xsl_rr(s);
    }
#pragma unroll
    for (int k = 0; k < kRunWords; ++k)
      if (first + k < words && rejected(word_of(out[k / 2], k))) rej |= 1u << k;
  }
  // The block's exclusive scan of the runs' counts.
  const uint32_t count = __popc(rej);
  uint32_t incl = count;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t v = __shfl_up_sync(0xFFFFFFFFu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_counts[warp] = incl;
  __syncthreads();
  uint32_t before = 0u, total = 0u;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    const uint32_t v = warp_counts[k];
    before += k < warp ? v : 0u;
    total += v;
  }
  const uint32_t excl = before + incl - count;
  if (warp == 0) {
    const unsigned long long prefix = look_back(status, blockIdx.x, total, epoch);
    if (lane == 0) block_prefix = prefix;
  }
  // Each accepted word at its draw's place in the block's range.
  if (first < words) {
#pragma unroll
    for (int k = 0; k < kRunWords; ++k) {
      if (first + k < words && !((rej >> k) & 1u)) {
        const uint32_t at = uint32_t(first - block_first) + k - excl -
                            __popc(rej & ((1u << k) - 1u));
        staged[at] = value_of(word_of(out[k / 2], k));
      }
    }
  }
  __syncthreads();
  const unsigned long long prefix = block_prefix;
  const uint64_t in_block =
      words - block_first < uint64_t(kBlockWords) ? words - block_first : uint64_t(kBlockWords);
  const uint64_t d0 = block_first - prefix;
  for (uint64_t i = threadIdx.x; i < in_block - total; i += kThreads) {
    if (d0 + i < draws) emit(o, d0 + i, staged[i]);
  }
  // The tail: more than the slack rejected, so the end of the pass holds
  // fewer than draws accepted words. Step on from word `words`.
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    uint64_t d = words - (prefix + total);
    uint64_t w = words;
    U128 s = jump(tab, state, w / 2ULL);
    uint64_t cur = 0ULL;
    if (d < draws && (w & 1ULL)) {
      s = step(s, inc);
      cur = xsl_rr(s);
    }
    for (; d < draws; ++w) {
      if (!(w & 1ULL)) {
        s = step(s, inc);
        cur = xsl_rr(s);
      }
      const uint32_t u = word_of(cur, w);
      if (!rejected(u)) emit(o, d++, value_of(u));
    }
  }
  pad_lanes(o, uint64_t(blockIdx.x) * kThreads + threadIdx.x, uint64_t(gridDim.x) * kThreads);
}

// K2's layout from the flat draws: lane l gets draws pix[l] and n + pix[l],
// or the pad.
__global__ void __launch_bounds__(kThreads)
gather_lanes_kernel(const uint32_t* __restrict__ flat, long long n, const int* __restrict__ pix,
                    long long lanes, uint32_t* s0, uint32_t* s1) {
  const long long l = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (l >= lanes) return;
  const long long p = pix[l];
  const bool real = p >= 0 && p < n;
  s0[l] = real ? flat[p] : kPad;
  s1[l] = real ? flat[n + p] : kPad;
}

// The pad lanes alone, when no lane needs a draw.
__global__ void __launch_bounds__(kThreads) pad_kernel(Out o) {
  pad_lanes(o, uint64_t(blockIdx.x) * kThreads + threadIdx.x, uint64_t(gridDim.x) * kThreads);
}

__global__ void __launch_bounds__(kThreads)
counter_lanes_kernel(uint32_t seed_word, long long n, const int* pix,
                     long long lane_offset, long long lanes, uint32_t* key,
                     uint32_t* ctr) {
  const long long l = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (l >= lanes) return;
  const long long p = pix != nullptr ? (long long)pix[l] : lane_offset + l;
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

unsigned int blocks_for(uint64_t items, uint64_t per_block) {
  return unsigned((items + per_block - 1) / per_block);
}

}  // namespace

// MWC seeds of lanes [0, lanes), in one pass and at most one more launch
// (the pad lanes of K1's layout, or K2's gather). tables: [kMaxBits][4]
// uint64 (mult hi, lo, plus hi, lo of the 2^i-step jump); state/inc:
// PCG64's 128-bit state and increment after its seeding (numpy's
// PCG64(seed).state); n: the frame's pixels; draws: the prefix of the flat
// draws the lanes need (at most 2n); slack: words past draws that the pass
// scans (the rest, if any, is the tail's); pix: [lanes] int32 pixel ids or
// null (then lane_offset + l); flat: [draws] uint32 scratch when pix is
// given; status: [status_len] the look-back's status words, written only
// by this entry; epoch: in [1, 2^30), never used before with this status
// buffer. Returns the launch error.
extern "C" int seed_mwc_lanes_cuda(
    const uint64_t* tables, uint64_t state_hi, uint64_t state_lo, uint64_t inc_hi,
    uint64_t inc_lo, long long n, long long draws, long long slack, const int* pix,
    long long lane_offset, long long lanes, uint32_t* flat,
    unsigned long long* status, long long status_len, unsigned long long epoch, uint32_t* s0,
    uint32_t* s1, void* stream) {
  const unsigned long long words = (unsigned long long)draws + (unsigned long long)slack;
  if (n < 0 || lanes < 0 || slack < 0 || draws < 0 || draws > 2 * n ||
      words >= (1ULL << 32) || epoch == 0 || epoch >= (1ULL << 30) ||
      (pix == nullptr && flat != nullptr) || (pix != nullptr && draws > 0 && flat == nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  JumpTables tab;
  for (int i = 0; i < kMaxBits; ++i) {
    tab.mult[i] = U128{tables[4 * i], tables[4 * i + 1]};
    tab.plus[i] = U128{tables[4 * i + 2], tables[4 * i + 3]};
  }
  const Out o{n, lane_offset, lanes, flat, s0, s1};
  const unsigned lane_blocks = blocks_for(uint64_t(lanes), kThreads);
  if (draws > 0) {
    const unsigned blocks = blocks_for(words, kBlockWords);
    if ((long long)blocks > status_len) return int(cudaErrorInvalidValue);
    mwc_pass_kernel<<<blocks, kThreads, 0, st>>>(tab, U128{state_hi, state_lo},
                                                 U128{inc_hi, inc_lo}, words,
                                                 (unsigned long long)draws, status, epoch, o);
  } else if (lanes > 0 && pix == nullptr) {
    pad_kernel<<<lane_blocks, kThreads, 0, st>>>(o);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  if (lanes > 0 && pix != nullptr)
    gather_lanes_kernel<<<lane_blocks, kThreads, 0, st>>>(flat, n, pix, lanes, s0, s1);
  return int(cudaGetLastError());
}

// Counter keys of lanes [0, lanes): seed_word = (seed * 0x85EBCA6B +
// 0x165667B1) mod 2^32; pix and lane_offset as above.
extern "C" int seed_counter_lanes_cuda(uint32_t seed_word, long long n, const int* pix,
                                       long long lane_offset, long long lanes,
                                       uint32_t* key, uint32_t* ctr, void* stream) {
  if (n < 0 || lanes < 0) return int(cudaErrorInvalidValue);
  if (lanes > 0) {
    counter_lanes_kernel<<<blocks_for(uint64_t(lanes), kThreads), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        seed_word, n, pix, lane_offset, lanes, key, ctr);
  }
  return int(cudaGetLastError());
}

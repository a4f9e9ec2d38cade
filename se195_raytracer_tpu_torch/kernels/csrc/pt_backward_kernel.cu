// K1b on Hopper: the vector-Jacobian product of the hard-estimator smallpt
// render for small scenes (at most 96 spheres), the backward of K1.
//
// The JAX package has no Pallas backward: it pairs K1's forward
// (se195_raytracer_tpu/kernels/pt_kernel.py _make_kernel(loop_scene=False),
// pallas_call at :736) with jax.vjp of its jnp path
// (se195_raytracer_tpu/driver/optimize.py _render_jnp_diff), one XLA program
// that the compiler fuses. This kernel takes that program's place: it
// computes the gradient of sum(grad_out * _render_plain_diff(...)) with
// respect to the spheres' centre, radius, emission and colour and the camera
// basis (orig, dir, x, y), as autograd of the port's plain path computes it.
//
// One thread per lane (a pixel sample), and per pass:
//   1. the replay: the camera ray and up to max_depth bounces, exactly as
//      models/smallpt.py computes them on the card: every product and sum
//      rounded on its own (the Rn policy's __fmul_rn / __fadd_rn /
//      __fsub_rn, which the compiler never contracts into FMAs), dot
//      products left to right, IEEE sqrt and division where the plain path
//      takes them, torch.linalg.cross's a1 * b2 - a2 * b1 as torch's kernel
//      rounds it (one FMA over the rounded second product), and the running
//      mean's division by a scalar as torch's card kernel does it, a product
//      with the float reciprocal. Its primal is the plain path's bit for bit,
//      so it takes the branch on every lane that the recompute it replaces
//      took. Each bounce keeps a record (Rec, 16 words): ray, throughput, hit
//      distance, the RNG state at its start, a flag word (sphere id, kind,
//      and whether the ray arrived by a specular bounce) and each light
//      sample's pass/fail;
//   2. the reverse sweep: from the last bounce back to the camera, the
//      adjoints of the throughput, origin and direction are carried back and
//      each bounce's local values are recomputed from its record (the draws
//      replayed from its RNG state) with the replay's own rounding, so they
//      are the replay's bit for bit, and so is every branch taken from them
//      (the orientation sign, the root, det > 0, into, the cosine frame's
//      axis, the clamps). The adjoint arithmetic itself contracts into FMAs:
//      only the gradient's accuracy is asked of it. (A recompute free to
//      contract moved K1b's worst row from 3.7e-5 to 2.0e-4 of its scale at
//      Cornell 512^2, DL: R usp + C - hp cancels for a sample near the hit
//      point, where the plain path's rounding sets the answer; it saved no
//      time.) Step functions get no gradient,
//      as under autograd: hit or miss, the nearest hit's choice, occlusion,
//      the light sample's half and wi > 0, total internal reflection, the
//      roulette pick and the orientation signs. The guards of the plain path
//      keep their derivatives: a zero one at sqrt(0) (the double where) and
//      at a clamp's floor, where torch's clamp passes none below it;
//   3. the pass's radiance cotangent is grad_out times the running mean's
//      weight of that pass (running_mean_weights, the host's).
// A sqrt's derivative is taken in float32 as g / (2 sqrt(x)); the plain
// path takes it in float64 and rounds (core/types.sqrt_rn).
//
// What bounds it on this card: FP32 operations. The replay repeats K1's pass
// (~15 ops a sphere of a nearest sweep, ~12 of a shadow sweep) and must not
// contract, so it runs at half the FMA rate (33.5 T op/s); the reverse sweep
// adds ~150 ops a bounce and ~90 a lit light sample, free to run at the FMA
// rate (67 TFLOP/s). Device memory carries only the lanes' seeds and
// cotangent. What the design does about it:
//   - rounding: only the primal is held to the plain path's rounding (Rn);
//     the file is built without -fmad=false, so the adjoint contracts;
//   - accumulation: the warp walks its lanes' bounces in lockstep, from its
//     deepest record down (a lane past its own records adds zeros). The hit
//     sphere's row (centre, radius, colour: 7 values a bounce) goes one of
//     two routes, chosen at launch from the scene's shape (lane_columns):
//       * per-lane columns: each thread owns a column of 7 n floats in
//         shared memory ([7 n][kThreads], the thread index fastest, so the
//         lanes of a warp never meet on a bank whatever spheres they hit)
//         and adds its row into it with plain adds: no ballot, no shuffle,
//         no wait on the other lanes (lane_add). After the last pass the
//         block folds the 128 columns in a fixed order (fold_columns). It
//         is taken wherever a block with the columns still fits kMinBlocks
//         to an SM: on sm_90, n <= 14 (the zoo's K1 scenes: 3 to 9 spheres);
//       * warp rounds, for larger scenes: the lanes are grouped by sphere
//         id, each group's 8 row slots summed by a fixed reduce-scatter of
//         9 shuffles (warp_sum8), and one lane per slot adds its sum into
//         the warp's table with a plain add (warp_add): groups hold
//         distinct ids and slots distinct entries, so no two writes meet. A
//         round costs its ballot and shuffle chain whatever its lanes, and
//         Cornell's warps see ~6 distinct hit spheres a step.
//     The light samples' rows (one id per light, so one round each) and the
//     rare emission row keep warp_add on both routes. No atomics: the
//     gradient is the same bit for bit from run to run;
//   - occupancy: 128-thread blocks, at least 4 an SM (16 warps, at most 128
//     registers), the record shrunk to the words the reverse sweep cannot
//     recompute cheaply; the per-lane columns (32,256 B a block at n = 9)
//     are what sizes a block's shared memory, and the route keeps the 4
//     blocks an SM;
//   - the scene sits in shared memory as in K1 (a float4 per sphere for the
//     sweeps), the nearest hit and the shadow tests' outcomes are recorded
//     rather than swept again.
// The block sums its warps' tables in warp order (the folded columns added
// into warp 0's first) into its row of a partials table, and a second
// kernel sums the rows in a fixed order. Blocks are aligned to absolute
// pixel ids (block b of a launch over rows lo..hi-1 holds pixels
// (lo & ~127) + 128 b ...), so a shard's blocks hold the same lanes as the
// whole frame's.
//
// Gradient layout (pt_backward_kernel.py pack_grad): center [n, 3], radius
// [n], emission [n, 3], color [n, 3], then the basis orig, dir, x, y (12).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC. Never --use_fast_math (it would change the replay).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;  // 16 warps an SM: at most 128 registers a thread
constexpr int kReduceThreads = 256;
constexpr int kRows = 12;          // cx cy cz rad ex ey ez cr cg cb refl emissive
constexpr int kMaxDepth = 16;      // MAX_DEPTH: bounces a record holds
constexpr int kMaxLightWords = 3;  // 96 lights at most: one bit each
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr float kEps = 0.01f;      // geomfunc.h:29 EPSILON
constexpr float kInf = 1e20f;      // geomfunc.h:80
constexpr float kTwoPi = 6.2831855f;
constexpr float kFourPi = 12.566371f;
constexpr float kNormFloor = 1e-38f;  // the clamp under a normal's and tdir's root
constexpr float kLenFloor = 1e-20f;   // the clamp of a light sample's length

enum { kMwc = 0, kCounter = 1 };
enum Kind : uint32_t { kLight = 0, kDiff = 1, kSpec = 2, kTir = 3, kRefl = 4, kTrans = 5 };

// A record's flag word: the sphere id, the kind, the specular flag of the
// incoming ray.
constexpr uint32_t kHidMask = 0x7Fu;   // bits 0-6: the hit sphere (n <= 96)
constexpr int kKindShift = 8;          // bits 8-10: Kind
constexpr uint32_t kSpecIn = 1u << 11;    // the ray arrived by a specular bounce

template <int RNG>
__device__ __forceinline__ float draw(uint32_t& s0, uint32_t& s1) {
  if (RNG == kMwc) {
    s0 = 36969u * (s0 & 0xFFFFu) + (s0 >> 16);
    s1 = 18000u * (s1 & 0xFFFFu) + (s1 >> 16);
    const uint32_t ires = (s0 << 16) + s1;
    const uint32_t bits = (ires & 0x007FFFFFu) | 0x40000000u;
    return (__uint_as_float(bits) - 2.0f) * 0.5f;
  } else {
    uint32_t x = s0 ^ (s1 * 0x9E3779B9u);
    x ^= x >> 16;
    x *= 0x21F0AAADu;
    x ^= x >> 15;
    x *= 0x735A2D97u;
    x ^= x >> 15;
    s1 += 1u;
    return (float)(int)(x >> 8) * (1.0f / 16777216.0f);
  }
}

// The primal's rounding: each product, sum and difference rounded on its
// own, as the plain path's separate tensor ops round them.
struct Rn {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
};

struct V3 {
  float x, y, z;
};
__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
// The adjoint's arithmetic (free to contract).
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 operator*(float s, V3 a) { return v3(s * a.x, s * a.y, s * a.z); }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
// The cross product of the adjoint (no primal to match).
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}

// The primal's arithmetic, in the replay and in the reverse sweep's
// recompute alike: Rn's rounding.
__device__ __forceinline__ V3 vadd(V3 a, V3 b) {
  return v3(Rn::add(a.x, b.x), Rn::add(a.y, b.y), Rn::add(a.z, b.z));
}
__device__ __forceinline__ V3 vsub(V3 a, V3 b) {
  return v3(Rn::sub(a.x, b.x), Rn::sub(a.y, b.y), Rn::sub(a.z, b.z));
}
__device__ __forceinline__ V3 vscale(float s, V3 a) {
  return v3(Rn::mul(s, a.x), Rn::mul(s, a.y), Rn::mul(s, a.z));
}
__device__ __forceinline__ V3 vmul(V3 a, V3 b) {
  return v3(Rn::mul(a.x, b.x), Rn::mul(a.y, b.y), Rn::mul(a.z, b.z));
}
// core/types.dot3: left to right.
__device__ __forceinline__ float vdot(V3 a, V3 b) {
  return Rn::add(Rn::add(Rn::mul(a.x, b.x), Rn::mul(a.y, b.y)), Rn::mul(a.z, b.z));
}
// torch.linalg.cross on the card: a1 * b2 - a2 * b1 as one FMA over the
// rounded second product.
__device__ __forceinline__ V3 cross_t(V3 a, V3 b) {
  return v3(__fmaf_rn(a.y, b.z, -Rn::mul(a.z, b.y)), __fmaf_rn(a.z, b.x, -Rn::mul(a.x, b.z)),
            __fmaf_rn(a.x, b.y, -Rn::mul(a.y, b.x)));
}

struct Scene {
  const float4* geom;  // [n] (cx, cy, cz, rad)
  const float* sc;     // [kRows, n]
  const int* lights;   // [n_lights]
  int n, n_lights;
  __device__ __forceinline__ V3 center(int j) const {
    return v3(sc[j], sc[n + j], sc[2 * n + j]);
  }
  __device__ __forceinline__ float radius(int j) const { return sc[3 * n + j]; }
  __device__ __forceinline__ V3 emission(int j) const {
    return v3(sc[4 * n + j], sc[5 * n + j], sc[6 * n + j]);
  }
  __device__ __forceinline__ V3 color(int j) const {
    return v3(sc[7 * n + j], sc[8 * n + j], sc[9 * n + j]);
  }
  __device__ __forceinline__ float refl(int j) const { return sc[10 * n + j]; }
  __device__ __forceinline__ bool emissive(int j) const { return sc[11 * n + j] > 0.5f; }
};

// The sphere quadratic of ops/intersect.sphere_intersect, as the replay
// rounds it: b = op . d, det = b b - op . op + r r, op = C - o.
struct Quad {
  V3 op;
  float b, det, sq;
};

__device__ __forceinline__ Quad quad(float4 s, V3 o, V3 d) {
  Quad q;
  q.op = v3(Rn::sub(s.x, o.x), Rn::sub(s.y, o.y), Rn::sub(s.z, o.z));
  q.b = vdot(q.op, d);
  q.det = Rn::add(Rn::sub(Rn::mul(q.b, q.b), vdot(q.op, q.op)), Rn::mul(s.w, s.w));
  q.sq = q.det > 0.0f ? sqrtf(q.det) : 0.0f;
  return q;
}

// ops/intersect.sphere_intersect for one sphere: t, or 0 on a miss.
__device__ __forceinline__ float sphere_t(float4 s, V3 o, V3 d) {
  const Quad q = quad(s, o, d);
  if (!(q.det >= 0.0f)) return 0.0f;
  const float t1 = Rn::sub(q.b, q.sq);
  const float t2 = Rn::add(q.b, q.sq);
  return t1 > kEps ? t1 : (t2 > kEps ? t2 : 0.0f);
}

// intersect_nearest: the largest index wins a tie.
__device__ __forceinline__ void nearest(const Scene& S, V3 o, V3 d, float& tb, int& id) {
  tb = kInf;
  id = 0;
  for (int j = S.n - 1; j >= 0; --j) {
    const float t = sphere_t(S.geom[j], o, d);
    if (t != 0.0f && t < tb) {
      tb = t;
      id = j;
    }
  }
}

// intersect_any: a sphere hit strictly closer than maxt.
__device__ __forceinline__ bool any_hit(const Scene& S, V3 o, V3 d, float maxt) {
  for (int j = S.n - 1; j >= 0; --j) {
    const float t = sphere_t(S.geom[j], o, d);
    if (t != 0.0f && t < maxt) return true;
  }
  return false;
}

// A bounce's record: its inputs, the hit distance, the RNG state at its
// start, the flag word and which light samples passed (bit k: light k).
struct Rec {
  V3 o, d, thr;
  float t;
  uint32_t s0, s1;
  uint32_t flags;
  uint32_t ok[kMaxLightWords];
};

// The hit's local frame (models/smallpt._bounce): hit point, normal before
// and after normalising, the oriented normal: nl = -_ref_sign(dp) n, -n
// where dp > 0.
struct Hit {
  V3 hp, n0, n, nl;
  float q, inv, dp, sgn;
};

__device__ __forceinline__ Hit hit_frame(const Scene& S, V3 o, V3 d, float t, int hid) {
  Hit h;
  h.hp = vadd(o, vscale(t, d));
  h.n0 = vsub(h.hp, S.center(hid));
  h.q = vdot(h.n0, h.n0);
  h.inv = 1.0f / sqrtf(fmaxf(h.q, kNormFloor));
  h.n = vscale(h.inv, h.n0);
  h.dp = vdot(h.n, d);
  h.sgn = h.dp > 0.0f ? -1.0f : 1.0f;
  h.nl = h.sgn * h.n;
  return h;
}

// One light sample of sample_lights: the draws u1 (second), u2 (first).
struct Light {
  V3 usp, sd0, sd;
  float len2, length, ls, wo, wi, a1, a2, s;
};

__device__ __forceinline__ Light light_sample(const Scene& S, int li, float u1, float u2, V3 hp,
                                              V3 nl) {
  Light L;
  const float zz = Rn::sub(1.0f, Rn::mul(2.0f, u1));
  const float rr = sqrtf(fmaxf(Rn::sub(1.0f, Rn::mul(zz, zz)), 0.0f));
  const float phi = Rn::mul(kTwoPi, u2);
  L.usp = v3(Rn::mul(rr, cosf(phi)), Rn::mul(rr, sinf(phi)), zz);
  const float rad = S.radius(li);
  L.sd0 = vsub(vadd(vscale(rad, L.usp), S.center(li)), hp);
  L.len2 = vdot(L.sd0, L.sd0);
  L.length = L.len2 > 0.0f ? sqrtf(L.len2) : 0.0f;
  L.ls = fmaxf(L.length, kLenFloor);
  L.sd = v3(L.sd0.x / L.ls, L.sd0.y / L.ls, L.sd0.z / L.ls);
  L.wo = vdot(L.sd, L.usp);
  L.wi = vdot(L.sd, nl);
  L.a1 = Rn::mul(kFourPi, rad);
  L.a2 = Rn::mul(L.a1, rad);
  L.s = Rn::mul(Rn::mul(L.a2, L.wi), -L.wo) / Rn::mul(L.ls, L.ls);
  return L;
}

// ops/sampling.cosine_sample_dir.
struct CosDir {
  V3 a, u0, u, v, w;
  float uinv, ca, sa, wz;
};

__device__ __forceinline__ V3 cosine_dir(V3 nl, float r1u, float r2u, CosDir& c) {
  const float r1 = Rn::mul(kTwoPi, r1u);
  const float r2s = sqrtf(r2u);
  c.w = nl;
  c.a = fabsf(nl.x) > 0.1f ? v3(0.0f, 1.0f, 0.0f) : v3(1.0f, 0.0f, 0.0f);
  c.u0 = cross_t(c.a, c.w);
  c.uinv = 1.0f / sqrtf(vdot(c.u0, c.u0));
  c.u = vscale(c.uinv, c.u0);
  c.v = cross_t(c.w, c.u);
  c.ca = Rn::mul(cosf(r1), r2s);
  c.sa = Rn::mul(sinf(r1), r2s);
  c.wz = sqrtf(fmaxf(Rn::sub(1.0f, r2u), 0.0f));
  return vadd(vadd(vscale(c.ca, c.u), vscale(c.sa, c.v)), vscale(c.wz, c.w));
}

// The REFR branch: refr_start up to cos2t (its sign is total internal
// reflection), refr_rest the smooth part of a lane without it.
struct Refr {
  V3 td0, td;
  float nnt, ddn, cos2t, sc, si, kk, tq, tinv, c1, m1, m2, m3, m4, re, p, rp, tp;
};

__device__ __forceinline__ void refr_start(V3 d, const Hit& h, bool into, Refr& r) {
  r.nnt = into ? (1.0f / 1.5f) : 1.5f;
  r.ddn = vdot(d, h.nl);
  r.cos2t = Rn::sub(1.0f, Rn::mul(Rn::mul(r.nnt, r.nnt), Rn::sub(1.0f, Rn::mul(r.ddn, r.ddn))));
}

__device__ __forceinline__ void refr_rest(V3 d, const Hit& h, bool into, Refr& r) {
  r.sc = sqrtf(r.cos2t);
  r.si = into ? 1.0f : -1.0f;
  r.kk = Rn::mul(r.si, Rn::add(Rn::mul(r.ddn, r.nnt), r.sc));
  r.td0 = vsub(vscale(r.nnt, d), vscale(r.kk, h.n));
  r.tq = vdot(r.td0, r.td0);
  r.tinv = 1.0f / sqrtf(fmaxf(r.tq, kNormFloor));
  r.td = vscale(r.tinv, r.td0);
  r.c1 = Rn::sub(1.0f, into ? -r.ddn : vdot(r.td, h.n));
  r.m1 = Rn::mul(0.96f, r.c1);  // (1 - r0) * c1, r0 = 0.04
  r.m2 = Rn::mul(r.m1, r.c1);
  r.m3 = Rn::mul(r.m2, r.c1);
  r.m4 = Rn::mul(r.m3, r.c1);
  r.re = Rn::add(0.04f, Rn::mul(r.m4, r.c1));
  r.p = Rn::add(0.25f, Rn::mul(0.5f, r.re));
  r.rp = r.re / r.p;
  r.tp = Rn::sub(1.0f, r.re) / Rn::sub(1.0f, r.p);
}

// The camera ray's direction before normalising: x kcx + y kcy + dir.
__device__ __forceinline__ V3 camera_dir(const float* cs, float kcx, float kcy) {
  return v3(Rn::add(Rn::add(Rn::mul(cs[6], kcx), Rn::mul(cs[9], kcy)), cs[3]),
            Rn::add(Rn::add(Rn::mul(cs[7], kcx), Rn::mul(cs[10], kcy)), cs[4]),
            Rn::add(Rn::add(Rn::mul(cs[8], kcx), Rn::mul(cs[11], kcy)), cs[5]));
}

// out = x0 * inv, inv = 1 / sqrt(max(x0 . x0, floor)): the cotangent of x0.
// The clamp passes a gradient only where x0 . x0 >= floor (``ok``).
__device__ __forceinline__ V3 norm_bwd(V3 g, V3 x0, float inv, bool ok) {
  const float g_s = -dot(g, x0) * (inv * inv);
  return g * inv + (ok ? g_s * inv : 0.0f) * x0;
}

// The warp's sums of its lanes' 8 values, scattered: lane L ends with the
// sum over the 32 lanes of v[L >> 2], the same in lanes L & ~3 .. L | 3.
// At each of the first three levels a lane keeps the half of its values
// that its lane bit selects and adds its partner's copy of that half; the
// last two add the partners' sums. A fixed pattern of 9 shuffles, where a
// butterfly per value takes 40.
__device__ __forceinline__ float warp_sum8(const float (&v)[8]) {
  const int lane = threadIdx.x & 31;
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    w[j] = (b4 ? v[j + 4] : v[j]) + __shfl_xor_sync(kFull, b4 ? v[j] : v[j + 4], 16);
  float x[2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
    x[j] = (b3 ? w[j + 2] : w[j]) + __shfl_xor_sync(kFull, b3 ? w[j] : w[j + 2], 8);
  float y = (b2 ? x[1] : x[0]) + __shfl_xor_sync(kFull, b2 ? x[0] : x[1], 4);
  y += __shfl_xor_sync(kFull, y, 2);
  y += __shfl_xor_sync(kFull, y, 1);
  return y;
}

// Slot c of sphere j's row in a warp's table: center (0-2), radius (3),
// then 3 values at `at` + 3 j (4-6: the colour's or the emission's); slot 7
// is unused.
__device__ __forceinline__ void put_slot(float* tab, int n, int j, int at, int c, float x) {
  if (c < 3) {
    tab[3 * j + c] += x;
  } else if (c == 3) {
    tab[3 * n + j] += x;
  } else if (c < 7) {
    tab[at + 3 * j + c - 4] += x;
  }
}

// Adds each lane's 8 slots v into row `key` of the warp's table (key < 0:
// nothing). One group of lanes with equal keys at a time: the group's sums
// are warp_sum8 over the warp (the other lanes add zeros), and one lane per
// slot writes its sum with a plain add. Groups hold distinct keys and a
// group's slots distinct entries, so no two writes meet, and a warp whose
// lanes share one key is one round. All 32 lanes call it together.
__device__ __forceinline__ void warp_add(int key, const float (&v)[8], float* tab, int n,
                                         int at) {
  const int lane = threadIdx.x & 31;
  unsigned todo = __ballot_sync(kFull, key >= 0);
  while (todo != 0u) {
    const int k = __shfl_sync(kFull, key, __ffs(todo) - 1);
    const bool mine = key == k;
    todo &= ~__ballot_sync(kFull, mine);
    float s[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) s[c] = mine ? v[c] : 0.0f;
    const float sum = warp_sum8(s);
    if ((lane & 3) == 0) put_slot(tab, n, k, at, lane >> 2, sum);
  }
}

// Adds a lane's hit row v (slots 0-6: centre, radius, colour) of sphere j
// into its own column: slot c of sphere j at (c n + j) kThreads, from the
// column's base (the thread's index).
__device__ __forceinline__ void lane_add(float* col, int n, int j, const float (&v)[8]) {
#pragma unroll
  for (int c = 0; c < 7; ++c) col[(c * n + j) * kThreads] += v[c];
}

// Sums each of the 7 n entries over the block's kThreads columns in a fixed
// order (a lane's four columns, then a butterfly over the warp) and adds it
// into its entry of the table `tab` (centre at 3 j, radius at 3 n + j,
// colour at 7 n + 3 j). Warp w takes entries w, w + kWarps, ...
__device__ __forceinline__ void fold_columns(const float* cols, float* tab, int n) {
  const int lane = threadIdx.x & 31;
  for (int e = threadIdx.x >> 5; e < 7 * n; e += kWarps) {
    const float* c = cols + e * kThreads;
    float v = (c[lane] + c[lane + 32]) + (c[lane + 64] + c[lane + 96]);
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    const int s = e / n, j = e - s * n;
    if (lane == 0) tab[s < 3 ? 3 * j + s : (s == 3 ? 3 * n + j : 7 * n + 3 * j + s - 4)] += v;
  }
}

// The replay of one pass: the camera ray's jitter (kcx, kcy), the records
// of its bounces, its radiance.
template <bool DIRECT_ONLY, int RNG>
__device__ __forceinline__ int replay(const Scene& S, const float* cs, float px, float py,
                                      float inv_w, float inv_h, int max_depth, uint32_t& s0,
                                      uint32_t& s1, float& kcx, float& kcy, Rec* recs, V3& rad) {
  const float r1 = draw<RNG>(s0, s1);
  const float r2 = draw<RNG>(s0, s1);
  kcx = Rn::sub(Rn::mul(Rn::add(px, Rn::sub(r1, 0.5f)), inv_w), 0.5f);
  kcy = Rn::sub(Rn::mul(Rn::add(py, Rn::sub(r2, 0.5f)), inv_h), 0.5f);
  const V3 rd = camera_dir(cs, kcx, kcy);
  V3 o = v3(Rn::add(Rn::mul(0.1f, rd.x), cs[0]), Rn::add(Rn::mul(0.1f, rd.y), cs[1]),
            Rn::add(Rn::mul(0.1f, rd.z), cs[2]));
  V3 d = vscale(1.0f / sqrtf(vdot(rd, rd)), rd);
  V3 thr = v3(1.0f, 1.0f, 1.0f);
  rad = v3(0.0f, 0.0f, 0.0f);
  bool spec = true;
  int nrec = 0;
  const int words = (S.n_lights + 31) >> 5;
  for (int depth = 0; depth < max_depth; ++depth) {
    float t;
    int hid;
    nearest(S, o, d, t, hid);
    if (!(t < kInf)) break;  // a miss ends the path
    Rec& rec = recs[nrec++];
    rec.o = o;
    rec.d = d;
    rec.thr = thr;
    rec.t = t;
    rec.s0 = s0;
    rec.s1 = s1;
    for (int w = 0; w < words; ++w) rec.ok[w] = 0u;
    uint32_t f = (uint32_t)hid | (spec ? kSpecIn : 0u);
    const Hit h = hit_frame(S, o, d, t, hid);
    if (S.emissive(hid)) {
      if (spec) rad = vadd(rad, vmul(vscale(fabsf(h.dp), thr), S.emission(hid)));
      rec.flags = f | ((uint32_t)kLight << kKindShift);
      break;  // a light ends the path
    }
    const float mat = S.refl(hid);
    const V3 c = S.color(hid);
    const V3 tc = vmul(thr, c);
    if (mat == 0.0f) {
      V3 ld = v3(0.0f, 0.0f, 0.0f);
      for (int k = 0; k < S.n_lights; ++k) {
        const int li = S.lights[k];
        const float u2 = draw<RNG>(s0, s1);
        const float u1 = draw<RNG>(s0, s1);
        const Light L = light_sample(S, li, u1, u2, h.hp, h.nl);
        if (!(L.wo > 0.0f) && L.wi > 0.0f &&
            !any_hit(S, h.hp, L.sd, Rn::sub(L.length, kEps))) {
          rec.ok[k >> 5] |= 1u << (k & 31);
          ld = vadd(ld, vscale(L.s, S.emission(li)));
        }
      }
      rad = vadd(rad, vmul(tc, ld));
      f |= (uint32_t)kDiff << kKindShift;
      if (DIRECT_ONLY) {  // RadianceDirectLighting: ends after NEE
        rec.flags = f;
        break;
      }
      const float r1u = draw<RNG>(s0, s1);
      const float r2u = draw<RNG>(s0, s1);
      CosDir cd;
      d = cosine_dir(h.nl, r1u, r2u, cd);
      thr = tc;
      spec = false;
    } else if (mat == 1.0f) {
      d = vsub(d, vscale(Rn::mul(2.0f, h.dp), h.n));
      thr = tc;
      spec = true;
      f |= (uint32_t)kSpec << kKindShift;
    } else {
      const bool into = vdot(h.n, h.nl) > 0.0f;
      Refr r;
      refr_start(d, h, into, r);
      const V3 refl_dir = vsub(d, vscale(Rn::mul(2.0f, h.dp), h.n));
      if (r.cos2t < 0.0f) {
        d = refl_dir;
        thr = tc;
        f |= (uint32_t)kTir << kKindShift;
      } else {
        refr_rest(d, h, into, r);
        if (draw<RNG>(s0, s1) < r.p) {
          thr = vmul(vscale(r.rp, thr), c);
          d = refl_dir;
          f |= (uint32_t)kRefl << kKindShift;
        } else {
          thr = vmul(vscale(r.tp, thr), c);
          d = r.td;
          f |= (uint32_t)kTrans << kKindShift;
        }
      }
      spec = true;
    }
    rec.flags = f;
    o = h.hp;
  }
  return nrec;
}

// The reverse sweep of one pass with radiance cotangent G, the warp's lanes
// in lockstep: the scene's gradients into the warp's table (with COLS the
// hit rows into the lane's column col), the camera basis's into gb. All 32
// lanes call it together (a lane with no records, nrec = 0, adds zeros).
template <bool DIRECT_ONLY, int RNG, bool COLS>
__device__ __forceinline__ void reverse(const Scene& S, float* tab, float* col, const float* cs,
                                        const Rec* recs, int nrec, float kcx, float kcy, V3 G,
                                        float* gb) {
  const V3 zero = v3(0.0f, 0.0f, 0.0f);
  const int n = S.n;
  V3 g_o = zero, g_d = zero, g_thr = zero;
  const int top = __reduce_max_sync(kFull, nrec);
  for (int i = top - 1; i >= 0; --i) {
    const bool act = i < nrec;
    const Rec& rec = recs[act ? i : 0];
    const uint32_t f = act ? rec.flags : 0u;
    const uint32_t kind = (f >> kKindShift) & 7u;
    const int hid = (int)(f & kHidMask);
    const bool diff = act && kind == kDiff;
    V3 o = zero, d = zero, thr = zero;
    float t = 0.0f;
    Hit h;
    // The cotangents of this bounce's outputs (o, d, thr of the next).
    const V3 g_on = g_o, g_dn = g_d, g_thrn = g_thr;
    V3 g_hp = zero, g_n = zero, g_nl = zero, ld = zero;
    float g_dp = 0.0f;
    uint32_t s0 = 0u, s1 = 0u;
    if (act) {
      o = rec.o;
      d = rec.d;
      thr = rec.thr;
      t = rec.t;
      s0 = rec.s0;
      s1 = rec.s1;
      h = hit_frame(S, o, d, t, hid);
      g_o = zero;
      g_d = zero;
      g_thr = zero;
      if (kind != kLight) g_hp = g_on;
    }
    // rad += tc * ld, ld the sum over the passing light samples: each
    // light's row (its center, radius and emission) summed over the warp.
    if (__any_sync(kFull, diff)) {
      const V3 g_ld = diff ? mul(G, mul(thr, S.color(hid))) : zero;
      for (int k = 0; k < S.n_lights; ++k) {
        const int li = S.lights[k];
        float cl[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        bool lit = false;
        if (diff) {
          const float u2 = draw<RNG>(s0, s1);
          const float u1 = draw<RNG>(s0, s1);
          lit = (rec.ok[k >> 5] >> (k & 31)) & 1u;
          if (lit) {
            const Light L = light_sample(S, li, u1, u2, h.hp, h.nl);
            const V3 e = S.emission(li);
            ld = ld + L.s * e;
            const V3 g_e = g_ld * L.s;
            // s = ((a2 wi) (-wo)) / (ls ls), a2 = (4 pi R) R
            const float g_s = dot(g_ld, e);
            const float rls = 1.0f / L.ls;
            const float rden = rls * rls;
            const float a3 = L.a2 * L.wi;
            const float a4 = a3 * (-L.wo);
            const float g_a4 = g_s * rden;
            const float g_den = -g_s * a4 * (rden * rden);
            float g_ls = 2.0f * L.ls * g_den;
            const float g_a3 = g_a4 * (-L.wo);
            const float g_wo = -(g_a4 * a3);
            const float g_a2 = g_a3 * L.wi;
            const float g_wi = g_a3 * L.a2;
            float g_R = g_a2 * L.a1 + (g_a2 * S.radius(li)) * kFourPi;
            const V3 g_sd = g_wo * L.usp + g_wi * h.nl;
            g_nl = g_nl + g_wi * L.sd;
            // sd = sd0 / ls, ls = clamp(length, 1e-20), length = sqrt(len2)
            V3 g_sd0 = g_sd * rls;
            g_ls += -dot(g_sd, L.sd0) * rden;
            const float g_len2 =
                L.length >= kLenFloor && L.len2 > 0.0f ? g_ls * (0.5f / L.length) : 0.0f;
            g_sd0 = g_sd0 + (2.0f * g_len2) * L.sd0;
            // sd0 = R usp + C - hp
            g_R += dot(g_sd0, L.usp);
            g_hp = g_hp - g_sd0;
            cl[0] = g_sd0.x;
            cl[1] = g_sd0.y;
            cl[2] = g_sd0.z;
            cl[3] = g_R;
            cl[4] = g_e.x;
            cl[5] = g_e.y;
            cl[6] = g_e.z;
          }
        }
        if (__any_sync(kFull, lit)) {
          warp_add(lit ? li : -1, cl, tab, n, 4 * n);
        }
      }
    }
    // The rest of the bounce, and the hit sphere's row: center, radius and
    // colour in ch, its emission in ce.
    float ch[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float ce[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    bool has_e = false;
    if (act) {
      if (kind == kLight) {
        if (f & kSpecIn) {
          // rad += (|dp| thr) e
          const float adp = fabsf(h.dp);
          const V3 e = S.emission(hid);
          const V3 g_m = mul(G, e);
          const V3 g_e = mul(G, adp * thr);
          ce[4] = g_e.x;
          ce[5] = g_e.y;
          ce[6] = g_e.z;
          has_e = true;
          g_thr = g_m * adp;
          g_dp = dot(g_m, thr) * (h.dp > 0.0f ? 1.0f : (h.dp == 0.0f ? 0.0f : -1.0f));
        }
      } else {
        const V3 c = S.color(hid);
        V3 g_tc = zero, g_c = zero;
        if (kind == kDiff) {
          g_tc = mul(G, ld);
          if (!DIRECT_ONLY) {
            // d' = cosine_dir(nl), thr' = tc
            const float r1u = draw<RNG>(s0, s1);
            const float r2u = draw<RNG>(s0, s1);
            CosDir cd;
            cosine_dir(h.nl, r1u, r2u, cd);
            V3 g_u = cd.ca * g_dn;
            const V3 g_v = cd.sa * g_dn;
            V3 g_w = cd.wz * g_dn;
            g_w = g_w + cross(cd.u, g_v);  // v = w x u
            g_u = g_u + cross(g_v, cd.w);
            const V3 g_u0 = norm_bwd(g_u, cd.u0, cd.uinv, true);
            g_w = g_w + cross(g_u0, cd.a);  // u0 = a x w
            g_nl = g_nl + g_w;
            g_tc = g_tc + g_thrn;
          }
        } else {
          if (kind != kTrans) {
            // d' = d - (2 dp) n
            g_d = g_d + g_dn;
            g_n = g_n - (2.0f * h.dp) * g_dn;
            g_dp += 2.0f * (-dot(g_dn, h.n));
          }
          if (kind == kSpec || kind == kTir) g_tc = g_tc + g_thrn;
          if (kind == kRefl || kind == kTrans) {
            const bool into = vdot(h.n, h.nl) > 0.0f;
            Refr r;
            refr_start(d, h, into, r);
            refr_rest(d, h, into, r);
            // thr' = (scale thr) c, scale rp or tp
            const float sc = kind == kRefl ? r.rp : r.tp;
            const V3 g_st = mul(g_thrn, c);
            g_c = mul(g_thrn, sc * thr);
            const float g_sc = dot(g_st, thr);
            g_thr = g_thr + g_st * sc;
            float g_re, g_p;
            if (kind == kRefl) {  // rp = re / p
              const float rpp = 1.0f / r.p;
              g_re = g_sc * rpp;
              g_p = -g_sc * r.re * (rpp * rpp);
            } else {  // tp = (1 - re) / (1 - p)
              const float romp = 1.0f / (1.0f - r.p);
              g_re = -(g_sc * romp);
              g_p = g_sc * (1.0f - r.re) * (romp * romp);
            }
            g_re += 0.5f * g_p;
            // re = 0.04 + ((((0.96 c1) c1) c1) c1) c1
            const float g_m4 = g_re * r.c1;
            float g_c1 = g_re * r.m4;
            const float g_m3 = g_m4 * r.c1;
            g_c1 += g_m4 * r.m3;
            const float g_m2 = g_m3 * r.c1;
            g_c1 += g_m3 * r.m2;
            const float g_m1 = g_m2 * r.c1;
            g_c1 += g_m2 * r.m1;
            g_c1 += g_m1 * 0.96f;
            float g_ddn = 0.0f;
            V3 g_td = kind == kTrans ? g_dn : zero;
            if (into) {
              g_ddn += g_c1;  // c1 = 1 + ddn
            } else {  // c1 = 1 - td . n
              g_td = g_td - g_c1 * h.n;
              g_n = g_n - g_c1 * r.td;
            }
            const V3 g_td0 = norm_bwd(g_td, r.td0, r.tinv, r.tq >= kNormFloor);
            // td0 = nnt d - kk n
            g_d = g_d + r.nnt * g_td0;
            g_n = g_n - r.kk * g_td0;
            const float g_in = r.si * (-dot(g_td0, h.n));
            g_ddn += g_in * r.nnt;
            // kk = si (ddn nnt + sqrt(cos2t)), cos2t = 1 - nnt^2 (1 - ddn^2)
            const float g_c2 = g_in / (2.0f * r.sc);
            g_ddn += g_c2 * (r.nnt * r.nnt) * 2.0f * r.ddn;
            g_d = g_d + g_ddn * h.nl;
            g_nl = g_nl + g_ddn * d;
          }
        }
        // tc = thr * c
        g_thr = g_thr + mul(g_tc, c);
        g_c = g_c + mul(g_tc, thr);
        ch[4] = g_c.x;
        ch[5] = g_c.y;
        ch[6] = g_c.z;
        g_n = g_n + h.sgn * g_nl;
      }
      // dp = n . d
      g_n = g_n + g_dp * d;
      g_d = g_d + g_dp * h.n;
      const V3 g_n0 = norm_bwd(g_n, h.n0, h.inv, h.q >= kNormFloor);
      g_hp = g_hp + g_n0;
      // hp = o + t d
      const float g_t = dot(g_hp, d);
      g_o = g_o + g_hp;
      g_d = g_d + t * g_hp;
      // t = b - sq or b + sq; det = b b - op . op + r r; op = C - o
      const Quad qd = quad(S.geom[hid], o, d);
      const float r = S.radius(hid);
      const float sgn_sq = Rn::sub(qd.b, qd.sq) > kEps ? -1.0f : 1.0f;
      const float g_det = qd.det > 0.0f ? sgn_sq * g_t / (2.0f * qd.sq) : 0.0f;
      const float g_b = g_t + 2.0f * qd.b * g_det;
      const V3 g_op = g_b * d - (2.0f * g_det) * qd.op;
      g_d = g_d + g_b * qd.op;
      g_o = g_o - g_op;
      const V3 g_ctr = g_op - g_n0;
      ch[0] = g_ctr.x;
      ch[1] = g_ctr.y;
      ch[2] = g_ctr.z;
      ch[3] = 2.0f * r * g_det;
    }
    if (COLS) {
      if (act) lane_add(col, n, hid, ch);
    } else {
      warp_add(act ? hid : -1, ch, tab, n, 7 * n);
    }
    // The emission only where some lane saw a light by a specular path.
    if (__any_sync(kFull, has_e)) warp_add(has_e ? hid : -1, ce, tab, n, 4 * n);
  }
  // The camera ray: rd = x kcx + y kcy + dir; o = 0.1 rd + orig; d = rd / |rd|.
  const V3 rd = camera_dir(cs, kcx, kcy);
  const V3 g_rd = norm_bwd(g_d, rd, 1.0f / sqrtf(dot(rd, rd)), true) + 0.1f * g_o;
  gb[0] += g_o.x;
  gb[1] += g_o.y;
  gb[2] += g_o.z;
  gb[3] += g_rd.x;
  gb[4] += g_rd.y;
  gb[5] += g_rd.z;
  gb[6] += g_rd.x * kcx;
  gb[7] += g_rd.y * kcx;
  gb[8] += g_rd.z * kcx;
  gb[9] += g_rd.x * kcy;
  gb[10] += g_rd.y * kcy;
  gb[11] += g_rd.z * kcy;
}

template <bool DIRECT_ONLY, int RNG, bool COLS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
pt_backward_kernel(const float* __restrict__ scene, int n, const int* __restrict__ lights,
                   int n_lights, const float* __restrict__ cam, const uint32_t* __restrict__ s0_in,
                   const uint32_t* __restrict__ s1_in, const float* __restrict__ grad_out,
                   const float* __restrict__ weights, int num_samples, int lo, int hi,
                   int lo_aligned, int width, int height, float inv_w, float inv_h,
                   int max_depth, float* __restrict__ partials, float* __restrict__ img_out) {
  extern __shared__ __align__(16) float smem[];
  const int P = 10 * n + 12;
  float4* g4 = reinterpret_cast<float4*>(smem);
  float* tab = reinterpret_cast<float*>(g4 + n);
  float* cs = tab + kRows * n;
  float* gtab = cs + 12;  // [kWarps, P]
  float* cols = gtab + kWarps * P;  // with COLS: [7 n, kThreads]
  int* ls = reinterpret_cast<int*>(cols + (COLS ? 7 * n * kThreads : 0));
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    g4[i] = make_float4(scene[i], scene[n + i], scene[2 * n + i], scene[3 * n + i]);
  for (int i = threadIdx.x; i < kRows * n; i += blockDim.x) tab[i] = scene[i];
  if (threadIdx.x < 12) cs[threadIdx.x] = cam[threadIdx.x];
  for (int i = threadIdx.x; i < n_lights; i += blockDim.x) ls[i] = lights[i];
  for (int i = threadIdx.x; i < kWarps * P; i += blockDim.x) gtab[i] = 0.0f;
  if (COLS)  // each thread its own column
    for (int i = threadIdx.x; i < 7 * n * kThreads; i += kThreads) cols[i] = 0.0f;
  __syncthreads();

  const Scene S{g4, tab, ls, n, n_lights};
  float* wtab = gtab + (threadIdx.x >> 5) * P;
  float* col = cols + threadIdx.x;
  float gb[12];
  for (int k = 0; k < 12; ++k) gb[k] = 0.0f;
  // Every lane of the block walks the passes (the reverse sweep's warp
  // reductions need all 32); a lane outside lo..hi-1 replays nothing.
  const int p = lo_aligned + blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = p >= lo && p < hi;
  const int lane = live ? p - lo : 0;
  uint32_t s0 = live ? s0_in[lane] : 0u, s1 = live ? s1_in[lane] : 0u;
  const V3 go = live ? v3(grad_out[3 * lane], grad_out[3 * lane + 1], grad_out[3 * lane + 2])
                     : v3(0.0f, 0.0f, 0.0f);
  const float px = (float)(p % width);
  const float py = (float)((height - 1) - p / width);
  V3 acc = v3(0.0f, 0.0f, 0.0f);
  Rec recs[kMaxDepth];
  for (int pass = 0; pass < num_samples; ++pass) {
    float kcx = 0.0f, kcy = 0.0f;
    int nrec = 0;
    if (live) {
      V3 rad;
      nrec = replay<DIRECT_ONLY, RNG>(S, cs, px, py, inv_w, inv_h, max_depth, s0, s1, kcx, kcy,
                                      recs, rad);
      // The plain running mean (accum * k + r) / (k + 1): torch's card
      // kernel divides by a scalar as a product with its reciprocal.
      const float k = (float)pass;
      const float rk = 1.0f / Rn::add(k, 1.0f);
      acc = v3(Rn::mul(Rn::add(Rn::mul(acc.x, k), rad.x), rk),
               Rn::mul(Rn::add(Rn::mul(acc.y, k), rad.y), rk),
               Rn::mul(Rn::add(Rn::mul(acc.z, k), rad.z), rk));
    }
    reverse<DIRECT_ONLY, RNG, COLS>(S, wtab, col, cs, recs, nrec, kcx, kcy, go * weights[pass],
                                    gb);
  }
  if (live && img_out != nullptr) {
    img_out[3 * lane] = acc.x;
    img_out[3 * lane + 1] = acc.y;
    img_out[3 * lane + 2] = acc.z;
  }
  // The basis: a fixed butterfly over the warp, then lane 0 into the table.
  for (int k = 0; k < 12; ++k) {
    float v = gb[k];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    gb[k] = v;
  }
  __syncwarp();
  if ((threadIdx.x & 31) == 0)
    for (int k = 0; k < 12; ++k) wtab[10 * n + k] += gb[k];
  if (COLS) {  // every column whole, then folded into warp 0's table
    __syncthreads();
    fold_columns(cols, gtab, n);
  }
  __syncthreads();
  float* row = partials + (size_t)blockIdx.x * P;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    float v = gtab[i];
    for (int w = 1; w < kWarps; ++w) v += gtab[w * P + i];
    row[i] = v;
  }
}

// out[i] = the sum of partials[b, i] over the blocks b, in a fixed order:
// one block per entry, each thread a strided share, then a fixed tree.
__global__ void __launch_bounds__(kReduceThreads)
reduce_partials(const float* __restrict__ partials, int blocks, int P, float* __restrict__ out) {
  __shared__ float part[kReduceThreads];
  const int i = blockIdx.x;
  float v = 0.0f;
  for (int b = threadIdx.x; b < blocks; b += kReduceThreads) v += partials[(size_t)b * P + i];
  part[threadIdx.x] = v;
  __syncthreads();
  for (int s = kReduceThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) part[threadIdx.x] += part[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[i] = part[0];
}

struct Args {
  const float* scene;
  int n;
  const int* lights;
  int n_lights;
  const float* cam;
  const uint32_t* s0;
  const uint32_t* s1;
  const float* grad_out;
  const float* weights;
  int num_samples, lo, hi, width, height;
  float inv_w, inv_h;
  int max_depth;
  float* partials;
  float* out;
  float* img_out;
};

// A block's shared memory: the spheres' float4s, the scene's rows, the
// camera, the warps' tables, with cols the per-lane columns, the lights.
size_t smem_bytes(int n, int n_lights, bool cols) {
  const size_t floats = kRows * n + 12 + kWarps * (10 * n + 12) + (cols ? 7 * n * kThreads : 0);
  return sizeof(float4) * n + sizeof(float) * floats + sizeof(int) * n_lights;
}

// The route on the current device: the per-lane columns where a block that
// holds them fits the opt-in limit a block and still kMinBlocks to an SM,
// each block with the runtime's reservation. lim: the three limits read.
cudaError_t lane_columns(int n, int n_lights, bool& cols, int (&lim)[3]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&lim[0], cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&lim[1], cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&lim[2], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const size_t b = smem_bytes(n, n_lights, true);
  cols = b <= static_cast<size_t>(lim[2]) &&
         kMinBlocks * (b + lim[1]) <= static_cast<size_t>(lim[0]);
  return cudaSuccess;
}

// Past the default 48 KB a block's shared memory needs the kernel's opt-in.
cudaError_t allow_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool DIRECT_ONLY, int RNG, bool COLS>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int P = 10 * a.n + 12;
  const size_t smem = smem_bytes(a.n, a.n_lights, COLS);
  const int lo_aligned = a.lo & ~(kThreads - 1);
  const int blocks = (a.hi - lo_aligned + kThreads - 1) / kThreads;
  pt_backward_kernel<DIRECT_ONLY, RNG, COLS><<<blocks, kThreads, smem, stream>>>(
      a.scene, a.n, a.lights, a.n_lights, a.cam, a.s0, a.s1, a.grad_out, a.weights,
      a.num_samples, a.lo, a.hi, lo_aligned, a.width, a.height, a.inv_w, a.inv_h, a.max_depth,
      a.partials, a.img_out);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  reduce_partials<<<P, kReduceThreads, 0, stream>>>(a.partials, blocks, P, a.out);
  return cudaGetLastError();
}

// The builds, PT or DL by mwc or counter by route: index 4 DL + 2 counter +
// cols.
int build(int direct_only, int rng_counter, bool cols) {
  return 4 * (direct_only != 0) + 2 * (rng_counter != 0) + (cols ? 1 : 0);
}
using Launch = cudaError_t (*)(const Args&, cudaStream_t);
const Launch kLaunch[8] = {
    launch<false, kMwc, false>,     launch<false, kMwc, true>,
    launch<false, kCounter, false>, launch<false, kCounter, true>,
    launch<true, kMwc, false>,      launch<true, kMwc, true>,
    launch<true, kCounter, false>,  launch<true, kCounter, true>};
const void* const kKernel[8] = {
    reinterpret_cast<const void*>(pt_backward_kernel<false, kMwc, false>),
    reinterpret_cast<const void*>(pt_backward_kernel<false, kMwc, true>),
    reinterpret_cast<const void*>(pt_backward_kernel<false, kCounter, false>),
    reinterpret_cast<const void*>(pt_backward_kernel<false, kCounter, true>),
    reinterpret_cast<const void*>(pt_backward_kernel<true, kMwc, false>),
    reinterpret_cast<const void*>(pt_backward_kernel<true, kMwc, true>),
    reinterpret_cast<const void*>(pt_backward_kernel<true, kCounter, false>),
    reinterpret_cast<const void*>(pt_backward_kernel<true, kCounter, true>)};

}  // namespace

// Plain C entry point, bound with ctypes. scene: [12, n] float32
// (pack_scene); lights: [n_lights] int32; cam: [12] float32 (orig, dir, x,
// y); s0/s1: [hi - lo] uint32, the plain path's seeds of pixels lo..hi-1;
// grad_out: [hi - lo, 3] float32; weights: [num_samples] float32;
// partials: [blocks, 10 n + 12] float32 scratch, blocks =
// pt_backward_blocks(lo, hi); out: [10 n + 12] float32; img_out: [hi - lo,
// 3] float32 or null; lane_cols: null, or where the route taken is written
// (1 the per-lane columns, 0 the warp rounds). max_depth <= 16, n <= 96.
// Returns cudaGetLastError() after the launches (0 = cudaSuccess).
extern "C" int pt_backward_cuda(const float* scene, int n, const int* lights, int n_lights,
                                const float* cam, const uint32_t* s0, const uint32_t* s1,
                                const float* grad_out, const float* weights, int num_samples,
                                int lo, int hi, int width, int height, float inv_w, float inv_h,
                                int max_depth, int direct_only, int rng_counter, float* partials,
                                float* out, float* img_out, void* stream, int* lane_cols) {
  if (max_depth > kMaxDepth || n_lights > 32 * kMaxLightWords || n > (int)kHidMask + 1 ||
      hi <= lo)
    return static_cast<int>(cudaErrorInvalidValue);
  bool cols = false;
  int lim[3];
  cudaError_t err = lane_columns(n, n_lights, cols, lim);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{scene, n, lights, n_lights, cam, s0, s1, grad_out, weights, num_samples, lo, hi,
               width, height, inv_w, inv_h, max_depth, partials, out, img_out};
  const int k = build(direct_only, rng_counter, cols);
  err = allow_smem(kKernel[k], smem_bytes(n, n_lights, cols));
  if (err == cudaSuccess) err = kLaunch[k](a, static_cast<cudaStream_t>(stream));
  if (lane_cols != nullptr) *lane_cols = cols ? 1 : 0;
  return static_cast<int>(err);
}

// K1b's route for a scene of n spheres and n_lights lights on the current
// device: out[0] 1 for the per-lane columns, 0 for the warp rounds; out[1]
// the shared memory a block of that route holds in bytes; out[2..4] the
// limits the choice read (shared memory an SM, the runtime's reservation a
// block, the opt-in limit a block). Returns the CUDA error code.
extern "C" int pt_backward_route(int n, int n_lights, int* out) {
  bool cols = false;
  int lim[3];
  const cudaError_t err = lane_columns(n, n_lights, cols, lim);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = cols ? 1 : 0;
  out[1] = static_cast<int>(smem_bytes(n, n_lights, cols));
  for (int k = 0; k < 3; ++k) out[2 + k] = lim[k];
  return 0;
}

// K1b's build and occupancy (PT or DL, mwc or counter) for a scene of n
// spheres and n_lights lights, on the route a launch takes: out[0] its warps
// resident on one SM, as the occupancy calculator gives them, out[1] its
// registers a thread, out[2] its local memory a thread in bytes (the stack
// frame), out[3] the route (1 the per-lane columns), out[4] its shared
// memory a block in bytes. Returns the CUDA error code (0 = cudaSuccess).
extern "C" int pt_backward_occupancy(int n, int n_lights, int direct_only, int rng_counter,
                                     int* out) {
  bool cols = false;
  int lim[3];
  cudaError_t err = lane_columns(n, n_lights, cols, lim);
  const void* fn = kKernel[build(direct_only, rng_counter, cols)];
  const size_t smem = smem_bytes(n, n_lights, cols);
  if (err == cudaSuccess) err = allow_smem(fn, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks * kWarps;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = cols ? 1 : 0;
  out[4] = static_cast<int>(smem);
  return 0;
}

// The number of blocks (rows of partials) of a launch over pixels lo..hi-1.
extern "C" int pt_backward_blocks(int lo, int hi) {
  const int lo_aligned = lo & ~(kThreads - 1);
  return (hi - lo_aligned + kThreads - 1) / kThreads;
}

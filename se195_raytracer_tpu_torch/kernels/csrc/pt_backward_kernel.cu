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
//      rounded on its own (this file is built with -fmad=false), dot products
//      left to right, IEEE sqrt and division where the plain path takes
//      them, torch.linalg.cross's a1 * b2 - a2 * b1 as torch's kernel rounds
//      it (one FMA over the rounded second product), and the running mean's
//      division by a scalar as torch's card kernel does it, a product with
//      the float reciprocal. Its primal is the plain path's bit for bit, so
//      it takes the branch on every lane that the recompute it replaces
//      took. Each bounce keeps a record: ray, throughput, the RNG state at
//      its start, the hit, its kind and each light sample's pass/fail;
//   2. the reverse sweep: from the last bounce back to the camera, the
//      adjoints of the throughput, origin and direction are carried back and
//      each bounce's local values are recomputed from its record (the draws
//      replayed from its RNG state). Step functions get no gradient, as
//      under autograd: hit or miss, the nearest hit's choice, occlusion, the
//      light sample's half and wi > 0, total internal reflection, the
//      roulette pick and the orientation signs. The guards of the plain path
//      keep their derivatives: a zero one at sqrt(0) (the double where) and
//      at a clamp's floor, where torch's clamp passes none below it;
//   3. the pass's radiance cotangent is grad_out times the running mean's
//      weight of that pass (running_mean_weights, the host's).
// A sqrt's derivative is taken in float32 as g / (2 sqrt(x)); the plain
// path takes it in float64 and rounds (core/types.sqrt_rn).
//
// Reduction: each warp adds its lanes' sphere gradients into its own
// [10 n + 12] table in shared memory with shared-memory atomics, and keeps
// the camera basis's in registers, summed by a fixed butterfly at the end;
// the block sums its warps' tables in warp order into its row of a partials
// table, and a second kernel sums the rows in a fixed order. Blocks are
// aligned to absolute pixel ids (block b of a launch over rows lo..hi-1
// holds pixels (lo & ~127) + 128 b ...), so a shard's blocks hold the same
// lanes as the whole frame's. Only the order of the shared-memory atomics
// within one warp instruction is up to the hardware.
//
// What bounds it on this card: FP32 work. The replay repeats K1's pass (the
// nearest-hit sweep of ~15 ops a sphere, a shadow sweep of ~12 a sphere per
// light) and the reverse sweep adds a few hundred ops per bounce; device
// memory moves the per-lane record (local memory, 72 bytes per bounce) and
// the lanes' grad_out and seeds. What the design does about it: the scene
// sits in shared memory as in K1 (a float4 record per sphere for the
// sweeps), the nearest hit is kept in the record rather than swept again,
// the shadow tests' outcomes too, and the reverse sweep recomputes the
// bounce's local geometry from the record instead of storing it.
//
// Gradient layout (pt_backward_kernel.py pack_grad): center [n, 3], radius
// [n], emission [n, 3], color [n, 3], then the basis orig, dir, x, y (12).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC -fmad=false. Never --use_fast_math.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kReduceThreads = 256;
constexpr int kRows = 12;          // cx cy cz rad ex ey ez cr cg cb refl emissive
constexpr int kMaxDepth = 16;      // MAX_DEPTH: bounces a record holds
constexpr int kMaxLightWords = 3;  // 96 lights at most: one bit each
constexpr float kEps = 0.01f;      // geomfunc.h:29 EPSILON
constexpr float kInf = 1e20f;      // geomfunc.h:80
constexpr float kTwoPi = 6.2831855f;
constexpr float kFourPi = 12.566371f;
constexpr float kNormFloor = 1e-38f;  // the clamp under a normal's and tdir's root
constexpr float kLenFloor = 1e-20f;   // the clamp of a light sample's length

enum { kMwc = 0, kCounter = 1 };
enum Kind : uint32_t { kLight = 0, kDiff = 1, kSpec = 2, kTir = 3, kRefl = 4, kTrans = 5 };

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

struct V3 {
  float x, y, z;
};
__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 operator*(float s, V3 a) { return v3(s * a.x, s * a.y, s * a.z); }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
// core/types.dot3: left to right.
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
// torch.linalg.cross on the card: a1 * b2 - a2 * b1 as one FMA over the
// rounded second product.
__device__ __forceinline__ V3 cross_t(V3 a, V3 b) {
  return v3(__fmaf_rn(a.y, b.z, -(a.z * b.y)), __fmaf_rn(a.z, b.x, -(a.x * b.z)),
            __fmaf_rn(a.x, b.y, -(a.y * b.x)));
}
// The cross product of the adjoint (no primal to match).
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
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

// ops/intersect.sphere_intersect for one sphere: t, or 0 on a miss.
__device__ __forceinline__ float sphere_t(float4 s, V3 o, V3 d) {
  const V3 op = v3(s.x - o.x, s.y - o.y, s.z - o.z);
  const float b = dot(op, d);
  const float det = b * b - dot(op, op) + s.w * s.w;
  if (!(det >= 0.0f)) return 0.0f;
  const float sq = det > 0.0f ? sqrtf(det) : 0.0f;
  const float t1 = b - sq;
  const float t2 = b + sq;
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

// A bounce's record: its inputs, the RNG state at its start, the hit and
// what the bounce did.
struct Rec {
  V3 o, d, thr;
  float t;
  uint32_t s0, s1;
  int hid;
  uint32_t kind, spec;
  uint32_t ok[kMaxLightWords];  // light k's sample passed (bit k)
};

// The hit's local frame (models/smallpt._bounce): hit point, normal before
// and after normalising, and the oriented normal.
struct Hit {
  V3 hp, n0, n, nl;
  float q, sn, inv, dp, sgn;
};

__device__ __forceinline__ Hit hit_frame(const Scene& S, V3 o, V3 d, float t, int hid) {
  Hit h;
  h.hp = o + t * d;
  h.n0 = h.hp - S.center(hid);
  h.q = dot(h.n0, h.n0);
  h.sn = sqrtf(fmaxf(h.q, kNormFloor));
  h.inv = 1.0f / h.sn;
  h.n = h.n0 * h.inv;
  h.dp = dot(h.n, d);
  h.sgn = h.dp > 0.0f ? -1.0f : 1.0f;  // -_ref_sign(dp)
  h.nl = h.sgn * h.n;
  return h;
}

// One light sample of sample_lights: the draws u1 (second), u2 (first).
struct Light {
  V3 usp, sd0, sd;
  float len2, length, ls, wo, wi, a1, a2, s;
  bool cand;  // the sample's half and wi > 0
};

__device__ __forceinline__ Light light_sample(const Scene& S, int li, float u1, float u2, V3 hp,
                                              V3 nl) {
  Light L;
  const float zz = 1.0f - 2.0f * u1;
  const float rr = sqrtf(fmaxf(1.0f - zz * zz, 0.0f));
  const float phi = kTwoPi * u2;
  L.usp = v3(rr * cosf(phi), rr * sinf(phi), zz);
  const float R = S.radius(li);
  L.sd0 = (R * L.usp + S.center(li)) - hp;
  L.len2 = dot(L.sd0, L.sd0);
  L.length = L.len2 > 0.0f ? sqrtf(L.len2) : 0.0f;
  L.ls = fmaxf(L.length, kLenFloor);
  L.sd = v3(L.sd0.x / L.ls, L.sd0.y / L.ls, L.sd0.z / L.ls);
  L.wo = dot(L.sd, L.usp);
  L.wi = dot(L.sd, nl);
  L.a1 = kFourPi * R;
  L.a2 = L.a1 * R;
  L.s = L.a2 * L.wi * (-L.wo) / (L.ls * L.ls);
  L.cand = !(L.wo > 0.0f) && L.wi > 0.0f;
  return L;
}

// ops/sampling.cosine_sample_dir.
struct CosDir {
  V3 a, u0, u, v, w;
  float un, uinv, ca, sa, wz;
};

__device__ __forceinline__ V3 cosine_dir(V3 nl, float r1u, float r2u, CosDir& c) {
  const float r1 = kTwoPi * r1u;
  const float r2s = sqrtf(r2u);
  c.w = nl;
  c.a = fabsf(nl.x) > 0.1f ? v3(0.0f, 1.0f, 0.0f) : v3(1.0f, 0.0f, 0.0f);
  c.u0 = cross_t(c.a, c.w);
  c.un = sqrtf(dot(c.u0, c.u0));
  c.uinv = 1.0f / c.un;
  c.u = c.u0 * c.uinv;
  c.v = cross_t(c.w, c.u);
  c.ca = cosf(r1) * r2s;
  c.sa = sinf(r1) * r2s;
  c.wz = sqrtf(fmaxf(1.0f - r2u, 0.0f));
  return c.u * c.ca + c.v * c.sa + c.w * c.wz;
}

// The REFR branch's smooth part, for a lane without total internal
// reflection.
struct Refr {
  V3 td0, td;
  float nnt, ddn, cos2t, sc, si, kk, tq, ts, tinv, c1, m1, m2, m3, m4, re, p, rp, tp;
  bool into, tir;
};

__device__ __forceinline__ void refr_frame(V3 d, const Hit& h, Refr& r) {
  r.into = dot(h.n, h.nl) > 0.0f;
  r.nnt = r.into ? (1.0f / 1.5f) : 1.5f;
  r.ddn = dot(d, h.nl);
  r.cos2t = 1.0f - r.nnt * r.nnt * (1.0f - r.ddn * r.ddn);
  r.tir = r.cos2t < 0.0f;
  if (r.tir) return;
  r.sc = sqrtf(r.cos2t);
  r.si = r.into ? 1.0f : -1.0f;
  r.kk = r.si * (r.ddn * r.nnt + r.sc);
  r.td0 = r.nnt * d - r.kk * h.n;
  r.tq = dot(r.td0, r.td0);
  r.ts = sqrtf(fmaxf(r.tq, kNormFloor));
  r.tinv = 1.0f / r.ts;
  r.td = r.td0 * r.tinv;
  r.c1 = 1.0f - (r.into ? -r.ddn : dot(r.td, h.n));
  r.m1 = 0.96f * r.c1;  // (1 - r0) * c1, r0 = 0.04
  r.m2 = r.m1 * r.c1;
  r.m3 = r.m2 * r.c1;
  r.m4 = r.m3 * r.c1;
  r.re = 0.04f + r.m4 * r.c1;
  r.p = 0.25f + 0.5f * r.re;
  r.rp = r.re / r.p;
  r.tp = (1.0f - r.re) / (1.0f - r.p);
}

// The derivative of sqrt at s = sqrt(x), given the cotangent g of s.
__device__ __forceinline__ float sqrt_bwd(float g, float s) { return g / (2.0f * s); }

// out = x0 * (1 / sqrt(max(q, floor))), q = x0 . x0: the cotangent of x0.
// clamp passes a gradient only where q >= floor.
__device__ __forceinline__ V3 norm_bwd(V3 g, V3 x0, float inv, float s, float q, float floor) {
  const float g_inv = dot(g, x0);
  const float g_s = -g_inv * (inv * inv);
  const float g_q = q >= floor ? sqrt_bwd(g_s, s) : 0.0f;
  return g * inv + (2.0f * g_q) * x0;
}

// A warp's gradient table in shared memory.
struct Grad {
  float* g;
  int n;
  __device__ __forceinline__ void center(int j, V3 v) const {
    atomicAdd(&g[3 * j], v.x);
    atomicAdd(&g[3 * j + 1], v.y);
    atomicAdd(&g[3 * j + 2], v.z);
  }
  __device__ __forceinline__ void radius(int j, float v) const { atomicAdd(&g[3 * n + j], v); }
  __device__ __forceinline__ void emission(int j, V3 v) const {
    atomicAdd(&g[4 * n + 3 * j], v.x);
    atomicAdd(&g[4 * n + 3 * j + 1], v.y);
    atomicAdd(&g[4 * n + 3 * j + 2], v.z);
  }
  __device__ __forceinline__ void color(int j, V3 v) const {
    atomicAdd(&g[7 * n + 3 * j], v.x);
    atomicAdd(&g[7 * n + 3 * j + 1], v.y);
    atomicAdd(&g[7 * n + 3 * j + 2], v.z);
  }
};

// The replay of one pass: the camera ray's jitter (kcx, kcy), the records
// of its bounces, its radiance.
template <bool DIRECT_ONLY, int RNG>
__device__ __forceinline__ int replay(const Scene& S, const float* cs, float px, float py,
                                      float inv_w, float inv_h, int max_depth, uint32_t& s0,
                                      uint32_t& s1, float& kcx, float& kcy, Rec* recs, V3& rad) {
  const float r1 = draw<RNG>(s0, s1);
  const float r2 = draw<RNG>(s0, s1);
  kcx = (px + (r1 - 0.5f)) * inv_w - 0.5f;
  kcy = (py + (r2 - 0.5f)) * inv_h - 0.5f;
  const V3 rd = v3(cs[6] * kcx + cs[9] * kcy + cs[3], cs[7] * kcx + cs[10] * kcy + cs[4],
                   cs[8] * kcx + cs[11] * kcy + cs[5]);
  V3 o = v3(0.1f * rd.x + cs[0], 0.1f * rd.y + cs[1], 0.1f * rd.z + cs[2]);
  V3 d = rd * (1.0f / sqrtf(dot(rd, rd)));
  V3 thr = v3(1.0f, 1.0f, 1.0f);
  rad = v3(0.0f, 0.0f, 0.0f);
  bool spec = true;
  int nrec = 0;
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
    rec.hid = hid;
    rec.spec = spec;
    for (int w = 0; w < kMaxLightWords; ++w) rec.ok[w] = 0u;
    const Hit h = hit_frame(S, o, d, t, hid);
    if (S.emissive(hid)) {
      if (spec) rad = rad + mul(fabsf(h.dp) * thr, S.emission(hid));
      rec.kind = kLight;
      break;  // a light ends the path
    }
    const float mat = S.refl(hid);
    const V3 c = S.color(hid);
    const V3 tc = mul(thr, c);
    if (mat == 0.0f) {
      V3 ld = v3(0.0f, 0.0f, 0.0f);
      for (int k = 0; k < S.n_lights; ++k) {
        const int li = S.lights[k];
        const float u2 = draw<RNG>(s0, s1);
        const float u1 = draw<RNG>(s0, s1);
        const Light L = light_sample(S, li, u1, u2, h.hp, h.nl);
        if (L.cand && !any_hit(S, h.hp, L.sd, L.length - kEps)) {
          rec.ok[k >> 5] |= 1u << (k & 31);
          ld = ld + L.s * S.emission(li);
        }
      }
      rad = rad + mul(tc, ld);
      rec.kind = kDiff;
      if (DIRECT_ONLY) break;  // RadianceDirectLighting: ends after NEE
      const float r1u = draw<RNG>(s0, s1);
      const float r2u = draw<RNG>(s0, s1);
      CosDir cd;
      d = cosine_dir(h.nl, r1u, r2u, cd);
      thr = tc;
      spec = false;
    } else if (mat == 1.0f) {
      d = d - (2.0f * h.dp) * h.n;
      thr = tc;
      spec = true;
      rec.kind = kSpec;
    } else {
      Refr r;
      refr_frame(d, h, r);
      const V3 refl_dir = d - (2.0f * h.dp) * h.n;
      if (r.tir) {
        d = refl_dir;
        thr = tc;
        rec.kind = kTir;
      } else if (draw<RNG>(s0, s1) < r.p) {
        thr = mul(r.rp * thr, c);
        d = refl_dir;
        rec.kind = kRefl;
      } else {
        thr = mul(r.tp * thr, c);
        d = r.td;
        rec.kind = kTrans;
      }
      spec = true;
    }
    o = h.hp;
  }
  return nrec;
}

// The reverse sweep of one pass with radiance cotangent G: the scene's
// gradients into the warp's table, the camera basis's into gb.
template <bool DIRECT_ONLY, int RNG>
__device__ __forceinline__ void reverse(const Scene& S, const Grad& gt, const float* cs,
                                        const Rec* recs, int nrec, float kcx, float kcy, V3 G,
                                        float* gb) {
  V3 g_o = v3(0.0f, 0.0f, 0.0f), g_d = g_o, g_thr = g_o;
  const V3 zero = g_o;
  for (int i = nrec - 1; i >= 0; --i) {
    const Rec& rec = recs[i];
    const V3 o = rec.o, d = rec.d, thr = rec.thr;
    const int hid = rec.hid;
    const Hit h = hit_frame(S, o, d, rec.t, hid);
    // The cotangents of this bounce's outputs (o, d, thr of the next).
    const V3 g_on = g_o, g_dn = g_d, g_thrn = g_thr;
    g_o = zero;
    g_d = zero;
    g_thr = zero;
    V3 g_hp = rec.kind == kLight ? zero : g_on;
    V3 g_n = zero, g_nl = zero;
    float g_dp = 0.0f;
    if (rec.kind == kLight) {
      if (rec.spec) {
        // rad += (|dp| thr) e
        const float adp = fabsf(h.dp);
        const V3 e = S.emission(hid);
        const V3 g_m = mul(G, e);
        gt.emission(hid, mul(G, adp * thr));
        g_thr = g_m * adp;
        g_dp = dot(g_m, thr) * (h.dp > 0.0f ? 1.0f : (h.dp < 0.0f ? -1.0f : 0.0f));
      }
    } else {
      const V3 c = S.color(hid);
      V3 g_tc = zero;
      if (rec.kind == kDiff) {
        // rad += tc * ld, ld the sum over the passing light samples.
        const V3 tc = mul(thr, c);
        const V3 g_ld = mul(G, tc);
        V3 ld = zero;
        uint32_t s0 = rec.s0, s1 = rec.s1;
        for (int k = 0; k < S.n_lights; ++k) {
          const int li = S.lights[k];
          const float u2 = draw<RNG>(s0, s1);
          const float u1 = draw<RNG>(s0, s1);
          if (!((rec.ok[k >> 5] >> (k & 31)) & 1u)) continue;
          const Light L = light_sample(S, li, u1, u2, h.hp, h.nl);
          const V3 e = S.emission(li);
          ld = ld + L.s * e;
          gt.emission(li, g_ld * L.s);
          // s = ((a2 wi) (-wo)) / (ls ls), a2 = (4 pi R) R
          const float g_s = dot(g_ld, e);
          const float den = L.ls * L.ls;
          const float a3 = L.a2 * L.wi;
          const float a4 = a3 * (-L.wo);
          const float g_a4 = g_s / den;
          const float g_den = -g_s * a4 / (den * den);
          float g_ls = 2.0f * L.ls * g_den;
          const float g_a3 = g_a4 * (-L.wo);
          const float g_wo = -(g_a4 * a3);
          const float g_a2 = g_a3 * L.wi;
          const float g_wi = g_a3 * L.a2;
          float g_R = g_a2 * L.a1 + (g_a2 * S.radius(li)) * kFourPi;
          const V3 g_sd = g_wo * L.usp + g_wi * h.nl;
          g_nl = g_nl + g_wi * L.sd;
          // sd = sd0 / ls, ls = clamp(length, 1e-20), length = sqrt(len2)
          V3 g_sd0 = v3(g_sd.x / L.ls, g_sd.y / L.ls, g_sd.z / L.ls);
          g_ls += -dot(g_sd, L.sd0) / (L.ls * L.ls);
          const float g_len = L.length >= kLenFloor ? g_ls : 0.0f;
          const float g_len2 = L.len2 > 0.0f ? sqrt_bwd(g_len, L.length) : 0.0f;
          g_sd0 = g_sd0 + (2.0f * g_len2) * L.sd0;
          // sd0 = R usp + C - hp
          g_R += dot(g_sd0, L.usp);
          gt.radius(li, g_R);
          gt.center(li, g_sd0);
          g_hp = g_hp - g_sd0;
        }
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
          const V3 g_u0 = norm_bwd(g_u, cd.u0, cd.uinv, cd.un, 1.0f, 0.0f);
          g_w = g_w + cross(g_u0, cd.a);  // u0 = a x w
          g_nl = g_nl + g_w;
          g_tc = g_tc + g_thrn;
        }
      } else {
        if (rec.kind != kTrans) {
          // d' = d - (2 dp) n
          g_d = g_d + g_dn;
          g_n = g_n - (2.0f * h.dp) * g_dn;
          g_dp += 2.0f * (-dot(g_dn, h.n));
        }
        if (rec.kind == kSpec || rec.kind == kTir) g_tc = g_tc + g_thrn;
        if (rec.kind == kRefl || rec.kind == kTrans) {
          Refr r;
          refr_frame(d, h, r);
          // thr' = (scale thr) c, scale rp or tp
          const float sc = rec.kind == kRefl ? r.rp : r.tp;
          const V3 g_st = mul(g_thrn, c);
          gt.color(hid, mul(g_thrn, sc * thr));
          const float g_sc = dot(g_st, thr);
          g_thr = g_thr + g_st * sc;
          float g_re, g_p;
          if (rec.kind == kRefl) {  // rp = re / p
            g_re = g_sc / r.p;
            g_p = -g_sc * r.re / (r.p * r.p);
          } else {  // tp = (1 - re) / (1 - p)
            const float omp = 1.0f - r.p;
            g_re = -(g_sc / omp);
            g_p = g_sc * (1.0f - r.re) / (omp * omp);
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
          V3 g_td = rec.kind == kTrans ? g_dn : zero;
          if (r.into) {
            g_ddn += g_c1;  // c1 = 1 + ddn
          } else {  // c1 = 1 - td . n
            g_td = g_td - g_c1 * h.n;
            g_n = g_n - g_c1 * r.td;
          }
          const V3 g_td0 = norm_bwd(g_td, r.td0, r.tinv, r.ts, r.tq, kNormFloor);
          // td0 = nnt d - kk n
          g_d = g_d + r.nnt * g_td0;
          g_n = g_n - r.kk * g_td0;
          const float g_in = r.si * (-dot(g_td0, h.n));
          g_ddn += g_in * r.nnt;
          // kk = si (ddn nnt + sqrt(cos2t)), cos2t = 1 - nnt^2 (1 - ddn^2)
          const float g_c2 = sqrt_bwd(g_in, r.sc);
          g_ddn += g_c2 * (r.nnt * r.nnt) * 2.0f * r.ddn;
          g_d = g_d + g_ddn * h.nl;
          g_nl = g_nl + g_ddn * d;
        }
      }
      // tc = thr * c
      g_thr = g_thr + mul(g_tc, c);
      gt.color(hid, mul(g_tc, thr));
      g_n = g_n + h.sgn * g_nl;
    }
    // dp = n . d
    g_n = g_n + g_dp * d;
    g_d = g_d + g_dp * h.n;
    const V3 g_n0 = norm_bwd(g_n, h.n0, h.inv, h.sn, h.q, kNormFloor);
    g_hp = g_hp + g_n0;
    // hp = o + t d
    const float g_t = dot(g_hp, d);
    g_o = g_o + g_hp;
    g_d = g_d + rec.t * g_hp;
    // t = b - sq or b + sq; det = b b - op . op + r r; op = C - o
    const V3 C = S.center(hid);
    const float r = S.radius(hid);
    const V3 op = C - o;
    const float b = dot(op, d);
    const float det = b * b - dot(op, op) + r * r;
    const float sq = det > 0.0f ? sqrtf(det) : 0.0f;
    const float sgn_sq = (b - sq) > kEps ? -1.0f : 1.0f;
    const float g_det = det > 0.0f ? sqrt_bwd(sgn_sq * g_t, sq) : 0.0f;
    const float g_b = g_t + 2.0f * b * g_det;
    const V3 g_op = g_b * d - (2.0f * g_det) * op;
    g_d = g_d + g_b * op;
    g_o = g_o - g_op;
    gt.radius(hid, 2.0f * r * g_det);
    gt.center(hid, g_op - g_n0);
  }
  // The camera ray: rd = x kcx + y kcy + dir; o = 0.1 rd + orig; d = rd / |rd|.
  const V3 rd = v3(cs[6] * kcx + cs[9] * kcy + cs[3], cs[7] * kcx + cs[10] * kcy + cs[4],
                   cs[8] * kcx + cs[11] * kcy + cs[5]);
  const float s = sqrtf(dot(rd, rd));
  const V3 g_rd = norm_bwd(g_d, rd, 1.0f / s, s, 1.0f, 0.0f) + 0.1f * g_o;
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

template <bool DIRECT_ONLY, int RNG>
__global__ void __launch_bounds__(kThreads)
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
  int* ls = reinterpret_cast<int*>(gtab + kWarps * P);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    g4[i] = make_float4(scene[i], scene[n + i], scene[2 * n + i], scene[3 * n + i]);
  for (int i = threadIdx.x; i < kRows * n; i += blockDim.x) tab[i] = scene[i];
  if (threadIdx.x < 12) cs[threadIdx.x] = cam[threadIdx.x];
  for (int i = threadIdx.x; i < n_lights; i += blockDim.x) ls[i] = lights[i];
  for (int i = threadIdx.x; i < kWarps * P; i += blockDim.x) gtab[i] = 0.0f;
  __syncthreads();

  const Scene S{g4, tab, ls, n, n_lights};
  const int warp = threadIdx.x >> 5;
  const Grad gt{gtab + warp * P, n};
  float gb[12];
  for (int k = 0; k < 12; ++k) gb[k] = 0.0f;
  const int p = lo_aligned + blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= lo && p < hi) {
    const int lane = p - lo;
    uint32_t s0 = s0_in[lane], s1 = s1_in[lane];
    const V3 go = v3(grad_out[3 * lane], grad_out[3 * lane + 1], grad_out[3 * lane + 2]);
    const float px = (float)(p % width);
    const float py = (float)((height - 1) - p / width);
    V3 acc = v3(0.0f, 0.0f, 0.0f);
    Rec recs[kMaxDepth];
    for (int pass = 0; pass < num_samples; ++pass) {
      float kcx, kcy;
      V3 rad;
      const int nrec = replay<DIRECT_ONLY, RNG>(S, cs, px, py, inv_w, inv_h, max_depth, s0, s1,
                                                kcx, kcy, recs, rad);
      // The plain running mean (accum * k + r) / (k + 1): torch's card
      // kernel divides by a scalar as a product with its reciprocal.
      const float k = (float)pass;
      const float rk = 1.0f / (k + 1.0f);
      acc = v3((acc.x * k + rad.x) * rk, (acc.y * k + rad.y) * rk, (acc.z * k + rad.z) * rk);
      reverse<DIRECT_ONLY, RNG>(S, gt, cs, recs, nrec, kcx, kcy, go * weights[pass], gb);
    }
    if (img_out != nullptr) {
      img_out[3 * lane] = acc.x;
      img_out[3 * lane + 1] = acc.y;
      img_out[3 * lane + 2] = acc.z;
    }
  }
  // The basis: a fixed butterfly over the warp, then lane 0 into the table.
  for (int k = 0; k < 12; ++k) {
    float v = gb[k];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
    gb[k] = v;
  }
  __syncwarp();
  if ((threadIdx.x & 31) == 0)
    for (int k = 0; k < 12; ++k) gt.g[10 * n + k] += gb[k];
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

template <bool DIRECT_ONLY, int RNG>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int P = 10 * a.n + 12;
  const size_t smem = sizeof(float4) * a.n + sizeof(float) * (kRows * a.n + 12 + kWarps * P) +
                      sizeof(int) * a.n_lights;
  const int lo_aligned = a.lo & ~(kThreads - 1);
  const int blocks = (a.hi - lo_aligned + kThreads - 1) / kThreads;
  pt_backward_kernel<DIRECT_ONLY, RNG><<<blocks, kThreads, smem, stream>>>(
      a.scene, a.n, a.lights, a.n_lights, a.cam, a.s0, a.s1, a.grad_out, a.weights,
      a.num_samples, a.lo, a.hi, lo_aligned, a.width, a.height, a.inv_w, a.inv_h, a.max_depth,
      a.partials, a.img_out);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  reduce_partials<<<P, kReduceThreads, 0, stream>>>(a.partials, blocks, P, a.out);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. scene: [12, n] float32
// (pack_scene); lights: [n_lights] int32; cam: [12] float32 (orig, dir, x,
// y); s0/s1: [hi - lo] uint32, the plain path's seeds of pixels lo..hi-1;
// grad_out: [hi - lo, 3] float32; weights: [num_samples] float32;
// partials: [blocks, 10 n + 12] float32 scratch, blocks =
// pt_backward_blocks(lo, hi); out: [10 n + 12] float32; img_out: [hi - lo,
// 3] float32 or null. max_depth <= 16, n <= 96. Returns cudaGetLastError()
// after the launches (0 = cudaSuccess).
extern "C" int pt_backward_cuda(const float* scene, int n, const int* lights, int n_lights,
                                const float* cam, const uint32_t* s0, const uint32_t* s1,
                                const float* grad_out, const float* weights, int num_samples,
                                int lo, int hi, int width, int height, float inv_w, float inv_h,
                                int max_depth, int direct_only, int rng_counter, float* partials,
                                float* out, float* img_out, void* stream) {
  if (max_depth > kMaxDepth || n_lights > 32 * kMaxLightWords || hi <= lo)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{scene, n, lights, n_lights, cam, s0, s1, grad_out, weights, num_samples, lo, hi,
               width, height, inv_w, inv_h, max_depth, partials, out, img_out};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (direct_only) {
    err = rng_counter ? launch<true, kCounter>(a, st) : launch<true, kMwc>(a, st);
  } else {
    err = rng_counter ? launch<false, kCounter>(a, st) : launch<false, kMwc>(a, st);
  }
  return static_cast<int>(err);
}

// The number of blocks (rows of partials) of a launch over pixels lo..hi-1.
extern "C" int pt_backward_blocks(int lo, int hi) {
  const int lo_aligned = lo & ~(kThreads - 1);
  return (hi - lo_aligned + kThreads - 1) / kThreads;
}

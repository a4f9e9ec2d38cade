// K4 and K5 on Hopper: the raytracer5 ("whitted5") tracer, with the bilinear
// texel fetch inside it.
//
// K4 replaces the TPU kernel se195_raytracer_tpu/kernels/whitted5_kernel.py
// _make_whitted5_level_kernel (launched per tree level by
// _whitted5_level_pallas, driven by whitted5_trace_pallas), together with the
// XLA glue that whitted5_trace_pallas runs between levels. K5 replaces
// kernels/texel_kernel.py _make_texel_kernel (_texel_pallas,
// texel_fetch_mxu): GetTexel's bilinear fetch, which the TPU computes as
// one-hot matrix products because it has no per-lane gather. Here it is a
// gather, `texel` below, called by K4 at every textured hit; the
// `texel_fetch` entry exposes it alone for its own check and its timing.
//
// K4 computes, per primary ray and pass, the reflect/refract tree of
// models/whitted5.whitted5_trace (depth <= 5): the nearest hit over spheres,
// one-sided planes and boxes (first minimum, a hit below 1e6); CalcShade for
// sphere lights and box area lights (n_samp jittered grid samples, counter
// RNG draws); Phong-20; the texture-modulated color; Beer's law with the
// node's own distance; the glossy disc sample on levels < 3; the refraction
// child. All spp passes run in one launch.
//
// What bounds it on this card: FP32 compute. A lit node costs a nearest
// sweep over the N primitives and one more sweep per shadow sample; a box
// test is six IEEE divisions and 18 compares, and the shadow sweeps were
// most of the work (5 per live node on room5, each testing all 5 boxes).
// Device memory sees the rays and RNG state in, the [R, 3] color out, and
// one texel fetch per textured hit (the texel units stay in L2: 16 B a
// texel, 2 x 64 x 64 procedural, 2 x 200 x 200 for the 200 x 200 assets).
// What the design does about it:
//   * one thread per primary ray walks its whole tree depth first, with a
//     per-thread stack of pending refraction children: no [K*R] node buffers
//     and no launch per level; dead subtrees are never visited;
//   * every node draws from its own stream (key mixed with its heap id,
//     counter from the pass's counter), so the walk order does not change
//     one draw; each node that hits writes its contribution into a
//     per-thread slot by heap id, and the slots are summed level by level
//     in node-major order, the order in which the plain version sums them;
//   * the shadow test runs the light's own candidate first and stops at the
//     first primitive that the first minimum would take instead; where
//     neither the diffuse nor the specular term can use a light's shade, its
//     shadow rays are not traced at all (their draws still advance the
//     counter);
//   * each sweep tests a box exactly only when a slab test of the ray
//     against the EPSILON-widened box, from the ray's reciprocal direction,
//     cannot rule out a hit below the running best (nearest) or the light's
//     distance (shadow): box_maybe argues why that is exact;
//   * the [27, N] table, the per-primitive tables, float4 geometry records
//     (a box's corners and widened corners made once per block), and the
//     sphere, plane, box and light index lists sit in shared memory.
//
// K5 alone is a gather of 25 B of useful data per lane from an atlas in L2.
// Read from the [texels, 3] float atlas it was 12 scalar loads over two
// rows (2-6 sectors) and six integer divisions by a runtime size; sm_90
// has no divide instruction, so each is some 20 instructions. The design
// reads 16-byte texel units built once per scene
// (texel_kernel.pack_texel_units), in one of two forms chosen per texture
// by its data and named in its table row:
//   * where every texel is k/256 (the reference's TGA assets), unit (v, u)
//     holds the texel's bilinear quad, its four corners with the wrap baked
//     in, as 12 bytes of u8: a fetch is one aligned 128-bit load, and
//     k * (1/256) gives each corner's float bit for bit;
//   * any other texture keeps its texels as float32 RGBA: four 128-bit
//     loads, none across a sector, u2 and v2 wrapped by a compare. (A
//     64-byte float quad, three loads in one segment, took 1.26x the time
//     on random lanes in four times the memory.)
// Either way u1 and v1 take one `%` and a conditional add each.
//
// Rounding: built with -fmad=false, so every a * b + c rounds twice, as the
// plain version's separate tensor ops do; the expressions keep its order.
// x^20 is the multiply chain of the plain version; Beer's law uses expf
// (never __expf); the texel wrap is a floor modulo, as torch's and JAX's `%`,
// and the texel blend keeps GetTexel's order, c1 w1 + c2 w2 + c3 w3 + c4 w4.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC -fmad=false. Never --use_fast_math.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Threads per block and the __launch_bounds__ minimum of resident blocks
// per SM, chosen by measuring (kernel_ab.py on edited copies): 80 registers and 6
// blocks per SM (at 1, 119 registers and 4 blocks took 1.11x the time).
constexpr int kThreads = 128;
constexpr int kMinBlocks = 6;
constexpr int kRows = 27;  // pack_whitted5_scene rows
constexpr int kMaxDepth = 5;
constexpr int kMaxNodes = (1 << kMaxDepth) - 1;
constexpr float kEps = 0.001f;   // EPSILON5 (raytracer5 common.h:27)
constexpr float kMaxDist = 1e6f;  // find_nearest's max_dist
constexpr float kBeer = 0.15f;
constexpr double kPiD = 3.1415927410125732;  // float32(pi)
constexpr float kPi = static_cast<float>(kPiD);
constexpr float kTwoPi = static_cast<float>(2.0 * kPiD);
constexpr float kInvPi = static_cast<float>(1.0 / kPiD);
constexpr float kTwoOverPi = static_cast<float>(2.0 / kPiD);
constexpr uint32_t kPassBudget = 1024u;  // PASS_DRAW_BUDGET

enum { kSphere = 0, kPlane = 1, kBox = 2 };

// Texture forms of the texel units (TEX_F32, TEX_U8 in texel_kernel.py).
enum { kTexF32 = 0, kTexU8 = 1 };

// pack_whitted5_scene rows.
enum {
  R_CX, R_CY, R_CZ, R_RAD, R_NX, R_NY, R_NZ, R_DEPTH, R_BPX, R_BPY, R_BPZ,
  R_BSX, R_BSY, R_BSZ, R_COLR, R_COLG, R_COLB, R_REFL, R_REFR, R_RIDX,
  R_DIFF, R_SPEC, R_DREFL, R_SNX, R_SNY, R_SNZ, R_RRAD
};

// Box::Light's 4x4 grid cell origins in units of size/4 (scene.cpp:381-396).
__constant__ float kGrid[16][2] = {
    {1, 2}, {3, 3}, {2, 0}, {0, 1}, {2, 3}, {0, 3}, {0, 0}, {2, 2},
    {3, 1}, {1, 3}, {1, 0}, {3, 2}, {2, 1}, {3, 0}, {1, 1}, {0, 2}};

// Per primitive, four float4 geometry records in shared memory, built once
// per block from the [27, n] table: a sphere (cx, cy, cz, rad), a plane (nx,
// ny, nz, depth), a box (v1, -), (v2, -), (lo, -), (hi, -) with v2 = v1 +
// size, lo = v1 - EPSILON, hi = v2 + EPSILON, the float32 sums the exact box
// test makes (box_records in whitted5_kernel.py makes the same on the host).
constexpr int kGeo = 4;

struct Scene {
  const float* t;      // [kRows, n]
  const float* uvs;    // [2, n] uv scale
  const int* type;     // [n]
  const int* light;    // [n] 1 for a light
  const int* tex;      // [n] texture id or -1
  const int* textab;   // [n_tex, 4] (texel offset, th, tw, form)
  const uint4* units;  // the texel units, in device memory
  const float4* geo;   // [n, kGeo]
  // Primitive indices by type, ascending, and the lights.
  const int* spheres;
  const int* planes;
  const int* boxes;
  const int* lights;
  int n, n_spheres, n_planes, n_boxes, n_lights;
  float big;  // the largest |coordinate| of any box's lo or hi
  __device__ float at(int row, int j) const { return t[row * n + j]; }
};

// Floor modulo for m > 0 with one division: C's truncating remainder, then
// m added where it is negative. The same integer as ((a % m) + m) % m for
// every int a (texel_kernel.floor_mod mirrors it).
__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// Corner k (byte k) of a u8 quad channel word, as the float k/256.
__device__ __forceinline__ float u8_corner(uint32_t word, int k) {
  return static_cast<float>((word >> (8 * k)) & 0xFFu) * (1.0f / 256.0f);
}

// K5: Texture::GetTexel (scene.cpp:81-106) with its quirks, the arithmetic of
// models/whitted5._texel: v is scaled by the width, the wrap is a floor
// modulo, and the blend is c1 w1 + c2 w2 + c3 w3 + c4 w4, left to right.
// Reads a texture of th x tw texels from `units` (the texel units, see the
// header) at texel `off`, in its form.
__device__ __forceinline__ void texel(const uint4* __restrict__ units, int off,
                                      int th, int tw, int form, float u,
                                      float v, float& r, float& g, float& b) {
  const float ftw = static_cast<float>(tw);
  const float fu = (u + 1000.5f) * ftw;
  const float fv = (v + 1000.0f) * ftw;
  const float flu = floorf(fu);
  const float flv = floorf(fv);
  const int u1 = floor_mod(static_cast<int>(flu), tw);
  const int v1 = floor_mod(static_cast<int>(flv), th);
  const float fracu = fu - flu;
  const float fracv = fv - flv;
  const float w1 = (1.0f - fracu) * (1.0f - fracv);
  const float w2 = fracu * (1.0f - fracv);
  const float w3 = (1.0f - fracu) * fracv;
  const float w4 = fracu * fracv;
  const uint4* t = units + off;
  float4 cr, cg, cb;  // per channel, the corners c1..c4
  if (form == kTexU8) {
    const uint4 q = __ldg(t + v1 * tw + u1);
    cr = make_float4(u8_corner(q.x, 0), u8_corner(q.x, 1), u8_corner(q.x, 2),
                     u8_corner(q.x, 3));
    cg = make_float4(u8_corner(q.y, 0), u8_corner(q.y, 1), u8_corner(q.y, 2),
                     u8_corner(q.y, 3));
    cb = make_float4(u8_corner(q.z, 0), u8_corner(q.z, 1), u8_corner(q.z, 2),
                     u8_corner(q.z, 3));
  } else {
    const int u2 = u1 + 1 == tw ? 0 : u1 + 1;
    const int v2 = v1 + 1 == th ? 0 : v1 + 1;
    const float4* f = reinterpret_cast<const float4*>(t);
    const float4 c1 = __ldg(f + v1 * tw + u1), c2 = __ldg(f + v1 * tw + u2);
    const float4 c3 = __ldg(f + v2 * tw + u1), c4 = __ldg(f + v2 * tw + u2);
    cr = make_float4(c1.x, c2.x, c3.x, c4.x);
    cg = make_float4(c1.y, c2.y, c3.y, c4.y);
    cb = make_float4(c1.z, c2.z, c3.z, c4.z);
  }
  r = cr.x * w1 + cr.y * w2 + cr.z * w3 + cr.w * w4;
  g = cg.x * w1 + cg.y * w2 + cg.z * w3 + cg.w * w4;
  b = cb.x * w1 + cb.y * w2 + cb.z * w3 + cb.w * w4;
}

__device__ __forceinline__ float pow20(float x) {
  const float x2 = x * x;
  const float x5 = x2 * x2 * x;
  const float x10 = x5 * x5;
  return x10 * x10;
}

// arccos of a clipped cosine with exact endpoints (models/whitted5._arccos1).
__device__ __forceinline__ float arccos1(float x) {
  if (fabsf(x) >= 1.0f) return x >= 1.0f ? 0.0f : kPi;
  return acosf(x);
}

// core/rng.counter_next: hash (key, counter), then increment the counter.
__device__ __forceinline__ float draw(uint32_t key, uint32_t& ctr) {
  uint32_t x = key ^ (ctr * 0x9E3779B9u);
  x ^= x >> 16;
  x *= 0x21F0AAADu;
  x ^= x >> 15;
  x *= 0x735A2D97u;
  x ^= x >> 15;
  ctr += 1u;
  return static_cast<float>(x >> 8) * (1.0f / 16777216.0f);
}

// models/whitted5._node_key.
__device__ __forceinline__ uint32_t node_key(uint32_t key, uint32_t heap) {
  uint32_t x = key ^ (heap * 0x9E3779B9u + 0x7F4A7C15u);
  x ^= x >> 16;
  x *= 0x21F0AAADu;
  x ^= x >> 15;
  return x;
}

// Candidate hits (models/whitted5._prim_candidates), each returning whether
// it is valid and its distance. A sphere also says whether it is entered
// from inside.
__device__ __forceinline__ bool sphere_hit(float4 g, float ox, float oy,
                                           float oz, float dx, float dy,
                                           float dz, float& dist,
                                           bool& inprim) {
  const float vx = ox - g.x;
  const float vy = oy - g.y;
  const float vz = oz - g.z;
  const float sb = -(vx * dx + vy * dy + vz * dz);
  const float rad = g.w;
  const float det = sb * sb - (vx * vx + vy * vy + vz * vz) + rad * rad;
  bool ok = det > 0.0f;
  const float sq = sqrtf(ok ? det : 1.0f);
  const float i1 = sb - sq;
  const float i2 = sb + sq;
  ok = ok && i2 > 0.0f;
  inprim = i1 < 0.0f;
  dist = inprim ? i2 : i1;
  return ok;
}

__device__ __forceinline__ bool plane_hit(float4 g, float ox, float oy,
                                          float oz, float dx, float dy,
                                          float dz, float& dist) {
  const float pd = g.x * dx + g.y * dy + g.z * dz;
  const float no = g.x * ox + g.y * oy + g.z * oz;
  const float pd_safe = pd != 0.0f ? pd : 1.0f;
  dist = -(no + g.w) / pd_safe;
  return pd < 0.0f;
}

// Box: six slab faces, the smallest positive one whose hit point lies in
// the box with +-EPSILON slack (scene.cpp:306-350). g: the four records.
// Kept out of line: inlined at its three call sites it made K4 1.10x
// slower (kernel_ab.py).
__device__ __noinline__ bool box_hit(const float4* g, float ox, float oy,
                                     float oz, float dx, float dy, float dz,
                                     float& dist) {
  const float o3[3] = {ox, oy, oz};
  const float d3[3] = {dx, dy, dz};
  const float v1[3] = {g[0].x, g[0].y, g[0].z};
  const float v2[3] = {g[1].x, g[1].y, g[1].z};
  const float lo[3] = {g[2].x, g[2].y, g[2].z};
  const float hi[3] = {g[3].x, g[3].y, g[3].z};
  float bd = 1e30f;
  bool bok = false;
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    const float d_a = d3[axis];
    const float d_safe = d_a != 0.0f ? d_a : 1.0f;
    const bool axis_ok = d_a != 0.0f;
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const float bound = side ? v2[axis] : v1[axis];
      const float t_f = (bound - o3[axis]) / d_safe;
      bool inside = true;
#pragma unroll
      for (int a2 = 0; a2 < 3; ++a2) {
        const float ip = o3[a2] + t_f * d3[a2];
        inside = inside && ip > lo[a2] && ip < hi[a2];
      }
      const bool face_ok = axis_ok && t_f > 0.0f && inside;
      if (face_ok && t_f < bd) bd = t_f;
      bok = bok || face_ok;
    }
  }
  dist = bd;
  return bok;
}

// Primitive j of any type.
__device__ __forceinline__ bool candidate(const Scene& s, int j, float ox,
                                          float oy, float oz, float dx,
                                          float dy, float dz, float& dist,
                                          bool& inprim) {
  inprim = false;
  const int ty = s.type[j];
  const float4* g = s.geo + kGeo * j;
  if (ty == kSphere) return sphere_hit(g[0], ox, oy, oz, dx, dy, dz, dist, inprim);
  if (ty == kPlane) return plane_hit(g[0], ox, oy, oz, dx, dy, dz, dist);
  return box_hit(g, ox, oy, oz, dx, dy, dz, dist);
}

// The box prefilter: a slab test of the ray against the EPSILON-widened box
// [lo, hi], from the ray's reciprocal direction, computed once per sweep.
// It skips box j when no face hit that box_hit counts can lie at or below
// `limit`: the slab interval [lo_t, hi_t] is empty, ends at or before 0, or
// starts beyond the limit.
//
// Why skipping is exact. A face hit that box_hit counts has a computed hit
// point ip inside (lo, hi) on every axis: ip = fl(o + fl(t d)) lies within
// u (|ip| + |t d|) (1 + 2u) of the real point o + t d (u = 2^-24), and
// |ip| < M, |t d| <= M (1 + u) + |o| for M = max(|lo|, |hi|). So the real
// point at the computed t lies in the box widened by e = kAbs (2 big + |o|)
// on each axis (kAbs = 1e-6 ~ 17u covers the ~3u needed; big bounds M over
// all boxes). On an axis with |d| >= kFlat, t then lies in that widened
// slab, [(lo - o)/d, (hi - o)/d] +- e / |d|; the kernel computes the slab
// bounds as (lo - o) * (1/d), within 3u of their value relative to
// themselves, which kRel = 1e-6 covers (min, max and their composition are
// monotone, so the relative margin can be applied to tn and tf once), and
// m, the largest e / |d| over the ray's axes, covers the widening. On an
// axis with |d| < kFlat (0 included) a hit at t <= 1e6 moves the point by
// under 1e-24, far inside e (>= 2e-9, since hi - lo >= 2 EPSILON): the ray
// can meet the box only if lo - e < o < hi + e. Every limit is at most
// MAX_DIST (nearest sweep) or a light's distance (shadow test).
// tests/test_torch_whitted5.py checks the interval against every valid box
// candidate of small room5 traces, with axis-parallel rays, and of rays that
// graze the boxes' edges, as built and scaled 10x and moved 1000 away with
// the rays started 1e5 back; there, without its margins, it loses hits and
// gets nearest hits wrong.
constexpr float kRel = 1e-6f;
constexpr float kAbs = 1e-6f;
constexpr float kFlat = 1e-30f;

struct RaySlab {
  float ox, oy, oz;
  float ix, iy, iz;  // 1 / d on the axes that are not flat
  float ex, ey, ez;  // the widening e per axis
  float m;           // the largest e / |d| over the axes that are not flat
  bool fx, fy, fz;   // |d| < kFlat
};

__device__ __forceinline__ RaySlab ray_slab(float ox, float oy, float oz,
                                            float dx, float dy, float dz,
                                            float big) {
  RaySlab r;
  r.ox = ox;
  r.oy = oy;
  r.oz = oz;
  r.fx = fabsf(dx) < kFlat;
  r.fy = fabsf(dy) < kFlat;
  r.fz = fabsf(dz) < kFlat;
  r.ix = 1.0f / (r.fx ? 1.0f : dx);
  r.iy = 1.0f / (r.fy ? 1.0f : dy);
  r.iz = 1.0f / (r.fz ? 1.0f : dz);
  const float big2 = 2.0f * big;
  r.ex = (big2 + fabsf(ox)) * kAbs;
  r.ey = (big2 + fabsf(oy)) * kAbs;
  r.ez = (big2 + fabsf(oz)) * kAbs;
  r.m = fmaxf(fmaxf(r.fx ? 0.0f : r.ex * fabsf(r.ix),
                    r.fy ? 0.0f : r.ey * fabsf(r.iy)),
              r.fz ? 0.0f : r.ez * fabsf(r.iz));
  return r;
}

// One axis of the slab test: narrows [tn, tf], or clears `in` where a flat
// axis's origin lies outside the widened slab.
__device__ __forceinline__ void slab_axis(float lo, float hi, float o,
                                          float inv, float e, bool flat,
                                          float& tn, float& tf, bool& in) {
  if (flat) {
    in = in && o > lo - e && o < hi + e;
  } else {
    const float t1 = (lo - o) * inv;
    const float t2 = (hi - o) * inv;
    tn = fmaxf(tn, fminf(t1, t2));
    tf = fminf(tf, fmaxf(t1, t2));
  }
}

__device__ __forceinline__ bool box_maybe(const float4* g, const RaySlab& r,
                                          float limit) {
  const float4 lo = g[2], hi = g[3];
  float tn = -__int_as_float(0x7f800000), tf = __int_as_float(0x7f800000);
  bool in = true;
  slab_axis(lo.x, hi.x, r.ox, r.ix, r.ex, r.fx, tn, tf, in);
  slab_axis(lo.y, hi.y, r.oy, r.iy, r.ey, r.fy, tn, tf, in);
  slab_axis(lo.z, hi.z, r.oz, r.iz, r.ez, r.fz, tn, tf, in);
  const float lo_t = tn - kRel * fabsf(tn) - r.m;
  const float hi_t = tf + kRel * fabsf(tf) + r.m;
  return in && lo_t <= hi_t && hi_t > 0.0f && !(lo_t > limit);
}

// The nearest hit: the first minimum over the valid candidates in ascending
// primitive order (models/whitted5._first_min). Swept by type, spheres and
// planes first, then the boxes behind the prefilter against the running best
// (capped at MAX_DIST: a nearest hit at or beyond it is a miss, whichever
// primitive it is); a candidate is taken when (dist, j) is below the running
// (best, amin), which gives the first minimum in any order (NaN is never
// taken). Returns its index (0 when none is valid) and sets best (+inf when
// none) and inprim.
__device__ int nearest(const Scene& s, float ox, float oy, float oz, float dx,
                       float dy, float dz, float& best, bool& inprim) {
  best = __int_as_float(0x7f800000);
  inprim = false;
  int amin = s.n;
  for (int k = 0; k < s.n_spheres; ++k) {
    const int j = s.spheres[k];
    float dist;
    bool inp;
    if (sphere_hit(s.geo[kGeo * j], ox, oy, oz, dx, dy, dz, dist, inp) &&
        (dist < best || (dist == best && j < amin))) {
      best = dist;
      amin = j;
      inprim = inp;
    }
  }
  for (int k = 0; k < s.n_planes; ++k) {
    const int j = s.planes[k];
    float dist;
    if (plane_hit(s.geo[kGeo * j], ox, oy, oz, dx, dy, dz, dist) &&
        (dist < best || (dist == best && j < amin))) {
      best = dist;
      amin = j;
      inprim = false;
    }
  }
  if (s.n_boxes > 0) {
    const RaySlab r = ray_slab(ox, oy, oz, dx, dy, dz, s.big);
    for (int k = 0; k < s.n_boxes; ++k) {
      const int j = s.boxes[k];
      const float4* g = s.geo + kGeo * j;
      float dist;
      if (box_maybe(g, r, fminf(best, kMaxDist)) &&
          box_hit(g, ox, oy, oz, dx, dy, dz, dist) &&
          (dist < best || (dist == best && j < amin))) {
        best = dist;
        amin = j;
        inprim = false;
      }
    }
  }
  return amin == s.n ? 0 : amin;
}

// CalcShade's visibility: is the nearest primitive within maxt the light
// `target` (best < maxt && first minimum == target)? Target first: dark when
// its candidate is invalid or not below maxt; else any other primitive j
// whose valid candidate is nearer than the target's d_t, or as near with
// j < target, is one that the first minimum's ascending strict-< scan takes
// instead, and the test stops there. The order is free: the boxes, behind
// the prefilter against d_t, then the spheres and the planes.
__device__ bool visible(const Scene& s, float ox, float oy, float oz,
                        float dx, float dy, float dz, float maxt, int target) {
  float d_t;
  bool inp;
  if (!candidate(s, target, ox, oy, oz, dx, dy, dz, d_t, inp) || !(d_t < maxt))
    return false;
  if (s.n_boxes > 0) {
    const RaySlab r = ray_slab(ox, oy, oz, dx, dy, dz, s.big);
    for (int k = 0; k < s.n_boxes; ++k) {
      const int j = s.boxes[k];
      const float4* g = s.geo + kGeo * j;
      float dist;
      if (j != target && box_maybe(g, r, d_t) &&
          box_hit(g, ox, oy, oz, dx, dy, dz, dist) &&
          (dist < d_t || (dist == d_t && j < target)))
        return false;
    }
  }
  for (int k = 0; k < s.n_spheres; ++k) {
    const int j = s.spheres[k];
    float dist;
    if (j != target &&
        sphere_hit(s.geo[kGeo * j], ox, oy, oz, dx, dy, dz, dist, inp) &&
        (dist < d_t || (dist == d_t && j < target)))
      return false;
  }
  for (int k = 0; k < s.n_planes; ++k) {
    const int j = s.planes[k];
    float dist;
    if (j != target && plane_hit(s.geo[kGeo * j], ox, oy, oz, dx, dy, dz, dist) &&
        (dist < d_t || (dist == d_t && j < target)))
      return false;
  }
  return true;
}

// A tree node: its ray, weight, Beer absorbance and refractive index.
struct Node {
  float ox, oy, oz, dx, dy, dz;
  float wr, wg, wb;
  float br, bg, bb;
  float ridx;
  int heap;
  int level;
};

struct Params {
  const float* o;  // [n_sets, r, 3]
  const float* d;
  int n_sets;
  int r;
  const uint32_t* key;  // [r]
  const uint32_t* ctr;  // [r]
  int spp;
  int depth;
  int nsamp[kMaxDepth];  // box-light samples at levels 1..depth
  float div;
  float* out;       // [r, 3]
  int* prim_idx;    // [r] or null
};

// One pass of one primary ray: the contribution of each node that hits by
// heap id into c*, its bit set in `live`. Returns the level-1 hit id (-1 on
// a miss).
__device__ int trace_pass(const Scene& s, const Params& p, Node root,
                          uint32_t key_in, uint32_t ctr_pass, float* cr,
                          float* cg, float* cb, uint32_t& live) {
  Node stack[kMaxDepth];
  int top = 0;
  int primary = -1;
  Node nd = root;
  while (true) {
    bool next = false;
    float best;
    bool inprim;
    const int amin = nearest(s, nd.ox, nd.oy, nd.oz, nd.dx, nd.dy, nd.dz,
                             best, inprim);
    const bool hit = best < kMaxDist;
    if (nd.heap == 0) primary = hit ? amin : -1;
    if (hit) {
      const int idx = amin;
      const float dist = best;
      const float px = nd.ox + nd.dx * dist;
      const float py = nd.oy + nd.dy * dist;
      const float pz = nd.oz + nd.dz * dist;
      // Beer's law with this node's own travel distance.
      const float er = nd.wr * expf(nd.br * (-dist));
      const float eg = nd.wg * expf(nd.bg * (-dist));
      const float eb = nd.wb * expf(nd.bb * (-dist));
      const float m_r = s.at(R_COLR, idx), m_g = s.at(R_COLG, idx),
                  m_b = s.at(R_COLB, idx);
      live |= 1u << nd.heap;
      if (s.light[idx]) {
        // A light that is hit returns its color and spawns nothing.
        cr[nd.heap] = er * m_r;
        cg[nd.heap] = eg * m_g;
        cb[nd.heap] = eb * m_b;
      } else {
        uint32_t key = node_key(key_in, static_cast<uint32_t>(nd.heap));
        uint32_t ctr = ctr_pass;
        const bool sphere = s.type[idx] == kSphere;
        // Texture-modulated color (Primitive::GetColor, K5 inside).
        float col_r = m_r, col_g = m_g, col_b = m_b;
        const int tid = s.tex[idx];
        if (tid >= 0) {
          const float us0 = s.uvs[idx], us1 = s.uvs[s.n + idx];
          float uc, vc;
          if (sphere) {
            const float rr = s.at(R_RRAD, idx);
            const float vpx = (px - s.at(R_CX, idx)) * rr;
            const float vpy = (py - s.at(R_CY, idx)) * rr;
            const float vpz = (pz - s.at(R_CZ, idx)) * rr;
            const float cosphi = fminf(fmaxf(-vpy, -1.0f), 1.0f);
            const float phi = arccos1(cosphi);
            const float sinphi = sqrtf(fmaxf(1.0f - cosphi * cosphi, 1e-12f));
            vc = phi * (1.0f / us1) * kInvPi;
            const float costheta = fminf(fmaxf(vpx / sinphi, -1.0f), 1.0f);
            const float theta = arccos1(costheta) * kTwoOverPi;
            uc = (-vpz >= 0.0f ? 1.0f - theta : theta) * (1.0f / us0);
          } else {
            const float n0 = s.at(R_NX, idx), n1 = s.at(R_NY, idx),
                        n2 = s.at(R_NZ, idx);
            const float ua0 = n1, ua1 = n2, ua2 = -n0;
            const float va0 = ua1 * n2 - ua2 * n1;
            const float va1 = ua2 * n0 - ua0 * n2;
            const float va2 = ua0 * n1 - ua1 * n0;
            uc = (px * ua0 + py * ua1 + pz * ua2) * us0;
            vc = (px * va0 + py * va1 + pz * va2) * us1;
          }
          float tr, tg, tb;
          const int* row = s.textab + 4 * tid;
          texel(s.units, row[0], row[1], row[2], row[3], uc, vc, tr, tg, tb);
          col_r = tr * m_r;
          col_g = tg * m_g;
          col_b = tb * m_b;
        }
        float nx, ny, nz;
        if (sphere) {
          const float rr = s.at(R_RRAD, idx);
          nx = (px - s.at(R_CX, idx)) * rr;
          ny = (py - s.at(R_CY, idx)) * rr;
          nz = (pz - s.at(R_CZ, idx)) * rr;
        } else {
          nx = s.at(R_SNX, idx);
          ny = s.at(R_SNY, idx);
          nz = s.at(R_SNZ, idx);
        }
        const float m_diff = s.at(R_DIFF, idx), m_spec = s.at(R_SPEC, idx);
        const int n_samp = p.nsamp[nd.level - 1];
        float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
        for (int k = 0; k < s.n_lights; ++k) {
          const int li = s.lights[k];
          const bool sphere_light = s.type[li] == kSphere;
          // The direction to the light's center.
          float ldx, ldy, ldz, tdist = 0.0f;
          if (sphere_light) {
            const float lvx = s.at(R_CX, li) - px;
            const float lvy = s.at(R_CY, li) - py;
            const float lvz = s.at(R_CZ, li) - pz;
            tdist = sqrtf(fmaxf(lvx * lvx + lvy * lvy + lvz * lvz, 1e-30f));
            ldx = lvx / tdist;
            ldy = lvy / tdist;
            ldz = lvz / tdist;
          } else {
            const float lvx = (s.at(R_BPX, li) + 0.5f * s.at(R_BSX, li)) - px;
            const float lvy = (s.at(R_BPY, li) + 0.5f * s.at(R_BSY, li)) - py;
            const float lvz = (s.at(R_BPZ, li) + 0.5f * s.at(R_BSZ, li)) - pz;
            const float linv =
                1.0f / sqrtf(fmaxf(lvx * lvx + lvy * lvy + lvz * lvz, 1e-30f));
            ldx = lvx * linv;
            ldy = lvy * linv;
            ldz = lvz * linv;
          }
          const float dnl = ldx * nx + ldy * ny + ldz * nz;
          const float k2 = 2.0f * dnl;
          const float rvx = ldx - k2 * nx;
          const float rvy = ldy - k2 * ny;
          const float rvz = ldz - k2 * nz;
          const float dvr = nd.dx * rvx + nd.dy * rvy + nd.dz * rvz;
          const bool diff_on = m_diff > 0.0f && dnl > 0.0f;
          const bool spec_on = m_spec > 0.0f && dvr > 0.0f;
          // The shade enters only through the two terms: where neither can
          // add, its shadow rays are not traced (their draws still advance
          // the counter).
          float shade = 0.0f;
          if (sphere_light) {
            if (diff_on || spec_on)
              shade = visible(s, px + ldx * kEps, py + ldy * kEps, pz + ldz * kEps,
                              ldx, ldy, ldz, tdist, li)
                          ? 1.0f
                          : 0.0f;
          } else if (!(diff_on || spec_on)) {
            ctr += 2u * static_cast<uint32_t>(n_samp);
          } else {
            // Box area light: n_samp jittered grid samples on its bottom
            // face (CalcShade, raytracer.cpp:385-404).
            const float bpx = s.at(R_BPX, li), bpy = s.at(R_BPY, li),
                        bpz = s.at(R_BPZ, li);
            const float bsx = s.at(R_BSX, li), bsz = s.at(R_BSZ, li);
            const float deltax = bsx * 0.25f;
            const float deltay = bsz * 0.25f;
            const float cellx = bsx / 4.0f;
            const float cellz = bsz / 4.0f;
            const float sscale = static_cast<float>(1.0 / n_samp);
            for (int i = 0; i < n_samp; ++i) {
              const float u1 = draw(key, ctr);
              const float u2 = draw(key, ctr);
              const float gx = kGrid[i & 15][0] * cellx + bpx + u1 * deltax;
              const float gz = kGrid[i & 15][1] * cellz + bpz + u2 * deltay;
              const float svx = gx - px, svy = bpy - py, svz = gz - pz;
              const float ldist =
                  sqrtf(fmaxf(svx * svx + svy * svy + svz * svz, 1e-30f));
              const float sdx = svx / ldist, sdy = svy / ldist,
                          sdz = svz / ldist;
              const bool vis = visible(s, px + sdx * kEps, py + sdy * kEps,
                                       pz + sdz * kEps, sdx, sdy, sdz, ldist, li);
              shade = shade + (vis ? 1.0f : 0.0f) * sscale;
            }
          }
          const bool pos_shade = shade > 0.0f;
          const float l_r = s.at(R_COLR, li), l_g = s.at(R_COLG, li),
                      l_b = s.at(R_COLB, li);
          if (pos_shade && diff_on) {
            const float dt = dnl * m_diff * shade;
            acc_r = acc_r + dt * col_r * l_r;
            acc_g = acc_g + dt * col_g * l_g;
            acc_b = acc_b + dt * col_b * l_b;
          }
          if (pos_shade && spec_on) {
            const float st = pow20(fmaxf(dvr, 0.0f)) * m_spec * shade;
            acc_r = acc_r + st * l_r;
            acc_g = acc_g + st * l_g;
            acc_b = acc_b + st * l_b;
          }
        }
        cr[nd.heap] = er * acc_r;
        cg[nd.heap] = eg * acc_g;
        cb[nd.heap] = eb * acc_b;

        if (nd.level < p.depth) {
          // Refraction child (raytracer.cpp:337-359), kept for later.
          const float refr = s.at(R_REFR, idx);
          const float m_ri = s.at(R_RIDX, idx);
          const float ri_safe = m_ri != 0.0f ? m_ri : 1.0f;
          const float n_ratio = nd.ridx / ri_safe;
          const float code = inprim ? -1.0f : 1.0f;
          const float n2x = nx * code, n2y = ny * code, n2z = nz * code;
          const float cos_i = -(n2x * nd.dx + n2y * nd.dy + n2z * nd.dz);
          const float cos_t2 =
              1.0f - n_ratio * n_ratio * (1.0f - cos_i * cos_i);
          if (refr > 0.0f && cos_t2 > 0.0f) {
            const float kk = n_ratio * cos_i - sqrtf(cos_t2);
            const float tdx = n_ratio * nd.dx + kk * n2x;
            const float tdy = n_ratio * nd.dy + kk * n2y;
            const float tdz = n_ratio * nd.dz + kk * n2z;
            Node& c = stack[top++];
            c.ox = px + tdx * kEps;
            c.oy = py + tdy * kEps;
            c.oz = pz + tdz * kEps;
            c.dx = tdx;
            c.dy = tdy;
            c.dz = tdz;
            c.wr = er;
            c.wg = eg;
            c.wb = eb;
            c.br = m_r * kBeer;
            c.bg = m_g * kBeer;
            c.bb = m_b * kBeer;
            c.ridx = ri_safe;
            c.heap = 2 * nd.heap + 2;
            c.level = nd.level + 1;
          }
          // Reflection child, perfect or glossy (raytracer.cpp:287-335),
          // traced next. The glossy pair is drawn after every shade draw.
          const float refl = s.at(R_REFL, idx);
          const float drefl = s.at(R_DREFL, idx);
          const float k2 = 2.0f * (nd.dx * nx + nd.dy * ny + nd.dz * nz);
          float cdx = nd.dx - k2 * nx;
          float cdy = nd.dy - k2 * ny;
          float cdz = nd.dz - k2 * nz;
          if (refl > 0.0f && drefl > 0.0f && nd.level < 3) {
            const float u1 = draw(key, ctr);
            const float u2 = draw(key, ctr);
            const float rad = drefl * sqrtf(u1);
            const float ang = kTwoPi * u2;
            const float xoffs = rad * cosf(ang);
            const float yoffs = rad * sinf(ang);
            // RN1 = (R.z, R.y, -R.x); RN2 = R x RN1 (raytracer.cpp:296-298)
            const float r1x = cdz, r1y = cdy, r1z = -cdx;
            const float r2x = cdy * r1z - cdz * r1y;
            const float r2y = cdz * r1x - cdx * r1z;
            const float r2z = cdx * r1y - cdy * r1x;
            const float yd = yoffs * drefl;
            const float gx = cdx + r1x * xoffs + r2x * yd;
            const float gy = cdy + r1y * xoffs + r2y * yd;
            const float gz = cdz + r1z * xoffs + r2z * yd;
            const float ginv =
                1.0f / sqrtf(fmaxf(gx * gx + gy * gy + gz * gz, 1e-30f));
            cdx = gx * ginv;
            cdy = gy * ginv;
            cdz = gz * ginv;
          }
          if (refl > 0.0f) {
            const float ridx = nd.ridx;
            const int heap = nd.heap;
            nd.ox = px + cdx * kEps;
            nd.oy = py + cdy * kEps;
            nd.oz = pz + cdz * kEps;
            nd.dx = cdx;
            nd.dy = cdy;
            nd.dz = cdz;
            nd.wr = er * refl * col_r;
            nd.wg = eg * refl * col_g;
            nd.wb = eb * refl * col_b;
            nd.br = nd.bg = nd.bb = 0.0f;
            nd.ridx = ridx;
            nd.heap = 2 * heap + 1;
            nd.level += 1;
            next = true;
          }
        }
      }
    }
    if (!next) {
      if (top == 0) break;
      nd = stack[--top];
    }
  }
  return primary;
}

// Shared memory of one block, in 4-byte words: the geometry records, the
// [kRows, n] table, the uv scales, the type, light and texture rows, the
// texture table (four ints a texture), the four index lists and their counts
// (whitted5_kernel.shared_memory_bytes counts the same). Above kSmemDefault
// bytes the launch opts in to more.
constexpr size_t kSmemDefault = 48 * 1024;
__host__ __device__ constexpr size_t smem_words(int n, int n_tex) {
  return static_cast<size_t>(4 * kGeo * n + (kRows + 2) * n + 3 * n + 4 * n_tex +
                             4 * n + 8);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
whitted5_kernel(const float* __restrict__ table, const float* __restrict__ uvs,
                const int* __restrict__ aux, int n,
                const uint4* __restrict__ units,
                const int* __restrict__ textab, int n_tex, Params p) {
  extern __shared__ __align__(16) float smem[];
  float4* geo = reinterpret_cast<float4*>(smem);
  float* st = smem + 4 * kGeo * n;
  float* su = st + kRows * n;
  int* si = reinterpret_cast<int*>(su + 2 * n);
  int* lists = si + 3 * n + 4 * n_tex;  // spheres, planes, boxes, lights
  int* counts = lists + 4 * n;
  for (int i = threadIdx.x; i < kRows * n; i += blockDim.x) st[i] = table[i];
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) su[i] = uvs[i];
  for (int i = threadIdx.x; i < 3 * n; i += blockDim.x) si[i] = aux[i];
  for (int i = threadIdx.x; i < 4 * n_tex; i += blockDim.x)
    si[3 * n + i] = textab[i];
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int ty = si[j];
    float4* g = geo + kGeo * j;
    if (ty == kSphere) {
      g[0] = make_float4(st[R_CX * n + j], st[R_CY * n + j], st[R_CZ * n + j],
                         st[R_RAD * n + j]);
    } else if (ty == kPlane) {
      g[0] = make_float4(st[R_NX * n + j], st[R_NY * n + j], st[R_NZ * n + j],
                         st[R_DEPTH * n + j]);
    } else {
      const float v1x = st[R_BPX * n + j], v1y = st[R_BPY * n + j],
                  v1z = st[R_BPZ * n + j];
      const float v2x = v1x + st[R_BSX * n + j], v2y = v1y + st[R_BSY * n + j],
                  v2z = v1z + st[R_BSZ * n + j];
      g[0] = make_float4(v1x, v1y, v1z, 0.0f);
      g[1] = make_float4(v2x, v2y, v2z, 0.0f);
      g[2] = make_float4(v1x - kEps, v1y - kEps, v1z - kEps, 0.0f);
      g[3] = make_float4(v2x + kEps, v2y + kEps, v2z + kEps, 0.0f);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int c[4] = {0, 0, 0, 0};
    float big = 0.0f;
    for (int j = 0; j < n; ++j) {
      const int ty = si[j];
      lists[ty * n + c[ty]++] = j;
      if (si[n + j]) lists[3 * n + c[3]++] = j;
      if (ty == kBox) {
        const float4 lo = geo[kGeo * j + 2], hi = geo[kGeo * j + 3];
        big = fmaxf(big, fmaxf(fmaxf(fabsf(lo.x), fabsf(hi.x)),
                               fmaxf(fmaxf(fabsf(lo.y), fabsf(hi.y)),
                                     fmaxf(fabsf(lo.z), fabsf(hi.z)))));
      }
    }
    for (int t = 0; t < 4; ++t) counts[t] = c[t];
    reinterpret_cast<float*>(counts)[4] = big;
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.r) return;
  const Scene s{st, su, si, si + n, si + 2 * n, si + 3 * n, units, geo,
                lists, lists + n, lists + 2 * n, lists + 3 * n,
                n, counts[0], counts[1], counts[2], counts[3],
                reinterpret_cast<const float*>(counts)[4]};

  // Per-thread slots by heap id; only the nodes that hit write theirs (bit
  // h of `live`), so a pass touches as many slots as its tree has hits.
  float cr[kMaxNodes], cg[kMaxNodes], cb[kMaxNodes];
  const uint32_t key_in = p.key[i];
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int pass = 0; pass < p.spp; ++pass) {
    const size_t ray = 3 * (static_cast<size_t>(p.n_sets == 1 ? 0 : pass) * p.r + i);
    Node root{p.o[ray], p.o[ray + 1], p.o[ray + 2], p.d[ray], p.d[ray + 1],
              p.d[ray + 2], 1.0f, 1.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0, 1};
    uint32_t live = 0u;
    const int prim = trace_pass(s, p, root, key_in,
                                p.ctr[i] + static_cast<uint32_t>(pass) * kPassBudget,
                                cr, cg, cb, live);
    if (pass == 0 && p.prim_idx) p.prim_idx[i] = prim;
    // Level sums in node-major order: position k of level l is the node
    // whose branch choices from the root are the bits of k, lowest first
    // (1 = refraction). A node without a hit adds 0, as its zero slot does
    // in the plain version's sum.
    float tot_r = 0.0f, tot_g = 0.0f, tot_b = 0.0f;
    for (int level = 1; level <= p.depth; ++level) {
      const int k_n = 1 << (level - 1);
      float lv_r = 0.0f, lv_g = 0.0f, lv_b = 0.0f;
      for (int k = 0; k < k_n; ++k) {
        int h = 0;
        for (int bit = 0; bit < level - 1; ++bit) h = 2 * h + 1 + ((k >> bit) & 1);
        const bool on = (live >> h) & 1u;
        const float c_r = on ? cr[h] : 0.0f;
        const float c_g = on ? cg[h] : 0.0f;
        const float c_b = on ? cb[h] : 0.0f;
        if (k == 0) {
          lv_r = c_r;
          lv_g = c_g;
          lv_b = c_b;
        } else {
          lv_r = lv_r + c_r;
          lv_g = lv_g + c_g;
          lv_b = lv_b + c_b;
        }
      }
      tot_r = tot_r + lv_r;
      tot_g = tot_g + lv_g;
      tot_b = tot_b + lv_b;
    }
    if (pass == 0) {
      acc_r = tot_r;
      acc_g = tot_g;
      acc_b = tot_b;
    } else {
      acc_r = acc_r + tot_r;
      acc_g = acc_g + tot_g;
      acc_b = acc_b + tot_b;
    }
  }
  p.out[3 * i] = acc_r / p.div;
  p.out[3 * i + 1] = acc_g / p.div;
  p.out[3 * i + 2] = acc_b / p.div;
}

// K5 alone over flat lanes: out [3, r]; dead lanes give 0.
__global__ void __launch_bounds__(256)
texel_fetch_kernel(const uint4* __restrict__ units,
                   const int4* __restrict__ textab,
                   const int* __restrict__ tex, const float* __restrict__ u,
                   const float* __restrict__ v,
                   const unsigned char* __restrict__ live, int r,
                   float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r) return;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  if (live[i]) {
    const int4 row = __ldg(textab + tex[i]);
    texel(units, row.x, row.y, row.z, row.w, u[i], v[i], cr, cg, cb);
  }
  out[i] = cr;
  out[r + i] = cg;
  out[2 * r + i] = cb;
}

}  // namespace

// Plain C entry points, bound with ctypes. Each returns cudaGetLastError()
// after its launch (0 = cudaSuccess).
//
// table [27, n] (pack_whitted5_scene); uvs [2, n]; aux [3, n] int32 (type,
// light flag, texture id); units [texels, 16] uint8 and textab [n_tex, 4]
// int32 (texel offset, th, tw, form), both from
// texel_kernel.pack_texel_units (in place of the [texels, 3] float32 atlas
// and [n_tex, 3] table these arguments took before the texel units); o, d
// [n_sets, r, 3] with n_sets 1 or spp; key, ctr
// [r] uint32; nsamp [depth] int32 read on the host side of the call;
// out [r, 3] = the passes' sum / div; prim_idx [r] int32 or null.
extern "C" int whitted5_trace_cuda(const float* table, const float* uvs,
                                   const int* aux, int n, const void* units,
                                   const int* textab, int n_tex,
                                   const float* o, const float* d, int n_sets,
                                   int r, const uint32_t* key,
                                   const uint32_t* ctr, int spp, int depth,
                                   const int* nsamp, float div, float* out,
                                   int* prim_idx, void* stream) {
  if (depth < 1 || depth > kMaxDepth) return static_cast<int>(cudaErrorInvalidValue);
  Params p{o, d, n_sets, r, key, ctr, spp, depth, {0, 0, 0, 0, 0}, div, out,
           prim_idx};
  for (int l = 0; l < depth; ++l) p.nsamp[l] = nsamp[l];
  const size_t smem = 4 * smem_words(n, n_tex);
  if (smem > kSmemDefault) {
    // Past the default 48 KB a block's shared memory needs the kernel's
    // opt-in, up to the device's limit (227 KB on sm_90).
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
    e = cudaFuncSetAttribute(whitted5_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (r + kThreads - 1) / kThreads;
  whitted5_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      table, uvs, aux, n, static_cast<const uint4*>(units), textab, n_tex, p);
  return static_cast<int>(cudaGetLastError());
}

// K5 alone: units, textab as above; tex [r] int32, u, v [r] float32, live
// [r] bool; out [3, r].
extern "C" int texel_fetch_cuda(const void* units, const int* textab,
                                const int* tex, const float* u,
                                const float* v, const unsigned char* live,
                                int r, float* out, void* stream) {
  const int blocks = (r + 255) / 256;
  texel_fetch_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(units), reinterpret_cast<const int4*>(textab),
      tex, u, v, live, r, out);
  return static_cast<int>(cudaGetLastError());
}

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
// plain gather, `texel` below, called by K4 at every textured hit; the
// `texel_fetch` entry exposes it alone for its own check.
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
// sweep over the N primitives and one more sweep per shadow sample (a box is
// 6 slab faces); device memory sees the rays and RNG state in, the [R, 3]
// color out, and four texel reads per textured hit (the atlas stays in L2:
// 2 x 64 x 64 x 12 B procedural, 960,000 B for the 200 x 200 assets).
// What the design does about it:
//   * one thread per primary ray walks its whole tree depth first, with a
//     per-thread stack of pending refraction children: no [K*R] node buffers
//     and no launch per level; dead subtrees are never visited;
//   * every node draws from its own stream (key mixed with its heap id,
//     counter from the pass's counter), so the walk order does not change
//     one draw; each node's contribution goes into a per-thread slot by heap
//     id, and the slots are summed level by level in node-major order, the
//     order in which the plain version sums them;
//   * the [27, N] primitive table and the small per-primitive tables sit in
//     shared memory.
//
// Rounding: built with -fmad=false, so every a * b + c rounds twice, as the
// plain version's separate tensor ops do; the expressions keep its order.
// x^20 is the multiply chain of the plain version; Beer's law uses expf
// (never __expf); the texel wrap is a floor modulo, as torch's and JAX's `%`.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC -fmad=false. Never --use_fast_math.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
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

struct Scene {
  const float* t;      // [kRows, n]
  const float* uvs;    // [2, n] uv scale
  const int* type;     // [n]
  const int* light;    // [n] 1 for a light
  const int* tex;      // [n] texture id or -1
  const int* textab;   // [n_tex, 3] (texel offset, th, tw)
  const float* atlas;  // [texels, 3] in device memory
  int n;
  __device__ float at(int row, int j) const { return t[row * n + j]; }
};

__device__ __forceinline__ int floor_mod(int a, int m) {
  return ((a % m) + m) % m;
}

// K5: Texture::GetTexel (scene.cpp:81-106) with its quirks, the arithmetic of
// models/whitted5._texel: v is scaled by the width, the wrap is a floor
// modulo, and the blend is c1 w1 + c2 w2 + c3 w3 + c4 w4, left to right.
__device__ __forceinline__ void texel(const float* __restrict__ atlas, int off,
                                      int th, int tw, float u, float v,
                                      float& r, float& g, float& b) {
  const float ftw = static_cast<float>(tw);
  const float fu = (u + 1000.5f) * ftw;
  const float fv = (v + 1000.0f) * ftw;
  const float flu = floorf(fu);
  const float flv = floorf(fv);
  const int u1 = floor_mod(static_cast<int>(flu), tw);
  const int v1 = floor_mod(static_cast<int>(flv), th);
  const int u2 = (u1 + 1) % tw;
  const int v2 = (v1 + 1) % th;
  const float fracu = fu - flu;
  const float fracv = fv - flv;
  const float w1 = (1.0f - fracu) * (1.0f - fracv);
  const float w2 = fracu * (1.0f - fracv);
  const float w3 = (1.0f - fracu) * fracv;
  const float w4 = fracu * fracv;
  const float* c1 = atlas + 3 * (off + v1 * tw + u1);
  const float* c2 = atlas + 3 * (off + v1 * tw + u2);
  const float* c3 = atlas + 3 * (off + v2 * tw + u1);
  const float* c4 = atlas + 3 * (off + v2 * tw + u2);
  r = __ldg(c1) * w1 + __ldg(c2) * w2 + __ldg(c3) * w3 + __ldg(c4) * w4;
  g = __ldg(c1 + 1) * w1 + __ldg(c2 + 1) * w2 + __ldg(c3 + 1) * w3 +
      __ldg(c4 + 1) * w4;
  b = __ldg(c1 + 2) * w1 + __ldg(c2 + 2) * w2 + __ldg(c3 + 2) * w3 +
      __ldg(c4 + 2) * w4;
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

// Candidate hit of primitive j (models/whitted5._prim_candidates): returns
// whether it is valid, its distance, and whether a sphere is entered from
// inside.
__device__ __forceinline__ bool candidate(const Scene& s, int j, float ox,
                                          float oy, float oz, float dx,
                                          float dy, float dz, float& dist,
                                          bool& inprim) {
  inprim = false;
  const int ty = s.type[j];
  if (ty == kSphere) {
    const float vx = ox - s.at(R_CX, j);
    const float vy = oy - s.at(R_CY, j);
    const float vz = oz - s.at(R_CZ, j);
    const float sb = -(vx * dx + vy * dy + vz * dz);
    const float rad = s.at(R_RAD, j);
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
  if (ty == kPlane) {
    const float nx = s.at(R_NX, j), ny = s.at(R_NY, j), nz = s.at(R_NZ, j);
    const float pd = nx * dx + ny * dy + nz * dz;
    const float no = nx * ox + ny * oy + nz * oz;
    const float pd_safe = pd != 0.0f ? pd : 1.0f;
    dist = -(no + s.at(R_DEPTH, j)) / pd_safe;
    return pd < 0.0f;
  }
  // Box: six slab faces, the smallest positive one whose hit point lies in
  // the box with +-EPSILON slack (scene.cpp:306-350).
  const float o3[3] = {ox, oy, oz};
  const float d3[3] = {dx, dy, dz};
  float v1[3], v2[3], lo[3], hi[3];
  for (int a = 0; a < 3; ++a) {
    v1[a] = s.at(R_BPX + a, j);
    v2[a] = v1[a] + s.at(R_BSX + a, j);
    lo[a] = v1[a] - kEps;
    hi[a] = v2[a] + kEps;
  }
  float bd = 1e30f;
  bool bok = false;
  for (int axis = 0; axis < 3; ++axis) {
    const float d_a = d3[axis];
    const float d_safe = d_a != 0.0f ? d_a : 1.0f;
    const bool axis_ok = d_a != 0.0f;
    for (int side = 0; side < 2; ++side) {
      const float bound = side ? v2[axis] : v1[axis];
      const float t_f = (bound - o3[axis]) / d_safe;
      bool inside = true;
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

// First minimum over the valid candidates, ascending primitive order.
// Returns its index (0 when none is valid) and sets best (+inf when none).
__device__ int first_min(const Scene& s, float ox, float oy, float oz,
                         float dx, float dy, float dz, float& best,
                         bool& inprim) {
  best = __int_as_float(0x7f800000);
  inprim = false;
  int amin = 0;
  for (int j = 0; j < s.n; ++j) {
    float dist;
    bool inp;
    if (candidate(s, j, ox, oy, oz, dx, dy, dz, dist, inp) && dist < best) {
      best = dist;
      amin = j;
      inprim = inp;
    }
  }
  return amin;
}

// CalcShade's visibility: the nearest primitive within maxt is the light.
__device__ __forceinline__ bool nearest_is(const Scene& s, float ox, float oy,
                                           float oz, float dx, float dy,
                                           float dz, float maxt, int target) {
  float best;
  bool inp;
  const int amin = first_min(s, ox, oy, oz, dx, dy, dz, best, inp);
  return best < maxt && amin == target;
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

// One pass of one primary ray: the node contributions by heap id into c*.
// Returns the level-1 hit id (-1 on a miss).
__device__ int trace_pass(const Scene& s, const Params& p, Node root,
                          uint32_t key_in, uint32_t ctr_pass, float* cr,
                          float* cg, float* cb) {
  Node stack[kMaxDepth];
  int top = 0;
  int primary = -1;
  Node nd = root;
  while (true) {
    bool next = false;
    float best;
    bool inprim;
    const int amin = first_min(s, nd.ox, nd.oy, nd.oz, nd.dx, nd.dy, nd.dz,
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
          texel(s.atlas, s.textab[3 * tid], s.textab[3 * tid + 1],
                s.textab[3 * tid + 2], uc, vc, tr, tg, tb);
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
        for (int li = 0; li < s.n; ++li) {
          if (!s.light[li]) continue;
          float ldx, ldy, ldz, shade;
          if (s.type[li] == kSphere) {
            const float lvx = s.at(R_CX, li) - px;
            const float lvy = s.at(R_CY, li) - py;
            const float lvz = s.at(R_CZ, li) - pz;
            const float tdist =
                sqrtf(fmaxf(lvx * lvx + lvy * lvy + lvz * lvz, 1e-30f));
            ldx = lvx / tdist;
            ldy = lvy / tdist;
            ldz = lvz / tdist;
            shade = nearest_is(s, px + ldx * kEps, py + ldy * kEps,
                               pz + ldz * kEps, ldx, ldy, ldz, tdist, li)
                        ? 1.0f
                        : 0.0f;
          } else {
            // Box area light: n_samp jittered grid samples on its bottom
            // face (CalcShade, raytracer.cpp:385-404).
            const float bpx = s.at(R_BPX, li), bpy = s.at(R_BPY, li),
                        bpz = s.at(R_BPZ, li);
            const float bsx = s.at(R_BSX, li), bsy = s.at(R_BSY, li),
                        bsz = s.at(R_BSZ, li);
            const float lvx = (bpx + 0.5f * bsx) - px;
            const float lvy = (bpy + 0.5f * bsy) - py;
            const float lvz = (bpz + 0.5f * bsz) - pz;
            const float linv =
                1.0f / sqrtf(fmaxf(lvx * lvx + lvy * lvy + lvz * lvz, 1e-30f));
            ldx = lvx * linv;
            ldy = lvy * linv;
            ldz = lvz * linv;
            const float deltax = bsx * 0.25f;
            const float deltay = bsz * 0.25f;
            const float cellx = bsx / 4.0f;
            const float cellz = bsz / 4.0f;
            const float sscale = static_cast<float>(1.0 / n_samp);
            shade = 0.0f;
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
              const bool vis =
                  nearest_is(s, px + sdx * kEps, py + sdy * kEps,
                             pz + sdz * kEps, sdx, sdy, sdz, ldist, li);
              shade = shade + (vis ? 1.0f : 0.0f) * sscale;
            }
          }
          const bool pos_shade = shade > 0.0f;
          const float l_r = s.at(R_COLR, li), l_g = s.at(R_COLG, li),
                      l_b = s.at(R_COLB, li);
          const float dnl = ldx * nx + ldy * ny + ldz * nz;
          if (pos_shade && m_diff > 0.0f && dnl > 0.0f) {
            const float dt = dnl * m_diff * shade;
            acc_r = acc_r + dt * col_r * l_r;
            acc_g = acc_g + dt * col_g * l_g;
            acc_b = acc_b + dt * col_b * l_b;
          }
          const float k2 = 2.0f * dnl;
          const float rvx = ldx - k2 * nx;
          const float rvy = ldy - k2 * ny;
          const float rvz = ldz - k2 * nz;
          const float dvr = nd.dx * rvx + nd.dy * rvy + nd.dz * rvz;
          if (pos_shade && m_spec > 0.0f && dvr > 0.0f) {
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

__global__ void __launch_bounds__(kThreads)
whitted5_kernel(const float* __restrict__ table, const float* __restrict__ uvs,
                const int* __restrict__ aux, int n,
                const float* __restrict__ atlas,
                const int* __restrict__ textab, int n_tex, Params p) {
  extern __shared__ float smem[];
  float* st = smem;
  float* su = st + kRows * n;
  int* si = reinterpret_cast<int*>(su + 2 * n);
  for (int i = threadIdx.x; i < kRows * n; i += blockDim.x) st[i] = table[i];
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) su[i] = uvs[i];
  for (int i = threadIdx.x; i < 3 * n; i += blockDim.x) si[i] = aux[i];
  for (int i = threadIdx.x; i < 3 * n_tex; i += blockDim.x)
    si[3 * n + i] = textab[i];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.r) return;
  const Scene s{st, su, si, si + n, si + 2 * n, si + 3 * n, atlas, n};

  const int n_nodes = (1 << p.depth) - 1;
  float cr[kMaxNodes], cg[kMaxNodes], cb[kMaxNodes];
  const uint32_t key_in = p.key[i];
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int pass = 0; pass < p.spp; ++pass) {
    const size_t ray = 3 * (static_cast<size_t>(p.n_sets == 1 ? 0 : pass) * p.r + i);
    Node root{p.o[ray], p.o[ray + 1], p.o[ray + 2], p.d[ray], p.d[ray + 1],
              p.d[ray + 2], 1.0f, 1.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0, 1};
    for (int h = 0; h < n_nodes; ++h) cr[h] = cg[h] = cb[h] = 0.0f;
    const int prim = trace_pass(s, p, root, key_in,
                                p.ctr[i] + static_cast<uint32_t>(pass) * kPassBudget,
                                cr, cg, cb);
    if (pass == 0 && p.prim_idx) p.prim_idx[i] = prim;
    // Level sums in node-major order: position k of level l is the node
    // whose branch choices from the root are the bits of k, lowest first
    // (1 = refraction).
    float tot_r = 0.0f, tot_g = 0.0f, tot_b = 0.0f;
    for (int level = 1; level <= p.depth; ++level) {
      const int k_n = 1 << (level - 1);
      float lv_r = 0.0f, lv_g = 0.0f, lv_b = 0.0f;
      for (int k = 0; k < k_n; ++k) {
        int h = 0;
        for (int bit = 0; bit < level - 1; ++bit) h = 2 * h + 1 + ((k >> bit) & 1);
        if (k == 0) {
          lv_r = cr[h];
          lv_g = cg[h];
          lv_b = cb[h];
        } else {
          lv_r = lv_r + cr[h];
          lv_g = lv_g + cg[h];
          lv_b = lv_b + cb[h];
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
texel_fetch_kernel(const float* __restrict__ atlas,
                   const int* __restrict__ textab,
                   const int* __restrict__ tex, const float* __restrict__ u,
                   const float* __restrict__ v,
                   const unsigned char* __restrict__ live, int r,
                   float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r) return;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  if (live[i]) {
    const int t = tex[i];
    texel(atlas, __ldg(textab + 3 * t), __ldg(textab + 3 * t + 1),
          __ldg(textab + 3 * t + 2), u[i], v[i], cr, cg, cb);
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
// light flag, texture id); atlas [texels, 3]; textab [n_tex, 3] int32
// (texel offset, th, tw); o, d [n_sets, r, 3] with n_sets 1 or spp; key, ctr
// [r] uint32; nsamp [depth] int32 read on the host side of the call;
// out [r, 3] = the passes' sum / div; prim_idx [r] int32 or null.
extern "C" int whitted5_trace_cuda(const float* table, const float* uvs,
                                   const int* aux, int n, const float* atlas,
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
  const size_t smem = sizeof(float) * (kRows + 2) * n + sizeof(int) * (3 * n + 3 * n_tex);
  const int blocks = (r + kThreads - 1) / kThreads;
  whitted5_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      table, uvs, aux, n, atlas, textab, n_tex, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int texel_fetch_cuda(const float* atlas, const int* textab,
                                const int* tex, const float* u,
                                const float* v, const unsigned char* live,
                                int r, float* out, void* stream) {
  const int blocks = (r + 255) / 256;
  texel_fetch_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      atlas, textab, tex, u, v, live, r, out);
  return static_cast<int>(cudaGetLastError());
}

// K1 and K2 on Hopper: the fused smallpt path-tracing / direct-lighting
// pass, for small scenes (K1) and for large ones through a blocked, culled
// sphere sweep (K2).
//
// K1 replaces the TPU kernel se195_raytracer_tpu/kernels/pt_kernel.py
// _make_kernel(loop_scene=False); K2 replaces _make_kernel(loop_scene=True)
// (_culled_sweep, block_possible, block_bounds). Both are driven there by
// _pass_impl (one pallas_call per pass) under pt_multi_pass (a lax.scan over
// the spp passes). Computes, per lane: jittered camera ray, up to max_depth
// bounces of a reverse-order nearest-hit sweep, next-event estimation with
// shadow rays, the DIFF / SPEC / REFR branches, the MWC or counter RNG
// advanced only where the reference draws, and the running mean
// acc = (acc * samp + rad) * (1 / (samp + 1)) once per pass.
//
// What bounds it on this card: FP32 compute. A bounce costs about 15 ops
// per sphere for the nearest-hit sweep plus a shadow sweep of about 12 ops
// per sphere for each light, and the only device-memory traffic is the
// per-lane state (s0, s1, acc: 20 bytes in, 20 bytes out per call). For K2
// what the card spends beyond that is SIMT waste: a warp runs the union of
// the blocks its 32 lanes keep, and a warp's pass lasts as long as its
// longest path.
// What the design does about it:
//   * a float4 (center, radius) record per sphere, the [12, N] scene table
//     (K1; K2 reads it from device memory), the camera row and the light
//     list sit in shared memory, loaded once per block; every thread reads
//     the same sphere at the same time, so a sphere test is one 16-byte
//     broadcast; K1's sweeps unroll by 4;
//   * the whole spp loop runs inside the kernel with the ray, throughput,
//     RNG state and accumulator in registers: no device-memory traffic per
//     bounce or per pass;
//   * a lane whose path ended (miss, light, or a DL diffuse hit) leaves the
//     bounce loop. This is exact: in the TPU kernel a dead lane's bounce is
//     the identity, since every draw there is masked by a subset of the
//     live lanes and every update is gated on them;
//   * K2 sweeps the spheres in the reference's order N-1 .. 0, as the
//     remainder N-1 .. nb*16 first, then blocks nb-1 .. 0 of kBlock = 16,
//     each as its upper half (spheres 8..15) and then its lower half, and
//     skips, per ray, whatever its bound rules out: the remainder, a group
//     of kGroup = 4 blocks, a block, a half block. Shared memory holds a
//     float4 record (center, radius) per sphere, per half block, block and
//     group bound, and the remainder's bound, so a test is one 16-byte
//     broadcast; the [12, N] table stays in device memory for the shading
//     reads. A bound is skipped when the ray's line cannot meet it, or it
//     enters it beyond the best t found so far (nearest sweep) or at the
//     shadow ray's maxt or beyond (shadow sweep). The bounds are inflated
//     (x1.001 + 0.01) and widened with the distance along the ray so that
//     rounding can never skip one holding a hit that counts (see
//     bound_hit), and the spheres that are tested keep
//     their order: the cull is exact, cull on == cull off bitwise. Groups
//     cut the bound tests per sweep; half blocks halve the spheres tested
//     in a kept block (block 0, whose bound holds complex's 10^4-radius
//     ground sphere, is never skipped);
//   * K2 runs one loop over a lane's bounces of all its passes: a lane
//     whose path ends starts its next pass at once, so a warp runs as many
//     bounces as its busiest lane traces in all passes, not the longest
//     path of each pass; each lane's draws and sums keep their order.
//
// One thread per lane over all Rp lanes, pad lanes included, so the state
// stays comparable with the JAX package's. K1's pixel id is its lane id plus
// lane_offset (the identity layout of ray_layout; a shard of a sharded
// render passes its first lane's absolute id); K2 reads the pixel id of
// its lane from the pix table (the blocked layout: one 16 x 128 lane tile
// is one 64 x 32 image block; pad lanes hold pixel id W*H, camera y = -1).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC. Never --use_fast_math (approximate sinf/cosf/sqrtf and
// division, denormals flushed to zero). Every constant is a float literal.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// K1's threads per block and __launch_bounds__ minimum of resident blocks
// per SM, chosen by measuring (kernel_ab.py on edited copies): 64 registers, 8
// blocks per SM, the 2048 blocks of 512x512 lanes in 1.94 waves. K2 states
// a minimum of 1, under which ptxas gives it 72-76 registers and no spill.
constexpr int kThreadsK1 = 128;
constexpr int kMinBlocksK1 = 8;
constexpr int kThreadsK2 = 256;
constexpr int kRows = 12;  // cx cy cz rad ex ey ez cr cg cb refl emissive
// A block's dynamic shared memory without the kernel's opt-in; K2 opts in
// above it (a scene of more than ~2,550 spheres).
constexpr size_t kSmemDefault = 48 * 1024;
constexpr int kBlock = 16;  // SPHERE_BLOCK: spheres per culled block
constexpr int kHalf = kBlock / 2;  // spheres per half-block bound
constexpr int kGroup = 4;   // GROUP_BLOCKS: blocks per group bound
constexpr float kEps = 0.01f;        // geomfunc.h:29 EPSILON
constexpr float kInf = 1e20f;        // geomfunc.h:80 initial nearest distance
constexpr float kReach = 2e-3f;  // CULL_REACH: widening of a bound per unit of distance
constexpr float kTwoPi = 6.2831855f;   // float32(2 pi)
constexpr float kFourPi = 12.566371f;  // float32(4 pi)

enum { kMwc = 0, kCounter = 1 };

// Whether K2 rounds every product and sum of its sphere test and of a
// path's geometry (camera ray, hit point, normal, bounce direction) on its
// own, as its plain version's separate tensor ops do. K2 ships from
// csrc/pt_blocked_kernel.cu, which sets PT_K2_ROUNDED and includes this
// file; this file's own build, K1's, leaves it unset, so its K2 entry has
// K1's arithmetic. With nvcc's contraction into FMAs K2's paths left its
// plain version's at grazing hits: on complex_scene(max_depth=5) (3,908
// spheres) 1.50% of the lanes' RNG states differed after a 512x512 pass,
// beyond K2's 1% contract; rounding the sphere test alone, 0.38%; with the
// path's geometry too, 0.0046%, as many as with every operation rounded
// (-fmad=false), which took 1.06-1.07x the time (kernel_ab.py). The rest
// keeps contraction: a shadow ray's test moves only radiance, and the cull
// is exact under either rounding (bound_hit).
#ifndef PT_K2_ROUNDED
#define PT_K2_ROUNDED 0
#endif
template <bool BLOCKED>
constexpr bool kRounded = BLOCKED && PT_K2_ROUNDED;

// One draw; advances (s0, s1). MWC: simplernd.h:34-48. Counter: the
// SplitMix-style hash of (key = s0, counter = s1).
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

// a * b, a + b and a - b. With R false, nvcc contracts a product and the
// sum it feeds into one FMA where it can; with R true each rounds on its
// own (__fmul_rn and its kin are never contracted), as the plain version's
// separate tensor ops round them.
template <bool R>
__device__ __forceinline__ float mul(float a, float b) {
  if constexpr (R) return __fmul_rn(a, b); else return a * b;
}
template <bool R>
__device__ __forceinline__ float add(float a, float b) {
  if constexpr (R) return __fadd_rn(a, b); else return a + b;
}
template <bool R>
__device__ __forceinline__ float sub(float a, float b) {
  if constexpr (R) return __fsub_rn(a, b); else return a - b;
}
// a . b, summed left to right (core/types.dot3).
template <bool R>
__device__ __forceinline__ float dot(float ax, float ay, float az, float bx,
                                     float by, float bz) {
  return add<R>(add<R>(mul<R>(ax, bx), mul<R>(ay, by)), mul<R>(az, bz));
}

// SphereIntersect (geomfunc.h:32-59) on a (cx, cy, cz, rad) record:
// distance, or 0 on a miss.
template <bool R>
__device__ __forceinline__ float sphere_t4(float4 s, float ox, float oy,
                                           float oz, float dx, float dy,
                                           float dz) {
  const float opx = s.x - ox;
  const float opy = s.y - oy;
  const float opz = s.z - oz;
  const float r = s.w;
  const float b = dot<R>(opx, opy, opz, dx, dy, dz);
  const float det = add<R>(sub<R>(mul<R>(b, b), dot<R>(opx, opy, opz, opx, opy, opz)),
                           mul<R>(r, r));
  if (!(det >= 0.0f)) return 0.0f;
  const float sq = sqrtf(det);
  const float t1 = b - sq;
  const float t2 = b + sq;
  return t1 > kEps ? t1 : (t2 > kEps ? t2 : 0.0f);
}

// The nearest hit (geomfunc.h:82-89): spheres N-1 .. 0, strict <, so the
// larger index wins a tie (K1); one 16-byte shared-memory broadcast per
// sphere, unrolled by 4.
__device__ __forceinline__ void nearest_all(const float4* geom, int n,
                                            float ox, float oy, float oz,
                                            float dx, float dy, float dz,
                                            float& tb, int& id) {
  tb = kInf;
  id = 0;
#pragma unroll 4
  for (int j = n - 1; j >= 0; --j) {
    const float t = sphere_t4<false>(geom[j], ox, oy, oz, dx, dy, dz);
    if (t != 0.0f && t < tb) {
      tb = t;
      id = j;
    }
  }
}

// IntersectP (geomfunc.h:94-110): any sphere hit strictly closer than maxt
// (K1).
__device__ __forceinline__ bool any_hit_all(const float4* geom, int n,
                                            float ox, float oy, float oz,
                                            float dx, float dy, float dz,
                                            float maxt) {
#pragma unroll 4
  for (int j = n - 1; j >= 0; --j) {
    const float t = sphere_t4<false>(geom[j], ox, oy, oz, dx, dy, dz);
    if (t != 0.0f && t < maxt) return true;
  }
  return false;
}

// K2's scene in shared memory: one (cx, cy, cz, rad) record per sphere, the
// inflated bounding sphere of each half block of kHalf spheres, of each
// block of kBlock spheres, of each group of kGroup blocks and of the
// remainder (half_bounds, block_bounds, group_bounds, remainder_bound).
struct Blocked {
  const float4* geom;   // [n]
  const float4* half;   // [2 nb]: half block h holds spheres 8h .. 8h+7
  const float4* block;  // [nb]
  const float4* group;  // [ng]
  float4 rest;          // the bound of the remainder, spheres nb*16 .. n-1
  int n, nb, ng;
  bool cull;
};

// The bound test: does the ray's line meet bounding sphere bb ahead of its
// origin (block_possible, JAX pt_kernel.py:239-255)? If so, `entry` is the
// distance at which it enters, b - sqrt(det) (negative from inside). The
// radius is widened by kReach * (|b| + 2 R') first.
//
// Why skipping on `entry` is exact. Every point of every sphere of a block
// (half block, group, remainder) lies inside its bounding sphere of radius
// R, and the table holds R' = R * 1.001 + 0.01. Walking back from a point
// at distance t that lies within R of the center, the ray stays inside a
// ball of radius R'' > R for at least R'' - R, so the exact entry into it
// is at most t - (R'' - R). What must fit into R'' - R is the rounding of
// two computed quantities:
//   * a sphere's t. b_s - sqrt(det_s) cancels: det_s = b_s^2 - |op_s|^2 +
//     r^2 carries an error e of up to ~12 u |op_s|^2 (u = 2^-24), so a ray
//     that passes within sqrt(r^2 + e) of the center, up to sqrt(e) ~
//     8.5e-4 |op_s| outside the sphere, can report a hit, and a sphere's t
//     can come out up to sqrt(e) early;
//   * the bound's entry, by the same cancellation: up to ~8.5e-4 |op_B|.
// With |op_s|, |op_B| <= |b| + 2 R' wherever the ray can report a hit in
// the bound, widening the radius by kReach * (|b| + 2 R'), kReach = 2e-3,
// covers both at any distance; the 0.001 R + 0.01 of the table covers the
// rest (the rounding of b and of the widened radius). So a bound whose
// computed entry is above the running best t holds no sphere that the
// strict < fold would take, and one whose entry is at least maxt holds no
// occluder closer than maxt. At complex's distances (~150 from the camera)
// the widening adds ~0.3 to a bound's radius; without it, a ray that starts
// far out on complex's 10^4-radius ground sphere, or the scene scaled up,
// can outrun the fixed inflation. tests/test_torch_pt_kernel.py checks the
// predicate on every sweep of a complex render, as built and scaled 10x
// and moved 1000 away from the origin; chip_smoke.py holds cull on bitwise
// equal to cull off.
__device__ __forceinline__ bool bound_hit(float4 bb, float ox, float oy,
                                          float oz, float dx, float dy,
                                          float dz, float& entry) {
  const float opx = bb.x - ox;
  const float opy = bb.y - oy;
  const float opz = bb.z - oz;
  const float b = opx * dx + opy * dy + opz * dz;
  const float r = bb.w + kReach * (fabsf(b) + 2.0f * bb.w);
  const float det = b * b - (opx * opx + opy * opy + opz * opz) + r * r;
  if (!(det >= 0.0f)) return false;
  const float sq = sqrtf(det);
  entry = b - sq;
  return b + sq > 0.0f;
}

// The spheres of half block h (2 * blk + 1 holds blk's spheres 8..15, 2 *
// blk its spheres 0..7) in descending order, each through test(j); stops
// and returns true where test does.
template <typename Test>
__device__ __forceinline__ bool sweep_half(int h, Test test) {
#pragma unroll
  for (int k = kHalf - 1; k >= 0; --k) {
    if (test(h * kHalf + k)) return true;
  }
  return false;
}

// K2's sweep: the remainder N-1 .. nb*16, then blocks nb-1 .. 0 (JAX
// _culled_sweep :366-410), each block as its upper, then its lower half;
// with the cull, the remainder, a group, a block and a half block is
// skipped unless keep(its bound). test(j) tests sphere j and returns true
// to stop the sweep.
template <typename Keep, typename Test>
__device__ __forceinline__ bool sweep_blocked(const Blocked& B, Keep keep,
                                              Test test) {
  if (!B.cull || keep(B.rest)) {
    for (int j = B.n - 1; j >= B.nb * kBlock; --j) {
      if (test(j)) return true;
    }
  }
  for (int g = B.ng - 1; g >= 0; --g) {
    if (B.cull && !keep(B.group[g])) continue;
    for (int blk = min(g * kGroup + kGroup, B.nb) - 1; blk >= g * kGroup;
         --blk) {
      if (B.cull && !keep(B.block[blk])) continue;
      for (int h = 2 * blk + 1; h >= 2 * blk; --h) {
        if ((!B.cull || keep(B.half[h])) && sweep_half(h, test)) return true;
      }
    }
  }
  return false;
}

// K2's nearest hit: the fold of nearest_all in its order (sweep_blocked);
// a bound is kept when the ray meets it and enters it no farther than the
// best t so far.
__device__ __forceinline__ void nearest_blocked(const Blocked& B, float ox,
                                                float oy, float oz, float dx,
                                                float dy, float dz, float& tb,
                                                int& id) {
  tb = kInf;
  id = 0;
  sweep_blocked(
      B,
      [&](float4 bb) {
        float entry;
        return bound_hit(bb, ox, oy, oz, dx, dy, dz, entry) && !(entry > tb);
      },
      [&](int j) {
        const float t = sphere_t4<kRounded<true>>(B.geom[j], ox, oy, oz, dx, dy, dz);
        if (t != 0.0f && t < tb) {
          tb = t;
          id = j;
        }
        return false;
      });
}

// K2's shadow test: any_hit_all over the order of sweep_blocked; a bound
// is kept when the ray meets it and enters it closer than maxt.
__device__ __forceinline__ bool any_hit_blocked(const Blocked& B, float ox,
                                                float oy, float oz, float dx,
                                                float dy, float dz,
                                                float maxt) {
  return sweep_blocked(
      B,
      [&](float4 bb) {
        float entry;
        return bound_hit(bb, ox, oy, oz, dx, dy, dz, entry) && entry < maxt;
      },
      [&](int j) {
        const float t = sphere_t4<kRounded<true>>(B.geom[j], ox, oy, oz, dx, dy, dz);
        return t != 0.0f && t < maxt;
      });
}

// The nearest hit and the shadow test: K1 sweeps every record of B, K2
// its blocks.
template <bool BLOCKED>
__device__ __forceinline__ void nearest(const Blocked& B, float ox, float oy,
                                        float oz, float dx, float dy,
                                        float dz, float& tb, int& id) {
  if constexpr (BLOCKED) {
    nearest_blocked(B, ox, oy, oz, dx, dy, dz, tb, id);
  } else {
    nearest_all(B.geom, B.n, ox, oy, oz, dx, dy, dz, tb, id);
  }
}

template <bool BLOCKED>
__device__ __forceinline__ bool any_hit(const Blocked& B, float ox, float oy,
                                        float oz, float dx, float dy,
                                        float dz, float maxt) {
  if constexpr (BLOCKED) {
    return any_hit_blocked(B, ox, oy, oz, dx, dy, dz, maxt);
  } else {
    return any_hit_all(B.geom, B.n, ox, oy, oz, dx, dy, dz, maxt);
  }
}

// A path's state: ray, radiance so far, throughput, and whether the last
// bounce was specular (emission counts).
struct Path {
  float ox, oy, oz, dx, dy, dz;
  float rad_r, rad_g, rad_b;
  float thr_r, thr_g, thr_b;
  bool spec;
};

// GenerateCameraRay (rendering_kernel.cl:29-51): 2 draws; a fresh path.
template <int RNG, bool R>
__device__ __forceinline__ void camera(Path& path, uint32_t& s0, uint32_t& s1,
                                       const float* cs, float px, float py,
                                       float inv_w, float inv_h) {
  const float r1 = draw<RNG>(s0, s1);
  const float r2 = draw<RNG>(s0, s1);
  const float kcx = sub<R>(mul<R>(px + (r1 - 0.5f), inv_w), 0.5f);
  const float kcy = sub<R>(mul<R>(py + (r2 - 0.5f), inv_h), 0.5f);
  const float rdx = add<R>(add<R>(mul<R>(cs[6], kcx), mul<R>(cs[9], kcy)), cs[3]);
  const float rdy = add<R>(add<R>(mul<R>(cs[7], kcx), mul<R>(cs[10], kcy)), cs[4]);
  const float rdz = add<R>(add<R>(mul<R>(cs[8], kcx), mul<R>(cs[11], kcy)), cs[5]);
  path.ox = add<R>(mul<R>(0.1f, rdx), cs[0]);
  path.oy = add<R>(mul<R>(0.1f, rdy), cs[1]);
  path.oz = add<R>(mul<R>(0.1f, rdz), cs[2]);
  const float rinv = 1.0f / sqrtf(dot<R>(rdx, rdy, rdz, rdx, rdy, rdz));
  path.dx = rdx * rinv;
  path.dy = rdy * rinv;
  path.dz = rdz * rinv;
  path.rad_r = path.rad_g = path.rad_b = 0.0f;
  path.thr_r = path.thr_g = path.thr_b = 1.0f;
  path.spec = true;
}

// One bounce of a path (geomfunc.h:182-336): the nearest hit, emission,
// next-event estimation and the DIFF / SPEC / REFR branch. Returns false
// where the path ends (a miss, a light, or DL's diffuse hit).
template <bool DIRECT_ONLY, int RNG, bool BLOCKED>
__device__ __forceinline__ bool bounce(Path& path, uint32_t& s0, uint32_t& s1,
                                       const float* sc, int n,
                                       const Blocked& B, const int* ls,
                                       int n_lights) {
  float &ox = path.ox, &oy = path.oy, &oz = path.oz;
  float &dx = path.dx, &dy = path.dy, &dz = path.dz;
  float &rad_r = path.rad_r, &rad_g = path.rad_g, &rad_b = path.rad_b;
  float &thr_r = path.thr_r, &thr_g = path.thr_g, &thr_b = path.thr_b;
  bool& spec = path.spec;
  constexpr bool R = kRounded<BLOCKED>;
  float tb;
  int id;
  nearest<BLOCKED>(B, ox, oy, oz, dx, dy, dz, tb, id);
  if (!(tb < kInf)) return false;  // miss: the path ends

  const float hx = add<R>(ox, mul<R>(tb, dx));
  const float hy = add<R>(oy, mul<R>(tb, dy));
  const float hz = add<R>(oz, mul<R>(tb, dz));
  const float nx0 = hx - sc[0 * n + id];
  const float ny0 = hy - sc[1 * n + id];
  const float nz0 = hz - sc[2 * n + id];
  const float ninv = 1.0f / sqrtf(fmaxf(dot<R>(nx0, ny0, nz0, nx0, ny0, nz0), 1e-38f));
  const float nx = nx0 * ninv, ny = ny0 * ninv, nz = nz0 * ninv;
  const float dp = dot<R>(nx, ny, nz, dx, dy, dz);
  const float sgn = dp > 0.0f ? -1.0f : 1.0f;  // -sign(dp), sign(0) = -1
  const float nlx = sgn * nx, nly = sgn * ny, nlz = sgn * nz;

  // Row 11: the reference's viszero classification (vec.h:44, y-bug
  // included), baked host-side from light_indices.
  if (sc[11 * n + id] > 0.5f) {
    if (spec) {
      const float adp = fabsf(dp);
      rad_r += adp * thr_r * sc[4 * n + id];
      rad_g += adp * thr_g * sc[5 * n + id];
      rad_b += adp * thr_b * sc[6 * n + id];
    }
    return false;  // a light ends the path
  }

  const float mat = sc[10 * n + id];
  const float tcr = thr_r * sc[7 * n + id];
  const float tcg = thr_g * sc[8 * n + id];
  const float tcb = thr_b * sc[9 * n + id];
  const float k2dp = 2.0f * dp;

  if (mat == 0.0f) {
    // DIFF: SampleLights (geomfunc.h:112-165). The reference evaluates
    // UniformSampleSphere(GetRandom(), GetRandom()) right to left: the
    // first draw is u2 (phi), the second u1 (zz).
    float ld_r = 0.0f, ld_g = 0.0f, ld_b = 0.0f;
    for (int k = 0; k < n_lights; ++k) {
      const int li = ls[k];
      const float u2 = draw<RNG>(s0, s1);
      const float u1 = draw<RNG>(s0, s1);
      const float zz = 1.0f - 2.0f * u1;
      const float rr = sqrtf(fmaxf(0.0f, 1.0f - zz * zz));
      const float phi = kTwoPi * u2;
      const float ux = rr * cosf(phi);
      const float uy = rr * sinf(phi);
      const float uz = zz;
      const float lrad = sc[3 * n + li];
      const float spx = lrad * ux + sc[0 * n + li] - hx;
      const float spy = lrad * uy + sc[1 * n + li] - hy;
      const float spz = lrad * uz + sc[2 * n + li] - hz;
      const float ln = sqrtf(spx * spx + spy * spy + spz * spz);
      const float ln_s = fmaxf(ln, 1e-20f);
      const float sdx = spx / ln_s, sdy = spy / ln_s, sdz = spz / ln_s;
      const float wo = sdx * ux + sdy * uy + sdz * uz;
      const float wi = sdx * nlx + sdy * nly + sdz * nlz;
      if (wo <= 0.0f && wi > 0.0f &&
          !any_hit<BLOCKED>(B, hx, hy, hz, sdx, sdy, sdz, ln - kEps)) {
        const float s =
            kFourPi * lrad * lrad * wi * (-wo) / (ln_s * ln_s);
        ld_r += s * sc[4 * n + li];
        ld_g += s * sc[5 * n + li];
        ld_b += s * sc[6 * n + li];
      }
    }
    rad_r += tcr * ld_r;
    rad_g += tcg * ld_g;
    rad_b += tcb * ld_b;
    if (DIRECT_ONLY) return false;  // RadianceDirectLighting: ends after NEE

    // Cosine-weighted bounce direction (geomfunc.h:242-265).
    const float r1u = draw<RNG>(s0, s1);
    const float r2u = draw<RNG>(s0, s1);
    const float ang = kTwoPi * r1u;
    const float r2s = sqrtf(r2u);
    const bool big_x = fabsf(nlx) > 0.1f;
    const float ax = big_x ? 0.0f : 1.0f;
    const float ay = big_x ? 1.0f : 0.0f;
    // u = norm(a x w); v = w x u
    const float ux0 = ay * nlz;
    const float uy0 = -ax * nlz;
    const float uz0 = ax * nly - ay * nlx;
    const float uinv = 1.0f / sqrtf(dot<R>(ux0, uy0, uz0, ux0, uy0, uz0));
    const float ux1 = ux0 * uinv, uy1 = uy0 * uinv, uz1 = uz0 * uinv;
    const float vx = sub<R>(mul<R>(nly, uz1), mul<R>(nlz, uy1));
    const float vy = sub<R>(mul<R>(nlz, ux1), mul<R>(nlx, uz1));
    const float vz = sub<R>(mul<R>(nlx, uy1), mul<R>(nly, ux1));
    const float ca = cosf(ang) * r2s;
    const float sa = sinf(ang) * r2s;
    const float wsc = sqrtf(fmaxf(0.0f, 1.0f - r2u));
    dx = dot<R>(ux1, vx, nlx, ca, sa, wsc);
    dy = dot<R>(uy1, vy, nly, ca, sa, wsc);
    dz = dot<R>(uz1, vz, nlz, ca, sa, wsc);
    thr_r = tcr;
    thr_g = tcg;
    thr_b = tcb;
    spec = false;
  } else if (mat == 1.0f) {
    // SPEC: mirror reflection (geomfunc.h:270-280).
    dx = sub<R>(dx, mul<R>(k2dp, nx));
    dy = sub<R>(dy, mul<R>(k2dp, ny));
    dz = sub<R>(dz, mul<R>(k2dp, nz));
    thr_r = tcr;
    thr_g = tcg;
    thr_b = tcb;
    spec = true;
  } else {
    // REFR: Fresnel-weighted Russian roulette (geomfunc.h:281-336).
    const bool into = dot<R>(nx, ny, nz, nlx, nly, nlz) > 0.0f;
    const float nnt = into ? (1.0f / 1.5f) : 1.5f;
    const float ddn = dot<R>(dx, dy, dz, nlx, nly, nlz);
    const float cos2t =
        sub<R>(1.0f, mul<R>(nnt * nnt, sub<R>(1.0f, mul<R>(ddn, ddn))));
    float scale = 1.0f;
    float ndx = sub<R>(dx, mul<R>(k2dp, nx));  // reflection, unless transmitted
    float ndy = sub<R>(dy, mul<R>(k2dp, ny));
    float ndz = sub<R>(dz, mul<R>(k2dp, nz));
    if (!(cos2t < 0.0f)) {  // not total internal reflection
      const float kk = (into ? 1.0f : -1.0f) * add<R>(mul<R>(ddn, nnt), sqrtf(cos2t));
      const float tdx0 = sub<R>(mul<R>(nnt, dx), mul<R>(kk, nx));
      const float tdy0 = sub<R>(mul<R>(nnt, dy), mul<R>(kk, ny));
      const float tdz0 = sub<R>(mul<R>(nnt, dz), mul<R>(kk, nz));
      const float tinv =
          1.0f / sqrtf(fmaxf(dot<R>(tdx0, tdy0, tdz0, tdx0, tdy0, tdz0), 1e-38f));
      const float tdx = tdx0 * tinv, tdy = tdy0 * tinv, tdz = tdz0 * tinv;
      const float r0 = 0.04f;  // float32(0.25 / 6.25)
      const float c1 = 1.0f - (into ? -ddn : dot<R>(tdx, tdy, tdz, nx, ny, nz));
      const float re = add<R>(r0, mul<R>((1.0f - r0) * c1 * c1 * c1 * c1, c1));
      const float pp = add<R>(0.25f, mul<R>(0.5f, re));
      const float u_rr = draw<RNG>(s0, s1);
      if (u_rr < pp) {
        scale = re / pp;
      } else {
        scale = (1.0f - re) / (1.0f - pp);
        ndx = tdx;
        ndy = tdy;
        ndz = tdz;
      }
    }
    dx = ndx;
    dy = ndy;
    dz = ndz;
    thr_r = scale * tcr;
    thr_g = scale * tcg;
    thr_b = scale * tcb;
    spec = true;
  }
  ox = hx;
  oy = hy;
  oz = hz;
  return true;
}

template <bool DIRECT_ONLY, int RNG, bool BLOCKED>
__global__ void __launch_bounds__(BLOCKED ? kThreadsK2 : kThreadsK1,
                                  BLOCKED ? 1 : kMinBlocksK1)
pt_pass_kernel(const float* __restrict__ scene, int n,
               const float* __restrict__ halves,
               const float* __restrict__ bounds, int nb,
               const float* __restrict__ groups, int ng,
               const float* __restrict__ rest, int cull_flag,
               const int* __restrict__ pix,
               const int* __restrict__ lights, int n_lights,
               const float* __restrict__ cam, int start_sample,
               int num_samples, const uint32_t* s0_in,
               const uint32_t* s1_in, const float* acc_in, uint32_t* s0_out,
               uint32_t* s1_out, float* acc_out, int rp, int lane_offset,
               int width, int height, float inv_w, float inv_h,
               int max_depth) {
  extern __shared__ __align__(16) float smem[];
  // Both: a (cx, cy, cz, rad) record per sphere. K1: then the [kRows, n]
  // table sc. K2: then the half block, block and group bounds of Blocked;
  // its table sc stays in device memory.
  float4* g4 = reinterpret_cast<float4*>(smem);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    g4[i] = make_float4(scene[i], scene[n + i], scene[2 * n + i],
                        scene[3 * n + i]);
  const float* sc;
  float* cs;
  Blocked B{g4, nullptr, nullptr, nullptr, make_float4(0.0f, 0.0f, 0.0f, 0.0f),
            n, 0, 0, false};
  if constexpr (BLOCKED) {
    float4* h4 = g4 + n;
    float4* b4 = h4 + 2 * nb;
    float4* q4 = b4 + nb;
    for (int i = threadIdx.x; i < 2 * nb; i += blockDim.x)
      h4[i] = make_float4(halves[i], halves[2 * nb + i], halves[4 * nb + i],
                          halves[6 * nb + i]);
    for (int i = threadIdx.x; i < nb; i += blockDim.x)
      b4[i] = make_float4(bounds[i], bounds[nb + i], bounds[2 * nb + i],
                          bounds[3 * nb + i]);
    for (int i = threadIdx.x; i < ng; i += blockDim.x)
      q4[i] = make_float4(groups[i], groups[ng + i], groups[2 * ng + i],
                          groups[3 * ng + i]);
    cs = reinterpret_cast<float*>(q4 + ng);
    sc = scene;
    B = Blocked{g4, h4, b4, q4, make_float4(rest[0], rest[1], rest[2], rest[3]),
                n, nb, ng, cull_flag != 0};
  } else {
    float* tab = reinterpret_cast<float*>(g4 + n);
    for (int i = threadIdx.x; i < kRows * n; i += blockDim.x) tab[i] = scene[i];
    sc = tab;
    cs = tab + kRows * n;
  }
  // cs: [12] orig, dir, x, y; ls: [n_lights]
  int* ls = reinterpret_cast<int*>(cs + 12);
  if (threadIdx.x < 12) cs[threadIdx.x] = cam[threadIdx.x];
  for (int i = threadIdx.x; i < n_lights; i += blockDim.x) ls[i] = lights[i];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= rp) return;

  uint32_t s0 = s0_in[lane];
  uint32_t s1 = s1_in[lane];
  float acc_r = acc_in[lane];
  float acc_g = acc_in[rp + lane];
  float acc_b = acc_in[2 * rp + lane];
  // Pixel coordinates with the framebuffer v-flip: row r is camera
  // y = height - 1 - r (rendering_kernel.cl:60-63). Pad lanes compute too.
  const int p = BLOCKED ? pix[lane] : lane_offset + lane;
  const float px = (float)(p % width);
  const float py = (float)((height - 1) - p / width);

  // Running mean (rendering_kernel.cl:80-89), in this order and with no
  // contraction into an FMA, as the TPU kernel rounds it.
  auto accumulate = [&](int pass, const Path& path) {
    const float samp = (float)(start_sample + pass);
    const float k2 = 1.0f / (samp + 1.0f);
    acc_r = __fmul_rn(__fadd_rn(__fmul_rn(acc_r, samp), path.rad_r), k2);
    acc_g = __fmul_rn(__fadd_rn(__fmul_rn(acc_g, samp), path.rad_g), k2);
    acc_b = __fmul_rn(__fadd_rn(__fmul_rn(acc_b, samp), path.rad_b), k2);
  };
  Path path;
  if constexpr (BLOCKED) {
    // K2: one loop over this lane's bounces of all passes. A lane whose path
    // ends starts its next pass's path at once, so a warp runs as many
    // bounces as its busiest lane traces over all passes, not the longest
    // path of every pass. Each lane runs its own draws and sums in the
    // order of the nested loops below: the result bits are theirs.
    int pass = 0, depth = 0;
    while (pass < num_samples) {
      if (depth == 0)
        camera<RNG, kRounded<BLOCKED>>(path, s0, s1, cs, px, py, inv_w, inv_h);
      if (depth < max_depth &&
          bounce<DIRECT_ONLY, RNG, BLOCKED>(path, s0, s1, sc, n, B, ls,
                                            n_lights) &&
          ++depth < max_depth)
        continue;
      accumulate(pass, path);
      ++pass;
      depth = 0;
    }
  } else {
    for (int pass = 0; pass < num_samples; ++pass) {
      camera<RNG, kRounded<BLOCKED>>(path, s0, s1, cs, px, py, inv_w, inv_h);
      for (int depth = 0; depth < max_depth; ++depth) {
        if (!bounce<DIRECT_ONLY, RNG, BLOCKED>(path, s0, s1, sc, n, B, ls,
                                               n_lights))
          break;
      }
      accumulate(pass, path);
    }
  }

  s0_out[lane] = s0;
  s1_out[lane] = s1;
  acc_out[lane] = acc_r;
  acc_out[rp + lane] = acc_g;
  acc_out[2 * rp + lane] = acc_b;
}

struct PassArgs {
  const float* scene;
  int n;
  const float* halves;
  const float* bounds;
  int nb;
  const float* groups;
  int ng;
  const float* rest;
  int cull;
  const int* pix;
  const int* lights;
  int n_lights;
  const float* cam;
  int start_sample;
  int num_samples;
  const uint32_t* s0_in;
  const uint32_t* s1_in;
  const float* acc_in;
  uint32_t* s0_out;
  uint32_t* s1_out;
  float* acc_out;
  int rp;
  int lane_offset;
  int width;
  int height;
  float inv_w;
  float inv_h;
  int max_depth;
};

template <bool DIRECT_ONLY, int RNG, bool BLOCKED>
cudaError_t launch(const PassArgs& a, cudaStream_t stream) {
  const int threads = BLOCKED ? kThreadsK2 : kThreadsK1;
  const size_t smem =
      sizeof(float4) * a.n +
      (BLOCKED ? sizeof(float4) * (3 * a.nb + a.ng) : sizeof(float) * kRows * a.n) +
      sizeof(float) * 12 + sizeof(int) * a.n_lights;
  if (smem > kSmemDefault) {
    // Past the default 48 KB a block's shared memory needs the kernel's
    // opt-in, up to the device's limit (227 KB on sm_90).
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
    if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(pt_pass_kernel<DIRECT_ONLY, RNG, BLOCKED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (a.rp + threads - 1) / threads;
  pt_pass_kernel<DIRECT_ONLY, RNG, BLOCKED><<<blocks, threads, smem, stream>>>(
      a.scene, a.n, a.halves, a.bounds, a.nb, a.groups, a.ng, a.rest, a.cull, a.pix,
      a.lights,
      a.n_lights,
      a.cam, a.start_sample, a.num_samples, a.s0_in, a.s1_in, a.acc_in,
      a.s0_out, a.s1_out, a.acc_out, a.rp, a.lane_offset, a.width, a.height, a.inv_w,
      a.inv_h, a.max_depth);
  return cudaGetLastError();
}

template <bool BLOCKED>
int dispatch(const PassArgs& a, int direct_only, int rng_counter,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (direct_only) {
    err = rng_counter ? launch<true, kCounter, BLOCKED>(a, st)
                      : launch<true, kMwc, BLOCKED>(a, st);
  } else {
    err = rng_counter ? launch<false, kCounter, BLOCKED>(a, st)
                      : launch<false, kMwc, BLOCKED>(a, st);
  }
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry points, bound with ctypes. scene: [12, n] float32; lights:
// [n_lights] int32 ascending; cam: [12] float32; s0/s1: [rp] uint32;
// acc: [3, rp] float32. In and out may not alias. Each returns
// cudaGetLastError() after the launch (0 = cudaSuccess).

// K1: pixel id = lane_offset + lane id; every sphere swept. lane_offset
// comes last, after the stream, so the other arguments keep the positions
// they had before it was added.
extern "C" int pt_multi_pass_cuda(
    const float* scene, int n, const int* lights, int n_lights,
    const float* cam, int start_sample, int num_samples,
    const uint32_t* s0_in, const uint32_t* s1_in, const float* acc_in,
    uint32_t* s0_out, uint32_t* s1_out, float* acc_out, int rp, int width,
    int height, float inv_w, float inv_h, int max_depth, int direct_only,
    int rng_counter, void* stream, int lane_offset) {
  const PassArgs a{scene, n, nullptr, nullptr, 0, nullptr, 0, nullptr, 0,
                   nullptr,
                   lights,
                   n_lights, cam,
                   start_sample, num_samples, s0_in, s1_in, acc_in, s0_out,
                   s1_out, acc_out, rp, lane_offset, width, height, inv_w, inv_h,
                   max_depth};
  return dispatch<false>(a, direct_only, rng_counter, stream);
}

// K2: halves: [4, 2 nb] float32 (half_bounds); bounds: [4, nb] float32
// (block_bounds), nb = n / 16; groups: [4, ng]
// float32 (group_bounds), ng = ceil(nb / 4); rest: [4] float32, the bound
// of spheres nb*16 .. n-1 (remainder_bound); pix: [rp] int32 pixel id per
// lane; cull != 0 skips the groups and blocks a ray cannot hit, or enters
// beyond what it has found.
extern "C" int pt_blocked_pass_cuda(
    const float* scene, int n, const float* halves, const float* bounds, int nb,
    const float* groups, int ng, const float* rest, int cull,
    const int* pix, const int* lights, int n_lights, const float* cam,
    int start_sample, int num_samples, const uint32_t* s0_in,
    const uint32_t* s1_in, const float* acc_in, uint32_t* s0_out,
    uint32_t* s1_out, float* acc_out, int rp, int width, int height,
    float inv_w, float inv_h, int max_depth, int direct_only,
    int rng_counter, void* stream) {
  const PassArgs a{scene, n, halves, bounds, nb, groups, ng, rest, cull, pix,
                   lights,
                   n_lights, cam,
                   start_sample, num_samples, s0_in, s1_in, acc_in, s0_out,
                   s1_out, acc_out, rp, 0, width, height, inv_w, inv_h,
                   max_depth};
  return dispatch<true>(a, direct_only, rng_counter, stream);
}

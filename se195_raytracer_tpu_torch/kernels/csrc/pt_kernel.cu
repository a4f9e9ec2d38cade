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
// per-lane state (s0, s1, acc: 20 bytes in, 20 bytes out per call).
// What the design does about it:
//   * the [12, N] scene table, the camera row and the light list (and for
//     K2 the [4, nb] block bounds) sit in shared memory, loaded once per
//     block; every thread reads the same sphere at the same time, so the
//     reads are broadcasts;
//   * the whole spp loop runs inside the kernel with the ray, throughput,
//     RNG state and accumulator in registers: no device-memory traffic per
//     bounce or per pass;
//   * a lane whose path ended (miss, light, or a DL diffuse hit) leaves the
//     bounce loop. This is exact: in the TPU kernel a dead lane's bounce is
//     the identity, since every draw there is masked by a subset of the
//     live lanes and every update is gated on them;
//   * K2 sweeps the spheres N-1 .. 0 as the remainder N-1 .. nb*16 first,
//     then blocks nb-1 .. 0 of kBlock = 16, and skips a block whose
//     inflated bounding sphere this lane's ray cannot hit (per ray, on the
//     nearest sweep and on every shadow sweep). The bounds are inflated
//     (x1.001 + 0.01) so that rounding can never reject a block holding a
//     true hit, and the order of the spheres that are tested is unchanged:
//     the cull is exact. Within a warp SIMT runs the union of its lanes'
//     surviving blocks, which amounts to a warp-level cull.
//
// One thread per lane over all Rp lanes, pad lanes included, so the state
// stays comparable with the JAX package's. K1's lane id is the absolute
// pixel id (the identity layout of ray_layout); K2 reads the pixel id of
// its lane from the pix table (the blocked layout: one 16 x 128 lane tile
// is one 64 x 32 image block; pad lanes hold pixel id W*H, camera y = -1).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC. Never --use_fast_math (approximate sinf/cosf/sqrtf and
// division, denormals flushed to zero). Every constant is a float literal.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreadsK1 = 128;
constexpr int kThreadsK2 = 256;
constexpr int kRows = 12;  // cx cy cz rad ex ey ez cr cg cb refl emissive
constexpr int kBlock = 16;  // SPHERE_BLOCK: spheres per culled block
constexpr float kEps = 0.01f;        // geomfunc.h:29 EPSILON
constexpr float kInf = 1e20f;        // geomfunc.h:80 initial nearest distance
constexpr float kTwoPi = 6.2831855f;   // float32(2 pi)
constexpr float kFourPi = 12.566371f;  // float32(4 pi)

enum { kMwc = 0, kCounter = 1 };

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

// SphereIntersect (geomfunc.h:32-59): distance, or 0 on a miss.
__device__ __forceinline__ float sphere_t(const float* sc, int n, int j,
                                          float ox, float oy, float oz,
                                          float dx, float dy, float dz) {
  const float opx = sc[0 * n + j] - ox;
  const float opy = sc[1 * n + j] - oy;
  const float opz = sc[2 * n + j] - oz;
  const float r = sc[3 * n + j];
  const float b = opx * dx + opy * dy + opz * dz;
  const float det = b * b - (opx * opx + opy * opy + opz * opz) + r * r;
  if (!(det >= 0.0f)) return 0.0f;
  const float sq = sqrtf(det);
  const float t1 = b - sq;
  const float t2 = b + sq;
  return t1 > kEps ? t1 : (t2 > kEps ? t2 : 0.0f);
}

// block_possible (JAX pt_kernel.py:239-255) for one ray: can it hit block
// t's bounding sphere ahead of its origin? bd: [4, nb] cx cy cz rad.
__device__ __forceinline__ bool block_possible(const float* bd, int nb, int t,
                                               float ox, float oy, float oz,
                                               float dx, float dy, float dz) {
  const float opx = bd[0 * nb + t] - ox;
  const float opy = bd[1 * nb + t] - oy;
  const float opz = bd[2 * nb + t] - oz;
  const float rb = bd[3 * nb + t];
  const float b = opx * dx + opy * dy + opz * dz;
  const float det = b * b - (opx * opx + opy * opy + opz * opz) + rb * rb;
  return det >= 0.0f && (b + sqrtf(fmaxf(det, 0.0f))) > 0.0f;
}

// The nearest hit (geomfunc.h:82-89): spheres N-1 .. 0, strict <, so the
// larger index wins a tie. BLOCKED: the remainder N-1 .. nb*16 first, then
// blocks nb-1 .. 0, each skipped when culled (JAX _culled_sweep :366-410).
template <bool BLOCKED>
__device__ __forceinline__ void nearest(const float* sc, int n,
                                        const float* bd, int nb, bool cull,
                                        float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        float& tb, int& id) {
  tb = kInf;
  id = 0;
  const int m = BLOCKED ? nb * kBlock : 0;
  for (int j = n - 1; j >= m; --j) {
    const float t = sphere_t(sc, n, j, ox, oy, oz, dx, dy, dz);
    if (t != 0.0f && t < tb) {
      tb = t;
      id = j;
    }
  }
  if constexpr (BLOCKED) {
    for (int blk = nb - 1; blk >= 0; --blk) {
      if (cull && !block_possible(bd, nb, blk, ox, oy, oz, dx, dy, dz)) continue;
#pragma unroll
      for (int k = kBlock - 1; k >= 0; --k) {
        const int j = blk * kBlock + k;
        const float t = sphere_t(sc, n, j, ox, oy, oz, dx, dy, dz);
        if (t != 0.0f && t < tb) {
          tb = t;
          id = j;
        }
      }
    }
  }
}

// IntersectP (geomfunc.h:94-110): any sphere hit strictly closer than maxt.
// BLOCKED: the same culled order as `nearest`; the bound test ignores maxt,
// a conservative superset.
template <bool BLOCKED>
__device__ __forceinline__ bool any_hit(const float* sc, int n,
                                        const float* bd, int nb, bool cull,
                                        float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        float maxt) {
  const int m = BLOCKED ? nb * kBlock : 0;
  for (int j = n - 1; j >= m; --j) {
    const float t = sphere_t(sc, n, j, ox, oy, oz, dx, dy, dz);
    if (t != 0.0f && t < maxt) return true;
  }
  if constexpr (BLOCKED) {
    for (int blk = nb - 1; blk >= 0; --blk) {
      if (cull && !block_possible(bd, nb, blk, ox, oy, oz, dx, dy, dz)) continue;
#pragma unroll
      for (int k = kBlock - 1; k >= 0; --k) {
        const float t = sphere_t(sc, n, blk * kBlock + k, ox, oy, oz, dx, dy, dz);
        if (t != 0.0f && t < maxt) return true;
      }
    }
  }
  return false;
}

template <bool DIRECT_ONLY, int RNG, bool BLOCKED>
__global__ void __launch_bounds__(BLOCKED ? kThreadsK2 : kThreadsK1)
pt_pass_kernel(const float* __restrict__ scene, int n,
               const float* __restrict__ bounds, int nb, int cull_flag,
               const int* __restrict__ pix,
               const int* __restrict__ lights, int n_lights,
               const float* __restrict__ cam, int start_sample,
               int num_samples, const uint32_t* s0_in,
               const uint32_t* s1_in, const float* acc_in, uint32_t* s0_out,
               uint32_t* s1_out, float* acc_out, int rp, int width,
               int height, float inv_w, float inv_h, int max_depth) {
  extern __shared__ float smem[];
  float* sc = smem;                     // [kRows, n]
  float* bd = smem + kRows * n;         // [4, nb] (K2 only; nb = 0 for K1)
  float* cs = bd + 4 * nb;              // [12] orig, dir, x, y
  int* ls = reinterpret_cast<int*>(cs + 12);  // [n_lights]
  for (int i = threadIdx.x; i < kRows * n; i += blockDim.x) sc[i] = scene[i];
  for (int i = threadIdx.x; i < 4 * nb; i += blockDim.x) bd[i] = bounds[i];
  if (threadIdx.x < 12) cs[threadIdx.x] = cam[threadIdx.x];
  for (int i = threadIdx.x; i < n_lights; i += blockDim.x) ls[i] = lights[i];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= rp) return;
  const bool cull = cull_flag != 0;

  uint32_t s0 = s0_in[lane];
  uint32_t s1 = s1_in[lane];
  float acc_r = acc_in[lane];
  float acc_g = acc_in[rp + lane];
  float acc_b = acc_in[2 * rp + lane];
  // Pixel coordinates with the framebuffer v-flip: row r is camera
  // y = height - 1 - r (rendering_kernel.cl:60-63). Pad lanes compute too.
  const int p = BLOCKED ? pix[lane] : lane;
  const float px = (float)(p % width);
  const float py = (float)((height - 1) - p / width);

  for (int pass = 0; pass < num_samples; ++pass) {
    // GenerateCameraRay (rendering_kernel.cl:29-51): 2 draws.
    const float r1 = draw<RNG>(s0, s1);
    const float r2 = draw<RNG>(s0, s1);
    const float kcx = (px + (r1 - 0.5f)) * inv_w - 0.5f;
    const float kcy = (py + (r2 - 0.5f)) * inv_h - 0.5f;
    const float rdx = cs[6] * kcx + cs[9] * kcy + cs[3];
    const float rdy = cs[7] * kcx + cs[10] * kcy + cs[4];
    const float rdz = cs[8] * kcx + cs[11] * kcy + cs[5];
    float ox = 0.1f * rdx + cs[0];
    float oy = 0.1f * rdy + cs[1];
    float oz = 0.1f * rdz + cs[2];
    const float rinv = 1.0f / sqrtf(rdx * rdx + rdy * rdy + rdz * rdz);
    float dx = rdx * rinv, dy = rdy * rinv, dz = rdz * rinv;

    float rad_r = 0.0f, rad_g = 0.0f, rad_b = 0.0f;
    float thr_r = 1.0f, thr_g = 1.0f, thr_b = 1.0f;
    bool spec = true;  // previous bounce specular: emission counts

    // Bounce loop (geomfunc.h:182-336).
    for (int depth = 0; depth < max_depth; ++depth) {
      float tb;
      int id;
      nearest<BLOCKED>(sc, n, bd, nb, cull, ox, oy, oz, dx, dy, dz, tb, id);
      if (!(tb < kInf)) break;  // miss: the path ends

      const float hx = ox + tb * dx;
      const float hy = oy + tb * dy;
      const float hz = oz + tb * dz;
      const float nx0 = hx - sc[0 * n + id];
      const float ny0 = hy - sc[1 * n + id];
      const float nz0 = hz - sc[2 * n + id];
      const float ninv =
          1.0f / sqrtf(fmaxf(nx0 * nx0 + ny0 * ny0 + nz0 * nz0, 1e-38f));
      const float nx = nx0 * ninv, ny = ny0 * ninv, nz = nz0 * ninv;
      const float dp = nx * dx + ny * dy + nz * dz;
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
        break;  // a light ends the path
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
              !any_hit<BLOCKED>(sc, n, bd, nb, cull, hx, hy, hz, sdx, sdy,
                                sdz, ln - kEps)) {
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
        if (DIRECT_ONLY) break;  // RadianceDirectLighting: ends after NEE

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
        const float uinv = 1.0f / sqrtf(ux0 * ux0 + uy0 * uy0 + uz0 * uz0);
        const float ux1 = ux0 * uinv, uy1 = uy0 * uinv, uz1 = uz0 * uinv;
        const float vx = nly * uz1 - nlz * uy1;
        const float vy = nlz * ux1 - nlx * uz1;
        const float vz = nlx * uy1 - nly * ux1;
        const float ca = cosf(ang) * r2s;
        const float sa = sinf(ang) * r2s;
        const float wsc = sqrtf(fmaxf(0.0f, 1.0f - r2u));
        dx = ux1 * ca + vx * sa + nlx * wsc;
        dy = uy1 * ca + vy * sa + nly * wsc;
        dz = uz1 * ca + vz * sa + nlz * wsc;
        thr_r = tcr;
        thr_g = tcg;
        thr_b = tcb;
        spec = false;
      } else if (mat == 1.0f) {
        // SPEC: mirror reflection (geomfunc.h:270-280).
        dx = dx - k2dp * nx;
        dy = dy - k2dp * ny;
        dz = dz - k2dp * nz;
        thr_r = tcr;
        thr_g = tcg;
        thr_b = tcb;
        spec = true;
      } else {
        // REFR: Fresnel-weighted Russian roulette (geomfunc.h:281-336).
        const bool into = (nx * nlx + ny * nly + nz * nlz) > 0.0f;
        const float nnt = into ? (1.0f / 1.5f) : 1.5f;
        const float ddn = dx * nlx + dy * nly + dz * nlz;
        const float cos2t = 1.0f - nnt * nnt * (1.0f - ddn * ddn);
        float scale = 1.0f;
        float ndx = dx - k2dp * nx;  // reflection, unless transmitted
        float ndy = dy - k2dp * ny;
        float ndz = dz - k2dp * nz;
        if (!(cos2t < 0.0f)) {  // not total internal reflection
          const float kk = (into ? 1.0f : -1.0f) * (ddn * nnt + sqrtf(cos2t));
          const float tdx0 = nnt * dx - kk * nx;
          const float tdy0 = nnt * dy - kk * ny;
          const float tdz0 = nnt * dz - kk * nz;
          const float tinv = 1.0f / sqrtf(fmaxf(
              tdx0 * tdx0 + tdy0 * tdy0 + tdz0 * tdz0, 1e-38f));
          const float tdx = tdx0 * tinv, tdy = tdy0 * tinv, tdz = tdz0 * tinv;
          const float r0 = 0.04f;  // float32(0.25 / 6.25)
          const float c1 = 1.0f - (into ? -ddn : (tdx * nx + tdy * ny + tdz * nz));
          const float re = r0 + (1.0f - r0) * c1 * c1 * c1 * c1 * c1;
          const float pp = 0.25f + 0.5f * re;
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
    }

    // Running mean (rendering_kernel.cl:80-89), in this order and with no
    // contraction into an FMA, as the TPU kernel rounds it.
    const float samp = (float)(start_sample + pass);
    const float k2 = 1.0f / (samp + 1.0f);
    acc_r = __fmul_rn(__fadd_rn(__fmul_rn(acc_r, samp), rad_r), k2);
    acc_g = __fmul_rn(__fadd_rn(__fmul_rn(acc_g, samp), rad_g), k2);
    acc_b = __fmul_rn(__fadd_rn(__fmul_rn(acc_b, samp), rad_b), k2);
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
  const float* bounds;
  int nb;
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
  int width;
  int height;
  float inv_w;
  float inv_h;
  int max_depth;
};

template <bool DIRECT_ONLY, int RNG, bool BLOCKED>
cudaError_t launch(const PassArgs& a, cudaStream_t stream) {
  const int threads = BLOCKED ? kThreadsK2 : kThreadsK1;
  const size_t smem = sizeof(float) * (kRows * a.n + 4 * a.nb + 12) +
                      sizeof(int) * a.n_lights;
  const int blocks = (a.rp + threads - 1) / threads;
  pt_pass_kernel<DIRECT_ONLY, RNG, BLOCKED><<<blocks, threads, smem, stream>>>(
      a.scene, a.n, a.bounds, a.nb, a.cull, a.pix, a.lights, a.n_lights,
      a.cam, a.start_sample, a.num_samples, a.s0_in, a.s1_in, a.acc_in,
      a.s0_out, a.s1_out, a.acc_out, a.rp, a.width, a.height, a.inv_w,
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

// K1: lane id = pixel id; every sphere swept.
extern "C" int pt_multi_pass_cuda(
    const float* scene, int n, const int* lights, int n_lights,
    const float* cam, int start_sample, int num_samples,
    const uint32_t* s0_in, const uint32_t* s1_in, const float* acc_in,
    uint32_t* s0_out, uint32_t* s1_out, float* acc_out, int rp, int width,
    int height, float inv_w, float inv_h, int max_depth, int direct_only,
    int rng_counter, void* stream) {
  const PassArgs a{scene, n, nullptr, 0, 0, nullptr, lights, n_lights, cam,
                   start_sample, num_samples, s0_in, s1_in, acc_in, s0_out,
                   s1_out, acc_out, rp, width, height, inv_w, inv_h,
                   max_depth};
  return dispatch<false>(a, direct_only, rng_counter, stream);
}

// K2: bounds: [4, nb] float32 (block_bounds), nb = n / 16; pix: [rp] int32
// pixel id per lane; cull != 0 skips the blocks a ray cannot hit.
extern "C" int pt_blocked_pass_cuda(
    const float* scene, int n, const float* bounds, int nb, int cull,
    const int* pix, const int* lights, int n_lights, const float* cam,
    int start_sample, int num_samples, const uint32_t* s0_in,
    const uint32_t* s1_in, const float* acc_in, uint32_t* s0_out,
    uint32_t* s1_out, float* acc_out, int rp, int width, int height,
    float inv_w, float inv_h, int max_depth, int direct_only,
    int rng_counter, void* stream) {
  const PassArgs a{scene, n, bounds, nb, cull, pix, lights, n_lights, cam,
                   start_sample, num_samples, s0_in, s1_in, acc_in, s0_out,
                   s1_out, acc_out, rp, width, height, inv_w, inv_h,
                   max_depth};
  return dispatch<true>(a, direct_only, rng_counter, stream);
}

// K3 on Hopper: the Whitted reflect/refract tree tracer (Raytracer3.2.0x /
// 3.0.06 family).
//
// Replaces the TPU kernel se195_raytracer_tpu/kernels/whitted_kernel.py
// _make_whitted_kernel, driven there by whitted_trace_pallas_padded
// (explicit rays) and whitted_frame_pallas (camera rays made in the kernel),
// and its debug taps (whitted_trace_pallas_padded(debug_tap=...)), which
// whitted_taps_kernel carries here.
// Computes, per primary ray, the bounded binary tree of depth trace_depth
// (63 nodes at depth 5): the order-dependent nearest hit over planes and
// spheres with the optional 3.2.03 hit_bias, hard shadows toward the
// sphere lights' centers, N.L diffuse plus Phong^20, and the reflection and
// refraction children with Beer's law on the parent's travel distance.
//
// What bounds it on this card: FP32 work that the build cannot fuse. A
// live node costs a nearest sweep over the N primitives (~10-17 ops each,
// with an IEEE division per plane and an IEEE sqrtf per sphere) and a
// shadow sweep over the non-light primitives for each sphere light; device
// memory sees only the finished frame (12 bytes per pixel) and the rays of
// the explicit entry. Built with -fmad=false (below), the card issues at
// most half of its 67 TFLOP/s FP32 peak, so K3 can reach at most 50% of a
// bound stated against that peak. The work per ray is very uneven (1 node
// over the walls, up to 63 over the glass spheres), so what the design
// fights is divergence and the tail, then instruction count per test:
//   * one thread per subsample ray (frame entry): a block of kThreads
//     threads traces the ss^2 camera rays of floor(kThreads / ss^2)
//     neighbouring pixels, so a warp holds neighbouring subsample rays,
//     which walk similar trees; at 800x600 3x3 that is 4,320,000 threads,
//     ~16 waves of the card, so no long tail of slow pixels. Each ray's
//     color goes to shared memory; the pixel's sum is then read back in ray
//     order (tx outer, ty inner, from subsample 0), as the plain version's
//     reduce_subsamples sums it, x 256/ss^2, clamped, written [H, W, 3]
//     (held bitwise against the plain render on the card, also where the
//     last block is partial: test_k3_bitwise_on_cuda, chip_smoke.py);
//   * at scene load the [18, N] table is repacked in shared memory into
//     records that a warp reads as 16-byte broadcasts: geometry (plane
//     normal and depth, or sphere center and r^2) in one float4, color and
//     refl in a second, diff / spec / refr / refr_index in a third; a kind
//     word per primitive (plane, light). The nearest fold still runs
//     0..N-1 with its strict < and hit_bias. The shadow sweep runs over a
//     list of the non-light primitives, spheres first: its result is an
//     any(), which no order changes, and inside the room the walls never
//     occlude a light, so the spheres find the occluders sooner. The
//     lights are a list too;
//   * the tree is walked depth first, pre-order, reflection before
//     refraction (the order in which the plain version, models/whitted.
//     whitted_trace, sums the nodes); only live nodes are traced, so dead
//     subtrees cost nothing. A pending refraction child is 12 words
//     (origin, direction, weight, transparency, index of refraction,
//     level): it needs neither the parent's color nor a type. The stack of
//     at most trace_depth such entries is a local array, which L1 holds: a
//     slice of shared memory per thread ([slot][word][thread], 240 bytes
//     at depth 5) was measured 8% slower on the room frame, because it cut
//     the threads an SM holds from 1024 to 768;
//   * the shadow sweep stops at its first occluder (the reference breaks
//     there too, raytrace:199-212).
//
// Rounding: built with -fmad=false, so every a * b + c rounds twice, as the
// plain version's separate tensor ops do; the expressions keep its order.
// x^20 is the multiply chain of the plain version; Beer's law uses expf
// (never __expf). A hit farther than 1e6 is clamped to 1e6, as the TPU
// kernel does (whitted_kernel.py:302).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC -fmad=false. Never --use_fast_math.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDepth = 8;
constexpr int kStackWords = 12;  // one pending refraction child
constexpr float kEps = 0.001f;    // W_EPSILON (raytracer_kernel.cl:30)
constexpr float kBeer = 0.15f;    // raytracer_kernel.cl:370
constexpr float kMaxDist = 1e6f;  // whitted_kernel.py:302

// Kind bits of a primitive.
constexpr int kPlane = 1;
constexpr int kLight = 2;

// The scene as the kernel reads it, in shared memory (see Layout).
struct Scene {
  const float4* geom;  // plane (nx, ny, nz, depth) | sphere (cx, cy, cz, r^2)
  const float4* col;   // (r, g, b, refl)
  const float4* mat;   // (diff, spec, refr, refr_index)
  const float4* lpos;  // per light: table center (x, y, z), w = 1 for a plane
  const float4* lcol;  // per light: (r, g, b, 0)
  const float* rrad;   // 1 / radius
  const int* kind;     // kPlane | kLight
  const int* occ;      // the non-light primitives: spheres, then planes
  int n, nl, no;
  float bias;
};

// The camera row [O(3), X(3), Y(3), C(3)] (whitted_camera_row), passed to
// the frame kernel by value: the launch takes its bytes from the host, so
// no copy to the device precedes it.
struct CamRow {
  float v[12];
};

// Byte offsets of the dynamic shared memory: 5 float4 records per
// primitive, then 1 / radius, kind and the occluder list, the two list
// lengths, the camera row and the block's ray colors.
struct Layout {
  size_t geom, col, mat, lpos, lcol, rrad, kind, occ, counts, cam, color, total;
  __host__ __device__ Layout(int n, int color_floats) {
    geom = 0;
    col = geom + 16 * (size_t)n;
    mat = col + 16 * (size_t)n;
    lpos = mat + 16 * (size_t)n;
    lcol = lpos + 16 * (size_t)n;
    rrad = lcol + 16 * (size_t)n;
    kind = rrad + 4 * (size_t)n;
    occ = kind + 4 * (size_t)n;
    counts = occ + 4 * (size_t)n;
    cam = counts + 8;
    color = cam + 4 * 12;
    total = color + 4 * (size_t)color_floats;
  }
};

__device__ __forceinline__ float pow20(float x) {
  const float x2 = x * x;
  const float x5 = x2 * x2 * x;
  const float x10 = x5 * x5;
  return x10 * x10;
}

// Sphere quadratic (raytracer_kernel.cl:104-137) on g = (center, r^2).
// Returns false on a miss or when the sphere is wholly behind the origin.
__device__ __forceinline__ bool sphere_roots(float4 g, float ox, float oy,
                                             float oz, float dx, float dy,
                                             float dz, float& i1, float& i2) {
  const float vx = ox - g.x;
  const float vy = oy - g.y;
  const float vz = oz - g.z;
  const float b = -(vx * dx + vy * dy + vz * dz);
  const float det = b * b - (vx * vx + vy * vy + vz * vz) + g.w;
  if (!(det > 0.0f)) return false;
  const float sq = sqrtf(det);
  i1 = b - sq;
  i2 = b + sq;
  return i2 > 0.0f;
}

// Plane test (raytracer_kernel.cl:89-102) on g = (normal, depth). Returns
// false when parallel or behind.
__device__ __forceinline__ bool plane_dist(float4 g, float ox, float oy,
                                           float oz, float dx, float dy,
                                           float dz, float& dist) {
  const float nd = g.x * dx + g.y * dy + g.z * dz;
  const float no = g.x * ox + g.y * oy + g.z * oz;
  const float nd_safe = nd != 0.0f ? nd : 1.0f;
  dist = -(no + g.w) / nd_safe;
  return nd != 0.0f && dist > 0.0f;
}

// The order-dependent nearest fold over primitives 0..N-1 (raytrace:
// 163-177). Returns the primitive or -1; res = HIT (1) or INPRIM (-1).
__device__ int nearest(const Scene& s, float ox, float oy, float oz, float dx,
                       float dy, float dz, float& cumu, float& res) {
  cumu = FLT_MAX;
  res = 0.0f;
  int idx = -1;
  for (int j = 0; j < s.n; ++j) {
    const float4 g = s.geom[j];
    if (s.kind[j] & kPlane) {
      float pd;
      if (plane_dist(g, ox, oy, oz, dx, dy, dz, pd) && pd < cumu) {
        cumu = pd;
        idx = j;
        res = 1.0f;
      }
    } else {
      float i1, i2;
      if (!sphere_roots(g, ox, oy, oz, dx, dy, dz, i1, i2)) continue;
      const bool inprim = i1 < 0.0f && i2 < cumu;
      const bool hit_near = i1 >= 0.0f && i1 < cumu + s.bias;
      if (inprim || hit_near) {
        cumu = i1 < 0.0f ? i2 : i1;
        idx = j;
        res = inprim ? -1.0f : 1.0f;
      }
    }
  }
  return idx;
}

// Shadow predicate (raytrace:199-212): a non-light primitive closer than
// maxt. Stops at the first one; any order gives the same answer.
__device__ bool occluded(const Scene& s, float ox, float oy, float oz,
                         float dx, float dy, float dz, float maxt) {
  for (int k = 0; k < s.no; ++k) {
    const int j = s.occ[k];
    const float4 g = s.geom[j];
    if (s.kind[j] & kPlane) {
      float pd;
      if (plane_dist(g, ox, oy, oz, dx, dy, dz, pd) && pd < maxt) return true;
    } else {
      float i1, i2;
      if (sphere_roots(g, ox, oy, oz, dx, dy, dz, i1, i2) &&
          (i1 < 0.0f ? i2 < maxt : i1 < maxt + s.bias))
        return true;
    }
  }
  return false;
}

// The local shading of a hit on primitive idx at (px, py, pz) by a ray of
// direction (dx, dy, dz) (raytrace:179-242): the hit's normal, and its
// color, added into col_*: a light's own color, else N.L diffuse and
// Phong^20 over the lights with hard shadows toward each sphere light's
// center.
__device__ __forceinline__ void local_shade(const Scene& s, int idx, float px,
                                            float py, float pz, float dx,
                                            float dy, float dz, float& nx,
                                            float& ny, float& nz,
                                            float& col_r, float& col_g,
                                            float& col_b) {
  const float4 g = s.geom[idx];
  const int kind = s.kind[idx];
  const float4 hcol = s.col[idx];
  if (kind & kPlane) {
    nx = g.x;
    ny = g.y;
    nz = g.z;
  } else {
    const float rr = s.rrad[idx];
    nx = (px - g.x) * rr;
    ny = (py - g.y) * rr;
    nz = (pz - g.z) * rr;
  }
  const float m_r = hcol.x, m_g = hcol.y, m_b = hcol.z;
  if (kind & kLight) {
    col_r = m_r;
    col_g = m_g;
    col_b = m_b;
    return;
  }
  const float4 hmat = s.mat[idx];
  const float m_diff = hmat.x, m_spec = hmat.y;
  for (int k = 0; k < s.nl; ++k) {
    const float4 lp = s.lpos[k];
    const float4 lc = s.lcol[k];
    const float lvx = lp.x - px;
    const float lvy = lp.y - py;
    const float lvz = lp.z - pz;
    const float llen = sqrtf(fmaxf(lvx * lvx + lvy * lvy + lvz * lvz, 1e-30f));
    const float ldx = lvx / llen, ldy = lvy / llen, ldz = lvz / llen;
    float shade = 1.0f;
    if (lp.w == 0.0f &&
        occluded(s, px + ldx * kEps, py + ldy * kEps, pz + ldz * kEps, ldx,
                 ldy, ldz, llen))
      shade = 0.0f;
    // Diffuse: dot(N, L) > 0 (raytracer_kernel.cl:215-223).
    const float dnl = nx * ldx + ny * ldy + nz * ldz;
    if (m_diff > 0.0f && dnl > 0.0f) {
      const float dterm = dnl * m_diff * shade;
      col_r = col_r + dterm * m_r * lc.x;
      col_g = col_g + dterm * m_g * lc.y;
      col_b = col_b + dterm * m_b * lc.z;
    }
    // Specular: R = L - 2 dot(L, N) N; powr(dot(V, R), 20) (:225-236).
    const float k2 = 2.0f * dnl;
    const float rvx = ldx - k2 * nx;
    const float rvy = ldy - k2 * ny;
    const float rvz = ldz - k2 * nz;
    const float dvr = dx * rvx + dy * rvy + dz * rvz;
    const float sterm = (m_spec > 0.0f && dvr > 0.0f)
                            ? pow20(fmaxf(dvr, 0.0f)) * m_spec * shade
                            : 0.0f;
    col_r = col_r + sterm * lc.x;
    col_g = col_g + sterm * lc.y;
    col_b = col_b + sterm * lc.z;
  }
}

// The ray being traced: a tree node with its scalar weight, Beer
// transparency, the immediate parent's color (reflection rays only) and the
// refractive index it travels in.
struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float weight;
  float tr, tg, tb;  // transparency
  float pr, pg, pb;  // parent color
  float ridx;
  int level;
  int type;  // 0 origin, 1 reflected, 2 refracted
};

// Traces one primary ray's tree; returns its summed color.
__device__ void trace_tree(const Scene& s, float ox, float oy, float oz,
                           float dx, float dy, float dz, int trace_depth,
                           float& out_r, float& out_g, float& out_b) {
  // The pending refraction children, kStackWords words each.
  float stack[kMaxDepth * kStackWords];
  int top = 0;
  Ray ray{ox, oy, oz, dx, dy, dz, 1.0f, 1.0f, 1.0f, 1.0f,
          1.0f, 1.0f, 1.0f, 1.0f, 0, 0};
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  while (true) {
    // raytrace: nearest hit and local shading.
    float cumu, res;
    const int idx = nearest(s, ray.ox, ray.oy, ray.oz, ray.dx, ray.dy, ray.dz,
                            cumu, res);
    const bool hit = idx >= 0;
    const float dist = fminf(hit ? cumu : 1.0f, kMaxDist);
    const float px = ray.ox + ray.dx * dist;
    const float py = ray.oy + ray.dy * dist;
    const float pz = ray.oz + ray.dz * dist;
    float col_r = 0.0f, col_g = 0.0f, col_b = 0.0f;
    float nx = 0.0f, ny = 0.0f, nz = 0.0f;
    if (hit)
      local_shade(s, idx, px, py, pz, ray.dx, ray.dy, ray.dz, nx, ny, nz,
                  col_r, col_g, col_b);
    // The node's contribution (raytracer_kernel.cl:317-328): color x weight
    // x (1 | parent color x transparency | transparency).
    float f_r = 1.0f, f_g = 1.0f, f_b = 1.0f;
    if (ray.type == 1) {
      f_r = ray.pr * ray.tr;
      f_g = ray.pg * ray.tg;
      f_b = ray.pb * ray.tb;
    } else if (ray.type == 2) {
      f_r = ray.tr;
      f_g = ray.tg;
      f_b = ray.tb;
    }
    acc_r = acc_r + col_r * ray.weight * f_r;
    acc_g = acc_g + col_g * ray.weight * f_g;
    acc_b = acc_b + col_b * ray.weight * f_b;

    bool next = false;
    if (hit && ray.level < trace_depth) {
      const float4 hcol = s.col[idx];
      const float4 hmat = s.mat[idx];
      const float c_r = hcol.x, c_g = hcol.y, c_b = hcol.z;
      // Refraction child (raytracer_kernel.cl:350-372), kept for later.
      const float refr_f = hmat.z;
      const float m_ri = hmat.w;
      const float ridx_m = m_ri != 0.0f ? m_ri : 1.0f;
      const float n_ratio = ray.ridx / ridx_m;
      const float n2x = nx * res, n2y = ny * res, n2z = nz * res;
      const float cos_i = -(n2x * ray.dx + n2y * ray.dy + n2z * ray.dz);
      const float cos_t2 = 1.0f - n_ratio * n_ratio * (1.0f - cos_i * cos_i);
      if (refr_f > 0.0f && cos_t2 > 0.0f) {
        const float kk = n_ratio * cos_i - sqrtf(cos_t2);
        const float tdx = n_ratio * ray.dx + kk * n2x;
        const float tdy = n_ratio * ray.dy + kk * n2y;
        const float tdz = n_ratio * ray.dz + kk * n2z;
        stack[top * kStackWords + 0] = px + tdx * kEps;
        stack[top * kStackWords + 1] = py + tdy * kEps;
        stack[top * kStackWords + 2] = pz + tdz * kEps;
        stack[top * kStackWords + 3] = tdx;
        stack[top * kStackWords + 4] = tdy;
        stack[top * kStackWords + 5] = tdz;
        stack[top * kStackWords + 6] = ray.weight;
        // Beer's law with the PARENT ray's travel distance (:370).
        stack[top * kStackWords + 7] = ray.tr * expf(c_r * kBeer * (-dist));
        stack[top * kStackWords + 8] = ray.tg * expf(c_g * kBeer * (-dist));
        stack[top * kStackWords + 9] = ray.tb * expf(c_b * kBeer * (-dist));
        stack[top * kStackWords + 10] = ridx_m;
        stack[top * kStackWords + 11] = __int_as_float(ray.level + 1);
        ++top;
      }
      // Reflection child (raytracer_kernel.cl:332-348), traced next.
      const float refl_f = hcol.w;
      if (refl_f > 0.0f) {
        const float k2 = 2.0f * (ray.dx * nx + ray.dy * ny + ray.dz * nz);
        const float rdx = ray.dx - k2 * nx;
        const float rdy = ray.dy - k2 * ny;
        const float rdz = ray.dz - k2 * nz;
        ray.ox = px + rdx * kEps;
        ray.oy = py + rdy * kEps;
        ray.oz = pz + rdz * kEps;
        ray.dx = rdx;
        ray.dy = rdy;
        ray.dz = rdz;
        ray.weight = refl_f * ray.weight;
        ray.pr = c_r;
        ray.pg = c_g;
        ray.pb = c_b;
        ray.level += 1;
        ray.type = 1;
        next = true;
      }
    }
    if (!next) {
      if (top == 0) break;
      --top;
      ray.ox = stack[top * kStackWords + 0];
      ray.oy = stack[top * kStackWords + 1];
      ray.oz = stack[top * kStackWords + 2];
      ray.dx = stack[top * kStackWords + 3];
      ray.dy = stack[top * kStackWords + 4];
      ray.dz = stack[top * kStackWords + 5];
      ray.weight = stack[top * kStackWords + 6];
      ray.tr = stack[top * kStackWords + 7];
      ray.tg = stack[top * kStackWords + 8];
      ray.tb = stack[top * kStackWords + 9];
      ray.ridx = stack[top * kStackWords + 10];
      ray.level = __float_as_int(stack[top * kStackWords + 11]);
      ray.type = 2;
    }
  }
  out_r = acc_r;
  out_g = acc_g;
  out_b = acc_b;
}

// Repacks the [kRows, n] table into the records of Layout and builds the
// light and occluder lists. Ends with the block synchronised.
__device__ Scene load_scene(const float* t, const int* light, int n,
                            float bias, unsigned char* smem, const Layout& L) {
  float4* geom = reinterpret_cast<float4*>(smem + L.geom);
  float4* col = reinterpret_cast<float4*>(smem + L.col);
  float4* mat = reinterpret_cast<float4*>(smem + L.mat);
  float4* lpos = reinterpret_cast<float4*>(smem + L.lpos);
  float4* lcol = reinterpret_cast<float4*>(smem + L.lcol);
  float* rrad = reinterpret_cast<float*>(smem + L.rrad);
  int* kind = reinterpret_cast<int*>(smem + L.kind);
  int* occ = reinterpret_cast<int*>(smem + L.occ);
  int* counts = reinterpret_cast<int*>(smem + L.counts);
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const bool plane = t[j] == 0.0f;
    geom[j] = plane ? make_float4(t[n + j], t[2 * n + j], t[3 * n + j], t[4 * n + j])
                    : make_float4(t[5 * n + j], t[6 * n + j], t[7 * n + j],
                                  t[8 * n + j]);
    col[j] = make_float4(t[10 * n + j], t[11 * n + j], t[12 * n + j],
                         t[13 * n + j]);
    mat[j] = make_float4(t[14 * n + j], t[15 * n + j], t[16 * n + j],
                         t[17 * n + j]);
    rrad[j] = t[9 * n + j];
    kind[j] = (plane ? kPlane : 0) | (light[j] ? kLight : 0);
  }
  if (threadIdx.x == 0) {
    int nl = 0, no = 0;
    for (int j = 0; j < n; ++j) {
      const bool plane = t[j] == 0.0f;
      if (light[j]) {
        lpos[nl] = make_float4(t[5 * n + j], t[6 * n + j], t[7 * n + j],
                               plane ? 1.0f : 0.0f);
        lcol[nl] = make_float4(t[10 * n + j], t[11 * n + j], t[12 * n + j],
                               0.0f);
        ++nl;
      } else if (!plane) {
        occ[no++] = j;
      }
    }
    for (int j = 0; j < n; ++j)
      if (!light[j] && t[j] == 0.0f) occ[no++] = j;
    counts[0] = nl;
    counts[1] = no;
  }
  __syncthreads();
  return Scene{geom, col, mat, lpos, lcol, rrad, kind, occ,
               n, counts[0], counts[1], bias};
}

// Explicit rays: rays [6, rp] (o, d) -> acc [3, rp], one thread per ray.
__global__ void __launch_bounds__(kThreads)
whitted_rays_kernel(const float* __restrict__ table,
                    const int* __restrict__ light, int n, float bias,
                    int trace_depth, const float* __restrict__ rays,
                    float* __restrict__ acc, int rp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(n, 0);
  const Scene s = load_scene(table, light, n, bias, smem, L);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= rp) return;
  float r, g, b;
  trace_tree(s, rays[i], rays[rp + i], rays[2 * rp + i],
             rays[3 * rp + i], rays[4 * rp + i], rays[5 * rp + i],
             trace_depth, r, g, b);
  acc[i] = r;
  acc[rp + i] = g;
  acc[2 * rp + i] = b;
}

// Frame: one thread per subsample ray. Block b traces the ss^2 camera rays
// of pixels b*ppb .. b*ppb + ppb - 1 (ray q of the block: pixel q / ss^2,
// subsample q % ss^2 = tx * ss + ty), made from the camera row [O, X, Y, C]
// that the launch passes by value and each block puts in shared memory
// (whitted_kernel.py:150-194, models/whitted.whitted_camera_rays_device);
// a thread takes rays q, q + kThreads, ... when ppb * ss^2 > kThreads. The
// colors meet in shared memory, [3][ppb * ss^2]; each pixel's subsamples
// are summed in ray order from subsample 0, x scale, clamped to 0..255
// into frame [H, W, 3].
__global__ void __launch_bounds__(kThreads)
whitted_frame_kernel(const float* __restrict__ table,
                     const int* __restrict__ light, int n, float bias,
                     int trace_depth, const __grid_constant__ CamRow cam,
                     int width, int height, int ss, int ppb, float dxs,
                     float dys, float hdx, float hdy, float scale,
                     float* __restrict__ frame) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ss2 = ss * ss;
  const int rays = ppb * ss2;
  const Layout L(n, 3 * rays);
  float* cs = reinterpret_cast<float*>(smem + L.cam);
  if (threadIdx.x < 12) cs[threadIdx.x] = cam.v[threadIdx.x];
  const Scene s = load_scene(table, light, n, bias, smem, L);
  float* color = reinterpret_cast<float*>(smem + L.color);
  const int npix = width * height;
  const int pix0 = blockIdx.x * ppb;
  const int half = ss / 2;
  for (int q = threadIdx.x; q < rays; q += kThreads) {
    const int lp = q / ss2;
    const int sub = q - lp * ss2;
    const int pix = pix0 + lp;
    float r = 0.0f, g = 0.0f, b = 0.0f;
    if (pix < npix) {
      const int txi = sub / ss;
      const int tyi = sub - txi * ss;
      const int x = pix % width;
      const int y = pix / width;
      const float sx = (-3.0f + (float)x * dxs) + (float)(txi - half) * hdx;
      const float sy = (2.25f + (float)y * dys) + (float)(tyi - half) * hdy;
      const float rdx = cs[3] * sx + cs[6] * sy + cs[9];
      const float rdy = cs[4] * sx + cs[7] * sy + cs[10];
      const float rdz = cs[5] * sx + cs[8] * sy + cs[11];
      const float inv = 1.0f / sqrtf(rdx * rdx + rdy * rdy + rdz * rdz);
      trace_tree(s, cs[0], cs[1], cs[2], rdx * inv, rdy * inv, rdz * inv,
                 trace_depth, r, g, b);
    }
    color[q] = r;
    color[rays + q] = g;
    color[2 * rays + q] = b;
  }
  __syncthreads();
  // Component e of the block's output: pixel e / 3, channel e % 3, so the
  // writes are consecutive floats of the frame.
  for (int e = threadIdx.x; e < 3 * ppb; e += kThreads) {
    const int lp = e / 3;
    const int c = e - 3 * lp;
    if (pix0 + lp >= npix) break;
    const float* sub = color + c * rays + lp * ss2;
    float sum = sub[0];
    for (int k = 1; k < ss2; ++k) sum = sum + sub[k];
    // Clamped to 0..255 with a NaN kept, as jnp.clip and torch.clamp keep
    // it (fmaxf alone would turn it into 0): on a dense scene a few trees'
    // directions grow in length until a Phong term is inf * 0, which gives
    // NaN in the JAX package's formulas and the plain version alike.
    const float v = sum * scale;
    frame[3 * pix0 + e] = v != v ? v : fminf(fmaxf(v, 0.0f), 255.0f);
  }
}

// The taps' scene load: the [kRows, n] table repacked into the records of
// Layout, as load_scene does, but with the light and occluder lists handed
// in (lists: the nl light indices, then the no occluders in load_scene's
// order; per-scene constants that the wrapper makes once), so every thread
// copies and none walks the table alone. Ends with the block synchronised.
__device__ Scene load_tap_scene(const float* t, const int* light, const int* lists, int n,
                                int nl, int no, float bias, unsigned char* smem,
                                const Layout& L) {
  float4* geom = reinterpret_cast<float4*>(smem + L.geom);
  float4* col = reinterpret_cast<float4*>(smem + L.col);
  float4* mat = reinterpret_cast<float4*>(smem + L.mat);
  float4* lpos = reinterpret_cast<float4*>(smem + L.lpos);
  float4* lcol = reinterpret_cast<float4*>(smem + L.lcol);
  float* rrad = reinterpret_cast<float*>(smem + L.rrad);
  int* kind = reinterpret_cast<int*>(smem + L.kind);
  int* occ = reinterpret_cast<int*>(smem + L.occ);
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const bool plane = t[j] == 0.0f;
    geom[j] = plane ? make_float4(t[n + j], t[2 * n + j], t[3 * n + j], t[4 * n + j])
                    : make_float4(t[5 * n + j], t[6 * n + j], t[7 * n + j],
                                  t[8 * n + j]);
    col[j] = make_float4(t[10 * n + j], t[11 * n + j], t[12 * n + j],
                         t[13 * n + j]);
    mat[j] = make_float4(t[14 * n + j], t[15 * n + j], t[16 * n + j],
                         t[17 * n + j]);
    rrad[j] = t[9 * n + j];
    kind[j] = (plane ? kPlane : 0) | (light[j] ? kLight : 0);
  }
  for (int k = threadIdx.x; k < nl; k += blockDim.x) {
    const int j = lists[k];
    lpos[k] = make_float4(t[5 * n + j], t[6 * n + j], t[7 * n + j],
                          t[j] == 0.0f ? 1.0f : 0.0f);
    lcol[k] = make_float4(t[10 * n + j], t[11 * n + j], t[12 * n + j], 0.0f);
  }
  for (int k = threadIdx.x; k < no; k += blockDim.x) occ[k] = lists[nl + k];
  __syncthreads();
  return Scene{geom, col, mat, lpos, lcol, rrad, kind, occ, n, nl, no, bias};
}

// The debug taps (whitted_kernel.py:356-370, the reference's DEBUGGING
// printf, raytracer_kernel.cl:1-6): instead of the tree, one triple per
// explicit ray into out [3, rp]. kTapTres: the nearest fold's raw distance
// (FLT_MAX on a miss), its result and a plane flag; kTapAttr: the winner's
// red, diffuse factor and light flag (0 on a miss); kTapShade: the local
// shade color of the primary hit (0 on a miss).
//
// A persistent grid: as many blocks as the card holds at once
// (whitted_taps_cuda sizes it by the occupancy calculator), each loading
// the scene once, not once for every 256 rays, with every thread copying
// (the lists come from the wrapper). The blocks take the rays kThreads at a
// time from a counter (work[0]), so a block that drew cheap rays takes
// more: kTapShade's work per ray is very uneven, and a fixed stride over
// the rays measured 7% slower there (room, 4.32 M rays). The last block out
// (work[1]) sets both words back to 0 for the next launch on the stream.
// The work per ray is K3's nearest fold and, for kTapShade, its local
// shading with the shadow tests; each ray is read once (24 B) and its
// triple written once (12 B), coalesced.
enum Tap { kTapTres = 0, kTapAttr = 1, kTapShade = 2 };

template <int kTap>
__global__ void __launch_bounds__(kThreads)
whitted_taps_kernel(const float* __restrict__ table,
                    const int* __restrict__ light, const int* __restrict__ lists,
                    int n, int nl, int no, float bias,
                    const float* __restrict__ rays, float* __restrict__ out,
                    int rp, unsigned int* work) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(n, 0);
  const Scene s = load_tap_scene(table, light, lists, n, nl, no, bias, smem, L);
  // Two slots for the block's chunk (the counts words, which the lists
  // make free): thread 0 writes one while the other is still being read.
  int* chunk = reinterpret_cast<int*>(smem + L.counts);
  for (int k = 0;; ++k) {
    if (threadIdx.x == 0) chunk[k & 1] = int(atomicAdd(work, 1u));
    __syncthreads();
    const int first = chunk[k & 1] * kThreads;
    if (first >= rp) break;
    const int i = first + threadIdx.x;
    if (i >= rp) continue;
    const float ox = rays[i], oy = rays[rp + i], oz = rays[2 * rp + i];
    const float dx = rays[3 * rp + i], dy = rays[4 * rp + i],
                dz = rays[5 * rp + i];
    float cumu, res;
    const int idx = nearest(s, ox, oy, oz, dx, dy, dz, cumu, res);
    const bool hit = idx >= 0;
    float a = 0.0f, b = 0.0f, c = 0.0f;
    if (kTap == kTapTres) {
      a = cumu;
      b = res;
      c = hit && (s.kind[idx] & kPlane) ? 1.0f : 0.0f;
    } else if (hit && kTap == kTapAttr) {
      a = s.col[idx].x;
      b = s.mat[idx].x;
      c = (s.kind[idx] & kLight) ? 1.0f : 0.0f;
    } else if (hit) {
      const float dist = fminf(cumu, kMaxDist);
      float nx, ny, nz;
      local_shade(s, idx, ox + dx * dist, oy + dy * dist, oz + dz * dist, dx,
                  dy, dz, nx, ny, nz, a, b, c);
    }
    out[i] = a;
    out[rp + i] = b;
    out[2 * rp + i] = c;
  }
  // Every block has drawn its last chunk before it counts itself out.
  if (threadIdx.x == 0 && atomicAdd(work + 1, 1u) == gridDim.x - 1) {
    work[0] = 0u;
    work[1] = 0u;
  }
}

// A block's dynamic shared memory without the kernel's opt-in.
constexpr size_t kSmemDefault = 48 * 1024;

// Past the default 48 KB a block's shared memory needs the kernel's opt-in,
// up to the device's limit (227 KB on sm_90): ~500 primitives and more.
template <class Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t smem) {
  if (smem <= kSmemDefault) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// Plain C entry points, bound with ctypes. table: [18, n] float32
// (pack_whitted_scene); light: [n] int32 flags; trace_depth <= 8. Each
// returns cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int whitted_trace_cuda(const float* table, const int* light, int n,
                                  float bias, int trace_depth,
                                  const float* rays, float* acc, int rp,
                                  void* stream) {
  const size_t smem = Layout(n, 0).total;
  const cudaError_t e = allow_smem(whitted_rays_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (rp + kThreads - 1) / kThreads;
  whitted_rays_kernel<<<blocks, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      table, light, n, bias, trace_depth, rays, acc, rp);
  return static_cast<int>(cudaGetLastError());
}

// cam: the 12 floats of the camera row in host memory, copied into the
// launch's parameters, so the caller may free them once this returns.
extern "C" int whitted_frame_cuda(const float* table, const int* light, int n,
                                  float bias, int trace_depth,
                                  const float* cam, int width, int height,
                                  int ss, float dxs, float dys, float hdx,
                                  float hdy, float scale, float* frame,
                                  void* stream) {
  // Pixels per block (whitted_kernel.pixels_per_block).
  const int ppb = ss * ss < kThreads ? kThreads / (ss * ss) : 1;
  const size_t smem = Layout(n, 3 * ppb * ss * ss).total;
  const cudaError_t e = allow_smem(whitted_frame_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (width * height + ppb - 1) / ppb;
  CamRow row;
  for (int k = 0; k < 12; ++k) row.v[k] = cam[k];
  whitted_frame_kernel<<<blocks, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      table, light, n, bias, trace_depth, row, width, height, ss, ppb, dxs,
      dys, hdx, hdy, scale, frame);
  return static_cast<int>(cudaGetLastError());
}

// tap: kTapTres, kTapAttr or kTapShade; lists: [nl + no] int32, the light
// indices and the occluders in load_scene's order; rays [6, rp] -> out
// [3, rp]; work: two uint32 words, 0 before the first launch and left 0 by
// each (one pair a stream: launches that share it run in order). The grid:
// the blocks the card holds at once, at most one a 256 rays. Returns
// cudaErrorInvalidValue for another tap.
extern "C" int whitted_taps_cuda(const float* table, const int* light, int n,
                                 float bias, const int* lists, int nl, int no, int tap,
                                 const float* rays, float* out, int rp, unsigned int* work,
                                 void* stream) {
  using TapKernel = void (*)(const float*, const int*, const int*, int, int, int, float,
                             const float*, float*, int, unsigned int*);
  const TapKernel kernel = tap == kTapTres    ? whitted_taps_kernel<kTapTres>
                           : tap == kTapAttr  ? whitted_taps_kernel<kTapAttr>
                           : tap == kTapShade ? whitted_taps_kernel<kTapShade>
                                              : nullptr;
  if (kernel == nullptr || nl < 0 || no < 0 || nl + no > n)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Layout(n, 0).total;
  cudaError_t e = allow_smem(kernel, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int needed = (rp + kThreads - 1) / kThreads;
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = needed < resident ? needed : resident;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      table, light, lists, n, nl, no, bias, rays, out, rp, work);
  return static_cast<int>(cudaGetLastError());
}

// K3 on Hopper: the Whitted reflect/refract tree tracer (Raytracer3.2.0x /
// 3.0.06 family).
//
// Replaces the TPU kernel se195_raytracer_tpu/kernels/whitted_kernel.py
// _make_whitted_kernel, driven there by whitted_trace_pallas_padded
// (explicit rays) and whitted_frame_pallas (camera rays made in the kernel).
// Computes, per primary ray, the bounded binary tree of depth trace_depth
// (63 nodes at depth 5): the order-dependent nearest hit over planes and
// spheres with the optional 3.2.03 hit_bias, hard shadows toward the
// sphere lights' centers, N.L diffuse plus Phong^20, and the reflection and
// refraction children with Beer's law on the parent's travel distance.
//
// What bounds it on this card: FP32 compute. A live node costs a nearest
// sweep over the N primitives (~10-17 ops each) and a shadow sweep over the
// non-light primitives for each sphere light; device memory sees only the
// finished frame (12 bytes per pixel) and the rays of the explicit entry.
// What the design does about it:
//   * the [18, N] primitive table, the type and light flags and the camera
//     row sit in shared memory, read by every thread at the same time;
//   * the tree is walked depth first, pre-order, reflection before
//     refraction, with an explicit per-thread stack of the pending
//     refraction children (at most trace_depth entries of 12 floats): the
//     reference's ray queue (raytracer_kernel.cl:34-44), not a 63 x 13 heap
//     of node state per ray. Only live nodes are traced, so dead subtrees
//     cost nothing. Pre-order is also the order in which the plain
//     version (models/whitted.whitted_trace) sums the nodes;
//   * the frame entry gives each thread one pixel: it makes the ss^2
//     camera rays itself (tx outer, ty inner), sums their trees, scales by
//     256/ss^2, clamps and writes [H, W, 3]. No rays cross device memory;
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

constexpr int kThreads = 128;
constexpr int kRows = 18;  // pack_whitted_scene rows
constexpr int kMaxDepth = 8;
constexpr float kEps = 0.001f;    // W_EPSILON (raytracer_kernel.cl:30)
constexpr float kBeer = 0.15f;    // raytracer_kernel.cl:370
constexpr float kMaxDist = 1e6f;  // whitted_kernel.py:302

// Table rows: 0 type | 1-3 plane normal | 4 plane depth | 5-7 center |
// 8 sq_radius | 9 r_radius | 10-12 color | 13 refl | 14 diff | 15 spec |
// 16 refr | 17 refr_index.
struct Scene {
  const float* t;    // [kRows, n]
  const int* light;  // [n] 1 for a light
  int n;
  float bias;
  __device__ float at(int row, int j) const { return t[row * n + j]; }
  __device__ bool plane(int j) const { return t[j] == 0.0f; }
};

__device__ __forceinline__ float pow20(float x) {
  const float x2 = x * x;
  const float x5 = x2 * x2 * x;
  const float x10 = x5 * x5;
  return x10 * x10;
}

// Sphere quadratic (raytracer_kernel.cl:104-137). Returns false on a miss
// or when the sphere is wholly behind the origin.
__device__ __forceinline__ bool sphere_roots(const Scene& s, int j, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz, float& i1,
                                             float& i2) {
  const float vx = ox - s.at(5, j);
  const float vy = oy - s.at(6, j);
  const float vz = oz - s.at(7, j);
  const float b = -(vx * dx + vy * dy + vz * dz);
  const float det = b * b - (vx * vx + vy * vy + vz * vz) + s.at(8, j);
  if (!(det > 0.0f)) return false;
  const float sq = sqrtf(det);
  i1 = b - sq;
  i2 = b + sq;
  return i2 > 0.0f;
}

// Plane test (raytracer_kernel.cl:89-102). Returns false when parallel or
// behind.
__device__ __forceinline__ bool plane_dist(const Scene& s, int j, float ox,
                                           float oy, float oz, float dx,
                                           float dy, float dz, float& dist) {
  const float nd = s.at(1, j) * dx + s.at(2, j) * dy + s.at(3, j) * dz;
  const float no = s.at(1, j) * ox + s.at(2, j) * oy + s.at(3, j) * oz;
  const float nd_safe = nd != 0.0f ? nd : 1.0f;
  dist = -(no + s.at(4, j)) / nd_safe;
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
    if (s.plane(j)) {
      float pd;
      if (plane_dist(s, j, ox, oy, oz, dx, dy, dz, pd) && pd < cumu) {
        cumu = pd;
        idx = j;
        res = 1.0f;
      }
    } else {
      float i1, i2;
      if (!sphere_roots(s, j, ox, oy, oz, dx, dy, dz, i1, i2)) continue;
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
// maxt. Stops at the first one.
__device__ bool occluded(const Scene& s, float ox, float oy, float oz,
                         float dx, float dy, float dz, float maxt) {
  for (int j = 0; j < s.n; ++j) {
    if (s.light[j]) continue;
    if (s.plane(j)) {
      float pd;
      if (plane_dist(s, j, ox, oy, oz, dx, dy, dz, pd) && pd < maxt) return true;
    } else {
      float i1, i2;
      if (sphere_roots(s, j, ox, oy, oz, dx, dy, dz, i1, i2) &&
          (i1 < 0.0f ? i2 < maxt : i1 < maxt + s.bias))
        return true;
    }
  }
  return false;
}

// One tree node: a ray with its scalar weight, Beer transparency, the
// immediate parent's color (reflection rays only) and the refractive index
// it travels in.
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
  Ray stack[kMaxDepth];
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
    if (hit) {
      if (s.plane(idx)) {
        nx = s.at(1, idx);
        ny = s.at(2, idx);
        nz = s.at(3, idx);
      } else {
        nx = (px - s.at(5, idx)) * s.at(9, idx);
        ny = (py - s.at(6, idx)) * s.at(9, idx);
        nz = (pz - s.at(7, idx)) * s.at(9, idx);
      }
      const float m_r = s.at(10, idx), m_g = s.at(11, idx), m_b = s.at(12, idx);
      if (s.light[idx]) {
        col_r = m_r;
        col_g = m_g;
        col_b = m_b;
      } else {
        const float m_diff = s.at(14, idx), m_spec = s.at(15, idx);
        for (int li = 0; li < s.n; ++li) {
          if (!s.light[li]) continue;
          const float lvx = s.at(5, li) - px;
          const float lvy = s.at(6, li) - py;
          const float lvz = s.at(7, li) - pz;
          const float llen =
              sqrtf(fmaxf(lvx * lvx + lvy * lvy + lvz * lvz, 1e-30f));
          const float ldx = lvx / llen, ldy = lvy / llen, ldz = lvz / llen;
          float shade = 1.0f;
          if (!s.plane(li) &&
              occluded(s, px + ldx * kEps, py + ldy * kEps, pz + ldz * kEps,
                       ldx, ldy, ldz, llen))
            shade = 0.0f;
          // Diffuse: dot(N, L) > 0 (raytracer_kernel.cl:215-223).
          const float dnl = nx * ldx + ny * ldy + nz * ldz;
          if (m_diff > 0.0f && dnl > 0.0f) {
            const float dterm = dnl * m_diff * shade;
            col_r = col_r + dterm * m_r * s.at(10, li);
            col_g = col_g + dterm * m_g * s.at(11, li);
            col_b = col_b + dterm * m_b * s.at(12, li);
          }
          // Specular: R = L - 2 dot(L, N) N; powr(dot(V, R), 20) (:225-236).
          const float k2 = 2.0f * dnl;
          const float rvx = ldx - k2 * nx;
          const float rvy = ldy - k2 * ny;
          const float rvz = ldz - k2 * nz;
          const float dvr = ray.dx * rvx + ray.dy * rvy + ray.dz * rvz;
          const float sterm = (m_spec > 0.0f && dvr > 0.0f)
                                  ? pow20(fmaxf(dvr, 0.0f)) * m_spec * shade
                                  : 0.0f;
          col_r = col_r + sterm * s.at(10, li);
          col_g = col_g + sterm * s.at(11, li);
          col_b = col_b + sterm * s.at(12, li);
        }
      }
    }
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
      const float c_r = s.at(10, idx), c_g = s.at(11, idx), c_b = s.at(12, idx);
      // Refraction child (raytracer_kernel.cl:350-372), kept for later.
      const float refr_f = s.at(16, idx);
      const float m_ri = s.at(17, idx);
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
        Ray& c = stack[top++];
        c.ox = px + tdx * kEps;
        c.oy = py + tdy * kEps;
        c.oz = pz + tdz * kEps;
        c.dx = tdx;
        c.dy = tdy;
        c.dz = tdz;
        c.weight = ray.weight;
        // Beer's law with the PARENT ray's travel distance (:370).
        c.tr = ray.tr * expf(c_r * kBeer * (-dist));
        c.tg = ray.tg * expf(c_g * kBeer * (-dist));
        c.tb = ray.tb * expf(c_b * kBeer * (-dist));
        c.ridx = ridx_m;
        c.level = ray.level + 1;
        c.type = 2;
      }
      // Reflection child (raytracer_kernel.cl:332-348), traced next.
      const float refl_f = s.at(13, idx);
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
      ray = stack[--top];
    }
  }
  out_r = acc_r;
  out_g = acc_g;
  out_b = acc_b;
}

__device__ void load_scene(const float* table, const int* light, int n,
                           float* st, int* sl) {
  for (int i = threadIdx.x; i < kRows * n; i += blockDim.x) st[i] = table[i];
  for (int i = threadIdx.x; i < n; i += blockDim.x) sl[i] = light[i];
}

// Explicit rays: rays [6, rp] (o, d) -> acc [3, rp], one thread per ray.
__global__ void __launch_bounds__(kThreads)
whitted_rays_kernel(const float* __restrict__ table,
                    const int* __restrict__ light, int n, float bias,
                    int trace_depth, const float* __restrict__ rays,
                    float* __restrict__ acc, int rp) {
  extern __shared__ float smem[];
  int* sl = reinterpret_cast<int*>(smem + kRows * n);
  load_scene(table, light, n, smem, sl);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rp) return;
  const Scene s{smem, sl, n, bias};
  float r, g, b;
  trace_tree(s, rays[i], rays[rp + i], rays[2 * rp + i], rays[3 * rp + i],
             rays[4 * rp + i], rays[5 * rp + i], trace_depth, r, g, b);
  acc[i] = r;
  acc[rp + i] = g;
  acc[2 * rp + i] = b;
}

// Frame: one thread per pixel, camera rays from the cam row [O, X, Y, C]
// (whitted_kernel.py:150-194, models/whitted.whitted_camera_rays_device),
// the ss^2 subsamples summed tx outer, ty inner, then x 256/ss^2 and
// clamped to 0..255 into frame [H, W, 3].
__global__ void __launch_bounds__(kThreads)
whitted_frame_kernel(const float* __restrict__ table,
                     const int* __restrict__ light, int n, float bias,
                     int trace_depth, const float* __restrict__ cam,
                     int width, int height, int ss, float dxs, float dys,
                     float hdx, float hdy, float scale,
                     float* __restrict__ frame) {
  extern __shared__ float smem[];
  int* sl = reinterpret_cast<int*>(smem + kRows * n);
  float* cs = reinterpret_cast<float*>(sl + n);
  load_scene(table, light, n, smem, sl);
  if (threadIdx.x < 12) cs[threadIdx.x] = cam[threadIdx.x];
  __syncthreads();
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= width * height) return;
  const Scene s{smem, sl, n, bias};
  const int x = pix % width;
  const int y = pix / width;
  const int half = ss / 2;
  float sum_r = 0.0f, sum_g = 0.0f, sum_b = 0.0f;
  for (int txi = 0; txi < ss; ++txi) {
    for (int tyi = 0; tyi < ss; ++tyi) {
      const float sx = (-3.0f + (float)x * dxs) + (float)(txi - half) * hdx;
      const float sy = (2.25f + (float)y * dys) + (float)(tyi - half) * hdy;
      const float rdx = cs[3] * sx + cs[6] * sy + cs[9];
      const float rdy = cs[4] * sx + cs[7] * sy + cs[10];
      const float rdz = cs[5] * sx + cs[8] * sy + cs[11];
      const float inv = 1.0f / sqrtf(rdx * rdx + rdy * rdy + rdz * rdz);
      float r, g, b;
      trace_tree(s, cs[0], cs[1], cs[2], rdx * inv, rdy * inv, rdz * inv,
                 trace_depth, r, g, b);
      sum_r = sum_r + r;
      sum_g = sum_g + g;
      sum_b = sum_b + b;
    }
  }
  frame[3 * pix] = fminf(fmaxf(sum_r * scale, 0.0f), 255.0f);
  frame[3 * pix + 1] = fminf(fmaxf(sum_g * scale, 0.0f), 255.0f);
  frame[3 * pix + 2] = fminf(fmaxf(sum_b * scale, 0.0f), 255.0f);
}

}  // namespace

// Plain C entry points, bound with ctypes. table: [18, n] float32
// (pack_whitted_scene); light: [n] int32 flags; trace_depth <= 8. Each
// returns cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int whitted_trace_cuda(const float* table, const int* light, int n,
                                  float bias, int trace_depth,
                                  const float* rays, float* acc, int rp,
                                  void* stream) {
  const size_t smem = sizeof(float) * kRows * n + sizeof(int) * n;
  const int blocks = (rp + kThreads - 1) / kThreads;
  whitted_rays_kernel<<<blocks, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      table, light, n, bias, trace_depth, rays, acc, rp);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int whitted_frame_cuda(const float* table, const int* light, int n,
                                  float bias, int trace_depth,
                                  const float* cam, int width, int height,
                                  int ss, float dxs, float dys, float hdx,
                                  float hdy, float scale, float* frame,
                                  void* stream) {
  const size_t smem = sizeof(float) * (kRows * n + 12) + sizeof(int) * n;
  const int blocks = (width * height + kThreads - 1) / kThreads;
  whitted_frame_kernel<<<blocks, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      table, light, n, bias, trace_depth, cam, width, height, ss, dxs, dys,
      hdx, hdy, scale, frame);
  return static_cast<int>(cudaGetLastError());
}

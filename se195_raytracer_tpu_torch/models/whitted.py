"""Whitted reflect/refract tracer, tree form, in plain PyTorch (twin of
se195_raytracer_tpu/models/whitted.py). It is the CPU twin and the oracle
of K3 (kernels/whitted_kernel.py).

The reference's Whitted family: the OpenCL ray-queue kernel
(Raytracer3.2.03/raytracer_kernel.cl: raytracer_kernel:246-383, raytrace
:163-242, plane/sphere intersect :89-137, Beer transparency :370) and the
de-recursified 63-node ray tree of raytracer3.0.06 (raytracer.cpp
Engine_Render:301-530). Every tree node's contribution is summed into the
ray's color independently, so ``whitted_trace`` walks the bounded binary tree
as an unrolled recursion over ray batches: pre-order, reflection child
before refraction child. Divergence (plane/sphere, hit/inprim, lit/shadowed)
is masked lane arithmetic.

Dot products are elementwise sums left to right (``core/types.dot3``), not
matrix products: on the card a float32 matmul could take TF32, and the
reassociation of a matmul moves the epsilon-scale shadow-ray offsets.

``hit_bias``: the 3.2.03 kernel biases sphere near-hits by +0.005
(raytracer_kernel.cl:128, ``i1 < cumu_dist + 0.005f``); 3.2.02 and the
scalar CPU port do not. Default 0.0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from se195_raytracer_tpu_torch.core.types import dot3, resolve_device, sqrt_rn
from se195_raytracer_tpu_torch.scenes.whitted_scenes import PLANE, SPHERE, WhittedScene
from se195_raytracer_tpu_torch.utils.profiling import span

# raytracer_kernel.cl:26-30
HIT = 1
MISS = 0
INPRIM = -1
W_EPSILON = 0.001  # Whitted-family epsilon (raytracer_kernel.cl:30)

# Ray node types (raytracer_kernel.cl:50-54)
ORIGIN = 0
REFLECTED = 1
REFRACTED = 2

# The reference's fixed viewpoint (raytracer_kernel.cl:267-281): camera
# at (0, 0.25, -7), world-anchored screen window on the z=0 plane.
DEFAULT_CAM_ORIG = (0.0, 0.25, -7.0)

_EPS = float(np.float32(W_EPSILON))
_F32_MAX = float(np.finfo(np.float32).max)


def whitted_camera_row(orig=None, target=None) -> np.ndarray:
    """Affine camera for the Whitted family as a [12] float32 row
    [O(3), X(3), Y(3), C(3)]: a primary ray through window point (sx, sy)
    has origin O and direction normalize(X*sx + Y*sy + C).

    No arguments: the reference's fixed viewpoint, O=(0,0.25,-7), X=e_x,
    Y=e_y, C=(0,-0.25,7). With ``orig``/``target`` a look-at basis (up =
    +y), the screen plane held at the reference's distance 7 in front of
    the eye with the same window extents."""
    f32 = np.float32
    if orig is None and target is None:
        o = np.array(DEFAULT_CAM_ORIG, f32)
        x = np.array([1, 0, 0], f32)
        y = np.array([0, 1, 0], f32)
        c = np.array([0.0, -0.25, 7.0], f32)
        return np.concatenate([o, x, y, c]).astype(f32)
    o = np.asarray(DEFAULT_CAM_ORIG if orig is None else orig, f32)
    t = np.asarray((0.0, 0.25, 0.0) if target is None else target, f32)
    z = t - o
    z = z / max(np.linalg.norm(z), 1e-12)
    up = np.array([0, 1, 0], f32)
    x = np.cross(up, z)
    nx = np.linalg.norm(x)
    if nx < 1e-6:  # looking straight up/down: fall back to world x
        x = np.array([1, 0, 0], f32)
    else:
        x = x / nx
    y = np.cross(z, x)
    return np.concatenate([o, x, y, 7.0 * z]).astype(f32)


def _pow20(x: torch.Tensor) -> torch.Tensor:
    """x^20 for x >= 0 as the multiply chain of K3 (x^5 squared twice): the
    reference's powr(dot, 20) (raytracer_kernel.cl:232) has an integer
    exponent. Within a few ulps of ``pow``."""
    x2 = x * x
    x5 = x2 * x2 * x
    x10 = x5 * x5
    return x10 * x10


def _prim_tests(scene: WhittedScene, o: torch.Tensor, d: torch.Tensor):
    """Per-primitive intersection candidates, each [R, N]: (plane_dist,
    plane_valid, i1, i2, sphere_valid). Plane test raytracer_kernel.cl:
    89-102, sphere quadratic :104-137; the INPRIM/near-root choice is made
    in the order-dependent fold of ``whitted_nearest``."""
    nrm = scene.normal
    denom = dot3(nrm[None, :, :], d[:, None, :])
    num = -(dot3(nrm[None, :, :], o[:, None, :]) + scene.depth[None, :])
    denom_safe = torch.where(denom != 0.0, denom, 1.0)
    pdist = num / denom_safe
    pvalid = (denom != 0.0) & (pdist > 0.0)

    v = o[:, None, :] - scene.center[None, :, :]
    b = -dot3(v, d[:, None, :])
    det = b * b - dot3(v, v) + scene.sq_radius[None, :]
    svalid = det > 0.0
    sq = sqrt_rn(torch.where(svalid, det, 1.0))
    i1 = b - sq
    i2 = b + sq
    svalid = svalid & (i2 > 0.0)
    return pdist, pvalid, i1, i2, svalid


def whitted_nearest(
    scene: WhittedScene, o: torch.Tensor, d: torch.Tensor, hit_bias: float = 0.0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sequential nearest-hit fold over primitives 0..N-1 (raytrace:163-177).

    Order-dependent: each primitive that improves ``cumu`` (a sphere with
    the ``+hit_bias`` slack) takes the hit, so with bias > 0 a later
    primitive can steal it at a slightly larger distance.
    Returns (prim_idx [R] int64, -1 on a miss; result [R] int64 HIT/INPRIM/
    MISS; dist [R])."""
    r = o.shape[0]
    pdist, pvalid, i1, i2, svalid = _prim_tests(scene, o, d)
    bias = float(np.float32(hit_bias))
    cumu = torch.full((r,), _F32_MAX, dtype=torch.float32, device=o.device)
    idx = torch.full((r,), -1, dtype=torch.int64, device=o.device)
    res = torch.full((r,), MISS, dtype=torch.int64, device=o.device)
    for j in range(scene.num_prims):
        if scene.ptype[j] == PLANE:
            upd = pvalid[:, j] & (pdist[:, j] < cumu)
            new_dist = pdist[:, j]
            new_res = torch.full_like(res, HIT)
        else:
            inprim = svalid[:, j] & (i1[:, j] < 0.0) & (i2[:, j] < cumu)
            hit_near = svalid[:, j] & (i1[:, j] >= 0.0) & (i1[:, j] < cumu + bias)
            upd = inprim | hit_near
            new_dist = torch.where(i1[:, j] < 0.0, i2[:, j], i1[:, j])
            new_res = torch.where(inprim, INPRIM, HIT)
        cumu = torch.where(upd, new_dist, cumu)
        idx = torch.where(upd, j, idx)
        res = torch.where(upd, new_res, res)
    return idx, res, cumu


def whitted_occluded(
    scene: WhittedScene,
    o: torch.Tensor,
    d: torch.Tensor,
    max_t: torch.Tensor,
    hit_bias: float = 0.0,
    work: Optional[dict] = None,
    live: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Shadow predicate (raytrace:199-212): any non-light primitive hit
    closer than max_t (the reference breaks on the first hit, and max_t
    changes only after the break, so an any() is exact).

    ``work``, when a dict, gets ``shadow_tests`` added: over the ``live``
    lanes, the primitive tests a sweep that stops at its first occluder
    (ascending order, lights skipped) runs."""
    pdist, pvalid, i1, i2, svalid = _prim_tests(scene, o, d)
    dev = o.device
    non_light = torch.tensor([not x for x in scene.is_light], device=dev)
    is_plane = torch.tensor([t == PLANE for t in scene.ptype], device=dev)
    bias = float(np.float32(hit_bias))
    mt = max_t[:, None]
    plane_hit = is_plane[None, :] & pvalid & (pdist < mt)
    sphere_hit = ~is_plane[None, :] & svalid & torch.where(i1 < 0.0, i2 < mt, i1 < mt + bias)
    blocker = non_light[None, :] & (plane_hit | sphere_hit)
    if work is not None:
        idx = torch.arange(scene.num_prims, device=dev)
        first = torch.where(blocker, idx, scene.num_prims).amin(dim=-1)  # N: none
        tests = (non_light[None, :] & (idx[None, :] <= first[:, None])).sum(dim=-1)
        work["shadow_tests"] = work.get("shadow_tests", 0) + int(tests[live].sum())
    return torch.any(blocker, dim=-1)


def _get_normal(scene: WhittedScene, prim_idx: torch.Tensor, point: torch.Tensor):
    """get_normal (raytracer_kernel.cl:151-161), gathered per lane."""
    is_plane = torch.tensor([t == PLANE for t in scene.ptype], device=point.device)
    n_plane = scene.normal[prim_idx]
    n_sphere = (point - scene.center[prim_idx]) * scene.r_radius[prim_idx][:, None]
    return torch.where(is_plane[prim_idx][:, None], n_plane, n_sphere)


def whitted_shade(scene: WhittedScene, o: torch.Tensor, d: torch.Tensor, hit_bias: float = 0.0,
                  work: Optional[dict] = None, live: Optional[torch.Tensor] = None,
                  max_dist: Optional[float] = None):
    """raytrace (raytracer_kernel.cl:163-242): nearest hit + local shading.

    Returns (prim_idx, result, dist, point, color [R, 3]). A light returns
    its material color; another hit sums N.L diffuse and Phong^20 specular
    over the lights, with hard point shadows toward each sphere light's
    center. ``work`` and ``live`` are passed to ``whitted_occluded`` (the
    lanes that hit a non-light). ``max_dist`` clamps the hit distance, as
    the kernels clamp it at 1e6 (``whitted_taps``)."""
    prim_idx, result, dist = whitted_nearest(scene, o, d, hit_bias)
    hit = prim_idx >= 0
    safe_idx = torch.clamp(prim_idx, min=0)
    dist_safe = torch.where(hit, dist, 1.0)
    if max_dist is not None:
        dist_safe = torch.clamp(dist_safe, max=max_dist)
    point = o + d * dist_safe[:, None]

    is_light = torch.tensor(scene.is_light, device=o.device)
    hit_is_light = hit & is_light[safe_idx]

    acc = torch.zeros_like(o)
    n_hit = _get_normal(scene, safe_idx, point)
    m_diff = scene.diff[safe_idx]
    m_spec = scene.spec[safe_idx]
    m_color = scene.color[safe_idx]

    for li in scene.light_indices:
        l_vec = scene.center[li][None, :] - point
        l_len = sqrt_rn(torch.clamp(dot3(l_vec, l_vec), min=1e-30))
        l_dir = l_vec / l_len[:, None]
        if scene.ptype[li] == SPHERE:
            sh_o = point + l_dir * _EPS
            occluded = whitted_occluded(scene, sh_o, l_dir, l_len, hit_bias, work,
                                        None if live is None else live & hit & ~hit_is_light)
            shade = torch.where(occluded, 0.0, 1.0)
        else:
            shade = torch.ones_like(l_len)
        # Diffuse: dot(N, L) > 0 (raytracer_kernel.cl:215-223)
        dnl = dot3(n_hit, l_dir)
        diff_term = torch.where((m_diff > 0.0) & (dnl > 0.0), dnl * m_diff * shade, 0.0)
        acc = acc + diff_term[:, None] * m_color * scene.color[li][None, :]
        # Specular: R = L - 2 dot(L, N) N; powr(dot(V, R), 20) (:225-236)
        r_vec = l_dir - (2.0 * dnl)[:, None] * n_hit
        dvr = dot3(d, r_vec)
        spec_term = torch.where(
            (m_spec > 0.0) & (dvr > 0.0),
            _pow20(torch.clamp(dvr, min=0.0)) * m_spec * shade,
            0.0,
        )
        acc = acc + spec_term[:, None] * scene.color[li][None, :]

    color = torch.where(hit_is_light[:, None], m_color, torch.where(hit[:, None], acc, 0.0))
    return prim_idx, result, dist_safe, point, color


# The kernels' debug taps (whitted_kernel.py:356-370 of the JAX package):
# instead of the tree, three planes per primary ray.
TAPS = ("tres", "attr", "shade")
# The kernels clamp a hit's distance before shading it (whitted_kernel.py:302).
_MAX_DIST = 1e6


def whitted_taps(scene: WhittedScene, o: torch.Tensor, d: torch.Tensor, tap: str,
                 hit_bias: float = 0.0) -> torch.Tensor:
    """What the Whitted kernels' debug tap ``tap`` emits for the rays
    (o, d) [R, 3], as [R, 3] float32 (the reference's DEBUGGING printf,
    raytracer_kernel.cl:1-6, as a tensor):

    - ``"tres"``: the nearest fold's raw distance (float32 max on a miss,
      not clamped), its result (MISS 0, HIT 1, INPRIM -1) and 1 where the
      winner is a plane;
    - ``"attr"``: the winner's red, diffuse factor and light flag, 0 on a miss;
    - ``"shade"``: ``whitted_shade``'s color with the hit distance clamped at
      1e6, as the kernels shade it: a light's own color, 0 on a miss.

    An unknown tap raises ValueError."""
    if tap not in TAPS:
        raise ValueError(f"unknown debug tap {tap!r}; one of {TAPS}")
    if tap == "shade":
        return whitted_shade(scene, o, d, hit_bias, max_dist=_MAX_DIST)[4]
    prim_idx, result, dist = whitted_nearest(scene, o, d, hit_bias)
    hit = prim_idx >= 0
    safe_idx = torch.clamp(prim_idx, min=0)
    if tap == "tres":
        is_plane = torch.tensor([t == PLANE for t in scene.ptype], device=o.device)[safe_idx]
        return torch.stack([dist, result.to(torch.float32), (hit & is_plane).to(torch.float32)],
                           dim=-1)
    is_light = torch.tensor(scene.is_light, device=o.device)[safe_idx]
    return torch.stack([torch.where(hit, scene.color[safe_idx, 0], 0.0),
                        torch.where(hit, scene.diff[safe_idx], 0.0),
                        (hit & is_light).to(torch.float32)], dim=-1)


def whitted_trace(
    scene: WhittedScene,
    o: torch.Tensor,
    d: torch.Tensor,
    trace_depth: int = 5,
    hit_bias: float = 0.0,
    work: Optional[dict] = None,
) -> torch.Tensor:
    """Trace a batch of primary rays through the bounded reflect/refract
    tree; returns the summed color [R, 3] (before the tone scale).

    An unrolled binary recursion over the 2^(depth+1)-1 tree positions (the
    3.0.06 formulation, raytracer.cpp:398-472), pre-order, reflection
    before refraction. Per ray type (raytracer_kernel.cl:317-328) a node's
    color is weighted by its scalar weight (the product of refl factors),
    its Beer transparency and, for reflection rays only, its immediate
    parent's material color.

    ``work``, when a dict, counts what a tracer that skips dead subtrees
    must do: ``nodes`` (live tree nodes shaded), ``hit_nodes`` (those that
    hit a non-light: they are lit) and ``shadow_tests`` (see
    ``whitted_occluded``)."""
    r = o.shape[0]
    dev = o.device
    acc_total = torch.zeros((r, 3), dtype=torch.float32, device=dev)

    def node(level, o, d, weight, rtype, parent_col, r_index, transp, valid):
        nonlocal acc_total
        prim_idx, result, dist, point, ray_col = whitted_shade(
            scene, o, d, hit_bias, work, valid if work is not None else None)
        hit = prim_idx >= 0
        safe_idx = torch.clamp(prim_idx, min=0)
        if work is not None:
            lit = valid & hit & ~torch.tensor(scene.is_light, device=dev)[safe_idx]
            work["nodes"] = work.get("nodes", 0) + int(valid.sum())
            work["hit_nodes"] = work.get("hit_nodes", 0) + int(lit.sum())

        if rtype == ORIGIN:
            factor = torch.ones((r, 3), dtype=torch.float32, device=dev)
        elif rtype == REFLECTED:
            factor = parent_col * transp
        else:
            factor = transp
        acc_total = acc_total + torch.where(
            valid[:, None], ray_col * weight[:, None] * factor, 0.0
        )

        if level >= trace_depth:
            return

        n_hit = _get_normal(scene, safe_idx, point)
        my_col = scene.color[safe_idx]
        # Reflection child (raytracer_kernel.cl:332-348).
        refl_f = scene.refl[safe_idx]
        rdir = d - (2.0 * dot3(d, n_hit))[:, None] * n_hit
        ro = point + rdir * _EPS
        refl_ok = valid & hit & (refl_f > 0.0)
        node(level + 1, ro, rdir, refl_f * weight, REFLECTED, my_col, r_index, transp, refl_ok)
        # Refraction child (raytracer_kernel.cl:350-372).
        refr_f = scene.refr[safe_idx]
        m_rindex = scene.refr_index[safe_idx]
        m_rindex_safe = torch.where(m_rindex != 0.0, m_rindex, 1.0)
        n_ratio = r_index / m_rindex_safe
        n2 = n_hit * result.to(torch.float32)[:, None]
        cos_i = -dot3(n2, d)
        cos_t2 = 1.0 - n_ratio * n_ratio * (1.0 - cos_i * cos_i)
        cos_t2_safe = torch.where(cos_t2 > 0.0, cos_t2, 1.0)
        tdir = n_ratio[:, None] * d + (n_ratio * cos_i - sqrt_rn(cos_t2_safe))[:, None] * n2
        to = point + tdir * _EPS
        # Beer's law with the PARENT ray's travel distance
        # (raytracer_kernel.cl:370).
        t_child = transp * torch.exp(scene.color[safe_idx] * float(np.float32(0.15))
                                     * (-dist)[:, None])
        refr_ok = valid & hit & (refr_f > 0.0) & (cos_t2 > 0.0)
        node(level + 1, to, tdir, weight, REFRACTED, my_col, m_rindex_safe, t_child, refr_ok)

    ones = torch.ones((r,), dtype=torch.float32, device=dev)
    ones3 = torch.ones((r, 3), dtype=torch.float32, device=dev)
    node(0, o, d, ones, ORIGIN, ones3, ones, ones3, torch.ones((r,), dtype=torch.bool, device=dev))
    return acc_total


def whitted_camera_rays(width: int, height: int, supersample: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """Primary rays of the fixed Whitted camera (raytracer_kernel.cl:
    267-305) as host numpy: window x in [-3, 3], y in [2.25, -2.25] (top row
    first), camera at (0, 0.25, -7), screen plane z = 0, subpixel offsets
    tx, ty in {-half..half} times half a pixel.

    Returns (origins [R, 3], dirs [R, 3]), R = H*W*supersample^2, pixel-major
    then subsample (tx outer, ty inner: the kernel's loop nesting :291-292),
    in strict float32 in the op order of K3's in-kernel generator."""
    f32 = np.float32
    dxs = f32(6.0 / width)
    dys = f32(-4.5 / height)
    half = supersample // 2
    xs = np.arange(width, dtype=f32)
    ys = np.arange(height, dtype=f32)
    offs = (np.arange(supersample, dtype=np.int32) - half).astype(f32)
    shape = (height, width, supersample, supersample)
    x = np.broadcast_to(xs[None, :, None, None], shape)
    y = np.broadcast_to(ys[:, None, None, None], shape)
    tx = np.broadcast_to(offs[None, None, :, None], shape)
    ty = np.broadcast_to(offs[None, None, None, :], shape)
    sx = (f32(-3.0) + x * dxs) + tx * (dxs / f32(2.0))
    sy = (f32(2.25) + y * dys) + ty * (dys / f32(2.0))
    rdx = sx - f32(0.0)
    rdy = sy - f32(0.25)
    rdz = np.full(shape, 7.0, f32)
    inv = f32(1.0) / np.sqrt(rdx * rdx + rdy * rdy + rdz * rdz)
    dirs = np.stack([rdx * inv, rdy * inv, rdz * inv], axis=-1).reshape(-1, 3)
    origins = np.broadcast_to(np.array(DEFAULT_CAM_ORIG, f32), dirs.shape)
    return np.ascontiguousarray(origins), dirs


def window_steps(width: int, height: int) -> Tuple[float, float, float, float]:
    """(dxs, dys, dxs/2, dys/2) of the screen window in float32: one pixel
    and half a pixel in x and y."""
    dxs = np.float32(6.0 / width)
    dys = np.float32(-4.5 / height)
    return float(dxs), float(dys), float(dxs / np.float32(2.0)), float(dys / np.float32(2.0))


def whitted_camera_rays_device(
    width: int,
    height: int,
    supersample: int = 3,
    cam_row: Optional[torch.Tensor] = None,
    device=None,
    ray_range: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Primary rays made on the device from the ray index (the same float32
    formula as ``whitted_camera_rays``), for any camera row
    (``whitted_camera_row``; None = the reference's fixed viewpoint).
    ``ray_range=(lo, hi)``: only the rays lo..hi-1 (a shard of a sharded
    frame)."""
    device = resolve_device(device)
    ss2 = supersample * supersample
    lo, hi = (0, width * height * ss2) if ray_range is None else ray_range
    r = hi - lo
    if cam_row is None:
        cam_row = torch.from_numpy(whitted_camera_row())
    c = cam_row.to(device=device, dtype=torch.float32).reshape(12)
    dxs, dys, hdx, hdy = window_steps(width, height)
    half = supersample // 2
    lin = torch.arange(lo, hi, dtype=torch.int64, device=device)
    pix = lin // ss2
    sub = lin - pix * ss2
    txi = sub // supersample
    tyi = sub - txi * supersample
    x = pix % width
    y = pix // width
    sx = (-3.0 + x.to(torch.float32) * dxs) + (txi - half).to(torch.float32) * hdx
    sy = (2.25 + y.to(torch.float32) * dys) + (tyi - half).to(torch.float32) * hdy
    rdx = c[3] * sx + c[6] * sy + c[9]
    rdy = c[4] * sx + c[7] * sy + c[10]
    rdz = c[5] * sx + c[8] * sy + c[11]
    inv = 1.0 / sqrt_rn(rdx * rdx + rdy * rdy + rdz * rdz)
    d = torch.stack([rdx * inv, rdy * inv, rdz * inv], dim=-1)
    o = c[0:3].expand(r, 3)
    return o, d


def reduce_subsamples(acc: torch.Tensor, width: int, height: int, supersample: int) -> torch.Tensor:
    """[H*W*ss^2, 3] ray colors -> [H, W, 3] frame in 0..255: the ss^2
    subsamples of a pixel summed in ray order, times 256/ss^2, clamped
    (raytracer_kernel.cl:378-382)."""
    ss2 = supersample * supersample
    sub = acc.reshape(height, width, ss2, 3)
    total = sub[:, :, 0]
    for k in range(1, ss2):
        total = total + sub[:, :, k]
    return torch.clamp(total * float(np.float32(256.0 / ss2)), 0.0, 255.0)


def render_whitted_scene(
    scene: WhittedScene,
    width: int = 800,
    height: int = 600,
    supersample: int = 3,
    trace_depth: int = 5,
    hit_bias: float = 0.0,
    ray_tile: Optional[int] = None,
    cam_row: Optional[torch.Tensor] = None,
    work: Optional[dict] = None,
) -> torch.Tensor:
    """Full-frame Whitted render on the scene's device -> float32 [H, W, 3]
    in 0..255 (acc * 256 / supersample^2, clamped). Rays are traced in
    chunks of ``ray_tile`` (default 256k rays), which bounds the tree's
    [rays, prims] temporaries. ``work`` is passed to ``whitted_trace``."""
    n = width * height * supersample * supersample
    ray_tile = min(ray_tile or 256 * 1024, n)
    o, d = whitted_camera_rays_device(width, height, supersample, cam_row, device=scene.device)
    acc = torch.cat([
        whitted_trace(scene, o[a:a + ray_tile], d[a:a + ray_tile], trace_depth, hit_bias, work)
        for a in range(0, n, ray_tile)
    ])
    return reduce_subsamples(acc, width, height, supersample)


def camera_row(camera) -> Optional[torch.Tensor]:
    """``render_whitted``'s ``camera`` as a [12] float32 row made on the
    host: None stays None (the reference's fixed viewpoint); a pose ``(eye,
    target)``, three floats each, is ``whitted_camera_row(eye, target)``;
    anything else is taken as a [12] row, left on its device. Nothing is
    copied to the device here: K3 takes the row as a launch parameter, and
    the plain render moves it to where it makes its rays."""
    if camera is None:
        return None
    if not isinstance(camera, torch.Tensor) and len(camera) == 2:
        return torch.from_numpy(whitted_camera_row(*camera))
    row = torch.as_tensor(camera, dtype=torch.float32)
    if row.numel() != 12:
        raise ValueError(f"camera: need (eye, target) or a [12] row, got {tuple(row.shape)}")
    return row.reshape(12)


def render_whitted(scene: WhittedScene, config, device=None, *, camera=None) -> torch.Tensor:
    """Render a WhittedScene with a RenderConfig (width, height,
    supersample, trace_depth, hit_bias, ray_tile, use_kernel) -> [H, W, 3]
    float32 in 0..255. With ``config.use_kernel`` the frame runs in K3
    (kernels/whitted_kernel.render_whitted_cuda, its plain version on the
    CPU); otherwise in ``render_whitted_scene``. ``device=None`` means
    CUDA and raises when no GPU is present. ``camera``: None for the
    reference's fixed viewpoint, a pose ``(eye, target)`` or a [12] row
    (``camera_row``).

    Under a profiler session the call is a ``wh.render`` span holding
    ``wh.camera`` (the row made on the host, passed to K3 as a launch
    parameter) and ``wh.launch``
    (K3's launch, or the plain render), K3's ``wh.tables`` lookup beside it
    on a CUDA device."""
    with span("wh.render"):
        device = resolve_device(device)
        scene = scene.to(device)
        with span("wh.camera"):
            cam_row = camera_row(camera)
        kw = dict(width=config.width, height=config.height, supersample=config.supersample,
                  trace_depth=config.trace_depth, hit_bias=config.hit_bias, cam_row=cam_row)
        if config.use_kernel:
            from se195_raytracer_tpu_torch.kernels.whitted_kernel import render_whitted_cuda

            return render_whitted_cuda(scene, device=device, **kw)
        with span("wh.launch"):
            return render_whitted_scene(scene, ray_tile=config.ray_tile, **kw)

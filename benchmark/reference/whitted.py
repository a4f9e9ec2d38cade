"""The plain reference of the Raytracer3.2 Whitted tracer: the integrator the
program under test implements, written in plain PyTorch from the source's
description.

Raytracer3.2.02's OpenCL kernel (raytracer_kernel.cl): the plane and sphere
tests (:89-137) and the nearest hit over the primitives in order
(``raytrace`` :163-177); per light a shadow ray toward the light's centre,
stopped by any primitive that is no light (:199-212), N.L diffuse and
Phong^20 specular (:215-236), a light's own color where one is hit; the
reflection (:332-348) and refraction (:349-373) children of every hit,
Beer's transparency from the parent's color and the PARENT ray's travel
distance (:370); a node's color weighted by the product of the
reflection factors, its transparency and, for a reflection ray, its parent's
color (:317-328); ``TRACEDEPTH`` 5 (:8); 3x3 subsamples a pixel over the
screen window [-3, 3] x [2.25, -2.25] (:267-292), summed, x 256/9 and
clamped to 0..255 (:378-382). ``hit_bias`` is 3.2.03's near-hit slack
(``i1 < cumu + 0.005``, :128); 3.2.02 has none (0.0).

Where it departs from the source:

* the camera is a look-at pose (``camera_row``: up +y, the screen plane at
  the source's distance 7 in front of the eye, the same window), drawn from
  a render's seed (``pose``), in place of the fixed viewpoint (0, 0.25, -7)
  looking at the z = 0 plane; with the fixed pose it is that viewpoint;
* the tree's nodes are summed breadth first, a parent's reflection child
  before its refraction child: the order of the source's circular ray queue
  (:283-312). The program (K3's stack and its plain twin) sums them depth
  first, pre-order; the two differ by float32 rounding alone;
* only live nodes are traced: each level holds the children that were
  spawned, which the queue holds too;
* square roots are correctly rounded; x^20 is a multiply chain (x^5
  squared twice) where the source calls ``powr``; dot products are summed
  left to right;
* the hit distance is not clamped (K3 clamps it at 1e6; in a closed room
  no hit is that far).

It imports nothing of the program. ``dtype`` runs the floating-point parts
in another precision (the benchmark's control runs it in bfloat16); the
camera's rays (numpy float32, as the program makes them) are computed in
float32 and then cast. ``on_work`` sees, level by level, what a tracer that
visits only live nodes does (``count_work``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

PLANE, SPHERE = 0, 1
TYPES = {"plane": PLANE, "sphere": SPHERE}
EPSILON = float(np.float32(0.001))  # raytracer_kernel.cl:30
BEER = float(np.float32(0.15))  # :370
HIT, MISS, INPRIM = 1, 0, -1  # :26-28
FIELDS = ("normal", "depth", "center", "radius", "color", "refl", "diff", "refr", "refr_index",
          "spec")
DEFAULTS = dict(normal=(0.0, 0.0, 0.0), depth=0.0, center=(0.0, 0.0, 0.0), radius=0.0)

Hook = Optional[Callable[[dict], None]]


class Scene(NamedTuple):
    normal: torch.Tensor  # [N, 3] plane normal
    depth: torch.Tensor  # [N] the plane is n.x + depth = 0
    center: torch.Tensor  # [N, 3]
    radius: torch.Tensor  # [N]
    color: torch.Tensor  # [N, 3]
    refl: torch.Tensor
    diff: torch.Tensor
    refr: torch.Tensor
    refr_index: torch.Tensor
    spec: torch.Tensor
    ptype: Tuple[int, ...]
    is_light: Tuple[bool, ...]


class Frame(NamedTuple):
    """What a render is: the frame, the subsamples of a pixel (``spp``, a
    square: 9 is the source's 3x3), the tree's depth and the near-hit
    slack."""
    width: int
    height: int
    spp: int = 9
    trace_depth: int = 5
    hit_bias: float = 0.0

    @property
    def supersample(self) -> int:
        ss = int(round(self.spp ** 0.5))
        if ss * ss != self.spp:
            raise ValueError(f"spp {self.spp}: the subsamples of a pixel make a square grid")
        return ss


def make_scene(scene_cfg: dict, device, dtype=torch.float32) -> Scene:
    """The scene of a configuration's primitive rows."""
    rows = [{**DEFAULTS, **p} for p in scene_cfg["primitives"]]

    def arr(k):
        return torch.tensor(np.array([r[k] for r in rows], np.float32), device=device).to(dtype)

    return Scene(*(arr(k) for k in FIELDS), ptype=tuple(TYPES[r["type"]] for r in rows),
                 is_light=tuple(bool(r["is_light"]) for r in rows))


def pose(seed: int, walk: dict):
    """(eye, target) of a render with ``seed``: each coordinate uniform
    between the bounds of ``walk`` (``eye`` and ``target``: [lo, hi] for x,
    y and z), drawn in that order from numpy's PCG64(seed)."""
    bounds = np.array(walk["eye"] + walk["target"], np.float64)
    v = np.random.Generator(np.random.PCG64(seed)).uniform(bounds[:, 0], bounds[:, 1])
    return tuple(float(x) for x in v[:3]), tuple(float(x) for x in v[3:])


def camera_row(eye=None, target=None) -> np.ndarray:
    """[12] float32 row [O, X, Y, C]: a ray through window point (sx, sy)
    starts at O along normalize(X sx + Y sy + C). None for both: the
    source's fixed viewpoint (O = (0, 0.25, -7), X = e_x, Y = e_y, C = (0,
    -0.25, 7)). Else a look-at basis with up +y and C = 7 z, z the unit
    vector from the eye to the target."""
    f32 = np.float32
    if eye is None and target is None:
        return np.array([0, 0.25, -7, 1, 0, 0, 0, 1, 0, 0, -0.25, 7], f32)
    o = np.asarray(eye, f32)
    z = np.asarray(target, f32) - o
    z = z / max(np.linalg.norm(z), 1e-12)
    x = np.cross(np.array([0, 1, 0], f32), z)
    nx = np.linalg.norm(x)
    x = np.array([1, 0, 0], f32) if nx < 1e-6 else x / nx
    y = np.cross(z, x)
    return np.concatenate([o, x, y, 7.0 * z]).astype(f32)


def camera_rays(frame: Frame, row: np.ndarray, pix: np.ndarray):
    """(origins, directions) [P * ss^2, 3] float32 of the pixels ``pix``
    (row-major ids): pixel by pixel, its subsamples with the x offset outer
    and the y offset inner (raytracer_kernel.cl:291-292), each offset half a
    pixel."""
    f32 = np.float32
    ss = frame.supersample
    dxs, dys = f32(6.0 / frame.width), f32(-4.5 / frame.height)
    offs = (np.arange(ss) - ss // 2).astype(f32)
    x = (pix % frame.width).astype(f32)[:, None, None]
    y = (pix // frame.width).astype(f32)[:, None, None]
    sx = (f32(-3.0) + x * dxs) + offs[None, :, None] * (dxs / f32(2.0))
    sy = (f32(2.25) + y * dys) + offs[None, None, :] * (dys / f32(2.0))
    sx, sy = np.broadcast_arrays(sx, sy)
    c = row.astype(f32)
    r = [c[3 + k] * sx + c[6 + k] * sy + c[9 + k] for k in range(3)]
    inv = f32(1.0) / np.sqrt(r[0] * r[0] + r[1] * r[1] + r[2] * r[2])
    d = np.stack([v * inv for v in r], axis=-1).reshape(-1, 3)
    return np.ascontiguousarray(np.broadcast_to(c[0:3], d.shape)), d


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root in ``x``'s precision."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def pow20(x: torch.Tensor) -> torch.Tensor:
    x2 = x * x
    x5 = x2 * x2 * x
    x10 = x5 * x5
    return x10 * x10


def prim_tests(scene: Scene, o, d):
    """[R, N] each: the plane distance and whether it is ahead, the sphere's
    roots i1 <= i2 and whether the sphere is ahead (:89-137)."""
    denom = dot3(scene.normal[None], d[:, None])
    pdist = -(dot3(scene.normal[None], o[:, None]) + scene.depth[None]) / torch.where(
        denom != 0.0, denom, 1.0)
    pvalid = (denom != 0.0) & (pdist > 0.0)
    v = o[:, None] - scene.center[None]
    b = -dot3(v, d[:, None])
    det = b * b - dot3(v, v) + (scene.radius * scene.radius)[None]
    svalid = det > 0.0
    sq = sqrt_rn(torch.where(svalid, det, 1.0))
    i1, i2 = b - sq, b + sq
    return pdist, pvalid, i1, i2, svalid & (i2 > 0.0)


def nearest(scene: Scene, o, d, bias: float):
    """The first primitive, in index order, that improves the running
    distance (raytrace:163-177): (index [R], -1 on a miss; HIT or INPRIM;
    distance)."""
    pdist, pvalid, i1, i2, svalid = prim_tests(scene, o, d)
    r = o.shape[0]
    cumu = torch.full((r,), torch.finfo(o.dtype).max, dtype=o.dtype, device=o.device)
    idx = torch.full((r,), -1, dtype=torch.int64, device=o.device)
    res = torch.full((r,), MISS, dtype=torch.int64, device=o.device)
    for j, kind in enumerate(scene.ptype):
        if kind == PLANE:
            take, dist, code = pvalid[:, j] & (pdist[:, j] < cumu), pdist[:, j], HIT
        else:
            inside = svalid[:, j] & (i1[:, j] < 0.0) & (i2[:, j] < cumu)
            ahead = svalid[:, j] & (i1[:, j] >= 0.0) & (i1[:, j] < cumu + bias)
            take = inside | ahead
            dist = torch.where(i1[:, j] < 0.0, i2[:, j], i1[:, j])
            code = torch.where(inside, INPRIM, HIT)
        cumu = torch.where(take, dist, cumu)
        idx = torch.where(take, j, idx)
        res = torch.where(take, code, res)
    return idx, res, cumu


def blocked(scene: Scene, o, d, max_t, bias: float):
    """(any primitive that is no light hit closer than ``max_t`` (:199-212),
    the primitive tests of a sweep over them in index order that stops at
    its first such hit)."""
    pdist, pvalid, i1, i2, svalid = prim_tests(scene, o, d)
    dev = o.device
    plane = torch.tensor([k == PLANE for k in scene.ptype], device=dev)
    occluder = torch.tensor([not x for x in scene.is_light], device=dev)
    mt = max_t[:, None]
    hits = occluder[None] & torch.where(
        plane[None], pvalid & (pdist < mt),
        svalid & torch.where(i1 < 0.0, i2 < mt, i1 < mt + bias))
    n = len(scene.ptype)
    ids = torch.arange(n, device=dev)
    first = torch.where(hits, ids, n).amin(dim=-1)
    tests = (occluder[None] & (ids[None] <= first[:, None])).sum(dim=-1)
    return hits.any(dim=-1), tests


def normal_at(scene: Scene, idx, point):
    """get_normal (:151-161): a plane's normal, a sphere's (p - c) / r."""
    plane = torch.tensor([k == PLANE for k in scene.ptype], device=point.device)[idx]
    r = scene.radius[idx]
    inv_r = 1.0 / torch.where(r != 0.0, r, 1.0)
    return torch.where(plane[:, None], scene.normal[idx],
                       (point - scene.center[idx]) * inv_r[:, None])


def shade(scene: Scene, o, d, bias: float, counts: Optional[dict]):
    """``raytrace`` (:163-242) of rays [L, 3]: (index, HIT/INPRIM, distance
    (1 on a miss), hit point, normal, local color). ``counts`` gets the
    lit nodes and the shadow sweeps' primitive tests."""
    idx, res, dist = nearest(scene, o, d, bias)
    hit = idx >= 0
    safe = torch.clamp(idx, min=0)
    dist = torch.where(hit, dist, 1.0)
    point = o + d * dist[:, None]
    hit_light = hit & torch.tensor(scene.is_light, device=o.device)[safe]
    lit = hit & ~hit_light
    n_hit = normal_at(scene, safe, point)
    m_color, m_diff, m_spec = scene.color[safe], scene.diff[safe], scene.spec[safe]
    acc = torch.zeros_like(o)
    for li, is_light in enumerate(scene.is_light):
        if not is_light:
            continue
        l_vec = scene.center[li][None] - point
        l_len = sqrt_rn(torch.clamp(dot3(l_vec, l_vec), min=1e-30))
        l_dir = l_vec / l_len[:, None]
        vis = torch.ones_like(l_len)
        if scene.ptype[li] == SPHERE:
            shadow, tests = blocked(scene, point + l_dir * EPSILON, l_dir, l_len, bias)
            vis = torch.where(shadow, 0.0, vis)
            if counts is not None:
                counts["shadow_tests"] += int(tests[lit].sum())
        lcol = scene.color[li][None]
        dnl = dot3(n_hit, l_dir)
        diff = torch.where((m_diff > 0.0) & (dnl > 0.0), dnl * m_diff * vis, 0.0)
        acc = acc + diff[:, None] * m_color * lcol
        dvr = dot3(d, l_dir - (2.0 * dnl)[:, None] * n_hit)
        spec = torch.where((m_spec > 0.0) & (dvr > 0.0),
                           pow20(torch.clamp(dvr, min=0.0)) * m_spec * vis, 0.0)
        acc = acc + spec[:, None] * lcol
    if counts is not None:
        counts["hit_nodes"] += int(lit.sum())
    local = torch.where(hit_light[:, None], m_color, torch.where(hit[:, None], acc, 0.0))
    return idx, res, dist, point, n_hit, local


def trace(scene: Scene, o, d, trace_depth: int, bias: float = 0.0, on_work: Hook = None):
    """Each ray's tree to ``trace_depth`` from rays [R, 3]: its summed color
    [R, 3] before the tone scale. A level's live nodes are one batch, each
    with its ray and its position in the level (2p a reflection child of
    node p, 2p + 1 its refraction child), summed into its ray's color in
    order of position: the source's queue order. ``on_work(counts)`` sees
    each level's ``nodes`` (live), ``hit_nodes`` (those that hit a
    primitive that is no light: they are lit) and ``shadow_tests``."""
    dev, dtype, r = o.device, o.dtype, o.shape[0]
    bias = float(np.float32(bias))
    total = torch.zeros_like(o)
    ray = torch.arange(r, device=dev)
    pos = torch.zeros(r, dtype=torch.int64, device=dev)
    weight = torch.ones(r, dtype=dtype, device=dev)
    factor = torch.ones_like(o)  # 1, parent color x transparency, or transparency
    transp = torch.ones_like(o)
    r_index = torch.ones(r, dtype=dtype, device=dev)
    for level in range(trace_depth + 1):
        if ray.numel() == 0:
            break
        counts = None if on_work is None else {"nodes": int(ray.numel()), "hit_nodes": 0,
                                               "shadow_tests": 0}
        idx, res, dist, point, n_hit, local = shade(scene, o, d, bias, counts)
        contrib = local * weight[:, None] * factor
        for p in torch.unique(pos).tolist():
            at = pos == p
            total[ray[at]] = total[ray[at]] + contrib[at]
        if on_work is not None:
            on_work(counts)
        if level == trace_depth:
            break
        hit = idx >= 0
        safe = torch.clamp(idx, min=0)
        m_color = scene.color[safe]
        # The reflection child (:332-348).
        refl = scene.refl[safe]
        rdir = d - (2.0 * dot3(d, n_hit))[:, None] * n_hit
        a = hit & (refl > 0.0)
        # The refraction child (:349-373); Beer from the parent's distance.
        ri = scene.refr_index[safe]
        ri = torch.where(ri != 0.0, ri, 1.0)
        ratio = r_index / ri
        n2 = n_hit * res.to(dtype)[:, None]
        cos_i = -dot3(n2, d)
        cos_t2 = 1.0 - ratio * ratio * (1.0 - cos_i * cos_i)
        b = hit & (scene.refr[safe] > 0.0) & (cos_t2 > 0.0)
        tdir = (ratio[:, None] * d
                + (ratio * cos_i - sqrt_rn(torch.where(cos_t2 > 0.0, cos_t2, 1.0)))[:, None] * n2)
        t_child = transp * torch.exp(m_color * BEER * (-dist)[:, None])
        o = torch.cat([point[a] + rdir[a] * EPSILON, point[b] + tdir[b] * EPSILON])
        d = torch.cat([rdir[a], tdir[b]])
        weight = torch.cat([refl[a] * weight[a], weight[b]])
        factor = torch.cat([m_color[a] * transp[a], t_child[b]])
        transp = torch.cat([transp[a], t_child[b]])
        r_index = torch.cat([r_index[a], ri[b]])
        ray = torch.cat([ray[a], ray[b]])
        pos = torch.cat([2 * pos[a], 2 * pos[b] + 1])
    return total


def render_pixels(scene: Scene, frame: Frame, row: np.ndarray, pixels: torch.Tensor,
                  dtype=torch.float32, block: int = 1 << 14, on_work: Hook = None
                  ) -> torch.Tensor:
    """[P, 3] values in 0..255 of the row-major ``pixels`` (int64, on the
    device) of a render from the camera ``row``: each pixel's subsample
    colors summed in ray order, x 256 / ss^2, clamped (:378-382); in blocks
    of ``block`` pixels. Float32 products never run in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = pixels.device
    ss2 = frame.spp
    scale = float(np.float32(256.0 / ss2))
    out = []
    for a in range(0, pixels.shape[0], block):
        pix = pixels[a:a + block].cpu().numpy()
        o, d = (torch.from_numpy(x).to(dev).to(dtype) for x in camera_rays(frame, row, pix))
        col = trace(scene, o, d, frame.trace_depth, frame.hit_bias, on_work).reshape(-1, ss2, 3)
        total = col[:, 0]
        for k in range(1, ss2):
            total = total + col[:, k]
        out.append(torch.clamp(total * scale, 0.0, 255.0))
    return torch.cat(out)


def all_pixels(frame: Frame, device) -> torch.Tensor:
    return torch.arange(frame.width * frame.height, dtype=torch.int64, device=device)


def count_work(scene: Scene, frame: Frame, row: np.ndarray, device, block: int = 1 << 14
               ) -> dict:
    """The live work of every subsample ray of a render (``trace``'s counts,
    summed)."""
    work = {"nodes": 0, "hit_nodes": 0, "shadow_tests": 0}

    def add(counts):
        for k in work:
            work[k] += counts[k]

    with torch.no_grad():
        render_pixels(scene, frame, row, all_pixels(frame, device), block=block, on_work=add)
    return work

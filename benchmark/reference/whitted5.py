"""The plain reference of the raytracer5 ("whitted5") tracer: a frozen copy,
in plain PyTorch, of the integrator the program under test implements.

raytracer5/trunk (Jacco Bikker's raytracing tutorial, part 5):
Engine::Raytrace (raytracer.cpp:228-363), CalcShade (:371-406), FindNearest
(:228-237), Engine::InitRender's look-at camera (:413-451); the sphere,
one-sided plane and axis-aligned box primitives (scene.cpp:128-159,
232-244, 306-374), Texture::GetTexel (:81-106), Box::Light's 4x4 jittered
grid (:376-404); TRACEDEPTH 4 and EPSILON 0.001 (common.h:27-28).

Where it follows the program rather than raytracer5/trunk:

* the tree is evaluated level by level over masked lanes: the 2^(l-1)
  nodes of level l are one node-major batch, each node keyed by its heap
  id (``node_key``), and a level's contributions are summed in node order;
* the RNG is the counter stream: each pixel's key is a hash of its id and
  the seed (``pixel_keys``), each pass starts its counters
  ``PASS_DRAW_BUDGET`` apart, and a draw advances only under its mask;
* glossy reflection takes one disc sample a pass (raytracer5 averages
  SAMPLES = 4 in the node), only below level 3;
* a box light's shadow samples are scheduled per tree level
  (``area_samples``: 2 at the first level, then 1), taken from the grid's
  first cells, each weighted 1 / samples; every other light occludes;
* nearest hits are found by brute force as the first minimum over the
  primitives in index order (raytracer5 walks an 8^3 grid with
  mailboxing); a plane keeps the source's missing dist > 0 guard;
* x^20 is a multiply chain; dot products are summed left to right;
* the pixel's ray goes through its centre (0.5, 0.5), where raytracer5's
  scanline uses the corner (0, 0).

It imports nothing of the program. ``dtype`` runs the floating-point parts
in another precision (the benchmark's control runs it in bfloat16); the
RNG and the camera's rays (numpy float32, as the program makes them) are
computed as in float32 and then cast. ``on_work`` sees, level by level,
what a tracer that visits only live nodes does (``count_work``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

SPHERE, PLANE, BOX = 0, 1, 2
TYPES = {"sphere": SPHERE, "plane": PLANE, "box": BOX}
EPSILON = float(np.float32(0.001))  # common.h:27
PI = float(np.float32(np.pi))
TWO_PI = float(np.float32(2.0 * PI))
PASS_DRAW_BUDGET = 1 << 10
MAX_DIST = 1e6
HIT, MISS, INPRIM = 1, 0, -1
M32 = 0xFFFFFFFF
# Box::Light's 4x4 grid cell origins, in units of size / 4 (scene.cpp:381-396).
GRID = ((1, 2), (3, 3), (2, 0), (0, 1), (2, 3), (0, 3), (0, 0), (2, 2),
        (3, 1), (1, 3), (1, 0), (3, 2), (2, 1), (3, 0), (1, 1), (0, 2))
BOX_NORMALS = ((-1.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, -1.0, 0.0),
               (0.0, 1.0, 0.0), (0.0, 0.0, -1.0), (0.0, 0.0, 1.0))
FIELDS = ("center", "radius", "normal", "depth", "box_pos", "box_size", "color", "refl",
          "refr", "refr_index", "diff", "spec", "drefl", "uv_scale")
# The values of a field a primitive's row leaves out (the source's
# Material defaults and zero geometry).
DEFAULTS = dict(center=(0.0, 0.0, 0.0), radius=0.0, normal=(0.0, 0.0, 0.0), depth=0.0,
                box_pos=(0.0, 0.0, 0.0), box_size=(0.0, 0.0, 0.0), color=(0.2, 0.2, 0.2),
                refl=0.0, refr=0.0, refr_index=1.5, diff=0.2, spec=0.8, drefl=0.0,
                uv_scale=(1.0, 1.0))

Hook = Optional[Callable[[dict], None]]


class Scene(NamedTuple):
    center: torch.Tensor  # [N, 3]
    radius: torch.Tensor  # [N]
    normal: torch.Tensor  # [N, 3]
    depth: torch.Tensor  # [N]
    box_pos: torch.Tensor  # [N, 3]
    box_size: torch.Tensor  # [N, 3]
    color: torch.Tensor  # [N, 3]
    refl: torch.Tensor
    refr: torch.Tensor
    refr_index: torch.Tensor
    diff: torch.Tensor
    spec: torch.Tensor
    drefl: torch.Tensor
    uv_scale: torch.Tensor  # [N, 2]
    textures: Tuple[torch.Tensor, ...]  # [Th, Tw, 3] each
    ptype: Tuple[int, ...]
    is_light: Tuple[bool, ...]
    tex_id: Tuple[int, ...]


class Frame(NamedTuple):
    """What a render is: the frame, its passes, the tree's depth and the box
    lights' shadow samples at each level, and the camera."""
    width: int
    height: int
    spp: int
    trace_depth: int = 4
    area_samples: Tuple[int, ...] = (2, 1, 1, 1)
    pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    target: Tuple[float, float, float] = (0.0, 0.0, 1.0)


def checker_texture(size: int, scale: int) -> np.ndarray:
    """The checker stand-in for textures/checker.tga."""
    ij = np.indices((size, size)).sum(axis=0) // scale
    c = (ij % 2).astype(np.float32)
    return np.stack([c, c, c], axis=-1) * 0.8 + 0.2


def marble_texture(size: int, seed: int) -> np.ndarray:
    """The marble stand-in for textures/marble.tga: sine-warped noise from
    numpy's PCG64."""
    rng = np.random.Generator(np.random.PCG64(seed))
    noise = rng.random((size, size)).astype(np.float32)
    for _ in range(3):
        noise = 0.25 * (noise + np.roll(noise, 1, 0) + np.roll(noise, 1, 1)
                        + np.roll(noise, (1, 1), (0, 1)))
    x = np.linspace(0, 4 * np.pi, size, dtype=np.float32)
    veins = 0.5 + 0.5 * np.sin(x[None, :] + 6.0 * noise)
    col = np.stack([veins, veins * 0.95, veins * 0.9], axis=-1)
    return (0.4 + 0.6 * col).astype(np.float32)


def texture(spec: dict) -> np.ndarray:
    """[Th, Tw, 3] float32 bitmap of a configuration's texture entry."""
    if spec["generator"] == "checker":
        return checker_texture(spec["size"], spec["scale"])
    if spec["generator"] == "marble":
        return marble_texture(spec["size"], spec["seed"])
    if spec["generator"] == "noise":  # [h, w] bytes / 256 from numpy's PCG64
        rng = np.random.Generator(np.random.PCG64(spec["seed"]))
        return (rng.integers(0, 256, size=(*spec["size"], 3)) / 256.0).astype(np.float32)
    raise ValueError(f"unknown texture generator {spec['generator']!r}")


def rows(scene_cfg: dict):
    """(primitive rows with every field, textures [Th, Tw, 3] in order) of a
    configuration's scene."""
    names = [t["name"] for t in scene_cfg["textures"]]
    out = []
    for p in scene_cfg["primitives"]:
        row = {**DEFAULTS, **{k: p[k] for k in FIELDS if k in p}}
        row.update(ptype=TYPES[p["type"]], is_light=bool(p["is_light"]),
                   tex=-1 if p["texture"] is None else names.index(p["texture"]))
        out.append(row)
    return out, [texture(t) for t in scene_cfg["textures"]]


def make_scene(scene_cfg: dict, device, dtype=torch.float32) -> Scene:
    r, texs = rows(scene_cfg)

    def arr(k):
        return torch.tensor(np.array([x[k] for x in r], np.float32), device=device).to(dtype)

    return Scene(*(arr(k) for k in FIELDS),
                 textures=tuple(torch.from_numpy(t).to(device).to(dtype) for t in texs),
                 ptype=tuple(x["ptype"] for x in r), is_light=tuple(x["is_light"] for x in r),
                 tex_id=tuple(x["tex"] for x in r))


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


def arccos1(x: torch.Tensor) -> torch.Tensor:
    """arccos of a clipped cosine with exact endpoints."""
    edge = torch.abs(x) >= 1.0
    xs = torch.where(edge, 0.0, x)
    return torch.where(edge, torch.where(x >= 1.0, 0.0, PI), torch.acos(xs))


# The counter RNG (int64 words holding uint32).

def counter_draw(key, ctr, mask, dtype):
    """One draw of the (key, counter) hash in [0, 1); the counter advances
    where ``mask``. Returns (value in ``dtype``, new counter)."""
    x = key ^ ((ctr * 0x9E3779B9) & M32)
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & M32
    x = x ^ (x >> 15)
    value = ((x >> 8).to(torch.float32) * float(np.float32(1.0 / (1 << 24)))).to(dtype)
    return value, torch.where(mask, (ctr + 1) & M32, ctr)


def node_key(key: torch.Tensor, heap_id: torch.Tensor) -> torch.Tensor:
    x = key ^ ((heap_id * 0x9E3779B9 + 0x7F4A7C15) & M32)
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & M32
    return x ^ (x >> 15)


def pixel_keys(seed: int, pixels: np.ndarray) -> np.ndarray:
    """The counter keys (uint32) of the row-major ``pixels`` of a render
    with ``seed``: the pixel id hashed with a word of the seed."""
    with np.errstate(over="ignore"):
        pid = np.asarray(pixels).astype(np.uint32)
        seed_word = np.uint32((seed * 0x85EBCA6B + 0x165667B1) & M32)
        key = pid * np.uint32(0x9E3779B1) ^ seed_word
        key = key ^ (key >> np.uint32(16))
        key = key * np.uint32(0x7FEB352D)
        return key ^ (key >> np.uint32(15))


# The camera (Engine::InitRender), in numpy float32.

def camera_frame(width: int, height: int, pos, target):
    """(origin, p1, dx, dy): the eye at (0, 0, -5) and the 8x6 screen at z = 0
    in camera space, in world space; pixel (col, row) sits at p1 + col dx +
    row dy."""
    pos = np.asarray(pos, np.float32)
    target = np.asarray(target, np.float32)
    z = target - pos
    z = z / np.linalg.norm(z)
    up = np.array([0, 1, 0], np.float32)
    x = np.cross(up, z)
    x = x / max(np.linalg.norm(x), 1e-12)
    y = np.cross(x, -z)
    inv = np.linalg.inv(np.stack([x, y, z], axis=0))

    def xf(p):
        return inv @ np.asarray(p, np.float32) + pos

    origin, p1, p2, p4 = xf((0, 0, -5)), xf((-4, 3, 0)), xf((4, 3, 0)), xf((-4, -3, 0))
    return (origin.astype(np.float32), p1.astype(np.float32),
            ((p2 - p1) / width).astype(np.float32), ((p4 - p1) / height).astype(np.float32))


def camera_rays(frame: Frame, pixels: np.ndarray):
    """(origins, directions) [P, 3] float32 of the rays through the centres
    of the row-major ``pixels``, row 0 at the top."""
    origin, p1, dx, dy = camera_frame(frame.width, frame.height, frame.pos, frame.target)
    pixels = np.asarray(pixels)
    cols = (pixels % frame.width).astype(np.float32) + np.float32(0.5)
    rws = (pixels // frame.width).astype(np.float32) + np.float32(0.5)
    screen = p1[None] + cols[:, None] * dx[None] + rws[:, None] * dy[None]
    dirs = screen - origin
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    return (np.ascontiguousarray(np.broadcast_to(origin, dirs.shape), np.float32),
            np.ascontiguousarray(dirs, np.float32))


# Intersections.

def candidates(scene: Scene, o: torch.Tensor, d: torch.Tensor):
    """[R, N] each: (dist, code, valid) of every primitive, in index order,
    each kind of primitive in one batch. Sphere: det > 0, i2 > 0, the near
    root, or the far one from inside (INPRIM); plane: only a face with
    N.d < 0, no dist > 0 guard; box: six slab distances with an EPSILON
    point-in-box slack, the least positive."""
    r, n = o.shape[0], len(scene.ptype)
    dist = torch.zeros((r, n), dtype=o.dtype, device=o.device)
    valid = torch.zeros((r, n), dtype=torch.bool, device=o.device)
    code = torch.full((r, n), HIT, dtype=torch.int64, device=o.device)
    sph, pla, box = ([j for j, t in enumerate(scene.ptype) if t == kind]
                     for kind in (SPHERE, PLANE, BOX))
    if sph:
        v = o[:, None, :] - scene.center[sph][None]
        b = -dot3(v, d[:, None, :])
        rad = scene.radius[sph]
        det = b * b - dot3(v, v) + (rad * rad)[None]
        ok = det > 0.0
        sq = sqrt_rn(torch.where(ok, det, 1.0))
        i1, i2 = b - sq, b + sq
        inprim = i1 < 0.0
        dist[:, sph] = torch.where(inprim, i2, i1)
        valid[:, sph] = ok & (i2 > 0.0)
        code[:, sph] = torch.where(inprim, INPRIM, HIT)
    if pla:
        nrm = scene.normal[pla][None]
        pd = nrm[..., 0] * d[:, None, 0] + nrm[..., 1] * d[:, None, 1] + nrm[..., 2] * d[:, None, 2]
        no = nrm[..., 0] * o[:, None, 0] + nrm[..., 1] * o[:, None, 1] + nrm[..., 2] * o[:, None, 2]
        dist[:, pla] = -(no + scene.depth[pla][None]) / torch.where(pd != 0.0, pd, 1.0)
        valid[:, pla] = pd < 0.0
    if box:
        v1 = scene.box_pos[box]
        v2 = v1 + scene.box_size[box]
        lo, hi = v1 - EPSILON, v2 + EPSILON
        best = torch.full((r, len(box)), 1e30, dtype=o.dtype, device=o.device)
        ok = torch.zeros((r, len(box)), dtype=torch.bool, device=o.device)
        for a in range(3):
            d_a, o_a = d[:, a:a + 1], o[:, a:a + 1]
            d_safe = torch.where(d_a != 0.0, d_a, 1.0)
            for bound in (v1, v2):
                tf = (bound[None, :, a] - o_a) / d_safe
                inside = torch.ones_like(ok)
                for a2 in range(3):
                    p = o[:, a2:a2 + 1] + tf * d[:, a2:a2 + 1]
                    inside = inside & (p > lo[None, :, a2]) & (p < hi[None, :, a2])
                face = (d_a != 0.0) & (tf > 0.0) & inside
                best = torch.where(face & (tf < best), tf, best)
                ok = ok | face
        dist[:, box] = best
        valid[:, box] = ok
    return dist, code, valid


def first_min(dist, valid):
    """(least distance, first index of it) over the valid candidates."""
    dm = torch.where(valid, dist, float("inf"))
    return dm.amin(dim=1), dm.argmin(dim=1)


def find_nearest(scene: Scene, o, d):
    """(idx, -1 on a miss; code; dist, MAX_DIST on a miss)."""
    dist, code, valid = candidates(scene, o, d)
    best, amin = first_min(dist, valid)
    hit = best < MAX_DIST
    return (torch.where(hit, amin, -1), torch.where(hit, code.gather(1, amin[:, None])[:, 0], MISS),
            torch.where(hit, best, MAX_DIST))


def nearest_is(scene: Scene, o, d, max_dist, target: int):
    """CalcShade's visibility: the nearest primitive within ``max_dist`` is
    the light ``target``."""
    dist, _, valid = candidates(scene, o, d)
    best, amin = first_min(dist, valid)
    return (best < max_dist) & (amin == target)


# Surfaces.

def static_normals(scene: Scene) -> torch.Tensor:
    """[N, 3]: a plane's normal, a box's position-free Box::GetNormal, zero
    for a sphere."""
    out = []
    for j, t in enumerate(scene.ptype):
        if t == PLANE:
            out.append(scene.normal[j])
        elif t == BOX:
            pos, size = scene.box_pos[j], scene.box_size[j]
            c = torch.stack([torch.abs(size[0] - pos[0]), torch.abs(size[0] + size[0] - pos[0]),
                             torch.abs(size[1] - pos[1]), torch.abs(size[1] + size[1] - pos[1]),
                             torch.abs(size[2] - pos[2]), torch.abs(size[2] + size[2] - pos[2])])
            out.append(torch.tensor(BOX_NORMALS, dtype=pos.dtype, device=pos.device)[
                torch.argmin(c)])
        else:
            out.append(torch.zeros(3, dtype=scene.center.dtype, device=scene.center.device))
    return torch.stack(out)


def normal_at(scene: Scene, idx, point):
    rad = scene.radius[idx]
    n_sphere = (point - scene.center[idx]) * (1.0 / torch.where(rad != 0.0, rad, 1.0))[:, None]
    is_sphere = torch.tensor([t == SPHERE for t in scene.ptype], device=point.device)[idx]
    return torch.where(is_sphere[:, None], n_sphere, static_normals(scene)[idx])


def texel(bitmap: torch.Tensor, u, v):
    """GetTexel: u and v both scaled by the width, +1000.5 / +1000.0, a floor
    modulo wrap, the bilinear blend."""
    th, tw = bitmap.shape[:2]
    fu = (u + 1000.5) * tw
    fv = (v + 1000.0) * tw
    u1 = torch.floor(fu).to(torch.int32) % tw
    v1 = torch.floor(fv).to(torch.int32) % th
    u2, v2 = (u1 + 1) % tw, (v1 + 1) % th
    fracu, fracv = fu - torch.floor(fu), fv - torch.floor(fv)
    w1 = (1 - fracu) * (1 - fracv)
    w2 = fracu * (1 - fracv)
    w3 = (1 - fracu) * fracv
    w4 = fracu * fracv
    u1, u2, v1, v2 = u1.long(), u2.long(), v1.long(), v2.long()
    return (bitmap[v1, u1] * w1[:, None] + bitmap[v1, u2] * w2[:, None]
            + bitmap[v2, u1] * w3[:, None] + bitmap[v2, u2] * w4[:, None])


def uv(scene: Scene, j: int, point):
    """(u, v) on textured primitive j: a sphere's polar mapping, a plane's
    axis mapping."""
    us = scene.uv_scale[j]
    if scene.ptype[j] == SPHERE:
        rad = scene.radius[j]
        vp = (point - scene.center[j][None]) * (1.0 / torch.where(rad != 0.0, rad, 1.0))
        cosphi = torch.clamp(-vp[:, 1], -1.0, 1.0)
        phi = arccos1(cosphi)
        sinphi = sqrt_rn(torch.clamp(1.0 - cosphi * cosphi, min=1e-12))
        v = phi * (1.0 / us[1]) * (1.0 / PI)
        theta = arccos1(torch.clamp(vp[:, 0] / sinphi, -1.0, 1.0)) * (2.0 / PI)
        return torch.where(-vp[:, 2] >= 0.0, 1.0 - theta, theta) * (1.0 / us[0]), v
    n = scene.normal[j]
    ua = torch.stack([n[1], n[2], -n[0]])
    va = torch.stack([ua[1] * n[2] - ua[2] * n[1], ua[2] * n[0] - ua[0] * n[2],
                      ua[0] * n[1] - ua[1] * n[0]])
    return dot3(point, ua[None]) * us[0], dot3(point, va[None]) * us[1]


def color_at(scene: Scene, idx, point):
    """GetColor: the material's color, times the texel where textured."""
    out = scene.color[idx]
    for j, t in enumerate(scene.tex_id):
        if t >= 0:
            u, v = uv(scene, j, point)
            out = torch.where((idx == j)[:, None], texel(scene.textures[t], u, v)
                              * scene.color[j][None], out)
    return out


# Shading and the tree.

def calc_shade(scene: Scene, light: int, point, key, ctr, mask, n_samples: int):
    """(shade, L, counter): a sphere light's binary visibility, or a box
    light's ``n_samples`` jittered grid samples on its bottom face, u1 then
    u2 a sample where ``mask``."""
    if scene.ptype[light] == SPHERE:
        ldir = scene.center[light][None] - point
        tdist = sqrt_rn(torch.clamp(dot3(ldir, ldir), min=1e-30))
        ldir = ldir / tdist[:, None]
        vis = nearest_is(scene, point + ldir * EPSILON, ldir, tdist, light)
        return torch.where(vis, 1.0, 0.0).to(point.dtype), ldir, ctr
    pos, size = scene.box_pos[light], scene.box_size[light]
    ldir = (pos + 0.5 * size)[None] - point
    ldir = ldir * (1.0 / sqrt_rn(torch.clamp(dot3(ldir, ldir), min=1e-30)))[:, None]
    deltax, deltay = size[0] * 0.25, size[2] * 0.25
    cell_x, cell_z = size[0] / 4.0, size[2] / 4.0
    shade = torch.zeros(point.shape[0], dtype=point.dtype, device=point.device)
    weight = float(np.float32(1.0 / n_samples))
    for i in range(n_samples):
        u1, ctr = counter_draw(key, ctr, mask, point.dtype)
        u2, ctr = counter_draw(key, ctr, mask, point.dtype)
        gx = float(GRID[i & 15][0]) * cell_x + pos[0] + u1 * deltax
        gz = float(GRID[i & 15][1]) * cell_z + pos[2] + u2 * deltay
        sdir = torch.stack([gx, pos[1].expand_as(gx), gz], dim=-1) - point
        ldist = sqrt_rn(torch.clamp(dot3(sdir, sdir), min=1e-30))
        sdir = sdir / ldist[:, None]
        vis = nearest_is(scene, point + sdir * EPSILON, sdir, ldist, light)
        shade = shade + torch.where(vis, 1.0, 0.0).to(point.dtype) * weight
    return shade, ldir, ctr


def shade_node(scene: Scene, o, d, key, ctr, valid, n_samples: int, counts: Optional[dict]):
    """A node's local work: nearest hit, each light's diffuse and Phong-20
    term under CalcShade's visibility, a light's own color where one is
    hit. ``counts`` gets the shadow sweeps whose shade a term can use."""
    idx, code, dist = find_nearest(scene, o, d)
    hit = idx >= 0
    safe = torch.clamp(idx, min=0)
    dist = torch.where(hit, dist, 1.0)
    point = o + d * dist[:, None]
    is_light = torch.tensor(scene.is_light, device=o.device)
    hit_light = hit & is_light[safe]
    color = color_at(scene, safe, point)
    n_hit = normal_at(scene, safe, point)
    m_diff, m_spec = scene.diff[safe], scene.spec[safe]
    acc = torch.zeros_like(o)
    for li in range(len(scene.ptype)):
        if not scene.is_light[li]:
            continue
        shade, ldir, ctr = calc_shade(scene, li, point, key, ctr, valid & hit & ~hit_light,
                                      n_samples)
        lit = shade > 0.0
        lcol = scene.color[li][None]
        dnl = dot3(ldir, n_hit)
        acc = acc + torch.where(lit & (m_diff > 0.0) & (dnl > 0.0), dnl * m_diff * shade,
                                0.0)[:, None] * color * lcol
        rv = ldir - (2.0 * dnl)[:, None] * n_hit
        dvr = dot3(d, rv)
        spec = torch.where(lit & (m_spec > 0.0) & (dvr > 0.0),
                           pow20(torch.clamp(dvr, min=0.0)) * m_spec * shade, 0.0)
        acc = acc + spec[:, None] * lcol
        if counts is not None:
            used = valid & hit & ~hit_light & (((m_diff > 0.0) & (dnl > 0.0))
                                               | ((m_spec > 0.0) & (dvr > 0.0)))
            sweeps = 1 if scene.ptype[li] == SPHERE else n_samples
            counts["shadow_sweeps_used"] += sweeps * int(used.sum())
    local = torch.where(hit_light[:, None], scene.color[safe], torch.where(hit[:, None], acc, 0.0))
    return idx, code, dist, point, color, n_hit, local, ctr


def trace(scene: Scene, o, d, key, ctr, trace_depth: int, area_samples, on_work: Hook = None):
    """One pass of the reflect/refract tree of depth ``trace_depth`` from
    rays [R, 3] and the lanes' (key, counter): its color [R, 3]. The level's
    nodes are keyed ``node_key(key, heap id)`` and start at ``ctr``.
    ``on_work(counts)`` sees each level's ``nodes`` (live: one nearest sweep
    each), ``lit`` (those shaded: they hit a primitive that is no light),
    ``texels`` (lit on a textured primitive: one fetch each), ``glossy``
    (disc samples drawn) and ``shadow_sweeps_used`` (the shadow sweeps of
    the (node, light) pairs whose diffuse or specular term can use the
    shade)."""
    dev, r, dtype = o.device, o.shape[0], o.dtype
    total = torch.zeros_like(o)
    is_light = torch.tensor(scene.is_light, device=dev)
    textured = torch.tensor([t >= 0 for t in scene.tex_id], device=dev)
    heap = [0]
    weight = torch.ones_like(o)
    beer = torch.zeros_like(o)
    rindex = torch.ones(r, dtype=dtype, device=dev)
    valid = torch.ones(r, dtype=torch.bool, device=dev)
    for level in range(1, trace_depth + 1):
        k = len(heap)
        hvec = torch.tensor(heap, dtype=torch.int64, device=dev).repeat_interleave(r)
        nkey, nctr = node_key(key.repeat(k), hvec), ctr.repeat(k)
        counts = None if on_work is None else {"shadow_sweeps_used": 0, "glossy": 0}
        idx, code, dist, point, color, n_hit, local, nctr = shade_node(
            scene, o, d, nkey, nctr, valid, area_samples[level - 1], counts)
        hit = idx >= 0
        safe = torch.clamp(idx, min=0)
        shaded = valid & hit & ~is_light[safe]
        if counts is not None:
            counts.update(nodes=int(valid.sum()), lit=int(shaded.sum()),
                          texels=int((shaded & textured[safe]).sum()))
        # Beer's law completes at this node with its own travel distance.
        w_eff = weight * torch.exp(beer * (-dist)[:, None])
        contrib = torch.where((valid & hit)[:, None], w_eff * local, 0.0)
        lvl = contrib[:r]
        for i in range(1, k):
            lvl = lvl + contrib[i * r:(i + 1) * r]
        total = total + lvl
        if level < trace_depth:
            # Reflection children, perfect or glossy: one disc sample.
            refl, drefl = scene.refl[safe], scene.drefl[safe]
            rdir = d - (2.0 * dot3(d, n_hit))[:, None] * n_hit
            glossy = shaded & (refl > 0.0) & (drefl > 0.0) & (level < 3)
            u1, nctr = counter_draw(nkey, nctr, glossy, dtype)
            u2, nctr = counter_draw(nkey, nctr, glossy, dtype)
            if counts is not None:
                counts["glossy"] = int(glossy.sum())
            rad = drefl * sqrt_rn(u1)
            ang = TWO_PI * u2
            xoffs, yoffs = rad * torch.cos(ang), rad * torch.sin(ang)
            r0, r1, r2 = rdir[:, 0], rdir[:, 1], rdir[:, 2]
            rn1 = torch.stack([r2, r1, -r0], dim=-1)
            n0, n1, n2 = rn1[:, 0], rn1[:, 1], rn1[:, 2]
            rn2 = torch.stack([r1 * n2 - r2 * n1, r2 * n0 - r0 * n2, r0 * n1 - r1 * n0], dim=-1)
            gdir = rdir + rn1 * xoffs[:, None] + rn2 * (yoffs * drefl)[:, None]
            gdir = gdir * (1.0 / sqrt_rn(torch.clamp(dot3(gdir, gdir), min=1e-30)))[:, None]
            child = torch.where(glossy[:, None], gdir, rdir)
            refl_ok = shaded & (refl > 0.0)
            # Refraction children; the child's absorbance is the parent's
            # color x 0.15.
            ri = scene.refr_index[safe]
            ri = torch.where(ri != 0.0, ri, 1.0)
            ratio = rindex / ri
            nrm = n_hit * code.to(dtype)[:, None]
            cos_i = -dot3(nrm, d)
            cos_t2 = 1.0 - ratio * ratio * (1.0 - cos_i * cos_i)
            refr_ok = shaded & (scene.refr[safe] > 0.0) & (cos_t2 > 0.0)
            tdir = (ratio[:, None] * d
                    + (ratio * cos_i - sqrt_rn(torch.where(cos_t2 > 0.0, cos_t2, 1.0)))[:, None]
                    * nrm)
            # The next level: [reflection children; refraction children].
            o = torch.cat([torch.where(refl_ok[:, None], point + child * EPSILON, point),
                           torch.where(refr_ok[:, None], point + tdir * EPSILON, point)])
            d = torch.cat([child, torch.where(refr_ok[:, None], tdir, d)])
            weight = torch.cat([torch.where(refl_ok[:, None], w_eff * refl[:, None] * color, 0.0),
                                torch.where(refr_ok[:, None], w_eff, 0.0)])
            beer = torch.cat([torch.zeros_like(w_eff),
                              torch.where(refr_ok[:, None],
                                          scene.color[safe] * float(np.float32(0.15)), 0.0)])
            rindex = torch.cat([rindex, torch.where(refr_ok, ri, rindex)])
            valid = torch.cat([refl_ok, refr_ok])
            heap = [2 * i + 1 for i in heap] + [2 * i + 2 for i in heap]
        if on_work is not None:
            on_work(counts)
    return total


def render_pixels(scene: Scene, frame: Frame, seed: int, pixels: torch.Tensor,
                  dtype=torch.float32, block: int = 1 << 15, on_work: Hook = None
                  ) -> torch.Tensor:
    """[P, 3] values of the row-major ``pixels`` (int64, on the device) of a
    render with ``seed``: the mean of ``frame.spp`` passes at the pixel
    centres, pass p drawing from counter p * PASS_DRAW_BUDGET, in blocks of
    ``block`` pixels. Float32 products never run in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = pixels.device
    out = []
    for a in range(0, pixels.shape[0], block):
        pix = pixels[a:a + block].cpu().numpy()
        o, d = (torch.from_numpy(x).to(dev).to(dtype) for x in camera_rays(frame, pix))
        key = torch.from_numpy(pixel_keys(seed, pix).astype(np.int64)).to(dev)
        ctr = torch.zeros_like(key)
        acc = None
        for _ in range(frame.spp):
            col = trace(scene, o, d, key, ctr, frame.trace_depth, frame.area_samples, on_work)
            acc = col if acc is None else acc + col
            ctr = (ctr + PASS_DRAW_BUDGET) & M32
        out.append(acc / frame.spp)
    return torch.cat(out)


def all_pixels(frame: Frame, device) -> torch.Tensor:
    return torch.arange(frame.width * frame.height, dtype=torch.int64, device=device)


def count_work(scene: Scene, frame: Frame, seed: int, device, block: int = 1 << 15) -> dict:
    """The live work of every pass of every pixel of a render (``trace``'s
    counts, summed)."""
    work = {"nodes": 0, "lit": 0, "texels": 0, "glossy": 0, "shadow_sweeps_used": 0}

    def add(counts):
        for k in work:
            work[k] += counts[k]

    with torch.no_grad():
        render_pixels(scene, frame, seed, all_pixels(frame, device), block=block, on_work=add)
    return work

"""Extended Whitted tracer, the raytracer5 feature set, in plain PyTorch (twin
of se195_raytracer_tpu/models/whitted5.py). It is the CPU path and the oracle
of K4 (kernels/whitted5_kernel.py).

raytracer5/trunk/raytracer.cpp Engine::Raytrace:228-363, CalcShade:371-406
and the scene.cpp primitives, as a batched reflect/refract tree over masked
ray lanes:

* sphere, one-sided plane (no dist > 0 guard, as the reference) and
  axis-aligned box primitives; nearest hit by first minimum;
* point (sphere) lights and box area lights with the 4x4 jittered grid
  Monte-Carlo shadow estimator; a shadow ray must reach the light itself,
  and other lights occlude it;
* glossy reflection (one disc sample per pass), refraction with Beer's law
  on the child ray's own travel distance;
* bilinear textures with the GetTexel quirks (+1000.5/+1000.0 offsets, v
  scaled by the width), the position-free Box::GetNormal;
* the look-at camera of Engine::InitRender, and adaptive 1-vs-4-ray
  supersampling (Engine::Render:481-535).

The tree is evaluated levelwise as in the JAX package: all nodes of a level
are one node-major batch, and every node draws from its own counter stream
(key mixed with the node's heap id). x^20 is the multiply chain ``_pow20``
here and in K4 (the JAX jnp tracer uses ``jnp.power``: a few ulps apart).
Dot products are elementwise sums left to right (``core/types.dot3``).

``soft_edges > 0`` swaps CalcShade's binary visibility for the smooth
shadow transmittance (``_soft_shadow_transmittance``), so that the
silhouettes of area lights and occluders carry gradients. It runs on the
plain tracer only (K4 is the hard estimator), which is differentiable
dataflow: textures, materials, geometry and light positions back-propagate.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from se195_raytracer_tpu_torch.core.rng import MWCState, counter_next_masked
from se195_raytracer_tpu_torch.core.types import dot3, resolve_device, sqrt_rn
from se195_raytracer_tpu_torch.kernels.seed_kernel import seed_lanes
from se195_raytracer_tpu_torch.models.smallpt import _sigmoid, _soft_root
from se195_raytracer_tpu_torch.models.whitted import _pow20
from se195_raytracer_tpu_torch.scenes.whitted5_scenes import (
    BOX5,
    BOX_LIGHT_GRID,
    PLANE5,
    SPHERE5,
    Whitted5Scene,
)
from se195_raytracer_tpu_torch.utils.profiling import span

EPSILON5 = 0.001  # raytracer5 common.h:27
TRACEDEPTH5 = 4  # common.h:28
PI = float(np.float32(np.pi))
# Counter budget reserved per trace pass: successive passes (spp loop,
# sub-pixel rays) start their draw counters this far apart, so no (node key,
# counter) pair repeats across passes.
PASS_DRAW_BUDGET = 1 << 10
AREA_SAMPLES_BY_LEVEL = (4, 2, 1, 1)
MAX_DIST = 1e6

HIT, MISS, INPRIM = 1, 0, -1

_EPS = float(np.float32(EPSILON5))
_M32 = 0xFFFFFFFF


def _arccos1(x: torch.Tensor) -> torch.Tensor:
    """arccos of an already-clipped cosine with exact endpoints
    (arccos(1) = 0, arccos(-1) = pi in float32), as the JAX package."""
    edge = torch.abs(x) >= 1.0
    xs = torch.where(edge, 0.0, x)
    endpoint = torch.where(x >= 1.0, 0.0, PI)
    return torch.where(edge, endpoint, torch.acos(xs))


@functools.lru_cache(maxsize=64)
def _type_partition(ptype: Tuple[int, ...]):
    """Primitive indices by class and the inverse permutation that restores
    primitive order after the per-class concatenation."""
    t = np.array(ptype, np.int64)
    sph = np.nonzero(t == SPHERE5)[0]
    pla = np.nonzero(t == PLANE5)[0]
    box = np.nonzero(t == BOX5)[0]
    inv = np.argsort(np.concatenate([sph, pla, box]))
    return sph, pla, box, inv


def _ix(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a).to(device)


def _prim_candidates(scene: Whitted5Scene, o: torch.Tensor, d: torch.Tensor):
    """Per-primitive candidate hits, [R, N] each: (dist, code, valid).

    code is HIT or INPRIM (a sphere entered from inside). Sphere:
    scene.cpp:128-159 (det > 0, i2 > 0, near root if i1 >= 0 else far root
    as INPRIM); plane: scene.cpp:232-244, only faces with dot(N, d) < 0 and
    NO dist > 0 rejection; box: scene.cpp:306-350, six slab distances with a
    +-EPSILON point-in-box slack, the smallest positive one."""
    dev = o.device
    sph, pla, box, inv = _type_partition(scene.ptype)
    dists, valids, codes = [], [], []
    r = o.shape[0]

    if sph.size:
        si = _ix(sph, dev)
        v = o[:, None, :] - scene.center[si][None, :, :]
        sb = -dot3(v, d[:, None, :])
        rad = scene.radius[si]
        det = sb * sb - dot3(v, v) + (rad * rad)[None, :]
        s_ok = det > 0.0
        sq = sqrt_rn(torch.where(s_ok, det, 1.0))
        i1 = sb - sq
        i2 = sb + sq
        s_ok = s_ok & (i2 > 0.0)
        s_inprim = i1 < 0.0
        dists.append(torch.where(s_inprim, i2, i1))
        valids.append(s_ok)
        codes.append(torch.where(s_inprim, INPRIM, HIT))

    if pla.size:
        pi = _ix(pla, dev)
        nrm = scene.normal[pi]
        pd = (nrm[None, :, 0] * d[:, None, 0] + nrm[None, :, 1] * d[:, None, 1]
              + nrm[None, :, 2] * d[:, None, 2])
        p_ok = pd < 0.0
        pd_safe = torch.where(pd != 0.0, pd, 1.0)
        no = (nrm[None, :, 0] * o[:, None, 0] + nrm[None, :, 1] * o[:, None, 1]
              + nrm[None, :, 2] * o[:, None, 2])
        p_dist = -(no + scene.depth[pi][None, :]) / pd_safe
        dists.append(p_dist)
        valids.append(p_ok)
        codes.append(torch.full(p_dist.shape, HIT, dtype=torch.int64, device=dev))

    if box.size:
        bi = _ix(box, dev)
        v1 = scene.box_pos[bi]
        v2 = v1 + scene.box_size[bi]
        lo = v1 - _EPS
        hi = v2 + _EPS
        b_dist = torch.full((r, box.size), 1e30, dtype=torch.float32, device=dev)
        b_ok = torch.zeros((r, box.size), dtype=torch.bool, device=dev)
        for axis in range(3):
            d_a = d[:, axis:axis + 1]
            o_a = o[:, axis:axis + 1]
            d_safe = torch.where(d_a != 0.0, d_a, 1.0)
            axis_ok = d_a != 0.0
            for bound in (v1, v2):
                t_f = (bound[None, :, axis] - o_a) / d_safe
                inside = torch.ones_like(b_ok)
                for a2 in range(3):
                    ip_a = o[:, a2:a2 + 1] + t_f * d[:, a2:a2 + 1]
                    inside = inside & (ip_a > lo[None, :, a2]) & (ip_a < hi[None, :, a2])
                face_ok = axis_ok & (t_f > 0.0) & inside
                b_dist = torch.where(face_ok & (t_f < b_dist), t_f, b_dist)
                b_ok = b_ok | face_ok
        dists.append(b_dist)
        valids.append(b_ok)
        codes.append(torch.full((r, box.size), HIT, dtype=torch.int64, device=dev))

    inv_t = _ix(inv, dev)
    dist = torch.cat(dists, dim=1)[:, inv_t]
    valid = torch.cat(valids, dim=1)[:, inv_t]
    code = torch.cat(codes, dim=1)[:, inv_t]
    return dist, code, valid


def _first_min(dist: torch.Tensor, valid: torch.Tensor):
    """(min, first index of the min) over the valid candidates: the
    reference's ascending-order scan with strict improvement."""
    dm = torch.where(valid, dist, float("inf"))
    return dm.amin(dim=1), dm.argmin(dim=1)


def find_nearest(scene: Whitted5Scene, o: torch.Tensor, d: torch.Tensor,
                 max_dist: float = MAX_DIST):
    """FindNearest (raytracer.cpp:228-237), brute force. Returns (idx [R]
    int64, -1 on a miss; code [R]; dist [R], max_dist on a miss). A hit is a
    nearest candidate below ``max_dist``, so a plane behind the origin (a
    negative distance) can win."""
    dist, code, valid = _prim_candidates(scene, o, d)
    best, amin = _first_min(dist, valid)
    hit = best < max_dist
    idx = torch.where(hit, amin, -1)
    res = torch.where(hit, code.gather(1, amin[:, None])[:, 0], MISS)
    best = torch.where(hit, best, max_dist)
    return idx, res, best


def _nearest_is(scene: Whitted5Scene, o, d, max_dist: torch.Tensor, target: int):
    """True where the nearest primitive within max_dist is ``target``: the
    CalcShade visibility test (raytracer.cpp:379-384,396-401)."""
    dist, _, valid = _prim_candidates(scene, o, d)
    best, amin = _first_min(dist, valid)
    return (best < max_dist) & (amin == target)


def _soft_shadow_transmittance(scene: Whitted5Scene, o: torch.Tensor, d: torch.Tensor,
                               max_t: torch.Tensor, target: int, soft_w: float) -> torch.Tensor:
    """[R] smooth shadow transmittance in [0, 1] (1 = fully lit), the whitted5
    face of the relaxation of models/smallpt.py: it replaces ``_nearest_is``'s
    binary nearest-is-the-light indicator. Every primitive but ``target``
    occludes with a smooth weight occ_j = sigma(margin / w) * an in-range
    window, and T = prod(1 - occ_j).

    Spheres use the silhouette distance, as in smallpt. One-sided planes keep
    the facing test hard (it depends on the shadow ray's direction only) and
    soften the in-range window. Boxes use smooth windows around the slab
    entry/exit span, the span itself from hard min/max (continuous, with
    bounded derivatives, inside the band that the relaxation blurs).

    As in the JAX package, the plane term does not recover the hard
    tracer's quirk as w -> 0: a plane has no dist > 0 guard there, so one
    behind the origin can be the nearest hit, where the soft window asks
    for t > EPSILON."""
    w = float(np.float32(soft_w))
    sph, pla, box, _ = _type_partition(scene.ptype)
    dev = o.device
    mt = max_t[:, None]
    trans = torch.ones(o.shape[0], dtype=torch.float32, device=dev)

    def in_range(t):
        return _sigmoid((t - _EPS) / w) * _sigmoid((mt - t) / w)

    def drop_target(occ, cls_idx):
        return torch.where(_ix(cls_idx != target, dev)[None, :], occ, 0.0)

    if sph.size:
        si = _ix(sph, dev)
        r = scene.radius[si]
        op = scene.center[si][None, :, :] - o[:, None, :]
        b = dot3(op, d[:, None, :])
        perp = op - b[..., None] * d[:, None, :]
        pd = sqrt_rn(torch.clamp(dot3(perp, perp), min=1e-12))
        m_sil = r[None, :] - pd
        sq = _soft_root(m_sil * (r[None, :] + pd), soft_w)
        f1 = in_range(b - sq)
        f2 = in_range(b + sq)
        occ = _sigmoid(m_sil / w) * (f1 + f2 - f1 * f2)
        trans = trans * torch.prod(1.0 - drop_target(occ, sph), dim=-1)

    if pla.size:
        pi = _ix(pla, dev)
        nrm = scene.normal[pi]
        pdir = (nrm[None, :, 0] * d[:, None, 0] + nrm[None, :, 1] * d[:, None, 1]
                + nrm[None, :, 2] * d[:, None, 2])
        pdir_safe = torch.where(pdir != 0.0, pdir, 1.0)
        no = (nrm[None, :, 0] * o[:, None, 0] + nrm[None, :, 1] * o[:, None, 1]
              + nrm[None, :, 2] * o[:, None, 2])
        t = -(no + scene.depth[pi][None, :]) / pdir_safe
        occ = torch.where(pdir < 0.0, in_range(t), 0.0)
        trans = trans * torch.prod(1.0 - drop_target(occ, pla), dim=-1)

    if box.size:
        bi = _ix(box, dev)
        v1 = scene.box_pos[bi]
        v2 = v1 + scene.box_size[bi]
        big = 1e30
        tmin = torch.full((o.shape[0], box.size), -big, dtype=torch.float32, device=dev)
        tmax = torch.full((o.shape[0], box.size), big, dtype=torch.float32, device=dev)
        for axis in range(3):
            d_a = d[:, axis:axis + 1]
            o_a = o[:, axis:axis + 1]
            d_safe = torch.where(d_a != 0.0, d_a, 1.0)
            ta = (v1[None, :, axis] - o_a) / d_safe
            tb = (v2[None, :, axis] - o_a) / d_safe
            inside_a = (o_a > v1[None, :, axis]) & (o_a < v2[None, :, axis])
            lo = torch.where(d_a != 0.0, torch.minimum(ta, tb), torch.where(inside_a, -big, big))
            hi = torch.where(d_a != 0.0, torch.maximum(ta, tb), torch.where(inside_a, big, -big))
            tmin = torch.maximum(tmin, lo)
            tmax = torch.minimum(tmax, hi)
        occ = (_sigmoid((tmax - tmin) / w) * _sigmoid((tmax - _EPS) / w)
               * _sigmoid((mt - tmin) / w))
        trans = trans * torch.prod(1.0 - drop_target(occ, box), dim=-1)

    return trans


_BOX_NORMALS = ((-1.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, -1.0, 0.0),
                (0.0, 1.0, 0.0), (0.0, 0.0, -1.0), (0.0, 0.0, 1.0))


def _box_normal_static(scene: Whitted5Scene, j: int) -> torch.Tensor:
    """Box::GetNormal (scene.cpp:352-374), position-free as in the
    reference: six candidate 'distances' from pos and size only."""
    pos = scene.box_pos[j]
    size = scene.box_size[j]
    cands = torch.stack([
        torch.abs(size[0] - pos[0]), torch.abs(size[0] + size[0] - pos[0]),
        torch.abs(size[1] - pos[1]), torch.abs(size[1] + size[1] - pos[1]),
        torch.abs(size[2] - pos[2]), torch.abs(size[2] + size[2] - pos[2]),
    ])
    normals = torch.tensor(_BOX_NORMALS, dtype=torch.float32, device=pos.device)
    return normals[torch.argmin(cands)]


def _static_normals(scene: Whitted5Scene) -> torch.Tensor:
    """[N, 3] position-free normals: plane normals and the constant
    Box::GetNormal; sphere rows are zero (their normal depends on the hit)."""
    rows = []
    for j in range(scene.num_prims):
        if scene.ptype[j] == PLANE5:
            rows.append(scene.normal[j])
        elif scene.ptype[j] == BOX5:
            rows.append(_box_normal_static(scene, j))
        else:
            rows.append(torch.zeros(3, dtype=torch.float32, device=scene.device))
    return torch.stack(rows)


def get_normal(scene: Whitted5Scene, idx: torch.Tensor, point: torch.Tensor):
    """Per-lane normal: the sphere formula or the static table."""
    rad = scene.radius[idx]
    n_sphere = (point - scene.center[idx]) * (1.0 / torch.where(rad != 0.0, rad, 1.0))[:, None]
    is_sphere = torch.tensor([t == SPHERE5 for t in scene.ptype], device=point.device)[idx]
    return torch.where(is_sphere[:, None], n_sphere, _static_normals(scene)[idx])


def _texel(bitmap: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
           row_offset: Optional[torch.Tensor] = None, wrap_shape=None) -> torch.Tensor:
    """Texture::GetTexel (scene.cpp:81-106), quirks included: both fu and fv
    are scaled by the texture *width*, and the wrap is a floor modulo (a
    far-negative u still lands inside the texture). ``row_offset`` and
    ``wrap_shape``: atlas mode, the wrap at the per-texture shape, rows
    offset into a row-concatenated atlas. Returns [R, 3]."""
    th, tw = (wrap_shape if wrap_shape is not None else bitmap.shape)[:2]
    fu = (u + 1000.5) * tw
    fv = (v + 1000.0) * tw
    u1 = torch.floor(fu).to(torch.int32) % tw
    v1 = torch.floor(fv).to(torch.int32) % th
    u2 = (u1 + 1) % tw
    v2 = (v1 + 1) % th
    if row_offset is not None:
        v1 = v1 + row_offset
        v2 = v2 + row_offset
    fracu = fu - torch.floor(fu)
    fracv = fv - torch.floor(fv)
    w1 = (1 - fracu) * (1 - fracv)
    w2 = fracu * (1 - fracv)
    w3 = (1 - fracu) * fracv
    w4 = fracu * fracv
    u1, u2, v1, v2 = u1.long(), u2.long(), v1.long(), v2.long()
    c1 = bitmap[v1, u1]
    c2 = bitmap[v1, u2]
    c3 = bitmap[v2, u1]
    c4 = bitmap[v2, u2]
    return c1 * w1[:, None] + c2 * w2[:, None] + c3 * w3[:, None] + c4 * w4[:, None]


def _prim_uv(scene: Whitted5Scene, j: int, point: torch.Tensor):
    """(ucoord, vcoord) [R] for textured primitive j: Sphere::GetColor's polar
    mapping (scene.cpp:161-176), PlanePrim::GetColor's axis mapping
    (:263-277)."""
    us = scene.uv_scale[j]
    if scene.ptype[j] == SPHERE5:
        rad = scene.radius[j]
        rr = 1.0 / torch.where(rad != 0.0, rad, 1.0)
        vp = (point - scene.center[j][None]) * rr
        # vn = (0,1,0), ve = (1,0,0), vc = vn x ve = (0,0,-1) (scene.cpp:117-120)
        cosphi = torch.clamp(-vp[:, 1], -1.0, 1.0)
        phi = _arccos1(cosphi)
        sinphi = sqrt_rn(torch.clamp(1.0 - cosphi * cosphi, min=1e-12))
        vcoord = phi * (1.0 / us[1]) * (1.0 / PI)
        costheta = torch.clamp(vp[:, 0] / sinphi, -1.0, 1.0)
        theta = _arccos1(costheta) * (2.0 / PI)
        ucoord = torch.where(-vp[:, 2] >= 0.0, 1.0 - theta, theta) * (1.0 / us[0])
        return ucoord, vcoord
    # Plane mapping (boxes keep their material color in the reference).
    n = scene.normal[j]
    ua = torch.stack([n[1], n[2], -n[0]])
    va = torch.stack([ua[1] * n[2] - ua[2] * n[1], ua[2] * n[0] - ua[0] * n[2],
                      ua[0] * n[1] - ua[1] * n[0]])
    return dot3(point, ua[None]) * us[0], dot3(point, va[None]) * us[1]


def get_color(scene: Whitted5Scene, idx: torch.Tensor, point: torch.Tensor):
    """Primitive::GetColor with texture modulation. Same-shaped textures go
    through ONE fetch from a row-concatenated atlas with the uv selected per
    lane (the JAX package's atlas mode); the values equal per-texture
    fetches."""
    out = scene.color[idx]
    textured = [j for j in range(scene.num_prims) if scene.tex_id[j] >= 0]
    if not textured:
        return out
    shapes = {tuple(scene.textures[scene.tex_id[j]].shape) for j in textured}
    if len(shapes) == 1 and len(textured) > 1:
        shape = next(iter(shapes))
        atlas = torch.cat(list(scene.textures), dim=0)
        sel_u = torch.zeros(point.shape[0], dtype=torch.float32, device=point.device)
        sel_v = torch.zeros_like(sel_u)
        sel_off = torch.zeros(point.shape[0], dtype=torch.int32, device=point.device)
        for j in textured:
            ucoord, vcoord = _prim_uv(scene, j, point)
            m = idx == j
            sel_u = torch.where(m, ucoord, sel_u)
            sel_v = torch.where(m, vcoord, sel_v)
            sel_off = torch.where(m, scene.tex_id[j] * shape[0], sel_off)
        tex = _texel(atlas, sel_u, sel_v, row_offset=sel_off, wrap_shape=shape)
        for j in textured:
            out = torch.where((idx == j)[:, None], tex * scene.color[j][None], out)
        return out
    for j in textured:
        ucoord, vcoord = _prim_uv(scene, j, point)
        tex = _texel(scene.textures[scene.tex_id[j]], ucoord, vcoord)
        out = torch.where((idx == j)[:, None], tex * scene.color[j][None], out)
    return out


def _texel_lanes(scene: Whitted5Scene, idx: torch.Tensor, point: torch.Tensor, lit: torch.Tensor):
    """(texture id, ucoord, vcoord) of the ``lit`` lanes whose primitive
    ``idx`` is textured, in lane order: the fetches GetColor makes there."""
    tex_of = torch.tensor(scene.tex_id, dtype=torch.int32, device=point.device)[idx]
    m = lit & (tex_of >= 0)
    sel_u = torch.zeros(point.shape[0], dtype=torch.float32, device=point.device)
    sel_v = torch.zeros_like(sel_u)
    for j in range(scene.num_prims):
        if scene.tex_id[j] >= 0:
            ucoord, vcoord = _prim_uv(scene, j, point)
            sel_u = torch.where(idx == j, ucoord, sel_u)
            sel_v = torch.where(idx == j, vcoord, sel_v)
    return tex_of[m], sel_u[m], sel_v[m]


def calc_shade(scene: Whitted5Scene, light: int, point: torch.Tensor, state: MWCState,
               draw_mask: torch.Tensor, n_samples: int, on_sweep: Optional[Callable] = None,
               soft_edges: float = 0.0):
    """CalcShade (raytracer.cpp:371-406): (shade [R], L [R, 3], new state).
    A sphere light: binary visibility of the light. Anything else is a box
    area light: ``n_samples`` jittered grid samples on its bottom face, each
    weighted 1/n_samples, drawing u1 then u2 per sample where ``draw_mask``.
    ``on_sweep(o, d, mask, max_t, target)`` sees every shadow ray, ``mask``
    the lanes whose node is shaded (``draw_mask``). ``soft_edges > 0``
    replaces each binary visibility with ``_soft_shadow_transmittance``."""

    def _visible(o, d, max_t):
        if soft_edges > 0.0:
            return _soft_shadow_transmittance(scene, o, d, max_t, light, soft_edges)
        return torch.where(_nearest_is(scene, o, d, max_t, light), 1.0, 0.0)

    if scene.ptype[light] == SPHERE5:
        ldir = scene.center[light][None] - point
        tdist = sqrt_rn(torch.clamp(dot3(ldir, ldir), min=1e-30))
        ldir = ldir / tdist[:, None]
        if on_sweep is not None:
            on_sweep(point + ldir * _EPS, ldir, draw_mask, tdist, light)
        return _visible(point + ldir * _EPS, ldir, tdist), ldir, state
    pos = scene.box_pos[light]
    size = scene.box_size[light]
    ldir = (pos + 0.5 * size)[None] - point
    ldir = ldir * (1.0 / sqrt_rn(torch.clamp(dot3(ldir, ldir), min=1e-30)))[:, None]
    deltax = size[0] * 0.25
    deltay = size[2] * 0.25
    cell_x = size[0] / 4.0
    cell_z = size[2] / 4.0
    shade = torch.zeros(point.shape[0], dtype=torch.float32, device=point.device)
    sscale = float(np.float32(1.0 / n_samples))
    for i in range(n_samples):
        u1, state = counter_next_masked(state, draw_mask)
        u2, state = counter_next_masked(state, draw_mask)
        gx = float(BOX_LIGHT_GRID[i & 15, 0]) * cell_x + pos[0] + u1 * deltax
        gz = float(BOX_LIGHT_GRID[i & 15, 1]) * cell_z + pos[2] + u2 * deltay
        sdir = torch.stack([gx, pos[1].expand_as(gx), gz], dim=-1) - point
        ldist = sqrt_rn(torch.clamp(dot3(sdir, sdir), min=1e-30))
        sdir = sdir / ldist[:, None]
        if on_sweep is not None:
            on_sweep(point + sdir * _EPS, sdir, draw_mask, ldist, light)
        shade = shade + _visible(point + sdir * _EPS, sdir, ldist) * sscale
    return shade, ldir, state


def _shade_node(scene: Whitted5Scene, o: torch.Tensor, d: torch.Tensor, state: MWCState,
                draw_mask: torch.Tensor, area_samples: int, on_sweep: Optional[Callable] = None,
                work: Optional[dict] = None, soft_edges: float = 0.0):
    """One Raytrace node's local work (raytracer.cpp:239-285): nearest hit,
    light by light diffuse plus Phong-20 specular under CalcShade
    visibility; a light that is hit returns its color. ``on_sweep(o, d,
    mask, max_t, target)`` sees the nearest sweep (max_t and target None,
    ``mask`` the live lanes, ``draw_mask``) and every shadow ray. ``work``,
    when a dict, gets ``shadow_sweeps_used`` added to it: the shadow rays of
    the (node, light) pairs whose diffuse or specular term can use the
    shade (K4 traces only those). ``soft_edges`` goes to ``calc_shade``."""
    if on_sweep is not None:
        on_sweep(o, d, draw_mask, None, None)
    idx, code, dist = find_nearest(scene, o, d)
    hit = idx >= 0
    safe = torch.clamp(idx, min=0)
    dist_safe = torch.where(hit, dist, 1.0)
    point = o + d * dist_safe[:, None]
    is_light = torch.tensor(scene.is_light, device=o.device)
    hit_light = hit & is_light[safe]

    color = get_color(scene, safe, point)
    n_hit = get_normal(scene, safe, point)
    m_diff = scene.diff[safe]
    m_spec = scene.spec[safe]

    acc = torch.zeros_like(o)
    for li in range(scene.num_prims):
        if not scene.is_light[li]:
            continue
        shade, ldir, state = calc_shade(scene, li, point, state, draw_mask & hit & ~hit_light,
                                        area_samples, on_sweep, soft_edges)
        pos_shade = shade > 0.0
        lcol = scene.color[li][None]
        dnl = dot3(ldir, n_hit)
        diff_term = torch.where(pos_shade & (m_diff > 0.0) & (dnl > 0.0), dnl * m_diff * shade, 0.0)
        acc = acc + diff_term[:, None] * color * lcol
        rv = ldir - (2.0 * dnl)[:, None] * n_hit
        dvr = dot3(d, rv)
        spec_term = torch.where(pos_shade & (m_spec > 0.0) & (dvr > 0.0),
                                _pow20(torch.clamp(dvr, min=0.0)) * m_spec * shade, 0.0)
        acc = acc + spec_term[:, None] * lcol
        if work is not None:
            used = draw_mask & hit & ~hit_light & (((m_diff > 0.0) & (dnl > 0.0))
                                                   | ((m_spec > 0.0) & (dvr > 0.0)))
            rays = 1 if scene.ptype[li] == SPHERE5 else area_samples
            work["shadow_sweeps_used"] = work.get("shadow_sweeps_used", 0) + rays * int(used.sum())

    local = torch.where(hit_light[:, None], scene.color[safe],
                        torch.where(hit[:, None], acc, 0.0))
    return idx, code, dist_safe, point, color, n_hit, local, state


def _node_key(key: torch.Tensor, heap_id: torch.Tensor) -> torch.Tensor:
    """Mix a ray-tree heap index into the per-ray key so every node of the
    tree draws its own stream (a SplitMix-style round, uint32 in int64)."""
    x = key ^ ((heap_id * 0x9E3779B9 + 0x7F4A7C15) & _M32)
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _M32
    return x ^ (x >> 15)


def _count_work(work: dict, scene: Whitted5Scene, lit, valid, safe, n_samp: int) -> None:
    n_lit = int(lit.sum())
    per_lit = sum(1 if scene.ptype[j] == SPHERE5 else n_samp
                  for j in range(scene.num_prims) if scene.is_light[j])
    textured = torch.tensor([t >= 0 for t in scene.tex_id], device=safe.device)[safe]
    for key, n in (("nodes", int(valid.sum())), ("lit", n_lit),
                   ("shadow_sweeps", n_lit * per_lit), ("texels", int((lit & textured).sum()))):
        work[key] = work.get(key, 0) + n


def samples_per_level(trace_depth: int, area_samples_by_level=AREA_SAMPLES_BY_LEVEL):
    """Shadow samples per box light at levels 1..trace_depth: entry
    min(level, len - 1) of the table, as the JAX package indexes it (so level
    1 takes entry 1)."""
    last = len(area_samples_by_level) - 1
    return tuple(int(area_samples_by_level[min(lv, last)]) for lv in range(1, trace_depth + 1))


def whitted5_trace(
    scene: Whitted5Scene,
    o: torch.Tensor,
    d: torch.Tensor,
    state: MWCState,
    trace_depth: int = TRACEDEPTH5,
    area_samples_by_level: Tuple[int, ...] = AREA_SAMPLES_BY_LEVEL,
    soft_edges: float = 0.0,
    return_primary_idx: bool = False,
    work: Optional[dict] = None,
    on_sweep: Optional[Callable] = None,
    on_texel: Optional[Callable] = None,
):
    """The binary reflect/refract tree of depth ``trace_depth`` (depth starts
    at 1 as in RenderRay, raytracer.cpp:457-474), levelwise: the 2^(l-1)
    nodes of level l are one node-major batch [K*R]. Node keys are
    ``_node_key(key, heap id)``, node counters start at the pass's counter,
    and the returned state advances the counter by ``PASS_DRAW_BUDGET``.

    A level's contributions are summed over its nodes in node-major order,
    then added to the running total; K4 sums in the same order.

    ``work``, when a dict, gets what a tracer that visits only live nodes
    does added to it: ``nodes`` (live nodes: one nearest sweep each), ``lit``
    (those that hit a non-light and are shaded), ``shadow_sweeps`` (one per
    sphere light and per box-light sample of a lit node), ``texels`` (lit
    nodes on a textured primitive: one bilinear fetch each) and ``glossy``
    (disc samples drawn), and ``shadow_sweeps_used`` (``_shade_node``).
    ``on_sweep`` is passed to ``_shade_node``: it sees
    every nearest sweep and shadow ray of the live nodes. ``on_texel(tex,
    u, v)`` sees, level by level, the texel fetches: the texture id and
    coordinates of every lit node on a textured primitive, node-major and
    in ray order within a node (the ``texels`` that ``work`` counts).

    Returns (color [R, 3], advanced state), plus the level-1 hit ids ([R],
    -1 on a miss) when ``return_primary_idx``. ``soft_edges > 0`` shades with
    the smooth shadow transmittance (``calc_shade``)."""
    dev = o.device
    r = o.shape[0]
    key_in = state[0].to(torch.int64)
    ctr_in = state[1].to(torch.int64)
    acc_total = torch.zeros_like(o)
    is_light = torch.tensor(scene.is_light, device=dev)
    n_samp = samples_per_level(trace_depth, area_samples_by_level)

    heap_ids = [0]
    o_b, d_b = o, d
    weight = torch.ones_like(o)
    beer = torch.zeros_like(o)
    rindex = torch.ones(r, dtype=torch.float32, device=dev)
    valid = torch.ones(r, dtype=torch.bool, device=dev)
    primary_idx = None

    for level in range(1, trace_depth + 1):
        k = len(heap_ids)
        hvec = torch.tensor(heap_ids, dtype=torch.int64, device=dev).repeat_interleave(r)
        st = (_node_key(key_in.repeat(k), hvec), ctr_in.repeat(k))
        idx, code, dist, point, color, n_hit, local, st = _shade_node(
            scene, o_b, d_b, st, valid, n_samp[level - 1], on_sweep, work, soft_edges)
        if level == 1:
            primary_idx = idx
        hit = idx >= 0
        safe = torch.clamp(idx, min=0)
        if work is not None:
            _count_work(work, scene, valid & hit & ~is_light[safe], valid, safe,
                        n_samp[level - 1])
        if on_texel is not None:
            on_texel(*_texel_lanes(scene, safe, point, valid & hit & ~is_light[safe]))
        # Beer's law completes at this node with its own travel distance
        # (raytracer.cpp:353-356); beer == 0 means no absorption.
        w_eff = weight * torch.exp(beer * (-dist)[:, None])
        contrib = torch.where((valid & hit)[:, None], w_eff * local, 0.0)
        lvl = contrib[:r]
        for i in range(1, k):
            lvl = lvl + contrib[i * r:(i + 1) * r]
        acc_total = acc_total + lvl
        if level >= trace_depth:
            break

        shaded = valid & hit & ~is_light[safe]

        # Reflection children, perfect or glossy (raytracer.cpp:287-335).
        refl = scene.refl[safe]
        drefl = scene.drefl[safe]
        rdir = d_b - (2.0 * dot3(d_b, n_hit))[:, None] * n_hit
        glossy_ok = shaded & (refl > 0.0) & (drefl > 0.0) & (level < 3)
        # One disc sample per pass (the reference averages 4 in the node).
        u1, st = counter_next_masked(st, glossy_ok)
        u2, st = counter_next_masked(st, glossy_ok)
        if work is not None:
            work["glossy"] = work.get("glossy", 0) + int(glossy_ok.sum())
        rad = drefl * sqrt_rn(u1)
        ang = float(np.float32(2.0 * PI)) * u2
        xoffs = rad * torch.cos(ang)
        yoffs = rad * torch.sin(ang)
        # RN1 = (R.z, R.y, -R.x); RN2 = R x RN1 (raytracer.cpp:296-298)
        r0, r1, r2 = rdir[:, 0], rdir[:, 1], rdir[:, 2]
        rn1 = torch.stack([r2, r1, -r0], dim=-1)
        n0, n1, n2 = rn1[:, 0], rn1[:, 1], rn1[:, 2]
        rn2 = torch.stack([r1 * n2 - r2 * n1, r2 * n0 - r0 * n2, r0 * n1 - r1 * n0], dim=-1)
        gdir = rdir + rn1 * xoffs[:, None] + rn2 * (yoffs * drefl)[:, None]
        gdir = gdir * (1.0 / sqrt_rn(torch.clamp(dot3(gdir, gdir), min=1e-30)))[:, None]
        child_dir = torch.where(glossy_ok[:, None], gdir, rdir)
        refl_ok = shaded & (refl > 0.0)
        child_w = w_eff * refl[:, None] * color
        refl_o = torch.where(refl_ok[:, None], point + child_dir * _EPS, point)
        refl_w = torch.where(refl_ok[:, None], child_w, 0.0)

        # Refraction children (raytracer.cpp:337-359).
        refr = scene.refr[safe]
        m_rindex = scene.refr_index[safe]
        m_rindex_safe = torch.where(m_rindex != 0.0, m_rindex, 1.0)
        n_ratio = rindex / m_rindex_safe
        nrm2 = n_hit * code.to(torch.float32)[:, None]
        cos_i = -dot3(nrm2, d_b)
        cos_t2 = 1.0 - n_ratio * n_ratio * (1.0 - cos_i * cos_i)
        refr_ok = shaded & (refr > 0.0) & (cos_t2 > 0.0)
        cos_t2_safe = torch.where(cos_t2 > 0.0, cos_t2, 1.0)
        tdir = n_ratio[:, None] * d_b + (n_ratio * cos_i - sqrt_rn(cos_t2_safe))[:, None] * nrm2
        # The child's Beer absorbance: the parent's material color x 0.15,
        # applied with the child's own hit distance.
        child_beer = scene.color[safe] * float(np.float32(0.15))
        refr_o = torch.where(refr_ok[:, None], point + tdir * _EPS, point)
        refr_d = torch.where(refr_ok[:, None], tdir, d_b)
        refr_w = torch.where(refr_ok[:, None], w_eff, 0.0)
        refr_beer = torch.where(refr_ok[:, None], child_beer, 0.0)
        refr_ri = torch.where(refr_ok, m_rindex_safe, rindex)

        # Next level: [reflection children of all nodes; refraction children].
        o_b = torch.cat([refl_o, refr_o])
        d_b = torch.cat([child_dir, refr_d])
        weight = torch.cat([refl_w, refr_w])
        beer = torch.cat([torch.zeros_like(refl_w), refr_beer])
        rindex = torch.cat([rindex, refr_ri])
        valid = torch.cat([refl_ok, refr_ok])
        heap_ids = [2 * i + 1 for i in heap_ids] + [2 * i + 2 for i in heap_ids]

    out_state = (key_in, (ctr_in + PASS_DRAW_BUDGET) & _M32)
    if return_primary_idx:
        return acc_total, out_state, primary_idx
    return acc_total, out_state


def trace_passes(scene: Whitted5Scene, o: torch.Tensor, d: torch.Tensor, state: MWCState, *,
                 spp: int = 1, mean: bool = True, trace_depth: int = TRACEDEPTH5,
                 area_samples_by_level=AREA_SAMPLES_BY_LEVEL, return_primary_idx: bool = False,
                 work: Optional[dict] = None, on_sweep: Optional[Callable] = None,
                 on_texel: Optional[Callable] = None, soft_edges: float = 0.0):
    """``spp`` successive passes of ``whitted5_trace``, summed (then divided
    by spp when ``mean``). ``o``/``d`` are [R, 3] (every pass traces the same
    rays) or [spp, R, 3] (pass p traces set p). Returns (color [R, 3], state
    advanced by spp passes), plus the first pass's level-1 hit ids when
    ``return_primary_idx``. ``work``, ``on_sweep``, ``on_texel`` and
    ``soft_edges`` are passed to ``whitted5_trace``. With ``soft_edges == 0``
    this is K4's plain version."""
    if o.dim() == 2:
        o, d = o[None], d[None]
    acc, idx, st = None, None, state
    for p in range(spp):
        op, dp = o[p % o.shape[0]], d[p % d.shape[0]]
        col, st, pidx = whitted5_trace(scene, op, dp, st, trace_depth, area_samples_by_level,
                                       soft_edges, return_primary_idx=True, work=work,
                                       on_sweep=on_sweep, on_texel=on_texel)
        idx = pidx if idx is None else idx
        acc = col if acc is None else acc + col
    if mean:
        acc = acc / spp
    return (acc, st, idx) if return_primary_idx else (acc, st)


def camera_frame5(width: int, height: int, pos=(0.0, 0.0, 0.0), target=(0.0, 0.0, 1.0)):
    """Look-at camera frame (Engine::InitRender, raytracer.cpp:413-451): eye
    at (0,0,-5), 8x6 screen plane at z=0 in camera space, in world space.
    Returns (origin, p1, dx, dy) as float32 numpy arrays: pixel (col, row)
    sits at ``p1 + col*dx + row*dy``."""
    pos = np.asarray(pos, np.float32)
    target = np.asarray(target, np.float32)
    z = target - pos
    z = z / np.linalg.norm(z)
    up = np.array([0, 1, 0], np.float32)
    x = np.cross(up, z)
    x = x / max(np.linalg.norm(x), 1e-12)
    y = np.cross(x, -z)
    rot = np.stack([x, y, z], axis=0)  # rows
    inv = np.linalg.inv(rot)

    def xf(p):
        return inv @ np.asarray(p, np.float32) + pos

    origin = xf((0, 0, -5))
    p1 = xf((-4, 3, 0))
    p2 = xf((4, 3, 0))
    p4 = xf((-4, -3, 0))
    dx = (p2 - p1) / width
    dy = (p4 - p1) / height
    return (origin.astype(np.float32), p1.astype(np.float32),
            dx.astype(np.float32), dy.astype(np.float32))


def camera_rays5(width: int, height: int, pos=(0.0, 0.0, 0.0), target=(0.0, 0.0, 1.0),
                 sub: Tuple[float, float] = (0.5, 0.5)) -> Tuple[np.ndarray, np.ndarray]:
    """Full-frame primary rays as float32 numpy [H*W, 3] (origins, dirs);
    ``sub`` is the sub-pixel offset in pixel units (0.5, 0.5 = pixel centres;
    the reference's scanline renderer samples at (0, 0)). Row 0 is the top."""
    origin, p1, dx, dy = camera_frame5(width, height, pos, target)
    cols = np.arange(width, dtype=np.float32) + np.float32(sub[0])
    rows = np.arange(height, dtype=np.float32) + np.float32(sub[1])
    screen = (p1[None, None] + cols[None, :, None] * dx[None, None]
              + rows[:, None, None] * dy[None, None]).reshape(-1, 3)
    dirs = screen - origin
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = np.broadcast_to(origin, dirs.shape)
    return np.ascontiguousarray(origins, np.float32), np.ascontiguousarray(dirs, np.float32)


def _init_state5_np(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-pixel counter-RNG state (key, counter) as uint32 numpy, bitwise
    the JAX package's ``_init_state5_np``."""
    with np.errstate(over="ignore"):
        pid = np.arange(n, dtype=np.uint32)
        seed_word = np.uint32((seed * 0x85EBCA6B + 0x165667B1) & _M32)
        key = pid * np.uint32(0x9E3779B1) ^ seed_word
        key = key ^ (key >> np.uint32(16))
        key = key * np.uint32(0x7FEB352D)
        key = key ^ (key >> np.uint32(15))
    return key, np.zeros((n,), np.uint32)


@functools.lru_cache(maxsize=32)
def _cached_rays5(width: int, height: int, sub=(0.5, 0.5), device: str = "cpu"):
    """Device copies of ``camera_rays5``, made once per (w, h, sub, device):
    a render uploads no rays."""
    o, d = camera_rays5(width, height, sub=sub)
    return torch.from_numpy(o).to(device), torch.from_numpy(d).to(device)


@functools.lru_cache(maxsize=32)
def _cached_rays5_4(width: int, height: int, device: str = "cpu"):
    """[4, R, 3] rays of the four sub-pixel samples of the 4-ray render."""
    rays = [_cached_rays5(width, height, sub, device) for sub in FOUR_RAY_SUBS]
    return torch.stack([r[0] for r in rays]), torch.stack([r[1] for r in rays])


def _state5(n: int, seed: int, device="cpu", lanes: Optional[int] = None,
            lane_offset: int = 0) -> MWCState:
    """The seed's counter-RNG state (key, counter) of an ``n``-pixel frame:
    two uint32 [lanes] tensors (all ``n`` by default), lane l holding pixel
    ``lane_offset + l`` bitwise as ``_init_state5_np`` does, and a pixel at
    or past ``n`` the pad state 2 (a shard of ``render_whitted5_sharded``).
    On a CUDA device the seed kernel hashes it on the card (one launch on
    the current stream, no copy from the host, no sync); on the CPU numpy
    hashes it."""
    return seed_lanes("counter", seed, n, n if lanes is None else lanes,
                      lane_offset=lane_offset, device=device)


def _trace(scene, o, d, state, use_kernel, work=None, **kw):
    """Every renderer traces through here, in a ``w5.launch`` span: K4 when
    ``use_kernel`` (its plain version on CPU tensors), else the plain
    passes, which count their live work into ``work`` when it is a dict."""
    with span("w5.launch"):
        if use_kernel:
            from se195_raytracer_tpu_torch.kernels.whitted5_kernel import whitted5_trace_cuda

            return whitted5_trace_cuda(scene, o, d, state, **kw)
        return trace_passes(scene, o, d, state, work=work, **kw)


def _rays_and_state(width: int, height: int, dev: str, seed: int, sub=(0.5, 0.5)):
    """The cached primary rays (``sub``, or the four sub-pixel sets when
    ``sub`` is None) and the seed's counter state (``_state5``, made
    afresh), in spans ``w5.rays`` and ``w5.state``."""
    with span("w5.rays"):
        if sub is None:
            o, d = _cached_rays5_4(width, height, dev)
        else:
            o, d = _cached_rays5(width, height, sub, dev)
    with span("w5.state"):
        state = _state5(width * height, seed, dev)
    return o, d, state


def _placed(scene: Whitted5Scene, device):
    device = resolve_device(device)
    return scene.to(device), str(device)


def render_whitted5(
    scene: Whitted5Scene,
    width: int = 320,
    height: int = 240,
    spp: int = 1,
    trace_depth: int = TRACEDEPTH5,
    seed: int = 0,
    soft_edges: float = 0.0,
    use_kernel: bool = True,
    device=None,
    work: Optional[dict] = None,
) -> torch.Tensor:
    """Full-frame render -> [H, W, 3] float32 linear radiance, the mean of
    ``spp`` stochastic passes (area-light jitter, glossy) at the pixel
    centres. With ``use_kernel`` one K4 launch runs every pass. ``device=None``
    means CUDA and raises when no GPU is present. ``work``: the plain path's
    live-work count (``whitted5_trace``).

    ``soft_edges > 0`` renders the relaxed estimator (smooth shadow
    transmittance) on the plain tracer; with ``use_kernel`` it raises, since
    K4 implements the hard estimator. The plain tracer back-propagates to
    the scene's tensors (textures, ``box_pos``, colours, ...).

    Under a profiler session the call is a ``w5.render`` span holding
    ``w5.rays``, ``w5.state`` and ``w5.launch`` (K4's ``w5.tables`` inside
    it on a CUDA device)."""
    if soft_edges > 0.0 and use_kernel:
        raise NotImplementedError(
            "soft_edges > 0: K4 implements the hard estimator; render the relaxed one "
            "with use_kernel=False")
    with span("w5.render"):
        scene, dev = _placed(scene, device)
        o, d, state = _rays_and_state(width, height, dev, seed)
        kw = dict(soft_edges=soft_edges) if soft_edges > 0.0 else {}
        col, _ = _trace(scene, o, d, state, use_kernel, work, spp=spp, trace_depth=trace_depth,
                        **kw)
        return col.reshape(height, width, 3)


# Extra sub-pixel offsets fired on a primitive-change edge, in pixel units
# relative to the primary sample (Engine::Render, raytracer.cpp:500-503).
ADAPTIVE_OFFSETS = ((-0.5, 0.0), (0.0, -0.5), (-0.5, -0.5))
FOUR_RAY_SUBS = ((0.0, 0.0),) + ADAPTIVE_OFFSETS


def render_whitted5_4ray(
    scene: Whitted5Scene,
    width: int = 320,
    height: int = 240,
    trace_depth: int = TRACEDEPTH5,
    seed: int = 0,
    use_kernel: bool = True,
    device=None,
    work: Optional[dict] = None,
) -> torch.Tensor:
    """Full 4-ray supersampling, the comparator of the adaptive renderer: the
    same four sub-pixel rays at every pixel, blended x 0.25. One K4 launch
    (four passes, one ray set each). Spans as ``render_whitted5``'s."""
    with span("w5.render"):
        scene, dev = _placed(scene, device)
        o, d, state = _rays_and_state(width, height, dev, seed, sub=None)
        col, _ = _trace(scene, o, d, state, use_kernel, work, spp=4, trace_depth=trace_depth)
        return col.reshape(height, width, 3)


def adaptive_bucket(width: int, height: int, min_bucket: int = 4096) -> int:
    """Edge pixels granted extra rays: max(min_bucket, ~1.6% of the pixels
    rounded up to a power of two), the JAX device path's bucket."""
    r = width * height
    return max(min_bucket, 1 << (max(r // 64, 1) - 1).bit_length())


def render_whitted5_adaptive(
    scene: Whitted5Scene,
    width: int = 320,
    height: int = 240,
    trace_depth: int = TRACEDEPTH5,
    seed: int = 0,
    min_bucket: int = 4096,
    use_kernel: bool = True,
    device=None,
    work: Optional[dict] = None,
):
    """Adaptive 1-vs-4-ray supersampling (Engine::Render, raytracer.cpp:
    481-535). Returns ([H, W, 3] float32, edge fraction); the fraction is
    the one host readback, after the frame (``adaptive_pipeline``)."""
    img, n_edge = adaptive_pipeline(scene, width, height, trace_depth, seed, min_bucket,
                                    use_kernel, device, work)
    return img, float(n_edge) / (width * height)


@functools.lru_cache(maxsize=32)
def _cached_frame5(width: int, height: int, device: str = "cpu"):
    """Device copies of ``camera_frame5`` (origin, p1, dx, dy)."""
    return tuple(torch.from_numpy(a).to(device) for a in camera_frame5(width, height))


def adaptive_pipeline(
    scene: Whitted5Scene,
    width: int = 320,
    height: int = 240,
    trace_depth: int = TRACEDEPTH5,
    seed: int = 0,
    min_bucket: int = 4096,
    use_kernel: bool = True,
    device=None,
    work: Optional[dict] = None,
):
    """The adaptive render in four phases on the device, with no host sync
    (once the scene's tables and rays are cached):

    1. primary: one ray per pixel at the raw ``lpos`` and the level-1 hit ids;
       edge = the hit primitive differs from the previous pixel's in scan
       order (the first pixel compares with a miss);
    2. select: edge pixels are ranked (cumsum(edge) - 1); edge k goes to slot
       k of a fixed bucket (``adaptive_bucket``), other pixels to a dump slot
       past its end, so no two kept pixels share a slot; ``used = edge &
       (rank < bucket)``. Slots past the edge count trace pixel 0 unseen;
    3. extra: the 3 extra sub-pixel rays of each slot, one K4 launch (three
       passes), from the advanced RNG state of the slot's pixel;
    4. blend: used pixels gather their slot, (primary + extra) x 0.25;
       the others keep the primary sample.

    Edges beyond the bucket keep their 1-ray sample. ``work``: the plain
    path's live-work count. Returns ([H, W, 3] float32, the edge count as a
    device tensor). Under a profiler session the call is one ``w5.render``
    span holding ``w5.rays``, ``w5.state``, a ``w5.launch`` for each of
    phases 1 and 3, and ``w5.select`` and ``w5.blend`` (phases 2 and 4)."""
    with span("w5.render"):
        scene, dev = _placed(scene, device)
        r = width * height
        o, d, state = _rays_and_state(width, height, dev, seed, sub=(0.0, 0.0))
        col0, st, idx = _trace(scene, o, d, state, use_kernel, work, spp=1,
                               trace_depth=trace_depth, return_primary_idx=True)
        with span("w5.select"):
            idx = idx.to(torch.int64)
            prev = torch.cat([torch.full((1,), -1, dtype=torch.int64, device=o.device),
                              idx[:-1]])
            edge = idx != prev
            padded = adaptive_bucket(width, height, min_bucket)
            rank = torch.cumsum(edge.to(torch.int64), 0) - 1
            used = edge & (rank < padded)
            slot = torch.where(used, rank, padded)
            sel = torch.zeros(padded + 1, dtype=torch.int64, device=o.device)
            sel.scatter_(0, slot, torch.arange(r, dtype=torch.int64, device=o.device))
            sel = sel[:padded]

        origin, p1, dx, dy = _cached_frame5(width, height, dev)
        colx = (sel % width).to(torch.float32)
        rowy = (sel // width).to(torch.float32)
        eo, ed = [], []
        for fx, fy in ADAPTIVE_OFFSETS:
            screen = p1 + (colx + fx)[:, None] * dx + (rowy + fy)[:, None] * dy
            dirs = screen - origin
            ed.append(dirs / sqrt_rn(dot3(dirs, dirs))[:, None])
            eo.append(origin.expand(padded, 3))
        st_sel = (st[0][sel], st[1][sel])
        extra, _ = _trace(scene, torch.stack(eo), torch.stack(ed), st_sel, use_kernel, work,
                          spp=3, mean=False, trace_depth=trace_depth)

        with span("w5.blend"):
            ext = extra[torch.clamp(rank, 0, padded - 1)]
            img = torch.where(used[:, None], (col0 + ext) * 0.25, col0)
            return img.reshape(height, width, 3), edge.sum()

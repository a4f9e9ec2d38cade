"""Smallpt-family integrators: path tracing and direct lighting, in plain
PyTorch (twin of se195_raytracer_tpu/models/smallpt.py).

The reference's per-work-item bounce loop (smallptgpu-v1.6/geomfunc.h
RadiancePathTracing:167-338, RadianceDirectLighting:340-483,
SampleLights:112-165) runs over a whole ray batch with masked selects in
place of branches, and masked RNG advancement reproduces the reference's
data-dependent number of draws per pixel. The hard estimator (the
reference's) is what K1 and K2 compute; ``soft_edges > 0`` swaps its two
visibility step functions for the smooth relaxation below, for gradients
across silhouettes. Everything here is differentiable dataflow: the RNG is
tensors, so a recompute draws the same numbers.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch.utils.checkpoint

import numpy as np
import torch

from se195_raytracer_tpu_torch.core.rng import MWCState, next_masked
from se195_raytracer_tpu_torch.core.types import (
    DIFF,
    EPSILON,
    SPEC,
    CameraBasis,
    Scene,
    dot3,
    sqrt_rn,
    take_rows,
)
from se195_raytracer_tpu_torch.ops.intersect import (
    intersect_any,
    intersect_nearest,
    intersect_nearest_excluding,
)
from se195_raytracer_tpu_torch.ops.sampling import cosine_sample_dir, uniform_sample_sphere

FOUR_PI = float(np.float32(4.0 * np.pi))


def _ref_sign(x: torch.Tensor) -> torch.Tensor:
    """vec.h:59 ``sign(x) = x > 0 ? 1 : -1`` (note: sign(0) == -1)."""
    return torch.where(x > 0.0, 1.0, -1.0)


def _is_emissive(e: torch.Tensor) -> torch.Tensor:
    """Negation of the reference ``viszero`` macro (vec.h:44), bug included:
    y is never tested. [R, 3] -> [R] bool."""
    return (e[..., 0] != 0.0) | (e[..., 2] != 0.0)


def generate_camera_rays(
    basis: CameraBasis,
    state: MWCState,
    width: int,
    height: int,
    xs: torch.Tensor,
    ys: torch.Tensor,
    rng: str = "mwc",
) -> Tuple[torch.Tensor, torch.Tensor, MWCState]:
    """Jittered primary rays — rendering_kernel.cl:29-51 GenerateCameraRay.
    Exactly 2 RNG draws per pixel; ``ys`` counts up from the image bottom."""
    draw = next_masked(rng)
    all_on = torch.ones(xs.shape, dtype=torch.bool, device=xs.device)
    r1, state = draw(state, all_on)
    r2, state = draw(state, all_on)
    inv_w = float(np.float32(1.0 / width))
    inv_h = float(np.float32(1.0 / height))
    kcx = (xs.to(torch.float32) + (r1 - 0.5)) * inv_w - 0.5
    kcy = (ys.to(torch.float32) + (r2 - 0.5)) * inv_h - 0.5
    rdir = basis.x[None, :] * kcx[:, None] + basis.y[None, :] * kcy[:, None] + basis.dir[None, :]
    rorig = 0.1 * rdir + basis.orig[None, :]
    rdir = rdir * (1.0 / sqrt_rn(dot3(rdir, rdir))[:, None])
    return rorig, rdir, state


def sample_lights(
    scene: Scene,
    state: MWCState,
    hit_point: torch.Tensor,
    nl: torch.Tensor,
    draw_mask: torch.Tensor,
    rng: str = "mwc",
    on_sweep: Optional[Callable] = None,
    soft_w: float = 0.0,
    origin_hid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, MWCState]:
    """Next-event estimation over all emissive spheres — geomfunc.h:112-165.

    Two draws per light in ascending index order, before the ``wo > 0``
    rejection; ``draw_mask`` gates the advance to lanes on this code path.
    The reference evaluates ``UniformSampleSphere(GetRandom(), GetRandom())``
    right to left, so the FIRST draw is u2 and the SECOND u1.
    ``on_sweep`` is ``radiance``'s hook (hard estimator only). ``soft_w > 0``
    replaces the binary occlusion test with ``_soft_transmittance``, which
    skips each lane's own sphere ``origin_hid``. Returns (Ld [R, 3],
    new_state)."""
    draw = next_masked(rng)
    ld = torch.zeros_like(hit_point)
    soft = soft_w > 0.0
    for li in scene.light_indices:
        draw_a, state = draw(state, draw_mask)
        draw_b, state = draw(state, draw_mask)
        usp = uniform_sample_sphere(draw_b, draw_a)
        sphere_point = scene.radius[li] * usp + scene.center[li][None, :]
        sdir = sphere_point - hit_point
        if soft:
            # The soft path's guards: sqrt at an exact 0 (the hit point on
            # the sampled light point) has a 0/0 tangent, and a floor of
            # 1e-10 squares to a normal float where 1e-20 would not. The
            # hard path keeps the reference's values.
            length = sqrt_rn(torch.clamp(dot3(sdir, sdir), min=1e-24))
            len_safe = torch.clamp(length, min=1e-10)
        else:
            # sqrt(0) = 0 as the reference computes it, with a zero
            # derivative there (a double where) so that the lane's 0/0
            # tangent cannot reach the backward.
            len2 = dot3(sdir, sdir)
            pos = len2 > 0.0
            length = torch.where(pos, sqrt_rn(torch.where(pos, len2, 1.0)), 0.0)
            len_safe = torch.clamp(length, min=1e-20)
        sdir = sdir / len_safe[:, None]
        wo = dot3(sdir, usp)
        wi = dot3(sdir, nl)
        s = FOUR_PI * scene.radius[li] * scene.radius[li] * wi * (-wo) / (len_safe * len_safe)
        wrong_half = wo > 0.0  # sample on the far half of the light sphere
        if soft:
            trans = _soft_transmittance(scene, hit_point, sdir, length - EPSILON, origin_hid,
                                        li, soft_w)
            ok = ~wrong_half & (wi > 0.0) & draw_mask
            ld = ld + torch.where(ok[:, None], (s * trans)[:, None] * scene.emission[li][None, :],
                                  0.0)
            continue
        occluded = intersect_any(scene, hit_point, sdir, length - EPSILON)
        if on_sweep is not None:
            on_sweep(hit_point, sdir, ~wrong_half & (wi > 0.0) & draw_mask, length - EPSILON)
        ok = ~wrong_half & (wi > 0.0) & ~occluded & draw_mask
        ld = ld + torch.where(ok[:, None], s[:, None] * scene.emission[li][None, :], 0.0)
    return ld, state


# ---------------------------------------------------------------------------
# The differentiable-visibility relaxation (RenderConfig.soft_edges > 0),
# as in the JAX package. The hard estimator's gradients fail at two step
# functions of the scene parameters: (a) the nearest-hit winner flipping
# between a light and the geometry at the light's silhouette, and (b) a
# shadow ray's occlusion switching as an occluder's entry distance crosses
# EPSILON. Both indicators become sigmoids of signed margins of width ``w``
# (world units), in forward and backward alike, so that finite differences
# of the relaxed forward agree with autodiff everywhere:
#
# * Emissive spheres leave the geometric nearest hit. Each contributes
#   ``g * |dp| * thr * e`` with g = sigma(silhouette margin / w) *
#   sigma((t_excl - t_light) / w) * sigma((t_light - eps) / w), and the path
#   goes on through the light to the non-light winner with its throughput
#   scaled by (1 - g). As w -> 0, g -> {0, 1} and the hard semantics return.
# * Shadow visibility becomes a transmittance T = prod_j (1 - occ_j), with
#   occ_j = sigma(margin_j / w) * the soft OR of the two roots' in-range
#   windows, skipping the sphere the shadow ray starts on and the target
#   light.
#
# The relaxed estimator is biased within a ~w-wide band at silhouettes; it
# is an option, not the default. Every guard of the JAX code is kept as
# written: torch.where, like jnp.where, does not stop a NaN or inf of the
# branch it does not take from reaching the backward.
# ---------------------------------------------------------------------------


def _f32(x: float) -> float:
    return float(np.float32(x))


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def _smax0(x: torch.Tensor, w: float) -> torch.Tensor:
    """Smooth max(x, 0) with curvature scale w^2: w^2 at x = 0, -> x for
    x >> w^2, -> 0 for x << -w^2; its derivative lies in (0, 1)."""
    w2 = np.float32(w * w)
    return 0.5 * (x + sqrt_rn(x * x + float(np.float32(4.0) * w2 * w2)))


def _soft_root(det: torch.Tensor, w: float) -> torch.Tensor:
    """sqrt(smax0(det) + w^2): the relaxation's ray-sphere root half-width.
    Not sqrt(max(det, tiny)), whose derivative diverges like 1/sqrt(det) at
    the silhouette and would shrink the ordering sigmoid's width in
    parameter space below any finite-difference step; this one's is bounded
    by ~1/(2w). det can be hugely negative (the 1e5-radius walls)."""
    return sqrt_rn(_smax0(det, w) + _f32(np.float32(w) * np.float32(w)))


def _soft_light_weight(scene: Scene, li: int, o: torch.Tensor, d: torch.Tensor,
                       t_excl: torch.Tensor, soft_w: float):
    """(g [R], |dp| [R]) for light ``li``: the smooth hit weight and the
    absolute normal cosine at the (phantom) hit point."""
    w = _f32(soft_w)
    c = scene.center[li][None, :]
    r = scene.radius[li]
    op = c - o
    b = dot3(op, d)
    # The perpendicular miss distance, computed stably: for the walls'
    # radii |op|^2 - b^2 cancels catastrophically, the rejection does not.
    perp = op - b[:, None] * d
    pd = sqrt_rn(torch.clamp(dot3(perp, perp), min=1e-12))
    m_sil = r - pd  # > 0: the ray's line passes inside the silhouette
    det = m_sil * (r + pd)  # r^2 - pd^2, factored for float32
    sq = _soft_root(det, soft_w)
    t1 = b - sq
    t2 = b + sq
    t_l = torch.where(t1 > EPSILON, t1, t2)
    g = (_sigmoid(m_sil / w) * _sigmoid((t_excl - t_l) / w)
         * _sigmoid((t_l - EPSILON) / w))
    n = o + t_l[:, None] * d - c
    n = n * (1.0 / sqrt_rn(torch.clamp(dot3(n, n), min=1e-12)))[:, None]
    return g, torch.abs(dot3(n, d))


def _soft_transmittance(scene: Scene, o: torch.Tensor, d: torch.Tensor, max_t: torch.Tensor,
                        origin_hid: torch.Tensor, target_li: int,
                        soft_w: float) -> torch.Tensor:
    """[R] smooth shadow transmittance in [0, 1] (1 = unoccluded): the
    product over spheres j of 1 - sigma(margin_j / w) * softOR(entry in
    range, exit in range), skipping each lane's originating sphere
    ``origin_hid`` and the static target light ``target_li``."""
    w = _f32(soft_w)
    op = scene.center[None, :, :] - o[:, None, :]  # [R, N, 3]
    b = dot3(op, d[:, None, :])  # [R, N]
    perp = op - b[..., None] * d[:, None, :]
    pd = sqrt_rn(torch.clamp(dot3(perp, perp), min=1e-12))
    m_sil = scene.radius[None, :] - pd
    det = m_sil * (scene.radius[None, :] + pd)
    sq = _soft_root(det, soft_w)
    mt = max_t[:, None]

    def in_range(t):
        return _sigmoid((t - EPSILON) / w) * _sigmoid((mt - t) / w)

    f1 = in_range(b - sq)
    f2 = in_range(b + sq)
    occ = _sigmoid(m_sil / w) * (f1 + f2 - f1 * f2)
    cols = torch.arange(occ.shape[-1], device=occ.device)[None, :]
    occ = torch.where(cols == origin_hid[:, None], 0.0, occ)
    occ = torch.where(cols == target_li, 0.0, occ)
    return torch.prod(1.0 - occ, dim=-1)


def _bounce(scene: Scene, direct_only: bool, rng: str, o, d, rad, thr, alive, spec_b, state,
            on_sweep=None, soft_edges: float = 0.0):
    """One iteration of the bounce loop (geomfunc.h:182-336) over all lanes.

    ``soft_edges > 0`` runs the relaxation (the block comment above): the
    lights leave the nearest hit and contribute analytically with smooth
    weights, and the path goes on through them with (1 - g)-damped
    throughput."""
    if on_sweep is not None:
        on_sweep(o, d, alive, None)
    if soft_edges > 0.0:
        t, hid, hit = intersect_nearest_excluding(scene, o, d, scene.light_indices)
        # Emission is gated on the specular-bounce flag as in the hard path
        # (geomfunc.h:216-227); the absorption (1 - g) applies regardless,
        # as the hard path ends at a light whether or not it adds emission.
        for li in scene.light_indices:
            g, adp = _soft_light_weight(scene, li, o, d, t, soft_edges)
            rad = rad + torch.where((alive & spec_b)[:, None],
                                    (g * adp)[:, None] * thr * scene.emission[li][None, :], 0.0)
            thr = thr * torch.where(alive[:, None], (1.0 - g)[:, None], 1.0)
    else:
        t, hid, hit = intersect_nearest(scene, o, d)
    act = alive & hit

    t_safe = torch.where(hit, t, 1.0)
    hp = o + t_safe[:, None] * d
    n = hp - take_rows(scene.center, hid)
    n = n * (1.0 / sqrt_rn(torch.clamp(dot3(n, n), min=1e-38))[:, None])
    dp = dot3(n, d)
    nl = (-_ref_sign(dp))[:, None] * n  # oriented normal (geomfunc.h:211-214)

    e = take_rows(scene.emission, hid)
    c = take_rows(scene.color, hid)
    emissive = _is_emissive(e)

    # Emission only if the previous bounce was specular (geomfunc.h:216-227).
    hit_light = act & emissive
    rad = rad + torch.where((hit_light & spec_b)[:, None], torch.abs(dp)[:, None] * thr * e, 0.0)

    live = act & ~emissive
    mat = scene.refl[hid]
    is_diff = live & (mat == DIFF)
    is_spec = live & (mat == SPEC)
    is_refr = live & (mat != DIFF) & (mat != SPEC)  # geomfunc.h else-branch

    draw = next_masked(rng)
    # ---------------- DIFF (geomfunc.h:229-269) ----------------
    thr_c = thr * c
    ld, state = sample_lights(scene, state, hp, nl, is_diff, rng, on_sweep,
                              soft_w=soft_edges, origin_hid=hid)
    rad = rad + torch.where(is_diff[:, None], thr_c * ld, 0.0)
    if direct_only:
        nd_diff = d  # RadianceDirectLighting:402-414 — ends after NEE
    else:
        r1u, state = draw(state, is_diff)
        r2u, state = draw(state, is_diff)
        nd_diff = cosine_sample_dir(nl, r1u, r2u)

    # ---------------- SPEC (geomfunc.h:270-280) ----------------
    refl_dir = d - (2.0 * dp)[:, None] * n

    # ---------------- REFR (geomfunc.h:281-336) ----------------
    into = dot3(n, nl) > 0.0
    nnt = torch.where(into, float(np.float32(1.0 / 1.5)), 1.5)
    ddn = dot3(d, nl)
    cos2t = 1.0 - nnt * nnt * (1.0 - ddn * ddn)
    tir = cos2t < 0.0
    # The square root of a where-guarded positive (cos2t_safe), not of
    # max(., 0): sqrt'(0) = inf would NaN-poison the backward on TIR lanes.
    kk = torch.where(into, 1.0, -1.0) * (ddn * nnt + sqrt_rn(torch.where(tir, 1.0, cos2t)))
    tdir = nnt[:, None] * d - kk[:, None] * n
    tdir = tdir * (1.0 / sqrt_rn(torch.clamp(dot3(tdir, tdir), min=1e-38))[:, None])
    # R0 = ((nt-nc)/(nt+nc))^2 with nc=1, nt=1.5 (geomfunc.h:312-314)
    r0 = float(np.float32(0.25 / 6.25))
    c1 = 1.0 - torch.where(into, -ddn, dot3(tdir, n))
    re = r0 + (1.0 - r0) * c1 * c1 * c1 * c1 * c1
    p = 0.25 + 0.5 * re
    rp = re / p
    tp = (1.0 - re) / (1.0 - p)
    u_rr, state = draw(state, is_refr & ~tir)
    pick_refl = u_rr < p
    refr_refl = is_refr & (tir | pick_refl)
    refr_trans = is_refr & ~tir & ~pick_refl

    # ---------------- combine ----------------
    thr_new = torch.where(
        (is_diff | is_spec | (is_refr & tir))[:, None],
        thr_c,
        torch.where(
            (is_refr & ~tir & pick_refl)[:, None],
            rp[:, None] * thr * c,
            torch.where(refr_trans[:, None], tp[:, None] * thr * c, thr),
        ),
    )
    d_new = torch.where(
        is_diff[:, None],
        nd_diff,
        torch.where(
            (is_spec | refr_refl)[:, None],
            refl_dir,
            torch.where(refr_trans[:, None], tdir, d),
        ),
    )
    o_new = torch.where(live[:, None], hp, o)
    spec_new = torch.where(is_diff, False, torch.where(is_spec | is_refr, True, spec_b))
    alive_new = live & ~is_diff if direct_only else live
    # Dead lanes keep their previous ray so downstream compute stays finite.
    d_new = torch.where(live[:, None], d_new, d)
    thr_new = torch.where(live[:, None], thr_new, thr)
    return o_new, d_new, rad, thr_new, alive_new, spec_new, state


def radiance(
    scene: Scene,
    origin: torch.Tensor,
    direction: torch.Tensor,
    state: MWCState,
    max_depth: int = 7,
    direct_only: bool = False,
    rng: str = "mwc",
    on_sweep: Optional[Callable] = None,
    remat: bool = False,
    soft_edges: float = 0.0,
) -> Tuple[torch.Tensor, MWCState]:
    """Radiance [R, 3] for a batch of rays, and the advanced RNG state
    (int64 words). ``max_depth`` counts bounce-body iterations; the
    reference runs depth = 0..6, so the default is 7.

    ``on_sweep(origin, direction, mask, max_t)``, when given, is called for
    every sphere sweep with the lanes on which a per-lane kernel (one that
    stops dead lanes) runs it: each bounce's nearest-hit sweep over the
    lanes alive at its start (``max_t`` None), and each shadow sweep over
    the diffuse lanes whose light sample passed the ``wo``/``wi`` tests.

    ``remat=True`` runs each bounce under ``torch.utils.checkpoint`` (the
    counterpart of ``jax.checkpoint``): the backward keeps one bounce's
    temporaries at a time and recomputes them, with the same values, since
    the RNG state is an input of the bounce. Forward-mode AD does not pass
    through a checkpoint: take a JVP with ``remat=False``.

    ``soft_edges > 0`` runs the differentiable-visibility relaxation (the
    block comment above ``_bounce``), biased within a ~soft_edges-wide band
    at silhouettes."""
    r = origin.shape[0]
    dev = origin.device
    o, d = origin, direction
    rad = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    thr = torch.ones((r, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((r,), dtype=torch.bool, device=dev)
    spec_b = torch.ones((r,), dtype=torch.bool, device=dev)
    soft_edges = float(soft_edges)

    def body(o, d, rad, thr, alive, spec_b, s0, s1):
        o, d, rad, thr, alive, spec_b, (s0, s1) = _bounce(
            scene, direct_only, rng, o, d, rad, thr, alive, spec_b, (s0, s1), on_sweep,
            soft_edges)
        return o, d, rad, thr, alive, spec_b, s0, s1

    carry = (o, d, rad, thr, alive, spec_b, state[0], state[1])
    for _ in range(max_depth):
        if remat:
            carry = torch.utils.checkpoint.checkpoint(
                body, *carry, use_reentrant=False, preserve_rng_state=False)
        else:
            carry = body(*carry)
    return carry[2], (carry[6], carry[7])

"""Smallpt-family integrators: path tracing and direct lighting, in plain
PyTorch (twin of se195_raytracer_tpu/models/smallpt.py, hard estimator).

The reference's per-work-item bounce loop (smallptgpu-v1.6/geomfunc.h
RadiancePathTracing:167-338, RadianceDirectLighting:340-483,
SampleLights:112-165) runs over a whole ray batch with masked selects in
place of branches, and masked RNG advancement reproduces the reference's
data-dependent number of draws per pixel.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

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
)
from se195_raytracer_tpu_torch.ops.intersect import intersect_any, intersect_nearest
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
) -> Tuple[torch.Tensor, MWCState]:
    """Next-event estimation over all emissive spheres — geomfunc.h:112-165.

    Two draws per light in ascending index order, before the ``wo > 0``
    rejection; ``draw_mask`` gates the advance to lanes on this code path.
    The reference evaluates ``UniformSampleSphere(GetRandom(), GetRandom())``
    right to left, so the FIRST draw is u2 and the SECOND u1.
    ``on_sweep`` is ``radiance``'s hook. Returns (Ld [R, 3], new_state)."""
    draw = next_masked(rng)
    ld = torch.zeros_like(hit_point)
    for li in scene.light_indices:
        draw_a, state = draw(state, draw_mask)
        draw_b, state = draw(state, draw_mask)
        usp = uniform_sample_sphere(draw_b, draw_a)
        sphere_point = scene.radius[li] * usp + scene.center[li][None, :]
        sdir = sphere_point - hit_point
        length = sqrt_rn(dot3(sdir, sdir))
        len_safe = torch.clamp(length, min=1e-20)
        sdir = sdir / len_safe[:, None]
        wo = dot3(sdir, usp)
        wi = dot3(sdir, nl)
        s = FOUR_PI * scene.radius[li] * scene.radius[li] * wi * (-wo) / (len_safe * len_safe)
        occluded = intersect_any(scene, hit_point, sdir, length - EPSILON)
        wrong_half = wo > 0.0  # sample on the far half of the light sphere
        if on_sweep is not None:
            on_sweep(hit_point, sdir, ~wrong_half & (wi > 0.0) & draw_mask, length - EPSILON)
        ok = ~wrong_half & (wi > 0.0) & ~occluded & draw_mask
        ld = ld + torch.where(ok[:, None], s[:, None] * scene.emission[li][None, :], 0.0)
    return ld, state


def _bounce(scene: Scene, direct_only: bool, rng: str, o, d, rad, thr, alive, spec_b, state,
            on_sweep=None):
    """One iteration of the bounce loop (geomfunc.h:182-336) over all lanes."""
    if on_sweep is not None:
        on_sweep(o, d, alive, None)
    t, hid, hit = intersect_nearest(scene, o, d)
    act = alive & hit

    t_safe = torch.where(hit, t, 1.0)
    hp = o + t_safe[:, None] * d
    n = hp - scene.center[hid]
    n = n * (1.0 / sqrt_rn(torch.clamp(dot3(n, n), min=1e-38))[:, None])
    dp = dot3(n, d)
    nl = (-_ref_sign(dp))[:, None] * n  # oriented normal (geomfunc.h:211-214)

    e = scene.emission[hid]
    c = scene.color[hid]
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
    ld, state = sample_lights(scene, state, hp, nl, is_diff, rng, on_sweep)
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
) -> Tuple[torch.Tensor, MWCState]:
    """Radiance [R, 3] for a batch of rays, and the advanced RNG state
    (int64 words). ``max_depth`` counts bounce-body iterations; the
    reference runs depth = 0..6, so the default is 7.

    ``on_sweep(origin, direction, mask, max_t)``, when given, is called for
    every sphere sweep with the lanes on which a per-lane kernel (one that
    stops dead lanes) runs it: each bounce's nearest-hit sweep over the
    lanes alive at its start (``max_t`` None), and each shadow sweep over
    the diffuse lanes whose light sample passed the ``wo``/``wi`` tests."""
    r = origin.shape[0]
    dev = origin.device
    o, d = origin, direction
    rad = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    thr = torch.ones((r, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((r,), dtype=torch.bool, device=dev)
    spec_b = torch.ones((r,), dtype=torch.bool, device=dev)
    for _ in range(max_depth):
        o, d, rad, thr, alive, spec_b, state = _bounce(
            scene, direct_only, rng, o, d, rad, thr, alive, spec_b, state, on_sweep
        )
    return rad, state

"""What a render's sweeps must do, counted by the reference over the same
inputs (its ``on_sweep`` hook sees every sweep of every lane): the work
the roofline readers charge. The counts are those of the program's own
records, frozen here: K1's live bounces; K1b's sweeps, recorded bounces,
shadow rays and lit samples; K2's per-ray culled sweep (a block is tested
when the ray can hit its bounding sphere, and a shadow sweep stops at its
first occluder in the sweep's order).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from reference import smallpt as ref

SPHERE_BLOCK = 16  # spheres a block of the culled sweep


def run(inputs: dict, hook: Callable, block: int = 1 << 16) -> None:
    """Render every pixel of the unit with ``hook`` on every sweep."""
    dev, frame = inputs["device"], inputs["frame"]
    scene = ref.make_scene(inputs["arrays"], dev)
    o, t = (torch.tensor(v, device=dev) for v in inputs["cam"])
    basis = ref.camera_basis(o, t, frame.width, frame.height)
    with torch.no_grad():
        ref.render_pixels(scene, basis, frame, inputs["seed"], ref.all_pixels(frame, dev),
                          block=block, on_sweep=hook)


def k1(inputs: dict) -> Dict[str, int]:
    """live_bounces: the lanes alive at the start of each nearest sweep."""
    work = {"live_bounces": 0}

    def hook(o, d, mask, max_t):
        if max_t is None:
            work["live_bounces"] += int(mask.sum())

    run(inputs, hook)
    return work


def k1b(inputs: dict) -> Dict[str, int]:
    """sweeps (nearest sweeps run), bounces (those that hit), shadow_rays
    (light samples shot) and lit (those no sphere occluded)."""
    scene = ref.make_scene(inputs["arrays"], inputs["device"])
    work = {"sweeps": 0, "bounces": 0, "shadow_rays": 0, "lit": 0}

    def hook(o, d, mask, max_t):
        o, d = o[mask], d[mask]
        if max_t is None:
            work["sweeps"] += int(mask.sum())
            work["bounces"] += int(ref.nearest(scene, o, d)[2].sum())
        else:
            work["shadow_rays"] += int(mask.sum())
            work["lit"] += int((~ref.occluded(scene, o, d, max_t[mask])).sum())

    run(inputs, hook)
    return work


def block_bounds(center: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    """[4, nb] bounding spheres (cx, cy, cz, r) of the whole blocks of
    ``SPHERE_BLOCK`` spheres in index order, the radius inflated x1.001 +
    0.01 so that rounding never rejects a block that holds a hit."""
    nb = center.shape[0] // SPHERE_BLOCK
    idx = torch.arange(nb * SPHERE_BLOCK, device=center.device).reshape(nb, SPHERE_BLOCK)
    c3 = center.T[:, idx]
    rad = radius[idx]
    lo = (c3 - rad[None]).amin(dim=-1)
    hi = (c3 + rad[None]).amax(dim=-1)
    bc = 0.5 * (lo + hi)
    dc = c3 - bc[:, :, None]
    dist = ref.sqrt_rn(dc[0] * dc[0] + dc[1] * dc[1] + dc[2] * dc[2])
    br = (dist + rad).amax(dim=-1) * float(np.float32(1.001)) + float(np.float32(0.01))
    return torch.cat([bc, br[None]], dim=0)


def possible(bounds: torch.Tensor, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """[R, nb]: the ray's line meets the bound ahead of its origin."""
    op = bounds[:3].T[None] - o[:, None, :]
    b = ref.dot3(op, d[:, None, :])
    r = bounds[3]
    det = b * b - ref.dot3(op, op) + r * r
    sq = ref.sqrt_rn(torch.clamp(det, min=0.0))
    return (det >= 0.0) & ((b + sq) > 0.0)


def k2(inputs: dict) -> Dict[str, int]:
    """nearest_rays, shadow_rays (sweeps run), nearest_tests, shadow_tests
    (sphere tests) and bound_tests of the per-ray culled sweep."""
    dev = inputs["device"]
    scene = ref.make_scene(inputs["arrays"], dev)
    bounds = block_bounds(scene.center, scene.radius)
    n, nb = scene.center.shape[0], bounds.shape[1]
    m = nb * SPHERE_BLOCK
    idx = torch.arange(n, device=dev)
    blk_last = torch.arange(nb, device=dev) * SPHERE_BLOCK + (SPHERE_BLOCK - 1)
    work = dict(nearest_rays=0, shadow_rays=0, nearest_tests=0, shadow_tests=0, bound_tests=0)

    def hook(o, d, mask, max_t):
        o, d = o[mask], d[mask]
        rays = o.shape[0]
        can = possible(bounds, o, d)
        if max_t is None:
            work["nearest_rays"] += rays
            work["bound_tests"] += rays * nb
            work["nearest_tests"] += rays * (n - m) + SPHERE_BLOCK * int(can.sum())
            return
        work["shadow_rays"] += rays
        t = ref.sphere_t(scene, o, d)
        occluder = (t != 0.0) & (t < max_t[mask][:, None])
        tested = torch.cat([can.repeat_interleave(SPHERE_BLOCK, dim=1),
                            torch.ones((rays, n - m), dtype=torch.bool, device=dev)], dim=1)
        first = torch.where(occluder & tested, idx, -1).amax(dim=1)
        work["shadow_tests"] += int((tested & (idx[None] >= first[:, None])).sum())
        work["bound_tests"] += int((blk_last[None] >= first[:, None]).sum())

    run(inputs, hook, block=1 << 14)
    return work

"""Batched ray-sphere intersection (twin of se195_raytracer_tpu/ops/intersect.py).

The reference's per-work-item loop over spheres (smallptgpu-v1.6/geomfunc.h
SphereIntersect:32-59, Intersect:71-92, IntersectP:94-110) as one
``[rays, spheres]`` test. ``op = center - origin`` is formed first and the
dot products elementwise: the Cornell walls are 1e4-radius spheres, where
the expanded form loses about three digits to cancellation.
"""

from __future__ import annotations

from typing import Tuple

import torch

from se195_raytracer_tpu_torch.core.types import EPSILON, Scene, dot3, sqrt_rn

_INF = 1e20  # geomfunc.h:80 — initial nearest-hit distance


def sphere_intersect(scene: Scene, origin: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """[R, N] distances from each ray to each sphere, 0 where no hit:
    ``b - sqrt(det)`` if > EPSILON, else ``b + sqrt(det)`` if > EPSILON,
    else 0 (geomfunc.h:32-59)."""
    op = scene.center[None, :, :] - origin[:, None, :]  # [R, N, 3]
    b = dot3(op, direction[:, None, :])  # [R, N]
    det = b * b - dot3(op, op) + (scene.radius * scene.radius)[None, :]
    hit_mask = det >= 0.0
    # An exactly tangent ray (det == 0; it happens at full frame size in
    # float32) has sqrt'(0) = inf, and 0 * inf poisons the backward. The
    # double where keeps the forward's values (sqrt(0) = 0, and the t it
    # picks) and gives those lanes a zero derivative instead.
    pos = det > 0.0
    sq = torch.where(pos, sqrt_rn(torch.where(pos, det, 1.0)), 0.0)
    t1 = b - sq
    t2 = b + sq
    t = torch.where(t1 > EPSILON, t1, torch.where(t2 > EPSILON, t2, 0.0))
    return torch.where(hit_mask, t, 0.0)


def intersect_nearest(
    scene: Scene, origin: torch.Tensor, direction: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest hit over all spheres: (t [R], hit_id [R] int64, hit [R] bool).

    The reference sweeps spheres N-1 .. 0 and replaces the best on strict
    ``<``, so among equal distances the LARGEST index wins
    (geomfunc.h:82-89): argmin over the reversed sphere axis (argmin
    returns the first minimum)."""
    d = sphere_intersect(scene, origin, direction)
    dm = torch.where(d != 0.0, d, _INF)
    n = dm.shape[-1]
    hit_id = (n - 1) - torch.argmin(torch.flip(dm, dims=(-1,)), dim=-1)
    t = torch.gather(dm, -1, hit_id[:, None])[:, 0]
    return t, hit_id, t < _INF


def _sphere_intersect_gradsafe(scene: Scene, origin: torch.Tensor,
                               direction: torch.Tensor) -> torch.Tensor:
    """``sphere_intersect`` with the discriminant floored at 1e-30 under the
    square root. The hard form passes det == +0.0 through, and an exactly
    tangent ray (it happens at full frame size in float32) then has
    sqrt'(0) = inf and a NaN tangent. The floor moves values only for det in
    (0, 1e-30), far below float32 visibility downstream. Used by the
    soft-edge relaxation's nearest hit; the hard path keeps the reference's
    form."""
    op = scene.center[None, :, :] - origin[:, None, :]
    b = dot3(op, direction[:, None, :])
    det = b * b - dot3(op, op) + (scene.radius * scene.radius)[None, :]
    hit_mask = det >= 0.0
    sq = sqrt_rn(torch.where(hit_mask, torch.clamp(det, min=1e-30), 1.0))
    t1 = b - sq
    t2 = b + sq
    t = torch.where(t1 > EPSILON, t1, torch.where(t2 > EPSILON, t2, 0.0))
    return torch.where(hit_mask, t, 0.0)


def intersect_nearest_excluding(
    scene: Scene, origin: torch.Tensor, direction: torch.Tensor, exclude: Tuple[int, ...]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest hit among the spheres NOT in the static index set
    ``exclude``: the soft-edge relaxation handles the emissive spheres
    analytically (models/smallpt.py), so the geometric winner is chosen
    among the others. The tie-break of ``intersect_nearest``; the
    derivative-safe discriminant of ``_sphere_intersect_gradsafe``."""
    d = _sphere_intersect_gradsafe(scene, origin, direction)
    dm = torch.where(d != 0.0, d, _INF)
    if exclude:
        cols = torch.zeros((dm.shape[-1],), dtype=torch.bool, device=dm.device)
        cols[list(exclude)] = True
        dm = torch.where(cols[None, :], _INF, dm)
    n = dm.shape[-1]
    hit_id = (n - 1) - torch.argmin(torch.flip(dm, dims=(-1,)), dim=-1)
    t = torch.gather(dm, -1, hit_id[:, None])[:, 0]
    return t, hit_id, t < _INF


def intersect_any(
    scene: Scene, origin: torch.Tensor, direction: torch.Tensor, max_t: torch.Tensor
) -> torch.Tensor:
    """Shadow predicate (IntersectP, geomfunc.h:94-110): [R] bool, True if
    any sphere is hit strictly closer than ``max_t``."""
    d = sphere_intersect(scene, origin, direction)
    return torch.any((d != 0.0) & (d < max_t[:, None]), dim=-1)

"""Whitted-family scene types and builders (twin of
se195_raytracer_tpu/scenes/whitted_scenes.py).

The reference's plane + sphere primitive table (Raytracer3.2.03/common.h:5-65
``Primitive``/``Material``, scene.c:6-127 create_*) as one SoA table of
float32 tensors with a type id per primitive and the full Whitted material
{color, refl, diff, refr, refr_index, spec}. ``ptype`` and ``is_light`` are
static structure: the tracer's light loops branch on them per primitive.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from se195_raytracer_tpu_torch.core.types import resolve_device

PLANE = 0
SPHERE = 1

# The float32 tensor fields.
FIELDS = ("normal", "depth", "center", "radius", "color", "refl", "diff", "refr", "refr_index",
          "spec")


@dataclasses.dataclass(frozen=True)
class WhittedScene:
    # Geometry (plane fields are zero for spheres and vice versa).
    normal: torch.Tensor  # [N, 3] plane normal
    depth: torch.Tensor  # [N] plane depth: plane is n.x + depth = 0
    center: torch.Tensor  # [N, 3] sphere center
    radius: torch.Tensor  # [N] sphere radius
    # Material (Raytracer3.2.03/common.h Material).
    color: torch.Tensor  # [N, 3] (may exceed 1: the reference uses e.g. 1.5)
    refl: torch.Tensor  # [N] reflection factor
    diff: torch.Tensor  # [N] diffuse factor
    refr: torch.Tensor  # [N] refraction factor
    refr_index: torch.Tensor  # [N] refractive index
    spec: torch.Tensor  # [N] specular (Phong^20) factor
    # Static structure.
    ptype: Tuple[int, ...] = ()
    is_light: Tuple[bool, ...] = ()

    @property
    def num_prims(self) -> int:
        return len(self.ptype)

    @property
    def device(self) -> torch.device:
        return self.center.device

    @property
    def light_indices(self) -> Tuple[int, ...]:
        return tuple(i for i, light in enumerate(self.is_light) if light)

    @property
    def sq_radius(self) -> torch.Tensor:
        return self.radius * self.radius

    @property
    def r_radius(self) -> torch.Tensor:
        return 1.0 / torch.where(self.radius != 0.0, self.radius, 1.0)

    def to(self, device) -> "WhittedScene":
        """The scene on ``device``: itself when it is there already, so that
        per-scene caches (K3's packed tables) keep hitting."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device == self.device:
            return self
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in FIELDS}
        )


class WhittedSceneBuilder:
    """Python-side builder mirroring scene.c's create_* helpers."""

    def __init__(self):
        self.rows = []

    def plane(self, color, refl, refr, refr_index, diff, spec, is_light, nx, ny, nz, depth):
        self.rows.append(dict(
            ptype=PLANE, is_light=bool(is_light), normal=(nx, ny, nz), depth=depth,
            center=(0.0, 0.0, 0.0), radius=0.0, color=color, refl=refl, diff=diff,
            refr=refr, refr_index=refr_index, spec=spec,
        ))
        return self

    def sphere(self, color, refl, refr, refr_index, diff, spec, is_light, cx, cy, cz, radius):
        self.rows.append(dict(
            ptype=SPHERE, is_light=bool(is_light), normal=(0.0, 0.0, 0.0), depth=0.0,
            center=(cx, cy, cz), radius=radius, color=color, refl=refl, diff=diff,
            refr=refr, refr_index=refr_index, spec=spec,
        ))
        return self

    def build(self, device=None) -> WhittedScene:
        device = resolve_device(device)
        r = self.rows
        tensors = {
            f: torch.from_numpy(np.array([x[f] for x in r], np.float32)).to(device)
            for f in FIELDS
        }
        return WhittedScene(
            **tensors,
            ptype=tuple(int(x["ptype"]) for x in r),
            is_light=tuple(bool(x["is_light"]) for x in r),
        )


def _mat(r, g, b_, refl, refr, refr_index, diff, spec):
    return dict(color=(r, g, b_), refl=refl, refr=refr, refr_index=refr_index, diff=diff,
                spec=spec)


def _adders(b: WhittedSceneBuilder):
    def plane(m, is_light, x, y, z, depth):
        b.plane(m["color"], m["refl"], m["refr"], m["refr_index"], m["diff"], m["spec"],
                is_light, x, y, z, depth)

    def sphere(m, is_light, x, y, z, rad):
        b.sphere(m["color"], m["refl"], m["refr"], m["refr_index"], m["diff"], m["spec"],
                 is_light, x, y, z, rad)

    return plane, sphere


def room_scene(device=None) -> WhittedScene:
    """Reference CHOOSE_SCENE 0 (scene.c:55-96): 16 primitives — a 6-plane
    room, 7 spheres (refractive/reflective mix) and 3 small sphere lights.
    Material arguments are (color..., refl, refr, refr_index, diff, spec),
    create_material's order."""
    b = WhittedSceneBuilder()
    plane, sphere = _adders(b)
    mat = _mat
    light = 0.85
    plane(mat(0.6, 0.6, 0.6, 0.0, 0.0, 0.0, 0.4, 1.8), False, 0.0, 0.75, 0.0, 4.4)  # floor
    sphere(mat(0.08, 0.08, 0.08, 0.2, 1.0, 1.4, 0.0, 0.0), False, 3.4, -3.4, 23.0, 2.5)  # big
    sphere(mat(0.07, 0.17, 0.07, 0.1, 1.0, 1.2, 0.0, 0.0), False, -0.7, -4.90, 27.0, 1.0)  # small 5
    sphere(mat(1.0, 1.0, 1.0, 0.8, 0.0, 0.0, 0.0, 0.0), False, -3.4, -3.4, 29.0, 2.5)  # small
    sphere(mat(1.5, 0.7, 0.7, 0.1, 0.0, 0.0, 0.2, 0.2), False, 0.5, -4.1, 29.0, 1.5)  # small 2
    sphere(mat(0.7, 0.7, 1.7, 0.2, 0.0, 0.0, 0.2, 0.2), False, -6.0, -4.1, 32.0, 1.5)  # small 3
    sphere(mat(0.07, 0.17, 0.07, 0.3, 1.0, 1.2, 0.2, 0.8), False, -6.7, -4.90, 29.0, 1.0)  # small 4
    sphere(mat(0.08, 0.08, 0.08, 0.7, 1.0, 1.3, 0.8, 0.0), False, 6.4, -4.9, 18.0, 1.0)  # small 6
    plane(mat(1.0, 0.6, 0.6, 0.0, 0.0, 0.0, 0.8, 1.5), False, 0.7, 0.0, 0.0, 5.4)  # left
    plane(mat(0.7, 0.6, 1.0, 0.0, 0.0, 0.0, 0.8, 0.8), False, -0.7, 0.0, 0.0, 5.4)  # right
    plane(mat(1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 1.2, 0.8), False, 0.0, -0.8, 0.0, 5.4)  # top
    plane(mat(1.5, 1.5, 1.5, 0.0, 0.0, 0.0, 1.2, 0.8), False, 0.0, 0.0, -0.14, 5.4)  # back
    plane(mat(0.1, 0.1, 0.1, 0.0, 0.0, 0.0, 1.0, 1.0), False, 0.0, 0.0, 0.72, 5.4)  # front
    sphere(mat(light, light, light, 0.0, 0.0, 0.0, 0.0, 1.8), True, 0.0, 6.5, 22.0, 0.35)  # light c
    sphere(mat(light, light, light, 0.0, 0.0, 0.0, 0.0, 1.8), True, -3.0, 6.5, 22.0, 0.35)  # light r
    sphere(mat(light, light, light, 0.0, 0.0, 0.0, 0.0, 1.8), True, 3.0, 6.5, 22.0, 0.35)  # light l
    return b.build(device)


def grid_scene(device=None) -> WhittedScene:
    """Reference CHOOSE_SCENE 1 (scene.c:98-124): 64 primitives — planes,
    a few feature spheres, 2 lights, and an 8x7 grid of small spheres."""
    b = WhittedSceneBuilder()
    plane, sphere = _adders(b)
    mat = _mat
    plane(mat(0.4, 0.3, 0.3, 0.0, 0.0, 1.0, 1.0, 0.8), False, 0.0, 1.0, 0.0, 4.4)  # floor
    sphere(mat(0.7, 0.7, 1.0, 0.0, 1.0, 1.3, 0.2, 0.8), False, 2.0, 0.8, 3.0, 2.5)  # big
    sphere(mat(0.7, 0.7, 1.0, 0.5, 0.0, 1.0, 0.1, 0.8), False, -5.5, -0.5, 7.0, 2.0)  # small
    sphere(mat(0.4, 0.4, 0.4, 0.0, 0.0, 1.0, 0.0, 0.0), True, 0.0, 5.0, 5.0, 0.1)  # light 1
    sphere(mat(0.6, 0.6, 0.8, 0.0, 0.0, 1.0, 0.0, 0.0), True, -3.0, 5.0, 1.0, 0.1)  # light 2
    sphere(mat(1.0, 0.4, 0.4, 0.5, 0.0, 1.0, 0.2, 0.8), False, -1.5, -3.8, 1.0, 1.5)  # sphere 3
    plane(mat(0.5, 0.3, 0.5, 0.0, 0.0, 1.0, 0.6, 0.0), False, 0.4, 0.0, -1.0, 12.0)  # back
    plane(mat(0.4, 0.7, 0.7, 0.0, 0.0, 1.0, 0.5, 0.0), False, 0.0, -1.0, 0.0, 7.4)  # ceiling
    for x in range(8):
        for y in range(7):
            sphere(mat(0.3, 1.0, 0.4, 0.0, 0.0, 1.0, 0.6, 0.6), False,
                   -4.5 + x * 1.5, -4.3 + y * 1.5, 10.0, 0.3)
    return b.build(device)


WHITTED_SCENES = {"room": room_scene, "grid": grid_scene}

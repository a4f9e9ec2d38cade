"""Scene types for the extended (raytracer5-family) Whitted tracer (twin of
se195_raytracer_tpu/scenes/whitted5_scenes.py).

raytracer5/trunk/scene.h:24-181: sphere, one-sided plane and axis-aligned box
primitives, the full material {color, refl, refr, refr_index, diff, spec,
drefl}, optional bilinear textures with UV scales, and box area lights
(Box::Light builds the 4x4 jittered shadow grid, scene.cpp:376-404).

Every numeric field is a float32 tensor on one device; the primitive types,
the light flags and the texture assignment are static tuples, because the
tracer's loops branch on them per primitive. Every array is bitwise the JAX
scene's.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from se195_raytracer_tpu_torch.core.types import resolve_device

SPHERE5 = 0
PLANE5 = 1
BOX5 = 2

# Box area-light 4x4 jittered grid cell origins, in units of size/4
# (the table of Box::Light, scene.cpp:381-396).
BOX_LIGHT_GRID = np.array(
    [
        (1, 2), (3, 3), (2, 0), (0, 1),
        (2, 3), (0, 3), (0, 0), (2, 2),
        (3, 1), (1, 3), (1, 0), (3, 2),
        (2, 1), (3, 0), (1, 1), (0, 2),
    ],
    np.float32,
)

# The float32 tensor fields, in the JAX scene's order.
FIELDS = ("center", "radius", "normal", "depth", "box_pos", "box_size", "color",
          "refl", "refr", "refr_index", "diff", "spec", "drefl", "uv_scale")


@dataclasses.dataclass(frozen=True)
class Whitted5Scene:
    # Geometry (fields of the other types are zero).
    center: torch.Tensor  # [N, 3] sphere center
    radius: torch.Tensor  # [N] sphere radius
    normal: torch.Tensor  # [N, 3] plane normal
    depth: torch.Tensor  # [N] plane D
    box_pos: torch.Tensor  # [N, 3] box min corner
    box_size: torch.Tensor  # [N, 3] box size
    # Material (raytracer5 Material, scene.h:43-76).
    color: torch.Tensor  # [N, 3]
    refl: torch.Tensor  # [N]
    refr: torch.Tensor  # [N]
    refr_index: torch.Tensor  # [N]
    diff: torch.Tensor  # [N]
    spec: torch.Tensor  # [N]
    drefl: torch.Tensor  # [N] diffuse (glossy) reflection radius
    uv_scale: torch.Tensor  # [N, 2]
    textures: Tuple[torch.Tensor, ...] = ()  # per texture, [Th, Tw, 3]
    # Static structure.
    ptype: Tuple[int, ...] = ()
    is_light: Tuple[bool, ...] = ()
    tex_id: Tuple[int, ...] = ()

    @property
    def num_prims(self) -> int:
        return len(self.ptype)

    @property
    def device(self) -> torch.device:
        return self.center.device

    def to(self, device) -> "Whitted5Scene":
        """The scene on ``device``: itself when it is there already, so that
        per-scene caches (K4's packed tables) keep hitting."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device == self.device:
            return self
        return dataclasses.replace(
            self,
            textures=tuple(t.to(device) for t in self.textures),
            **{f: getattr(self, f).to(device) for f in FIELDS},
        )


class Whitted5Builder:
    def __init__(self):
        self.rows = []
        self.textures = []

    def add_texture(self, bitmap: np.ndarray) -> int:
        self.textures.append(np.asarray(bitmap, np.float32))
        return len(self.textures) - 1

    def _row(self, ptype, **kw):
        base = dict(
            center=(0.0, 0.0, 0.0), radius=0.0,
            normal=(0.0, 0.0, 0.0), depth=0.0,
            box_pos=(0.0, 0.0, 0.0), box_size=(0.0, 0.0, 0.0),
            color=(0.2, 0.2, 0.2), refl=0.0, refr=0.0, refr_index=1.5,
            diff=0.2, spec=0.8, drefl=0.0, uv_scale=(1.0, 1.0),
            is_light=False, tex=-1,
        )
        base.update(kw)
        base["ptype"] = ptype
        self.rows.append(base)
        return self

    def sphere(self, centre, radius, **kw):
        return self._row(SPHERE5, center=tuple(centre), radius=radius, **kw)

    def plane(self, normal, d, **kw):
        return self._row(PLANE5, normal=tuple(normal), depth=d, **kw)

    def box(self, pos, size, **kw):
        return self._row(BOX5, box_pos=tuple(pos), box_size=tuple(size), **kw)

    def build(self, device=None) -> Whitted5Scene:
        device = resolve_device(device)
        r = self.rows

        def arr(k):
            return torch.from_numpy(np.array([x[k] for x in r], np.float32)).to(device)

        return Whitted5Scene(
            **{f: arr(f) for f in FIELDS},
            textures=tuple(torch.from_numpy(t).to(device) for t in self.textures),
            ptype=tuple(int(x["ptype"]) for x in r),
            is_light=tuple(bool(x["is_light"]) for x in r),
            tex_id=tuple(int(x["tex"]) for x in r),
        )


# The reference's texture assets (raytracer5/trunk/textures/{checker,marble,
# wood}.tga, loaded by Texture::Texture, scene.cpp:38-60) live in a checkout of
# the reference, outside this repository; SE195_REF_TEXTURES names that
# directory. Without it, textures="auto" takes the procedural stand-ins.
REF_TEXTURES_ENV = "SE195_REF_TEXTURES"


def ref_textures_dir() -> Optional[str]:
    return os.environ.get(REF_TEXTURES_ENV) or None


def load_ref_texture(name: str, textures_dir: Optional[str] = None) -> np.ndarray:
    """One of the reference's .tga assets, read with the reference's own
    decoder semantics (io/tga.py)."""
    from se195_raytracer_tpu_torch.io.tga import load_tga

    textures_dir = textures_dir or ref_textures_dir()
    if textures_dir is None:
        raise FileNotFoundError(f"set {REF_TEXTURES_ENV} to the reference's textures directory")
    return load_tga(os.path.join(textures_dir, f"{name}.tga"))


def checker_texture(size: int = 64, scale: int = 8) -> np.ndarray:
    """Procedural stand-in for textures/checker.tga."""
    ij = np.indices((size, size)).sum(axis=0) // scale
    c = (ij % 2).astype(np.float32)
    return np.stack([c, c, c], axis=-1) * 0.8 + 0.2


def marble_texture(size: int = 64, seed: int = 0) -> np.ndarray:
    """Procedural marble-ish texture (sine-warped noise, numpy PCG64)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    noise = rng.random((size, size)).astype(np.float32)
    for _ in range(3):  # cheap smoothing
        noise = 0.25 * (
            noise
            + np.roll(noise, 1, 0)
            + np.roll(noise, 1, 1)
            + np.roll(noise, (1, 1), (0, 1))
        )
    x = np.linspace(0, 4 * np.pi, size, dtype=np.float32)
    veins = 0.5 + 0.5 * np.sin(x[None, :] + 6.0 * noise)
    col = np.stack([veins, veins * 0.95, veins * 0.9], axis=-1)
    return (0.4 + 0.6 * col).astype(np.float32)


def room5_scene(textures: str = "auto", device=None,
                textures_dir: Optional[str] = None) -> Whitted5Scene:
    """The hard-coded raytracer5 room (Scene::InitScene, scene.cpp:415-542):
    checker-textured ground plane, marble-textured big sphere (scene.cpp:
    429,448), glossy sphere, degenerate third sphere, 3 box area lights, back
    plane, box pillar, bright box ceiling, refractive ceiling plane.

    textures: 'real' = the reference's .tga assets (``textures_dir`` or
    SE195_REF_TEXTURES), 'procedural' = the stand-ins, 'auto' = real when a
    textures directory is given."""
    textures_dir = textures_dir or ref_textures_dir()
    if textures == "auto":
        textures = "real" if textures_dir and os.path.isdir(textures_dir) else "procedural"
    b = Whitted5Builder()
    if textures == "real":
        checker = b.add_texture(load_ref_texture("checker", textures_dir))
        marble = b.add_texture(load_ref_texture("marble", textures_dir))
    elif textures == "procedural":
        checker = b.add_texture(checker_texture())
        marble = b.add_texture(marble_texture())
    else:
        raise ValueError(f"textures must be auto|real|procedural, got {textures!r}")
    b.plane((0, 1, 0), 4.4, refl=0.0, refr=0.0, diff=1.0, spec=0.5,
            color=(0.7, 0.7, 0.7), tex=checker, uv_scale=(0.45, 0.45))
    b.sphere((0, -0.8, 7), 2.0, refl=0.05, refr=0.0, refr_index=1.3,
             diff=0.5, spec=0.8, color=(2.7, 2.7, 3.0), tex=marble,
             uv_scale=(0.8, 0.8))
    b.sphere((-5, -0.8, 7), 2.0, refl=0.5, refr=0.0, refr_index=1.3,
             diff=0.1, color=(0.7, 0.7, 1.0), drefl=0.6)
    b.sphere((5, -0.8, 7), 0.0, refl=0.5, refr=0.0, refr_index=1.3,
             diff=0.1, color=(0.7, 0.7, 1.0))
    h = 5.0
    lc = (0.5, 0.5, 0.5)
    b.box((-1, h, 4), (2, 0.1, 2), is_light=True, color=lc)
    b.box((-6, h, 4), (2, 0.1, 2), is_light=True, color=lc)
    b.box((4, h, 4), (2, 0.1, 2), is_light=True, color=lc)
    b.plane((0, 0, -1), 10.4, refl=0.0, refr=0.0, diff=1.7,
            color=(0.4, 0.3, 0.3))
    b.box((4, -2, 0.5), (0.25, 3.5, 12), refl=0.2, refr=0.0, diff=0.1,
          color=(2.7, 2.7, 3.0))
    b.box((-15.0, h + 0.1, 2.5), (30.0, 0.25, 30.0), refl=0.0, refr=0.0,
          diff=0.0, color=(12.7, 12.7, 13.0))
    b.plane((0, 1, 0), 5.0, refl=0.0, refr=0.5, diff=0.0,
            color=(0.4, 0.3, 0.3))
    return b.build(device)


# Scene registry of the raytracer5 family (CLI --integrator whitted5 resolves
# --scene here; "room5" is Scene::InitScene, scene.cpp:415-542).
WHITTED5_SCENES = {
    "room5": lambda device=None: room5_scene(device=device),
    "room5_procedural": lambda device=None: room5_scene(textures="procedural", device=device),
}

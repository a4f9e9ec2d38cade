"""Core value types: sphere scene, camera, material constants.

Twin of se195_raytracer_tpu/core/types.py. The scene is a structure of
float32 tensors (the reference's ``Sphere {rad, p, e, c, refl}`` array in
SoA form) plus the static, ascending tuple of emissive sphere indices.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Tuple

import numpy as np
import torch

# Material ids — reference geom.h:36-40 (enum Refl { DIFF, SPEC, REFR }).
DIFF = 0
SPEC = 1
REFR = 2

# Reference geom.h:29 (#define EPSILON 0.01f) — smallpt intersection epsilon.
EPSILON = 0.01

FLOAT_PI = float(np.float32(np.pi))


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device. Raises when CUDA is asked for and no
    GPU is present: the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


@functools.lru_cache(maxsize=64)
def _device_copy(values: Tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    # A normal tensor even when first asked for under inference mode, so
    # that autograd may save it (``update_camera``'s ``up``).
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def device_copy(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, copied to the
    device once per (values, dtype, device) and kept: a copy from pageable
    host memory blocks the host until the stream's queued work is done, so
    a per-call copy would stall every launch that needs it. It never
    requires grad. Callers must not write to it."""
    return _device_copy(tuple(values), dtype, torch.device(device))


# The entries ``derived`` keeps, of every kind together.
DERIVED_ENTRIES = 32
# (kind, static, tensors, their versions, value), the most recently used last.
_DERIVED: list = []


def derived(kind: str, tensors: Tuple[torch.Tensor, ...], static: Tuple, build: Callable[[], Any]):
    """``build()``, made once and kept: a device table that launches only
    read (a scene's packed tables, a layout's lane tables). An entry is
    found by ``kind``, ``static`` (the static arguments, and the device
    where no tensor names it) and ``tensors``, those it is derived from, by
    identity; it is made again once one of them was written in place (its
    ``_version`` moved: Adam's update, ``mul_``; an inference tensor has no
    version and cannot be written outside inference mode). The last
    ``DERIVED_ENTRIES`` entries used are kept. Callers must not write to
    what it returns."""
    versions = tuple(None if t.is_inference() else t._version for t in tensors)
    for i, (k, s, ts, vs, value) in enumerate(_DERIVED):
        if k == kind and s == static and len(ts) == len(tensors) and all(
                a is b for a, b in zip(ts, tensors)):
            del _DERIVED[i]
            if vs == versions:
                _DERIVED.append((k, s, ts, vs, value))
                return value
            break
    value = build()
    _DERIVED.append((kind, static, tuple(tensors), versions, value))
    del _DERIVED[:-DERIVED_ENTRIES]
    return value


def _ref_is_zero_vec(e: np.ndarray) -> bool:
    """The reference's ``viszero`` macro, bug included.

    vec.h:44 reads ``(((v).x == 0.f) && ((v).x == 0.f) && ((v).z == 0.f))``
    — the y component is never tested (x is tested twice). A sphere with
    emission (0, 5, 0) is therefore *not* treated as a light by the
    reference. Replicated exactly so light classification matches.
    """
    return bool(e[0] == 0.0 and e[2] == 0.0)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the last axis (size 3), summed left to right, the
    order in which XLA and the CUDA kernel sum it: at the 1e4 scale of the
    Cornell walls the order moves the discriminant by ulps."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root. torch's vectorized CPU sqrt
    can miss by an ulp, which at the 1e4 scale of the Cornell walls moves a
    hit distance by 1e-3; the float64 root rounded to float32 is the IEEE
    float32 root (53 >= 2 * 24 + 2 bits), as XLA and CUDA compute it."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


class _TakeRows(torch.autograd.Function):
    """``table[idx]`` with a backward that sums each row's cotangents in
    bounded chunks of a [rows, lanes, cols] select and a sum over the lanes:
    deterministic, and a lane's NaN reaches only its own row."""

    @staticmethod
    def forward(table, idx):
        return table[idx]

    @staticmethod
    def setup_context(ctx, inputs, output):
        table, idx = inputs
        ctx.save_for_backward(idx)
        ctx.idx, ctx.rows = idx, table.shape[0]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        n = ctx.rows
        g = grad.reshape(grad.shape[0], -1)
        out = torch.zeros((n, g.shape[1]), dtype=grad.dtype, device=grad.device)
        rows = torch.arange(n, device=idx.device)[:, None]
        step = max(1, (1 << 24) // (n * g.shape[1]))
        for a in range(0, idx.shape[0], step):
            sel = rows == idx[None, a:a + step]  # [n, chunk]
            out = out + torch.where(sel[..., None], g[None, a:a + step], 0.0).sum(dim=1)
        return out.reshape((n,) + tuple(grad.shape[1:])), None

    @staticmethod
    def jvp(ctx, table_t, idx_t):
        return table_t[ctx.idx]


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``: a per-lane row of a small per-primitive table (a
    sphere's centre, emission, colour). The same values; when ``table``
    needs a gradient, the backward sums the cotangents of each row without
    the indexing backward, which on the GPU accumulates the duplicate
    indices of a few rows one after another (at Cornell 512², 85% of a
    gradient step's device time)."""
    if table.requires_grad and torch.is_grad_enabled():
        return _TakeRows.apply(table, idx)
    return table[idx]


def _f32(x: Any, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32), device=device)


@dataclasses.dataclass(frozen=True)
class Scene:
    """SoA sphere scene. ``refl`` holds the material id as float32 (0, 1, 2)
    so every field packs into one float table; ``light_indices`` is static
    structure (which spheres are emissive, ascending), because the
    reference's SampleLights (geomfunc.h:112-165) draws two RNG values per
    light in index order."""

    center: torch.Tensor  # [N, 3] float32
    radius: torch.Tensor  # [N]    float32
    emission: torch.Tensor  # [N, 3] float32
    color: torch.Tensor  # [N, 3] float32
    refl: torch.Tensor  # [N]    float32 — DIFF / SPEC / REFR
    light_indices: Tuple[int, ...] = ()

    @property
    def num_spheres(self) -> int:
        return self.center.shape[0]

    @property
    def device(self) -> torch.device:
        return self.center.device

    def to(self, device) -> "Scene":
        return dataclasses.replace(
            self,
            center=self.center.to(device),
            radius=self.radius.to(device),
            emission=self.emission.to(device),
            color=self.color.to(device),
            refl=self.refl.to(device),
        )

    @classmethod
    def from_arrays(cls, center, radius, emission, color, refl, device=None) -> "Scene":
        device = resolve_device(device)
        emission_np = np.asarray(emission, np.float32).reshape(-1, 3)
        lights = tuple(
            int(i)
            for i in range(emission_np.shape[0])
            if not _ref_is_zero_vec(emission_np[i])
        )
        return cls(
            center=_f32(center, device).reshape(-1, 3),
            radius=_f32(radius, device).reshape(-1),
            emission=_f32(emission_np, device),
            color=_f32(color, device).reshape(-1, 3),
            refl=_f32(refl, device).reshape(-1),
            light_indices=lights,
        )


@dataclasses.dataclass(frozen=True)
class Camera:
    """Camera pose: position + look-at target (reference camera.h:29-34)."""

    orig: torch.Tensor  # [3] float32
    target: torch.Tensor  # [3] float32

    @classmethod
    def look_at(cls, orig, target, device=None) -> "Camera":
        device = resolve_device(device)
        return cls(orig=_f32(orig, device), target=_f32(target, device))

    def to(self, device) -> "Camera":
        return Camera(self.orig.to(device), self.target.to(device))


@dataclasses.dataclass(frozen=True)
class CameraBasis:
    """Derived screen basis (reference displayfunc.cpp:182-195 UpdateCamera)."""

    orig: torch.Tensor  # [3]
    dir: torch.Tensor  # [3] normalized view direction
    x: torch.Tensor  # [3] screen-x axis, scaled by width*fov/height
    y: torch.Tensor  # [3] screen-y axis, scaled by fov


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def update_camera(camera: Camera, width: int, height: int) -> CameraBasis:
    """The screen basis exactly as displayfunc.cpp:182-195, in float32:
    fov = 45 degrees; x axis scaled by width*fov/height, y axis by fov.
    ``up`` is kept on the device (``device_copy``), so the call copies
    nothing from the host and never waits on the card."""
    d = camera.target - camera.orig
    d = d * (1.0 / sqrt_rn(dot3(d, d)))
    up = device_copy((0.0, 1.0, 0.0), torch.float32, d.device)
    fov = np.float32(np.pi / 180.0) * np.float32(45.0)
    cx = _cross(d, up)
    cx = cx * (1.0 / sqrt_rn(dot3(cx, cx)))
    cx = cx * float(np.float32(width) * fov / np.float32(height))
    cy = _cross(cx, d)
    cy = cy * (1.0 / sqrt_rn(dot3(cy, cy)))
    cy = cy * float(fov)
    return CameraBasis(orig=camera.orig, dir=d, x=cx, y=cy)


@dataclasses.dataclass(frozen=True)
class SceneSpec:
    """Host-side (numpy) scene description, placed on a device by
    ``to_scene`` / ``to_camera``."""

    camera_orig: np.ndarray
    camera_target: np.ndarray
    radius: np.ndarray
    center: np.ndarray
    emission: np.ndarray
    color: np.ndarray
    refl: np.ndarray

    def to_scene(self, device=None) -> Scene:
        return Scene.from_arrays(
            self.center, self.radius, self.emission, self.color, self.refl,
            device=device,
        )

    def to_camera(self, device=None) -> Camera:
        return Camera.look_at(self.camera_orig, self.camera_target, device=device)

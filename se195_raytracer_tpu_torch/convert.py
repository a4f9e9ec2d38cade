"""Carry scenes, cameras and render state across from the JAX package.

Each function takes the numpy arrays that ``np.asarray`` gives of the JAX
objects (``Scene`` fields, ``Camera`` fields, the ``render_pallas`` state),
so the port never imports JAX.

A ``render_pallas`` state has the shapes of ``render_cuda``'s for every
scene. Its lanes are in the layout both packages take for the scene
(``kernels/pt_kernel.ray_layout``): the identity for at most 96 spheres,
the blocked layout of K2 above, so a state carries across as it is and the
pixels of a blocked state are ``acc.reshape(3, -1)[:, inv]``.

A whitted5 scene carries across as its numeric fields, its textures and its
static tuples; its counter-RNG state is two uint32 arrays (key, counter) and
carries across as it is.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from se195_raytracer_tpu_torch.core.types import Camera, Scene, resolve_device
from se195_raytracer_tpu_torch.kernels.pt_kernel import LANES, PTState
from se195_raytracer_tpu_torch.scenes.whitted5_scenes import FIELDS as WHITTED5_FIELDS
from se195_raytracer_tpu_torch.scenes.whitted5_scenes import Whitted5Scene



def scene_from_numpy(center, radius, emission, color, refl, device=None) -> Scene:
    """Scene from the JAX ``Scene`` fields; ``light_indices`` is derived from
    the emission exactly as the JAX package derives it."""
    return Scene.from_arrays(center, radius, emission, color, refl, device=device)


def camera_from_numpy(orig, target, device=None) -> Camera:
    return Camera.look_at(orig, target, device=device)


def pallas_state_from_numpy(s0, s1, acc, sample, device=None) -> PTState:
    """``render_pallas`` state (s0 [Rp], s1 [Rp] uint32, acc
    [3, Rp/128, 128] float32, sample) -> ``render_cuda`` state."""
    device = resolve_device(device)
    s0 = np.array(s0, dtype=np.uint32)  # copies: JAX buffers are read-only
    s1 = np.array(s1, dtype=np.uint32)
    acc = np.array(acc, dtype=np.float32)
    rp = s0.shape[0]
    if s0.shape != (rp,) or s1.shape != (rp,) or acc.shape != (3, rp // LANES, LANES):
        raise ValueError(f"bad state shapes {s0.shape}, {s1.shape}, {acc.shape}")
    return (
        torch.from_numpy(s0).to(device),
        torch.from_numpy(s1).to(device),
        torch.from_numpy(acc).to(device),
        int(sample),
    )


def pallas_state_to_numpy(state: PTState) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """``render_cuda`` state -> numpy arrays that ``render_pallas`` takes
    (after ``jnp.asarray``)."""
    s0, s1, acc, sample = state
    return s0.cpu().numpy(), s1.cpu().numpy(), acc.cpu().numpy(), int(sample)


def whitted5_scene_from_numpy(fields, textures, ptype, is_light, tex_id,
                              device=None) -> Whitted5Scene:
    """Whitted5Scene from the JAX scene's arrays: ``fields`` maps each name of
    ``WHITTED5_FIELDS`` to ``np.asarray`` of the JAX field, ``textures`` the
    [Th, Tw, 3] bitmaps, then the static tuples as they are."""
    device = resolve_device(device)
    missing = set(WHITTED5_FIELDS) - set(fields)
    if missing:
        raise ValueError(f"missing fields {sorted(missing)}")
    return Whitted5Scene(
        **{f: torch.from_numpy(np.array(fields[f], dtype=np.float32)).to(device)
           for f in WHITTED5_FIELDS},
        textures=tuple(torch.from_numpy(np.array(t, dtype=np.float32)).to(device)
                       for t in textures),
        ptype=tuple(int(x) for x in ptype),
        is_light=tuple(bool(x) for x in is_light),
        tex_id=tuple(int(x) for x in tex_id),
    )


def whitted5_scene_to_numpy(scene: Whitted5Scene):
    """(fields, textures, ptype, is_light, tex_id) as numpy and tuples, the
    arguments of ``whitted5_scene_from_numpy`` (and of the JAX
    ``Whitted5Scene`` after ``jnp.asarray``)."""
    fields = {f: getattr(scene, f).cpu().numpy() for f in WHITTED5_FIELDS}
    textures = [t.cpu().numpy() for t in scene.textures]
    return fields, textures, scene.ptype, scene.is_light, scene.tex_id


def whitted5_state_from_numpy(key, ctr, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX (key, counter) uint32 state -> the port's (int64 words holding
    uint32)."""
    device = resolve_device(device)
    return tuple(torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64)).to(device)
                 for a in (key, ctr))


def whitted5_state_to_numpy(state) -> Tuple[np.ndarray, np.ndarray]:
    return tuple(s.cpu().numpy().astype(np.uint32) for s in state)

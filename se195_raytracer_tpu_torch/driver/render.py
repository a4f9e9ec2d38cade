"""Render driver: progressive accumulation and resumable state (twin of
se195_raytracer_tpu/driver/render.py).

Framebuffer convention: ``image[row, col]`` with row 0 = TOP of the image.
The reference's camera-space y counts up from the bottom, so row r maps to
camera y = height-1-r (the v-flip of rendering_kernel.cl:79).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from se195_raytracer_tpu_torch.core.config import RenderConfig
from se195_raytracer_tpu_torch.core.rng import MWCState
from se195_raytracer_tpu_torch.core.types import Camera, Scene, resolve_device, update_camera
from se195_raytracer_tpu_torch.kernels.seed_kernel import seed_lanes
from se195_raytracer_tpu_torch.models.smallpt import generate_camera_rays, radiance


class RenderState(NamedTuple):
    """Resumable progressive-render state of the plain path — the
    reference's ``(colors[], seeds[], currentSample)`` triple."""

    accum: torch.Tensor  # [R, 3] running-mean radiance
    s0: torch.Tensor  # [R] uint32
    s1: torch.Tensor  # [R] uint32
    sample: int  # currentSample


def pixel_coords(width: int, height: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flattened (x, y) camera coordinates in framebuffer row-major order:
    index i = row*width + col; x = col, y = height-1-row."""
    rows = torch.arange(height, dtype=torch.int32, device=device)
    cols = torch.arange(width, dtype=torch.int32, device=device)
    return cols.repeat(height), (height - 1 - rows).repeat_interleave(width)


def _sample_once(scene, basis, config: RenderConfig, xs, ys, state: MWCState,
                 remat: bool = False):
    """One progressive pass: camera rays + radiance, in ``ray_tile`` chunks,
    with ``config.soft_edges``; ``remat`` checkpoints each bounce
    (``radiance``)."""
    n = xs.shape[0]
    tile = config.ray_tile or n
    if n % tile != 0:
        raise ValueError(f"ray_tile {tile} must divide pixel count {n}")
    rads, s0s, s1s = [], [], []
    for a in range(0, n, tile):
        sl = slice(a, a + tile)
        o, d, st = generate_camera_rays(
            basis, (state[0][sl], state[1][sl]), config.width, config.height,
            xs[sl], ys[sl], config.rng,
        )
        r, st = radiance(
            scene, o, d, st, config.max_depth, config.integrator == "dl", config.rng,
            remat=remat, soft_edges=config.soft_edges,
        )
        rads.append(r)
        s0s.append(st[0])
        s1s.append(st[1])
    return torch.cat(rads), (torch.cat(s0s), torch.cat(s1s))


def init_render_state(config: RenderConfig, device=None) -> RenderState:
    """Fresh plain-path state: the seeds of ``init_state`` in pixel order,
    drawn by ``seed_lanes`` (the seed kernel on a CUDA device, numpy on the
    CPU; ``device=None`` is the CPU)."""
    n = config.width * config.height
    device = torch.device("cpu" if device is None else device)
    s0, s1 = seed_lanes(config.rng, config.seed, n, n, device=device)
    return RenderState(
        accum=torch.zeros((n, 3), dtype=torch.float32, device=device),
        s0=s0,
        s1=s1,
        sample=0,
    )


def render_steps(
    scene: Scene,
    camera: Camera,
    state: RenderState,
    config: RenderConfig,
    num_samples: int,
    pixel_range: Optional[Tuple[int, int]] = None,
) -> RenderState:
    """Advance the plain-path progressive render by ``num_samples`` passes.
    ``pixel_range=(lo, hi)``: the state holds pixels lo..hi-1 only (a shard
    of a sharded render), which trace their own absolute pixel ids."""
    basis = update_camera(camera, config.width, config.height)
    xs, ys = pixel_coords(config.width, config.height, device=state.accum.device)
    if pixel_range is not None:
        xs, ys = xs[pixel_range[0]:pixel_range[1]], ys[pixel_range[0]:pixel_range[1]]
    accum, s0, s1, sample = state
    for _ in range(num_samples):
        r, (s0, s1) = _sample_once(scene, basis, config, xs, ys, (s0, s1))
        if sample == 0:
            accum = r
        else:
            k1 = np.float32(sample)
            k2 = float(np.float32(1.0) / (k1 + np.float32(1.0)))
            accum = (accum * float(k1) + r) * k2
        sample += 1
    return RenderState(accum, s0.to(torch.uint32), s1.to(torch.uint32), sample)


def render(
    scene: Scene,
    camera: Camera,
    config: RenderConfig,
    state=None,
    device=None,
):
    """Render ``config.spp`` samples; returns ([H, W, 3] radiance, state).

    Pass the returned state back in to continue accumulating. With
    ``config.use_kernel`` the passes run in the CUDA kernel
    (kernels/pt_kernel.render_cuda), whose state is (s0, s1, acc, sample);
    otherwise in the plain PyTorch integrator, whose state is a
    ``RenderState``. ``device=None`` means CUDA, and raises when no GPU is
    present; pass ``device="cpu"`` to run on the CPU.

    ``config.soft_edges > 0`` (the relaxed estimator) runs on the plain path
    only: with ``use_kernel`` it raises, since the kernels implement the
    hard estimator (``render_cuda``). Gradients:
    ``driver.optimize.render_differentiable``."""
    device = resolve_device(device)
    if config.use_kernel:
        from se195_raytracer_tpu_torch.kernels.pt_kernel import render_cuda

        return render_cuda(scene, camera, config, state=state, device=device)
    scene, camera = scene.to(device), camera.to(device)
    if state is None:
        state = init_render_state(config, device=device)
    state = render_steps(scene, camera, state, config, config.spp)
    return state.accum.reshape(config.height, config.width, 3), state


def render_image(scene: Scene, camera: Camera, config: RenderConfig, device=None) -> np.ndarray:
    """Render ``config.spp`` samples and return the image as a host numpy
    [H, W, 3] float32 array (twin of the JAX ``render_image``)."""
    img, _ = render(scene, camera, config, device=device)
    return img.cpu().numpy()

"""The gradient metric and the inverse-rendering setup of the full-frame
gradient benchmark (twin of the pieces of tools/grad_bench.py that
``chip_smoke.py`` and ``tools/grad_bench_torch.py`` share).

* ``pixel_grad_check``: the per-pixel gradient field d(img)/d(theta) by
  forward-mode AD, against central finite differences of the same forward
  ("pixel-grad max-err vs finite diff", BASELINE.json).
* ``grad_bench_start``: the start of the recovery run, the Cornell scene
  with its ceiling light moved by (8, -5, 0) and its left wall tinted
  (0.3, 0.6, 0.3) (examples/inverse_rendering.py's perturbation).
* ``GroupAdam``: optax's ``multi_transform`` of
  ``chain(zero_nans, clip_by_global_norm, adam(cosine_decay_schedule))``
  per parameter group, on ``torch.optim.Adam``.
* ``light_capsule_mask``: the pixels whose primary ray can see the light
  anywhere along the path from its start to its true position; the loss
  over the rest is the component the hard estimator can descend.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from se195_raytracer_tpu_torch.core.config import RenderConfig
from se195_raytracer_tpu_torch.core.types import Camera, Scene, update_camera
from se195_raytracer_tpu_torch.driver.optimize import _render_plain_diff
from se195_raytracer_tpu_torch.driver.render import pixel_coords

# The six checks of the gradient benchmark: (label, scene field, index,
# finite-difference step). Emission and albedo enter the estimator
# (near-)linearly; the light's centre moves shadows and silhouettes.
PIXEL_CHECKS = (
    ("light emission r", "emission", (8, 0), 1e-2),
    ("wall albedo g", "color", (0, 1), 1e-3),
    ("light center y", "center", (8, 1), 1e-2),
)
START_LIGHT = 8
START_LIGHT_MOVE = (8.0, -5.0, 0.0)
START_WALL = 0
START_WALL_COLOR = (0.3, 0.6, 0.3)


def pixel_grad_check(scene: Scene, camera: Camera, config: RenderConfig, param: str,
                     idx: Tuple[int, ...], eps: float, soft: float = 0.0):
    """(max_abs_err, p99_abs_err, fd_scale, jvp_img) over all pixels: the JVP
    of ``_render_plain_diff`` (remat off: forward mode keeps no tape) along
    the unit tangent of ``getattr(scene, param)[idx]``, against the central
    difference (f(x + eps) - f(x - eps)) / (2 eps) of the SAME plain forward,
    both with ``soft_edges = soft``. The finite difference must difference
    the estimator that the JVP differentiates, not the kernel's forward,
    whose ulp-level drift divided by 2 eps would pass for gradient error."""
    cfg = dataclasses.replace(config, use_kernel=False, soft_edges=soft)
    arr = getattr(scene, param).detach()
    tangent = torch.zeros_like(arr)
    tangent[idx] = 1.0

    def f(a):
        return _render_plain_diff(dataclasses.replace(scene, **{param: a}), camera, cfg,
                                  remat=False)

    _, jvp_img = torch.func.jvp(f, (arr,), (tangent,))
    up = f(arr + eps * tangent)
    dn = f(arr - eps * tangent)
    fd = ((up - dn) / (2.0 * eps)).cpu().numpy()
    err = np.abs(jvp_img.cpu().numpy() - fd)
    scale = float(np.abs(fd).max()) or 1.0
    return float(err.max()), float(np.percentile(err, 99)), scale, jvp_img


def grad_bench_start(scene: Scene) -> Scene:
    """The recovery run's start: light ``START_LIGHT`` moved by
    ``START_LIGHT_MOVE``, sphere ``START_WALL`` coloured
    ``START_WALL_COLOR``."""
    center = scene.center.detach().clone()
    color = scene.color.detach().clone()
    center[START_LIGHT] += torch.tensor(START_LIGHT_MOVE, device=center.device)
    color[START_WALL] = torch.tensor(START_WALL_COLOR, device=color.device)
    return dataclasses.replace(scene, center=center, color=color)


class GroupAdam:
    """Per group of parameters, optax's ``chain(zero_nans(),
    clip_by_global_norm(max_norm), adam(cosine_decay_schedule(lr, steps,
    alpha)))``: NaN gradients become 0; a group whose gradient norm is at
    least ``max_norm`` is scaled to it; Adam's rate at its n-th update is
    lr * ((1 - alpha) * (1 + cos(pi * min(n, steps) / steps)) / 2 + alpha).
    ``torch.optim.Adam`` is optax's adam (b1 0.9, b2 0.999, eps 1e-8
    outside the square root). ``groups``: name -> (tensors, lr)."""

    def __init__(self, groups: Dict[str, Tuple[Sequence[torch.Tensor], float]], steps: int,
                 alpha: float, max_norm: float = 10.0):
        self.opt = torch.optim.Adam(
            [{"params": list(ps), "lr": lr, "base_lr": lr} for ps, lr in groups.values()])
        self.steps, self.alpha, self.max_norm, self.count = steps, alpha, max_norm, 0

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.opt.zero_grad(set_to_none=set_to_none)

    def rate_factor(self, n: int) -> float:
        c = min(n, self.steps)
        return (1.0 - self.alpha) * 0.5 * (1.0 + math.cos(math.pi * c / self.steps)) + self.alpha

    def step(self) -> None:
        factor = self.rate_factor(self.count)
        for group in self.opt.param_groups:
            grads: List[torch.Tensor] = [p.grad for p in group["params"] if p.grad is not None]
            for g in grads:
                g.masked_fill_(torch.isnan(g), 0.0)
            if grads:
                norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                scale = torch.where(norm < self.max_norm, 1.0, self.max_norm / norm)
                for g in grads:
                    g.mul_(scale)
            group["lr"] = group["base_lr"] * factor
        self.opt.step()
        self.count += 1


def light_capsule_mask(scene_true: Scene, scene0: Scene, camera: Camera, width: int,
                       height: int, li: int, margin: float = 1.4, nseg: int = 17) -> np.ndarray:
    """Boolean [H, W] numpy mask of the pixels whose primary ray (through
    the pixel centre) can see light ``li``'s disk anywhere on the segment
    from its centre in ``scene0`` to that in ``scene_true``, its angular
    radius widened by ``margin`` (and 0.01 rad)."""
    basis = update_camera(camera, width, height)
    xs, ys = pixel_coords(width, height)
    kcx = (xs.numpy().astype(np.float32) + 0.5) / width - 0.5
    kcy = (ys.numpy().astype(np.float32) + 0.5) / height - 0.5
    bdir = basis.dir.detach().cpu().numpy()
    bx, by = basis.x.detach().cpu().numpy(), basis.y.detach().cpu().numpy()
    d = bdir[None] + bx[None] * kcx[:, None] + by[None] * kcy[:, None]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    orig = basis.orig.detach().cpu().numpy()
    c0 = scene0.center[li].detach().cpu().numpy()
    c1 = scene_true.center[li].detach().cpu().numpy()
    rad = float(scene_true.radius[li])
    mask = np.zeros(d.shape[0], bool)
    for t in np.linspace(0.0, 1.0, nseg):
        v = c0 + t * (c1 - c0) - orig
        dist = np.linalg.norm(v)
        ang = np.arccos(np.clip((d @ v) / dist, -1.0, 1.0))
        mask |= ang < np.arcsin(min(rad / dist, 1.0)) * margin + 0.01
    return mask.reshape(height, width)

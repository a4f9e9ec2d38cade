"""Inverse rendering: recover scene parameters from a target image (twin of
se195_raytracer_tpu/driver/optimize.py).

The differentiable form of the reference's interactive edit loop
(displayfunc.cpp:252-420, smallptGPU.cpp:784-830: keystrokes move the camera
and spheres, then re-render). Here the edits are gradients: render with
fixed RNG streams, take the L2 against the target, and let an optimizer
update any subset of the scene's and the camera's tensors.

Hit/miss and shadow predicates are step functions, so silhouette pixels
carry no (or biased) gradient under the hard estimator; interior shading,
material colours, emission and smooth geometry terms differentiate
exactly. ``RenderConfig.soft_edges > 0`` relaxes the two step functions
(models/smallpt.py) so that silhouettes carry gradients too.

With ``config.use_kernel`` and the hard estimator, the forward runs in the
hand-written kernel (K1 or K2). The JAX package pairs its Pallas forward
with the VJP of its jnp path, one fused XLA program; here the backward is
K1b (``kernels/pt_backward_kernel.pt_backward_cuda``, which replays the
plain path from the same seeds and sweeps its bounces in reverse) where
``k1b_takes``, else the autograd of the plain path recomputed from the same
seeds (``_KernelForward``). The relaxed estimator (``soft_edges > 0``) runs
the plain path both ways.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from se195_raytracer_tpu_torch.core.config import RenderConfig
from se195_raytracer_tpu_torch.core.types import (
    Camera,
    CameraBasis,
    Scene,
    resolve_device,
    update_camera,
)
from se195_raytracer_tpu_torch.driver.render import _sample_once, pixel_coords
from se195_raytracer_tpu_torch.kernels.seed_kernel import seed_lanes
from se195_raytracer_tpu_torch.utils.profiling import span

# The trainable leaves, by field name, in the order the kernel-forward
# Function takes them.
SCENE_LEAVES = ("center", "radius", "emission", "color")
CAMERA_LEAVES = ("orig", "target")
LEAVES = SCENE_LEAVES + CAMERA_LEAVES


def render_differentiable(
    scene: Scene,
    camera: Camera,
    config: RenderConfig,
    seed: Optional[int] = None,
    device=None,
    pixels: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Differentiable render with FIXED RNG streams (the same seeds every
    call, so the loss surface is deterministic). Returns [H, W, 3], or with
    ``pixels=(lo, hi)`` the [hi - lo, 3] rows of the row-major pixels
    lo..hi-1 only, forward and recompute both (a shard of a sharded
    gradient, ``parallel.render_sharded.l2_image_loss_sharded``).

    With ``config.use_kernel`` and ``soft_edges == 0`` the forward runs in
    the kernel (``kernels/pt_kernel.render_cuda``; on CPU tensors its plain
    version) and the backward as ``_KernelForward`` routes it. Otherwise
    both directions run ``_render_plain_diff``: the kernels implement the
    hard estimator, and the relaxation must be the same in forward and
    backward.

    ``device=None`` means CUDA (and raises without a GPU); the scene and
    camera are moved there, which autograd follows."""
    device = resolve_device(device)
    scene, camera = scene.to(device), camera.to(device)
    if seed is not None and seed != config.seed:
        config = dataclasses.replace(config, seed=seed)
    if config.use_kernel and config.soft_edges == 0.0:
        return _KernelForward.apply(
            *(getattr(scene, k) for k in SCENE_LEAVES),
            *(getattr(camera, k) for k in CAMERA_LEAVES),
            scene.refl, scene.light_indices, config, pixels,
        )
    return _render_plain_diff(scene, camera, config, pixels=pixels)


def _render_plain_diff(
    scene: Scene,
    camera: Camera,
    config: RenderConfig,
    seed: Optional[int] = None,
    remat: bool = True,
    pixels: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """The plain differentiable render (twin of ``_render_jnp_diff``):
    ``config.spp`` passes with the running mean ``(accum * k + r) / (k + 1)``
    (a division, as the JAX package writes it, where the kernels multiply
    by the reciprocal), each bounce checkpointed when ``remat``.

    It is seeded with ``init_state(config.rng, ...)``'s words, drawn by
    ``seed_lanes`` (the seed kernel on a CUDA device, only for the rows it
    renders). The JAX package seeds
    its recompute with the MWC generator whatever ``config.rng`` says, so
    under ``rng="counter"`` its backward differentiates another stream than
    its kernel forward evaluated; here the two draw the same stream. Take a
    forward-mode JVP with ``remat=False``. ``pixels=(lo, hi)`` renders only
    the rows lo..hi-1, from the seeds the whole frame gives them, and
    returns [hi - lo, 3]."""
    return _render_plain_basis(scene, update_camera(camera, config.width, config.height), config,
                               seed, remat, pixels)


def _render_plain_basis(
    scene: Scene,
    basis: CameraBasis,
    config: RenderConfig,
    seed: Optional[int] = None,
    remat: bool = True,
    pixels: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """``_render_plain_diff`` from the camera basis on (``update_camera``'s
    output): what K1b differentiates, and its plain version differentiates
    (``kernels/pt_backward_kernel.pt_backward_reference``)."""
    dev = scene.center.device
    xs, ys = pixel_coords(config.width, config.height, device=dev)
    n = config.width * config.height
    lo, hi = (0, n) if pixels is None else pixels
    state = seed_lanes(config.rng, config.seed if seed is None else seed, n, hi - lo,
                       lane_offset=lo, device=dev)
    if pixels is not None:
        xs, ys = xs[lo:hi], ys[lo:hi]
    accum = torch.zeros((hi - lo, 3), dtype=torch.float32, device=dev)
    for k in range(config.spp):
        r, state = _sample_once(scene, basis, config, xs, ys, state, remat=remat)
        accum = (accum * float(k) + r) / (float(k) + 1.0)
    return accum if pixels is not None else accum.reshape(config.height, config.width, 3)


class _KernelForward(torch.autograd.Function):
    """Forward: the kernel render (``render_cuda``). Backward (the twin of
    ``_render_pallas_diff_bwd``), a static route
    (``pt_backward_kernel.k1b_takes``):

    * where K1b takes it: K1b (``pt_backward_cuda``: one seeding and one
      launch, no plain ``radiance``) gives the scene's and the camera
      basis's gradients, and ``torch.autograd.grad`` of ``update_camera``
      carries the basis's to the camera's ``orig`` and ``target``. A K1b
      build or launch that fails raises;
    * otherwise (the CPU, K2's scenes, deeper paths than K1b records):
      under ``torch.enable_grad()``, ``_render_plain_diff`` re-run on
      detached copies of the leaves, from the same seeds, and
      ``torch.autograd.grad(img, leaves, grad_out)``.

    The scene's and the camera's tensors are separate arguments: autograd
    does not look inside a dataclass. ``refl``, ``light_indices``, the
    config and ``pixels`` (None, or the (lo, hi) rows of a shard) are
    static."""

    @staticmethod
    def forward(ctx, center, radius, emission, color, orig, target, refl, light_indices, config,
                pixels):
        from se195_raytracer_tpu_torch.kernels.pt_kernel import render_cuda

        scene = Scene(center, radius, emission, color, refl, light_indices)
        img, _ = render_cuda(scene, Camera(orig, target), config, device=center.device,
                             pixels=pixels)
        ctx.save_for_backward(center, radius, emission, color, orig, target)
        ctx.refl, ctx.light_indices, ctx.config, ctx.pixels = refl, light_indices, config, pixels
        return img

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        from se195_raytracer_tpu_torch.kernels.pt_backward_kernel import k1b_takes

        needs = ctx.needs_input_grad[:len(LEAVES)]
        center = ctx.saved_tensors[0]
        if k1b_takes(center.device, center.shape[0], ctx.config.max_depth, ctx.config.soft_edges):
            with span("k1b.backward"):
                return (*_k1b_backward(ctx, grad_out, needs), None, None, None, None)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, needs)]
            scene = Scene(*leaves[:4], ctx.refl, ctx.light_indices)
            img = _render_plain_diff(scene, Camera(*leaves[4:]), ctx.config, pixels=ctx.pixels)
            wanted = [t for t, need in zip(leaves, needs) if need]
            grads = iter(torch.autograd.grad(img, wanted, grad_out, allow_unused=True))
        out = [next(grads) if need else None for need in needs]
        return (*out, None, None, None, None)


def _k1b_backward(ctx, grad_out, needs):
    """The leaves' gradients by K1b: the scene's from its flat gradient, the
    camera's by the autograd of ``update_camera`` (about 20 ops on [3]
    vectors) from the basis's; spans ``k1b.camera`` and ``k1b.launch``
    (autograd's thread, inside ``k1b.backward``)."""
    from se195_raytracer_tpu_torch.kernels.pt_backward_kernel import (
        BASIS_FIELDS,
        pt_backward_cuda,
        unpack_grad,
    )

    center, radius, emission, color, orig, target = ctx.saved_tensors
    scene = Scene(center, radius, emission, color, ctx.refl, ctx.light_indices)
    cfg = ctx.config
    with span("k1b.camera"), torch.enable_grad():
        cam = [t.detach().requires_grad_(need) for t, need in zip((orig, target), needs[4:])]
        basis = update_camera(Camera(*cam), cfg.width, cfg.height)
    detached = CameraBasis(*(getattr(basis, k).detach() for k in BASIS_FIELDS))
    with span("k1b.launch"):
        flat = pt_backward_cuda(scene, detached, cfg, grad_out, ctx.pixels)
    g = unpack_grad(flat, center.shape[0])
    out = [g[k] if need else None for k, need in zip(SCENE_LEAVES, needs)]
    wanted = [t for t in cam if t.requires_grad]
    if wanted:
        with span("k1b.camera"), torch.enable_grad():
            outs = [(getattr(basis, k), g[k]) for k in BASIS_FIELDS
                    if getattr(basis, k).requires_grad]
            cam_grads = iter(torch.autograd.grad([o for o, _ in outs], wanted,
                                                 [v for _, v in outs], allow_unused=True))
    return out + [next(cam_grads) if t.requires_grad else None for t in cam]


def l2_image_loss(scene: Scene, camera: Camera, target: torch.Tensor, config: RenderConfig,
                  device=None) -> torch.Tensor:
    img = render_differentiable(scene, camera, config, device=device)
    return torch.mean((img - target) ** 2)


class OptState(NamedTuple):
    scene: Scene
    camera: Camera
    opt_state: Optional[torch.optim.Optimizer]  # None until the first step makes it
    loss: Optional[torch.Tensor]  # the loss before the last update


def split(scene: Scene, camera: Camera, param_filter: Callable[[str], bool]) -> Dict[str, torch.Tensor]:
    """The trainable leaves selected by ``param_filter``, by field name
    ('center', 'radius', 'emission', 'color', 'orig', 'target'). ``refl``
    never trains."""
    fields = {**{k: getattr(scene, k) for k in SCENE_LEAVES},
              **{k: getattr(camera, k) for k in CAMERA_LEAVES}}
    return {k: v for k, v in fields.items() if param_filter(k)}


def merge(scene: Scene, camera: Camera, trainable: Dict[str, torch.Tensor]) -> Tuple[Scene, Camera]:
    """``scene`` and ``camera`` with the leaves of ``trainable`` in place."""
    scene = dataclasses.replace(scene, **{k: v for k, v in trainable.items() if k in SCENE_LEAVES})
    cam_kw = {k: v for k, v in trainable.items() if k in CAMERA_LEAVES}
    if cam_kw:
        camera = dataclasses.replace(camera, **cam_kw)
    return scene, camera


def make_inverse_step(
    target: torch.Tensor,
    config: RenderConfig,
    optimizer: Callable[[Dict[str, torch.Tensor]], torch.optim.Optimizer],
    param_filter: Callable[[str], bool] = lambda name: True,
    device=None,
) -> Callable[[OptState], OptState]:
    """One optimization step over (scene, camera): ``st.loss`` is the loss AT
    the parameters ``st`` held before the update. The trainable leaves are
    ``split`` by ``param_filter``, cloned into leaf tensors the first time
    (so the caller's scene is never written) and updated in place after.
    ``optimizer(trainable)`` makes the torch optimizer when ``st.opt_state``
    is None (``torch.optim.Adam`` is optax's adam: eps outside the square
    root, bias-corrected moments)."""

    def step(st: OptState) -> OptState:
        with span("opt.step"):
            trainable = split(st.scene, st.camera, param_filter)
            opt = st.opt_state
            if opt is None:
                trainable = {k: v.detach().clone().requires_grad_(True)
                             for k, v in trainable.items()}
                opt = optimizer(trainable)
            scene, camera = merge(st.scene, st.camera, trainable)
            opt.zero_grad(set_to_none=True)
            with span("opt.forward"):
                loss = l2_image_loss(scene, camera, target, config, device=device)
            with span("opt.backward"):
                loss.backward()
            with span("opt.update"):
                opt.step()
            return OptState(scene, camera, opt, loss.detach())

    return step


def run_inverse_rendering(
    scene0: Scene,
    camera0: Camera,
    target: torch.Tensor,
    config: RenderConfig,
    steps: int = 100,
    learning_rate: float = 1e-2,
    param_filter: Callable[[str], bool] = lambda name: True,
    log_every: int = 0,
    device=None,
) -> OptState:
    """``steps`` Adam steps from (scene0, camera0) towards ``target``; the
    returned state holds the parameters after the last update and the loss
    before it."""
    st = OptState(scene0, camera0, None, torch.zeros(()))
    step = make_inverse_step(target, config,
                             lambda tr: torch.optim.Adam(list(tr.values()), lr=learning_rate),
                             param_filter, device=device)
    for i in range(steps):
        st = step(st)
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"step {i:4d}  loss {float(st.loss):.6e}")
    return st

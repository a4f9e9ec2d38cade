"""Sharded and multi-process rendering (twin of
se195_raytracer_tpu/parallel/render_sharded.py).

The reference never left devices[0] (smallptGPU.cpp:463-467). Here the
pixel (or ray) axis is split into the contiguous lane ranges of a
``parallel.mesh.Mesh``, the scene is replicated, and every shard renders
its range with ABSOLUTE pixel or ray ids: the seeds are drawn over the
whole frame and then sliced, K1 takes the shard's first lane id as its
lane offset, K2 reads absolute ids from its pix table, and the Whitted
families make a shard's rays from the absolute ray index. The forward
pass therefore needs no communication and the frame, the shards' outputs
in shard order (concatenated in-process, ``all_gather`` across
processes), is bitwise the single-device render. Gradients of a loss over
the pixels are sums of the shards' gradients: ``all_reduce(SUM)`` across
processes, a sum over shards in-process (where the JAX package's XLA
inserts a ``psum``).

A sharded state holds the lanes of this process's shards in shard order:
the whole frame in-process, the rank's own shard across processes.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import torch

from se195_raytracer_tpu_torch.core.config import RenderConfig
from se195_raytracer_tpu_torch.core.types import Camera, Scene
from se195_raytracer_tpu_torch.driver.render import RenderState, render_steps
from se195_raytracer_tpu_torch.kernels.seed_kernel import seed_lanes
from se195_raytracer_tpu_torch.parallel.mesh import (
    Mesh,
    gather_shards,
    make_mesh,
    replicate,
    shard_bounds,
    sum_across,
)


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "gloo",
) -> None:
    """Bring up ``torch.distributed`` for a render over several processes.
    Call once per process before building ``make_mesh(process_group=True)``.

    ``coordinator_address`` is ``host:port`` of rank 0 (``tcp://`` init);
    None reads ``MASTER_ADDR``/``MASTER_PORT``, and unset counts read
    ``WORLD_SIZE``/``RANK``, as ``torchrun`` sets them. The default backend
    is gloo: it runs on the CPU, and it takes several ranks on one GPU,
    which NCCL refuses; across GPUs pass ``backend="nccl"``."""
    import torch.distributed as dist

    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    init = "env://" if coordinator_address is None else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id)


def _local(t: torch.Tensor, mesh: Mesh, dim: int = 0):
    """``t``'s lanes (along ``dim``) of each local shard: ``t`` holds the
    local shards' lanes in shard order."""
    per = t.shape[dim] // len(mesh.local_shards)
    return [t.narrow(dim, i * per, per) for i in range(len(mesh.local_shards))]


def render_sharded(
    scene: Scene,
    camera: Camera,
    config: RenderConfig,
    mesh: Optional[Mesh] = None,
    state: Optional[RenderState] = None,
):
    """Progressive render on the plain path with the pixel axis sharded over
    ``mesh`` (default: every CUDA device). Returns ([H, W, 3] radiance,
    state); pass the state back to continue. Raises ValueError when the
    shards do not divide the pixel count."""
    if mesh is None:
        mesh = make_mesh()
    n = config.width * config.height
    bounds = shard_bounds(n, mesh)
    if state is None:
        # Each shard seeds its own pixels on its own device.
        parts, sample = [], 0
        for k in mesh.local_shards:
            dev, (lo, hi) = mesh.devices[k], bounds[k]
            s0, s1 = seed_lanes(config.rng, config.seed, n, hi - lo, lane_offset=lo, device=dev)
            parts.append((torch.zeros((hi - lo, 3), dtype=torch.float32, device=dev), s0, s1))
    else:
        parts, sample = zip(_local(state.accum, mesh), _local(state.s0, mesh),
                            _local(state.s1, mesh)), state.sample
    scenes, cams = replicate(scene, mesh), replicate(camera, mesh)
    outs = []
    for k, (accum, s0, s1) in zip(mesh.local_shards, parts):
        dev = mesh.devices[k]
        st = RenderState(accum.to(dev), s0.to(dev), s1.to(dev), sample)
        outs.append(render_steps(scenes[dev], cams[dev], st, config, config.spp,
                                 pixel_range=bounds[k]))
    dev0 = mesh.devices[mesh.local_shards[0]]
    img = gather_shards([o.accum for o in outs], mesh).reshape(config.height, config.width, 3)
    new_state = RenderState(*(torch.cat([getattr(o, f).to(dev0) for o in outs])
                              for f in ("accum", "s0", "s1")), outs[0].sample)
    return img, new_state


def render_cuda_sharded(
    scene: Scene,
    camera: Camera,
    config: RenderConfig,
    mesh: Optional[Mesh] = None,
    state=None,
):
    """Progressive render through K1 or K2 with the lanes sharded over
    ``mesh`` (twin of ``render_pallas_sharded``): one launch per shard, on
    each device ``render_cuda``'s frame (``prepare_frame``) in whole tiles
    a shard. Each shard seeds only its own lanes, on its own device, from
    the whole frame's stream (``Layout.seed``), and traces absolute pixel
    ids, so the image is bitwise ``render_cuda``'s.

    Returns ([H, W, 3] radiance, (s0, s1, acc, sample)); the state holds
    the lanes of this process's shards. CPU tensors run the kernels' plain
    version."""
    from se195_raytracer_tpu_torch.kernels.pt_kernel import LANES, prepare_frame, trace_lanes

    if mesh is None:
        mesh = make_mesh()
    scenes, cams = replicate(scene, mesh), replicate(camera, mesh)
    frames = {dev: prepare_frame(scenes[dev], cams[dev], config, mesh.size, dev)
              for dev in scenes}
    dev0 = mesh.devices[mesh.local_shards[0]]
    layout = frames[dev0].layout
    per = layout.rp // mesh.size
    if state is None:
        # Each shard seeds only its own lanes, on its own device.
        parts, start = [frames[mesh.devices[k]].layout.seed(config, k * per, (k + 1) * per,
                                                            mesh.devices[k])
                        for k in mesh.local_shards], 0
    else:
        s0, s1, acc, start = state
        parts = zip(_local(s0, mesh), _local(s1, mesh), _local(acc.reshape(3, -1), mesh, dim=1))
    outs = []
    for k, (s0k, s1k, acck) in zip(mesh.local_shards, parts):
        dev = mesh.devices[k]
        shard = (s0k.to(dev).contiguous(), s1k.to(dev).contiguous(),
                 acck.to(dev).contiguous().reshape(3, per // LANES, LANES), start)
        outs.append(trace_lanes(frames[dev], config, config.spp, shard,
                                *frames[dev].layout.lanes(k * per, (k + 1) * per)))
    acc = gather_shards([o[2].reshape(3, per) for o in outs], mesh, dim=1)
    new_state = (torch.cat([o[0].to(dev0) for o in outs]),
                 torch.cat([o[1].to(dev0) for o in outs]),
                 torch.cat([o[2].to(dev0) for o in outs], dim=1),
                 start + config.spp)
    return layout.image(acc, config.width, config.height), new_state


def _ray_shards(n: int, mesh: Mesh):
    """(per-shard lane count, [(lo, hi)] of each local shard's real rays):
    n rays padded with inert lanes to a multiple of the shard count."""
    per = (n + (-n) % mesh.size) // mesh.size
    return per, [(min(k * per, n), min((k + 1) * per, n)) for k in mesh.local_shards]


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    if t.shape[0] == rows:
        return t
    fill = torch.zeros((rows - t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                       device=t.device)
    return torch.cat([t, fill])


def render_whitted_sharded(
    scene,
    width: int = 800,
    height: int = 600,
    supersample: int = 3,
    trace_depth: int = 5,
    hit_bias: float = 0.0,
    mesh: Optional[Mesh] = None,
    ray_tile: Optional[int] = None,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Whitted (3.2.0x) frame with the ray axis sharded over ``mesh``. Each
    shard makes its contiguous range of subsample rays from the absolute
    ray index (``whitted_camera_rays_device``), padded with inert rays
    (o = d = 0) to equal shards, and traces them through K3's explicit-ray
    entry (``use_kernel``; its plain version on the CPU) or the plain
    tracer in chunks of ``ray_tile``; the ray colours are gathered and
    reduced as the single-device frame reduces them. Returns [H, W, 3]
    float32 in 0..255."""
    from se195_raytracer_tpu_torch.kernels.whitted_kernel import rays_to_tiles, whitted_trace_cuda
    from se195_raytracer_tpu_torch.models.whitted import (
        reduce_subsamples,
        whitted_camera_rays_device,
        whitted_trace,
    )

    if mesh is None:
        mesh = make_mesh()
    n = width * height * supersample * supersample
    per, ranges = _ray_shards(n, mesh)
    tile = ray_tile or min(per, 256 * 1024)
    scenes = replicate(scene, mesh)
    accs = []
    for k, (lo, hi) in zip(mesh.local_shards, ranges):
        dev = mesh.devices[k]
        o, d = whitted_camera_rays_device(width, height, supersample, device=dev,
                                          ray_range=(lo, hi))
        o, d = _pad_rows(o, per), _pad_rows(d, per)
        if use_kernel:
            acc = whitted_trace_cuda(scenes[dev], rays_to_tiles(o, d), trace_depth=trace_depth,
                                     hit_bias=hit_bias)
            accs.append(acc.reshape(3, -1)[:, :per].T)
        else:
            accs.append(torch.cat([
                whitted_trace(scenes[dev], o[a:a + tile], d[a:a + tile], trace_depth, hit_bias)
                for a in range(0, per, tile)]))
    acc = gather_shards(accs, mesh)[:n]
    return reduce_subsamples(acc, width, height, supersample)


def render_whitted5_sharded(
    scene,
    width: int = 320,
    height: int = 240,
    spp: int = 1,
    trace_depth: Optional[int] = None,
    seed: int = 0,
    mesh: Optional[Mesh] = None,
    use_kernel: bool = True,
) -> torch.Tensor:
    """raytracer5-family frame with the ray axis sharded over ``mesh``. Each
    shard seeds its own lanes' counter-RNG state (key, counter) from the
    absolute ray id (``models.whitted5._state5``: the seed kernel on a CUDA device);
    its pad lanes get the state 2 and zero rays. The frame's rays are
    cached on the device per size, as ``render_whitted5`` caches them. With
    ``use_kernel`` each shard runs its ``spp`` passes in one K4 launch (K5
    inside; the plain tracer on the CPU), else on the plain tracer; the
    mean is per lane, so the frame is bitwise ``render_whitted5``'s.
    Returns [H, W, 3] float32 linear radiance."""
    from se195_raytracer_tpu_torch.models.whitted5 import (
        TRACEDEPTH5,
        _cached_rays5,
        _state5,
        _trace,
    )

    if trace_depth is None:
        trace_depth = TRACEDEPTH5
    if mesh is None:
        mesh = make_mesh()
    r = width * height
    per, ranges = _ray_shards(r, mesh)
    scenes = replicate(scene, mesh)
    cols = []
    for k, (lo, hi) in zip(mesh.local_shards, ranges):
        dev = mesh.devices[k]
        # The frame's rays on the shard's device, made once per size (as
        # render_whitted5 caches them), then sliced.
        o, d = _cached_rays5(width, height, (0.5, 0.5), str(dev))
        ok, dk = _pad_rows(o[lo:hi], per), _pad_rows(d[lo:hi], per)
        state = _state5(r, seed, dev, lanes=per, lane_offset=lo)
        col, _ = _trace(scenes[dev], ok, dk, state, use_kernel, spp=spp, trace_depth=trace_depth)
        cols.append(col)
    return gather_shards(cols, mesh)[:r].reshape(height, width, 3)


def l2_image_loss_sharded(
    scene: Scene,
    camera: Camera,
    target: torch.Tensor,
    config: RenderConfig,
    mesh: Optional[Mesh] = None,
    names: Sequence[str] = ("center", "radius", "emission", "color", "orig", "target"),
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The L2 image loss ``mean((img - target)^2)`` and its gradient with
    respect to the named scene and camera fields, with the pixels sharded
    over ``mesh`` (the twin of the JAX package's psum'd sharded gradient).
    Each shard renders its own pixels through
    ``driver.optimize.render_differentiable(pixels=...)`` (the kernel
    forward and the recompute both cover the shard only) and takes its
    part of the loss; the shards' losses and gradients are summed, over
    shards in-process and by ``all_reduce(SUM)`` across processes.
    Returns (loss, {name: gradient}) on the device of the first local
    shard."""
    from se195_raytracer_tpu_torch.driver.optimize import (
        CAMERA_LEAVES,
        merge,
        render_differentiable,
    )

    if mesh is None:
        mesh = make_mesh()
    n = config.width * config.height
    bounds = shard_bounds(n, mesh)
    flat_target = target.reshape(n, 3)
    scale = 1.0 / (3 * n)
    dev0 = mesh.devices[mesh.local_shards[0]]
    loss = torch.zeros((), dtype=torch.float32, device=dev0)
    grads: Dict[str, torch.Tensor] = {}
    for k in mesh.local_shards:
        dev = mesh.devices[k]
        lo, hi = bounds[k]
        leaves = {name: getattr(camera if name in CAMERA_LEAVES else scene, name)
                  .detach().to(dev).requires_grad_(True) for name in names}
        sc, cam = merge(scene.to(dev), camera.to(dev), leaves)
        img = render_differentiable(sc, cam, config, device=dev, pixels=(lo, hi))
        part = ((img - flat_target[lo:hi].to(dev)) ** 2).sum() * scale
        for name, g in zip(names, torch.autograd.grad(part, list(leaves.values()))):
            g = g.to(dev0)
            grads[name] = g if name not in grads else grads[name] + g
        loss = loss + part.detach().to(dev0)
    return sum_across(loss, mesh), {name: sum_across(g, mesh) for name, g in grads.items()}

"""Shard layout over devices (twin of se195_raytracer_tpu/parallel/mesh.py).

The reference is single-device only (smallptGPU.cpp:463-467 always picks
devices[0]). As in the JAX package, rays/pixels are the sharded axis and
the scene is tiny and replicated: a shard renders a contiguous range of
lanes with absolute pixel or ray ids, so the forward pass needs no
communication and the frame is the shards' outputs in shard order.

A ``Mesh`` takes one of two forms:

- **in-process** (``make_mesh``): one shard per entry of a device list,
  every shard rendered by this process. Entries may repeat, so 8 shards on
  one GPU (``make_mesh("cuda:0", n_devices=8)``), or on the CPU, exercise
  the shard arithmetic without 8 devices: the ``shard_map`` analogue.
- **process group** (``make_mesh(process_group=True)``): one shard per
  rank of ``torch.distributed``, this process rendering its rank's shard
  on its own device; the frame is assembled with ``all_gather``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import torch

from se195_raytracer_tpu_torch.core.types import resolve_device

DeviceLike = Union[str, torch.device]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[k]`` holds shard k; this process renders the shards of
    ``local_shards`` (all of them in-process, its rank's over a process
    group)."""

    devices: Tuple[torch.device, ...]
    local_shards: Tuple[int, ...]
    process_group: bool = False

    @property
    def size(self) -> int:
        """The number of shards."""
        return len(self.devices)


def make_mesh(devices: Union[None, DeviceLike, Sequence[DeviceLike]] = None,
              n_devices: Optional[int] = None, process_group: bool = False) -> Mesh:
    """An in-process mesh over ``devices``: None = every CUDA device (raises
    without one), one device = that device ``n_devices`` times (default 1),
    a sequence = as given, cut to its first ``n_devices``.

    ``process_group=True``: one shard per rank of the initialised default
    process group; shard k lies on ``devices[k]`` when a sequence is given,
    else on ``devices`` (one device) or on ``cuda:(k % device_count)``."""
    if process_group:
        return _process_mesh(devices)
    if devices is None:
        resolve_device("cuda")
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        devs = devs[:n_devices] if n_devices is not None else devs
    elif isinstance(devices, (str, torch.device)):
        devs = [resolve_device(devices)] * (1 if n_devices is None else n_devices)
    else:
        devs = [resolve_device(d) for d in devices]
        devs = devs[:n_devices] if n_devices is not None else devs
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devs), tuple(range(len(devs))))


def _process_mesh(devices) -> Mesh:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("process_group=True needs torch.distributed initialised "
                           "(parallel.render_sharded.initialize_multihost)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if devices is None:
        resolve_device("cuda")
        count = torch.cuda.device_count()
        devs = [torch.device("cuda", k % count) for k in range(world)]
    elif isinstance(devices, (str, torch.device)):
        devs = [resolve_device(devices)] * world
    else:
        devs = [resolve_device(d) for d in devices]
        if len(devs) != world:
            raise ValueError(f"{len(devs)} devices for a world of {world} ranks")
    return Mesh(tuple(devs), (rank,), process_group=True)


def shard_bounds(n: int, mesh: Mesh) -> List[Tuple[int, int]]:
    """The contiguous range [lo, hi) of the n pixels that each shard holds,
    for every shard (the stand-in for ``ray_sharding``/``shard_pixels``).
    Raises the JAX package's ValueError when the shards do not divide n."""
    if n % mesh.size:
        raise ValueError(f"pixel count {n} must divide evenly over {mesh.size} devices")
    per = n // mesh.size
    return [(k * per, (k + 1) * per) for k in range(mesh.size)]


def replicate(x, mesh: Mesh) -> dict:
    """``x`` (a tensor, or anything with ``.to(device)``: Scene, Camera,
    WhittedScene, Whitted5Scene) on the device of each local shard, as a
    dict by device; one copy per distinct device."""
    return {dev: x.to(dev) for dev in dict.fromkeys(mesh.devices[k] for k in mesh.local_shards)}


def gather_shards(local: Sequence[torch.Tensor], mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """The shards' outputs concatenated along ``dim`` in shard order, on the
    device of this process's first shard. ``local`` holds the outputs of
    ``mesh.local_shards``, each the same shape. Over a process group this is
    an ``all_gather``; the gloo backend (CPU, and two ranks on one GPU)
    gathers host copies, NCCL the device tensors."""
    dev = mesh.devices[mesh.local_shards[0]]
    if not mesh.process_group:
        return torch.cat([t.to(dev) for t in local], dim=dim)
    import torch.distributed as dist

    (mine,) = local
    on_host = dist.get_backend() != "nccl"
    t = (mine.cpu() if on_host else mine).contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t)
    return torch.cat(parts, dim=dim).to(dev)


def sum_across(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` summed over the processes of a process-group mesh
    (``all_reduce(SUM)``, through the host under gloo); itself in-process."""
    if not mesh.process_group:
        return t
    import torch.distributed as dist

    on_host = dist.get_backend() != "nccl"
    buf = (t.detach().cpu() if on_host else t.detach()).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    return buf.to(t.device)

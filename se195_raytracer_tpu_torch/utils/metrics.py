"""Structured metrics and topology (twin of
se195_raytracer_tpu/utils/metrics.py).

Replaces the reference's observability surface: the stderr device
inventory at startup (smallptGPU.cpp:236-459) and the per-pass "Rendering
time ... Sample/sec" caption (smallptGPU.cpp:777-781, smallptCPU.cpp:126-129)
become structured dicts. Timing inside the program is
``utils.profiling.span``, on the profiler's clock.
"""

from __future__ import annotations

from typing import Optional

import torch


def device_inventory() -> dict:
    """The devices at init, with the JAX inventory's keys: the CUDA devices
    of this process (``backend`` "cuda"), or the CPU when there is none
    (``backend`` "cpu"); the process index and count from
    ``torch.distributed`` when it is initialised, else 0 and 1."""
    import torch.distributed as dist

    dist_on = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if dist_on else 0
    world = dist.get_world_size() if dist_on else 1
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        devices = [{"id": i, "platform": "cuda", "kind": torch.cuda.get_device_name(i),
                    "process": rank} for i in range(n)]
        backend = "cuda"
    else:
        devices = [{"id": 0, "platform": "cpu", "kind": "cpu", "process": rank}]
        backend = "cpu"
    return {
        "backend": backend,
        "process_index": rank,
        "process_count": world,
        "device_count": len(devices) * world,
        "local_device_count": len(devices),
        "devices": devices,
    }


def render_metrics(width: int, height: int, spp: int, elapsed_s: float,
                   pass_index: Optional[int] = None) -> dict:
    """Per-step metrics dict; samples/sec as the reference's caption counts
    them (samples * W * H / elapsed)."""
    rays = width * height * spp
    m = {
        "width": width,
        "height": height,
        "spp": spp,
        "elapsed_s": round(elapsed_s, 6),
        "rays_per_sec": round(rays / elapsed_s, 1) if elapsed_s > 0 else None,
        "samples_per_sec_k": round(rays / elapsed_s / 1e3, 1) if elapsed_s > 0 else None,
    }
    if pass_index is not None:
        m["pass"] = pass_index
    return m

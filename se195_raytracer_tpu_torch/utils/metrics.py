"""Structured metrics and topology logging (twin of
se195_raytracer_tpu/utils/metrics.py).

Replaces the reference's observability surface: the stderr device
inventory at startup (smallptGPU.cpp:236-459), the per-pass "Rendering
time ... Sample/sec" caption (smallptGPU.cpp:777-781, smallptCPU.cpp:126-129)
and the mm:ss.mmm frame timers (raytracer.c:759-770) become structured
dicts and a JSON-lines logger.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Optional, TextIO

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


class MetricsLogger:
    """JSON-lines metrics sink (stderr by default)."""

    def __init__(self, stream: Optional[TextIO] = None):
        self.stream = stream or sys.stderr

    def log(self, event: str, **fields) -> None:
        rec = {"event": event, "t": round(time.time(), 3), **fields}
        print(json.dumps(rec), file=self.stream, flush=True)

    def log_topology(self) -> None:
        self.log("topology", **device_inventory())


class Timer:
    """Wall-clock timer of a region (the WallClockTime analogue,
    displayfunc.cpp:69-80). With a CUDA device it synchronises the device
    before each clock reading, so the region's queued kernels are
    counted."""

    @staticmethod
    def _sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def __enter__(self):
        self._sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.elapsed = time.perf_counter() - self.t0
        return False

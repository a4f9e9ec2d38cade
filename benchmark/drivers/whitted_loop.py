"""Closed-loop Raytracer3.2 Whitted renders under a moving camera: one client
calls the program's ``models.whitted.render_whitted`` back to back, each
render from the camera pose its seed draws, and takes each image to the
host, with ``in_flight`` renders outstanding (``render_loop``'s loop,
copies, reservoir and check).

Configuration keys: ``scene`` (primitives by row), ``supersample``,
``trace_depth``, ``hit_bias``. Traffic keys as ``render_loop``'s (no
``spp``: a render's samples are its ss^2 subsample rays a pixel), and
``camera_walk``: the bounds of the pose a render's seed draws
(``reference.whitted.pose``).

The check: for each kept render the reference (``reference.whitted``)
renders the sampled pixels from the same scene and pose, and
``image_gap`` must stay within its limit.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness.manifest import BENCH_DIR, load_module
from harness.trace import Spans
from reference import whitted as refw

render_loop = load_module(BENCH_DIR / "drivers" / "render_loop.py")


def port_scene(scene_cfg: dict, device):
    """The program's scene of a configuration's rows, built by its
    ``WhittedSceneBuilder``."""
    from se195_raytracer_tpu_torch.scenes.whitted_scenes import WhittedSceneBuilder

    b = WhittedSceneBuilder()
    for p in scene_cfg["primitives"]:
        p = {**refw.DEFAULTS, **p}
        mat = (tuple(p["color"]), p["refl"], p["refr"], p["refr_index"], p["diff"], p["spec"],
               p["is_light"])
        if p["type"] == "plane":
            b.plane(*mat, *p["normal"], p["depth"])
        else:
            b.sphere(*mat, *p["center"], p["radius"])
    return b.build(device)


def frame_of(config: dict, traffic: dict) -> refw.Frame:
    return refw.Frame(traffic["width"], traffic["height"], config["supersample"] ** 2,
                      config["trace_depth"], config["hit_bias"])


class Job(render_loop.Job):
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.config, self.traffic, self.device = config, traffic, device
        self.frame = frame_of(config, traffic)
        self.walk = traffic["camera_walk"]
        self.seeds = np.random.Generator(np.random.PCG64(seed))
        self.check_rng = np.random.Generator(np.random.PCG64([seed, 1]))
        self.keep = traffic["check"]["renders"]
        self.kept = []  # (index in the window, seed, host image)
        self.times, self.done = [], []
        self.elapsed = 0.0
        self.attempted = self.failed = 0

    def setup(self) -> None:
        from se195_raytracer_tpu_torch.core.config import RenderConfig
        from se195_raytracer_tpu_torch.models.whitted import render_whitted

        f = self.frame
        self.render = render_whitted
        self.scene = port_scene(self.config["scene"], self.device)
        self.cfg = RenderConfig(width=f.width, height=f.height, supersample=f.supersample,
                                trace_depth=f.trace_depth, hit_bias=f.hit_bias)
        self.depth = self.traffic.get("in_flight", 1)
        self.free = None
        if self.device.type == "cuda":
            self.free = [torch.empty((f.height, f.width, 3), pin_memory=True)
                         for _ in range(self.depth)]
        # Warm-up: the window's own path, the copies too, for a few renders.
        warmed = []
        while len(warmed) < self.traffic.get("warmup_renders", 1):
            self._loop(time.perf_counter() + 1e-3, Spans(), lambda *unit: warmed.append(unit))

    def one(self, seed: int, spans):
        camera = refw.pose(seed, self.walk)
        with spans.span("bench.render"):
            return self.render(self.scene, self.cfg, device=self.device, camera=camera)

    def release(self) -> None:
        for k in ("scene", "render"):
            self.__dict__.pop(k, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_pixels(self, seed: int, pixels: torch.Tensor, dtype=torch.float32):
        """The reference's values of ``pixels`` of the render with ``seed``."""
        scene = refw.make_scene(self.config["scene"], self.device, dtype)
        row = refw.camera_row(*refw.pose(seed, self.walk))
        with torch.no_grad():
            return refw.render_pixels(scene, self.frame, row, pixels, dtype=dtype,
                                      block=self.traffic["check"]["block"])

    def roofline_unit(self):
        i = min(self.traffic.get("roofline_render", 1), len(self.done) - 1)
        if i < 0:
            return None
        return i, {"config": self.config, "frame": self.frame, "seed": self.done[i],
                   "walk": self.walk, "device": self.device}

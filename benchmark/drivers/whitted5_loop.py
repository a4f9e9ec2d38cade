"""Closed-loop raytracer5 ("whitted5") renders: one client calls the
program's ``models.whitted5.render_whitted5`` back to back, each render
with a fresh seed, and takes each image to the host, with ``in_flight``
renders outstanding (``render_loop``'s loop, copies, reservoir and check).

Configuration keys: ``scene`` (textures by generator, primitives by row),
``camera``, ``trace_depth``, ``area_samples``. Traffic keys as
``render_loop``'s.

The check: for each kept render the reference (``reference.whitted5``)
renders the sampled pixels from the same scene and seed, and
``image_gap`` must stay within its limit.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness.manifest import BENCH_DIR, load_module
from harness.trace import Spans
from reference import whitted5 as ref5

render_loop = load_module(BENCH_DIR / "drivers" / "render_loop.py")


def _value(v):
    return tuple(v) if isinstance(v, list) else v


def port_scene(scene_cfg: dict, device):
    """The program's scene of a configuration's rows, built by its
    ``Whitted5Builder``."""
    from se195_raytracer_tpu_torch.scenes.whitted5_scenes import Whitted5Builder

    b = Whitted5Builder()
    tex = {t["name"]: b.add_texture(ref5.texture(t)) for t in scene_cfg["textures"]}
    geometry = {"sphere": ("center", "radius", b.sphere), "plane": ("normal", "depth", b.plane),
                "box": ("box_pos", "box_size", b.box)}
    for p in scene_cfg["primitives"]:
        first, second, add = geometry[p["type"]]
        kw = {k: _value(v) for k, v in p.items() if k in ref5.FIELDS and k not in (first, second)}
        add(_value(p[first]), _value(p[second]), is_light=p["is_light"],
            tex=-1 if p["texture"] is None else tex[p["texture"]], **kw)
    return b.build(device)


def frame_of(config: dict, traffic: dict) -> ref5.Frame:
    return ref5.Frame(traffic["width"], traffic["height"], traffic["spp"], config["trace_depth"],
                      tuple(config["area_samples"]), tuple(config["camera"]["pos"]),
                      tuple(config["camera"]["target"]))


class Job(render_loop.Job):
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.config, self.traffic, self.device = config, traffic, device
        self.frame = frame_of(config, traffic)
        self.seeds = np.random.Generator(np.random.PCG64(seed))
        self.check_rng = np.random.Generator(np.random.PCG64([seed, 1]))
        self.keep = traffic["check"]["renders"]
        self.kept = []  # (index in the window, seed, host image)
        self.times, self.done = [], []
        self.elapsed = 0.0
        self.attempted = self.failed = 0

    def setup(self) -> None:
        from se195_raytracer_tpu_torch.models import whitted5

        self.render = whitted5.render_whitted5
        self.scene = port_scene(self.config["scene"], self.device)
        self.depth = self.traffic.get("in_flight", 1)
        self.free = None
        if self.device.type == "cuda":
            self.free = [torch.empty((self.frame.height, self.frame.width, 3), pin_memory=True)
                         for _ in range(self.depth)]
        # Warm-up: the window's own path, the copies too, for a few renders.
        warmed = []
        while len(warmed) < self.traffic.get("warmup_renders", 1):
            self._loop(time.perf_counter() + 1e-3, Spans(), lambda *unit: warmed.append(unit))

    def one(self, seed: int, spans):
        f = self.frame
        with spans.span("bench.render"):
            return self.render(self.scene, f.width, f.height, spp=f.spp,
                               trace_depth=f.trace_depth, seed=seed, device=self.device)

    def release(self) -> None:
        for k in ("scene", "render"):
            self.__dict__.pop(k, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_pixels(self, seed: int, pixels: torch.Tensor, dtype=torch.float32):
        """The reference's values of ``pixels`` of the render with ``seed``."""
        scene = ref5.make_scene(self.config["scene"], self.device, dtype)
        with torch.no_grad():
            return ref5.render_pixels(scene, self.frame, seed, pixels, dtype=dtype,
                                      block=self.traffic["check"]["block"])

    def roofline_unit(self):
        i = min(self.traffic.get("roofline_render", 1), len(self.done) - 1)
        if i < 0:
            return None
        return i, {"config": self.config, "frame": self.frame, "seed": self.done[i],
                   "device": self.device}

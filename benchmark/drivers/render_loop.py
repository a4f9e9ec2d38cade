"""Closed-loop renders: one client calls the program's
``driver.render.render`` back to back, each render from a fresh state with
its own seed, and takes each image to the host. It keeps ``in_flight``
renders outstanding: it makes the next call while the previous image is
still being rendered and copied (into page-locked host memory, a
non-blocking copy on the render's stream), and waits for the oldest image
once that many are outstanding. With ``in_flight`` 1 each call waits for
its image (``.cpu()``) before the next. A render's time runs from its call
until its image is on the host.

Traffic keys: ``width``, ``height``, ``spp``, ``in_flight``; ``check``: ``renders`` (kept
by a reservoir drawn from the seed, so any render of the window may be
judged), ``pixels`` (a sample of each kept image drawn from the seed) and
``block``; ``limits``: ``image_gap``; ``roofline_render``: the render of
the window whose kernel time and work the roofline readers compare.

The check: for each kept render the reference renders the sampled pixels
from the same scene, camera and seed, and ``image_gap`` (the share of the
reference's light that the program's pixels misplace) must stay within
its limit.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from harness.trace import Spans
from reference import scenes
from reference import smallpt as ref


class Job:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.config, self.traffic, self.device = config, traffic, device
        self.frame = ref.Frame(traffic["width"], traffic["height"], traffic["spp"],
                               config["max_depth"], config["integrator"] == "dl")
        self.arrays = scenes.build(config["scene"])
        self.cam = scenes.camera(config)
        self.seeds = np.random.Generator(np.random.PCG64(seed))
        self.check_rng = np.random.Generator(np.random.PCG64([seed, 1]))
        self.keep = traffic["check"]["renders"]
        self.kept = []  # (index in the window, seed, host image)
        self.times, self.done = [], []
        self.elapsed = 0.0
        self.attempted = self.failed = 0

    def _draw(self) -> int:
        return int(self.seeds.integers(0, 2**62))

    def setup(self) -> None:
        from se195_raytracer_tpu_torch.core.config import RenderConfig
        from se195_raytracer_tpu_torch.core.types import Camera, Scene
        from se195_raytracer_tpu_torch.driver.render import render

        a = self.arrays
        self.render = render
        self.scene = Scene.from_arrays(a["center"], a["radius"], a["emission"], a["color"],
                                       a["refl"], device=self.device)
        self.camera = Camera.look_at(*self.cam, device=self.device)
        self.cfg = RenderConfig(width=self.frame.width, height=self.frame.height,
                                spp=self.frame.spp, max_depth=self.frame.max_depth,
                                integrator=self.config["integrator"], rng=self.config["rng"])
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
        """Call the program for the render with ``seed``: its image on the
        device."""
        cfg = dataclasses.replace(self.cfg, seed=seed)
        with spans.span("bench.render"):
            return self.render(self.scene, self.camera, cfg, device=self.device)[0]

    def window(self, seconds: float, spans) -> None:
        t0 = time.perf_counter()
        self.elapsed = self._loop(t0 + seconds, spans, self._complete) - t0
        self.attempted = len(self.times)

    def _loop(self, end: float, spans, complete) -> float:
        """Renders until ``end`` (host clock), keeping ``in_flight`` of them
        outstanding, then the last ones to their end; ``complete(seed,
        seconds, host image)`` for each. Returns when the last image was on
        the host."""
        pending = collections.deque()  # (seed, call time, host buffer, done event)
        b = time.perf_counter()
        while True:
            now = time.perf_counter()
            if now < end:
                seed = self._draw()
                img = self.one(seed, spans)
                with spans.span("bench.readback"):
                    if self.free is None:
                        buf, done = img.cpu(), None
                    else:
                        buf = self.free.pop()
                        buf.copy_(img, non_blocking=True)
                        done = torch.cuda.Event()
                        done.record()
                pending.append((seed, now, buf, done))
                if len(pending) < self.depth:
                    continue
            if not pending:
                return b
            seed, a, buf, done = pending.popleft()
            if done is not None:
                done.synchronize()
            b = time.perf_counter()
            complete(seed, b - a, buf)
            if self.free is not None:
                self.free.append(buf)

    def _complete(self, seed: int, seconds: float, host: torch.Tensor) -> None:
        """Count a render whose image is on the host; a reservoir drawn from
        the seed keeps ``check.renders`` of them for the check."""
        i = len(self.times)
        self.times.append(seconds)
        self.done.append(seed)
        if i < self.keep:
            self.kept.append((i, seed, host.clone()))
            return
        j = int(self.check_rng.integers(0, i + 1))
        if j < self.keep:
            self.kept[j] = (i, seed, host.clone())

    def end_to_end(self) -> dict:
        samples = self.frame.width * self.frame.height * self.frame.spp
        return {"samples_per_s": samples * len(self.times) / self.elapsed,
                "render_p95_ms": float(np.percentile(np.array(self.times) * 1e3, 95))}

    def release(self) -> None:
        for k in ("scene", "camera", "render"):
            self.__dict__.pop(k, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_scene(self, dtype=torch.float32):
        return ref.make_scene(self.arrays, self.device, dtype)

    def reference_pixels(self, seed: int, pixels: torch.Tensor, dtype=torch.float32):
        """The reference's values of ``pixels`` of the render with ``seed``."""
        scene = self.reference_scene(dtype)
        o, t = (torch.tensor(v, device=self.device).to(dtype) for v in self.cam)
        basis = ref.camera_basis(o, t, self.frame.width, self.frame.height)
        with torch.no_grad():
            return ref.render_pixels(scene, basis, self.frame, seed, pixels, dtype=dtype,
                                     block=self.traffic["check"]["block"])

    def samples(self):
        """(seed, pixels, the program's values there) of each kept render."""
        out = []
        for _, seed, host in sorted(self.kept):
            pixels = ref.sample_pixels(self.frame, self.traffic["check"]["pixels"],
                                       self.check_rng, self.device)
            got = host.reshape(-1, 3)[pixels.cpu()].to(self.device)
            out.append((seed, pixels, got))
        return out

    def check(self):
        gap = 0.0
        for seed, pixels, got in self.samples():
            gap = max(gap, ref.image_gap(got, self.reference_pixels(seed, pixels)))
        limit = self.traffic["limits"]["image_gap"]
        return bool(self.kept) and gap <= limit, {"image_gap": (gap, limit)}

    def roofline_unit(self):
        """(index in the window, the reference's inputs) of the render the
        roofline readers count."""
        i = min(self.traffic.get("roofline_render", 1), len(self.done) - 1)
        if i < 0:
            return None
        return i, {"arrays": self.arrays, "cam": self.cam, "frame": self.frame,
                   "seed": self.done[i], "device": self.device}

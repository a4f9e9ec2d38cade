"""Inverse rendering: Adam steps of the program's
``driver.optimize.make_inverse_step`` (an L2 image loss through
``render_differentiable``), from a perturbed start towards a target
rendered from the true scene.

Traffic keys: ``width``, ``height``, ``spp``; ``start``: ``light``,
``light_move``, ``wall``, ``wall_color`` (the sphere moved and the one
tinted); ``optimizer``: ``lr``, ``geom_mult`` (the centres' rate over the
base rate), ``sched_alpha``, ``max_norm``; ``restart_every`` (the job
starts again from the start after that many steps, with a fresh
optimizer, so the work is stationary); ``check``: ``steps`` (the first
steps the reference follows), ``block``; ``limits``: ``loss_gap``,
``grad_gap``, ``change_gap``.

Every step renders with a seed of its own, drawn from the run's seed, so
no two steps of a window are alike. Set-up renders the target, then takes
the first ``check.steps`` steps through the window's own call; the window
goes on from there with the same state. The check has the reference
follow those steps: each step's loss, the first gradient as the optimizer
got it (worked out from Adam's first moment after one step) and the
parameters' change after the steps, each by the worst trainable leaf
(``reference.inverse``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from reference import inverse
from reference import scenes
from reference import smallpt as ref

class Job:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.config, self.traffic, self.device = config, traffic, device
        self.frame = ref.Frame(traffic["width"], traffic["height"], traffic["spp"],
                               config["max_depth"], config["integrator"] == "dl")
        self.arrays = scenes.build(config["scene"])
        self.start = inverse.start_arrays(self.arrays, traffic["start"])
        self.cam = scenes.camera(config)
        self.seeds = np.random.Generator(np.random.PCG64(seed))
        self.target_seed = self._draw()
        self.step_seeds = []
        self.readings = None
        self.steps = 0
        self.elapsed = 0.0
        self.attempted = self.failed = 0

    def _draw(self) -> int:
        return int(self.seeds.integers(0, 2**62))

    def setup(self) -> None:
        import dataclasses

        from se195_raytracer_tpu_torch.core.config import RenderConfig
        from se195_raytracer_tpu_torch.core.types import Camera, Scene
        from se195_raytracer_tpu_torch.driver.grad_check import GroupAdam
        from se195_raytracer_tpu_torch.driver.optimize import (OptState, make_inverse_step,
                                                               render_differentiable)

        opt = self.traffic["optimizer"]

        def scene_of(a):
            return Scene.from_arrays(a["center"], a["radius"], a["emission"], a["color"],
                                     a["refl"], device=self.device)

        self.camera = Camera.look_at(*self.cam, device=self.device)
        cfg = RenderConfig(width=self.frame.width, height=self.frame.height, spp=self.frame.spp,
                           max_depth=self.frame.max_depth, integrator=self.config["integrator"],
                           rng=self.config["rng"])
        with torch.no_grad():
            target = render_differentiable(
                scene_of(self.arrays), self.camera,
                dataclasses.replace(cfg, seed=self.target_seed), device=self.device)
        self.scene0 = scene_of(self.start)
        every = self.traffic["restart_every"]

        def optimizer(tr):
            return GroupAdam({"geom": ([tr["center"]], opt["lr"] * opt["geom_mult"]),
                              "mat": ([tr["color"]], opt["lr"])}, every, opt["sched_alpha"],
                             max_norm=opt["max_norm"])

        def make_step(seed):
            return make_inverse_step(target, dataclasses.replace(cfg, seed=seed), optimizer,
                                     lambda name: name in ("center", "color"), device=self.device)

        self.make_step, self.fresh = make_step, lambda: OptState(self.scene0, self.camera, None,
                                                                 None)
        self.st = self.fresh()
        losses = []
        for k in range(self.traffic["check"]["steps"]):
            self._step()
            losses.append(float(self.st.loss))
            if k == 0:
                first = self._first_gradient()
        after = [t.detach().cpu().clone() for t in (self.st.scene.center, self.st.scene.color)]
        self.readings = {"loss": losses, "grad": first, "params": after}

    def _first_gradient(self):
        """The gradient the optimizer got at its first step, from its first
        moment (zero where it holds none: it got nothing)."""
        adam = self.st.opt_state.opt
        beta1 = adam.param_groups[0]["betas"][0]
        out = []
        for p in (self.st.scene.center, self.st.scene.color):
            m = adam.state.get(p, {}).get("exp_avg")
            out.append(torch.zeros_like(p).cpu() if m is None
                       else (m / (1.0 - beta1)).detach().cpu())
        return out

    def _step(self, spans=None) -> None:
        if self.steps and self.steps % self.traffic["restart_every"] == 0:
            self.st = self.fresh()
        seed = self._draw()
        self.step_seeds.append(seed)
        step = self.make_step(seed)
        if spans is None:
            self.st = step(self.st)
        else:
            with spans.span("bench.step"):
                self.st = step(self.st)
        self.steps += 1

    def window(self, seconds: float, spans) -> None:
        self.first_in_window = self.steps
        t0 = time.perf_counter()
        end = t0 + seconds
        while time.perf_counter() < end:
            self._step(spans)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.elapsed = time.perf_counter() - t0
        self.attempted = self.steps - self.first_in_window

    def end_to_end(self) -> dict:
        return {"grad_step_ms": self.elapsed / self.attempted * 1e3}

    def release(self) -> None:
        for k in ("st", "scene0", "camera", "make_step", "fresh"):
            self.__dict__.pop(k, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_run(self, dtype=torch.float32, fault=None) -> dict:
        """The reference's three steps from the same start, target seed and
        step seeds (``inverse.follow``)."""
        return inverse.follow(self.arrays, self.start, self.cam, self.frame, self.target_seed,
                              self.step_seeds[:self.traffic["check"]["steps"]], self.traffic,
                              self.device,
                              dtype=dtype, fault=fault)

    def check(self):
        numbers = inverse.compare(self.readings, self.reference_run())
        limits = self.traffic["limits"]
        checked = {k: (v, limits[k]) for k, v in numbers.items()}
        return all(v <= lim for v, lim in checked.values()), checked

    def roofline_unit(self):
        """(index in the window, the reference's inputs) of the first step
        after a restart inside the window: its parameters are the start's."""
        every = self.traffic["restart_every"]
        k = -(-self.first_in_window // every) * every
        if k >= self.steps:
            return None
        return k - self.first_in_window, {"arrays": self.start, "cam": self.cam,
                                          "frame": self.frame, "seed": self.step_seeds[k],
                                          "device": self.device}

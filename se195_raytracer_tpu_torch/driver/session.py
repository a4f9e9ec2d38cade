"""Interactive render session: the reference's keystroke edit loop as an API
(twin of se195_raytracer_tpu/driver/session.py).

Re-expresses displayfunc.cpp's GLUT keyboard surface (keyFunc:251-362,
specialFunc:364-420, key catalog README.txt:19-31) headlessly: every edit
mutates the camera or scene and restarts progressive accumulation exactly
like ReInit(0)/ReInitScene (currentSample = 0, seeds kept,
smallptGPU.cpp:784-830), while ``refresh()`` is ReInit(1) (buffers
reallocated, fresh seeds). ``key()`` dispatches the original bindings.

Rotation quirk kept: the reference updates t.y and then uses the *new*
t.y in the t.z update (specialFunc:367-373 etc.), making arrow rotations
slightly non-orthogonal; the arithmetic here is the same.

Unlike the JAX session, which renders on its plain path to bound the XLA
compiles (one program per spp), this one steps through
``driver.render.render`` as ``config.use_kernel`` says: K1 (K2 where
``kernels/pt_kernel.uses_k2``) on the kernels' state, whose pass count is a launch argument.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from se195_raytracer_tpu_torch.core.config import RenderConfig
from se195_raytracer_tpu_torch.core.types import Camera, Scene, dot3, resolve_device, sqrt_rn, update_camera
from se195_raytracer_tpu_torch.driver.render import RenderState, init_render_state, render

MOVE_STEP = 10.0
ROTATE_STEP = 2.0 * math.pi / 180.0


class RenderSession:
    # Batch sizes of step_for past the interactive phase, climbed in turn.
    STEP_LADDER = (1, 8, 64)

    def __init__(self, scene: Scene, camera: Camera, config: RenderConfig, device=None):
        self.device = resolve_device(device)
        self.scene = scene.to(self.device)
        self.camera = camera.to(self.device)
        self.config = config
        self.current_sphere = 0
        self.state = self._fresh_state()
        self._image = None

    def _fresh_state(self):
        """The state of a render that has not started: fresh seeds, a zero
        accumulator, sample 0 (the plain ``RenderState`` or the kernels'
        ``(s0, s1, acc, sample)``)."""
        if not self.config.use_kernel:
            return init_render_state(self.config, device=self.device)
        from se195_raytracer_tpu_torch.kernels.pt_kernel import init_pt_state, uses_k2

        return init_pt_state(self.config, self.device, uses_k2(self.scene.num_spheres)) + (0,)

    # ---- progressive loop (idleFunc analogue) ----

    def step(self, samples: int = 1) -> np.ndarray:
        """Advance accumulation by ``samples`` passes; returns the image."""
        cfg = dataclasses.replace(self.config, spp=samples)
        img, self.state = render(self.scene, self.camera, cfg, state=self.state,
                                 device=self.device)
        self._image = img.cpu().numpy()
        return self._image

    def step_for(self, budget_s: float = 0.1) -> np.ndarray:
        """Adaptive multi-launch batching (smallptGPU.cpp:739-755): below 20
        accumulated samples, one pass per call for fast interactive
        feedback; past that, batches of passes climbing ``STEP_LADDER``
        until the wall-clock budget is spent."""
        if self.current_sample < 20:
            return self.step(1)
        t0 = time.perf_counter()
        img = self.step(self.STEP_LADDER[0])
        rung = 0
        while time.perf_counter() - t0 < budget_s:
            rung = min(rung + 1, len(self.STEP_LADDER) - 1)
            img = self.step(self.STEP_LADDER[rung])
        return img

    @property
    def current_sample(self) -> int:
        return int(self.state.sample if isinstance(self.state, RenderState) else self.state[3])

    # ---- ReInit semantics ----

    def _reinit(self):
        """ReInit(0)/ReInitScene: restart accumulation, keep the seeds
        (smallptGPU.cpp:784-830)."""
        if isinstance(self.state, RenderState):
            self.state = self.state._replace(accum=torch.zeros_like(self.state.accum), sample=0)
        else:
            s0, s1, acc, _ = self.state
            self.state = (s0, s1, torch.zeros_like(acc), 0)

    def refresh(self):
        """ReInit(1): reallocate buffers, fresh seeds (AllocateBuffers)."""
        self.state = self._fresh_state()

    # ---- camera edits (keyFunc:277-320, specialFunc) ----

    def _vec(self, x, y, z) -> torch.Tensor:
        return torch.tensor([x, y, z], dtype=torch.float32, device=self.device)

    def _move(self, delta: torch.Tensor):
        self.camera = Camera(orig=self.camera.orig + delta, target=self.camera.target + delta)
        self._reinit()

    def move_right(self):  # 'd'
        x = self.camera_basis().x
        self._move(MOVE_STEP * x / sqrt_rn(dot3(x, x)))

    def move_left(self):  # 'a'
        x = self.camera_basis().x
        self._move(-MOVE_STEP * x / sqrt_rn(dot3(x, x)))

    def move_forward(self):  # 'w'
        self._move(MOVE_STEP * self.camera_basis().dir)

    def move_backward(self):  # 's'
        self._move(-MOVE_STEP * self.camera_basis().dir)

    def move_up(self):  # 'r'
        self._move(self._vec(0.0, MOVE_STEP, 0.0))

    def move_down(self):  # 'f'
        self._move(self._vec(0.0, -MOVE_STEP, 0.0))

    def target_up(self):  # PageUp
        self.camera = dataclasses.replace(
            self.camera, target=self.camera.target + self._vec(0.0, MOVE_STEP, 0.0))
        self._reinit()

    def target_down(self):  # PageDown
        self.camera = dataclasses.replace(
            self.camera, target=self.camera.target - self._vec(0.0, MOVE_STEP, 0.0))
        self._reinit()

    def _rotate_vertical(self, angle: float):
        """UP/DOWN arrows: the sequential y-then-z update of the reference."""
        t = self.camera.target - self.camera.orig
        ty = t[1] * math.cos(angle) + t[2] * math.sin(angle)
        tz = -ty * math.sin(angle) + t[2] * math.cos(angle)
        t = torch.stack([t[0], ty, tz])
        self.camera = dataclasses.replace(self.camera, target=t + self.camera.orig)
        self._reinit()

    def _rotate_horizontal(self, angle: float):
        t = self.camera.target - self.camera.orig
        tx = t[0] * math.cos(angle) - t[2] * math.sin(angle)
        tz = tx * math.sin(angle) + t[2] * math.cos(angle)
        t = torch.stack([tx, t[1], tz])
        self.camera = dataclasses.replace(self.camera, target=t + self.camera.orig)
        self._reinit()

    def rotate_up(self):
        self._rotate_vertical(-ROTATE_STEP)

    def rotate_down(self):
        self._rotate_vertical(ROTATE_STEP)

    def rotate_left(self):
        self._rotate_horizontal(-ROTATE_STEP)

    def rotate_right(self):
        self._rotate_horizontal(ROTATE_STEP)

    def camera_basis(self):
        return update_camera(self.camera, self.config.width, self.config.height)

    # ---- object edits (keyFunc:322-355) ----

    def select_next(self):  # '+'
        self.current_sphere = (self.current_sphere + 1) % self.scene.num_spheres
        self._reinit()

    def select_prev(self):  # '-'
        n = self.scene.num_spheres
        self.current_sphere = (self.current_sphere + n - 1) % n
        self._reinit()

    def move_sphere(self, dx=0.0, dy=0.0, dz=0.0):
        center = self.scene.center.clone()
        center[self.current_sphere] += self._vec(dx, dy, dz)
        self.scene = dataclasses.replace(self.scene, center=center)
        self._reinit()

    # ---- output ('p') ----

    def save_image(self, path: str):
        from se195_raytracer_tpu_torch.io.image import write_image
        from se195_raytracer_tpu_torch.ops.tonemap import to_srgb_bytes

        img = self._image if self._image is not None else self.step(1)
        write_image(to_srgb_bytes(torch.from_numpy(img)).numpy(), path)

    # ---- key dispatch (README.txt:19-31 bindings) ----

    def key(self, k: str, path: str = "image.ppm") -> bool:
        """Apply one reference key binding. Returns False for ESC."""
        half = 0.5 * MOVE_STEP
        table = {
            "a": self.move_left, "d": self.move_right,
            "w": self.move_forward, "s": self.move_backward,
            "r": self.move_up, "f": self.move_down,
            "+": self.select_next, "-": self.select_prev,
            "4": lambda: self.move_sphere(dx=-half),
            "6": lambda: self.move_sphere(dx=half),
            "8": lambda: self.move_sphere(dz=-half),
            "2": lambda: self.move_sphere(dz=half),
            "9": lambda: self.move_sphere(dy=half),
            "3": lambda: self.move_sphere(dy=-half),
            " ": self.refresh,
            "up": self.rotate_up, "down": self.rotate_down,
            "left": self.rotate_left, "right": self.rotate_right,
            "pageup": self.target_up, "pagedown": self.target_down,
        }
        if k == "p":
            self.save_image(path)
            return True
        if k == "\x1b":
            return False
        fn = table.get(k)
        if fn is not None:
            fn()
        return True

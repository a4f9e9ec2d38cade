"""A render and an inverse step never make the host wait on the card.

A copy from pageable host memory to the device (``torch.tensor(..., device=
"cuda")``) blocks the host until the stream's queued work is done, so one
such copy inside a render turns two renders in flight into one. The render
path takes its constants from copies kept on the device (``core.types.
device_copy``): ``update_camera``'s ``up`` and K2's light list.

- on the CPU: ``update_camera`` bitwise (bit patterns, signed zeros
  included) against the formula with a fresh ``up``, values and the
  gradients of ``orig`` and ``target``, over the benchmark's cameras and
  edge cases; neither ``update_camera`` nor a miss of K2's tables calls
  ``torch.tensor`` once its constants are kept;
- on the card (``cuda``; skips here): K1's and K2's renders, whole and by
  pixel range, and a ``GroupAdam`` inverse step, under
  ``torch.cuda.set_sync_debug_mode("error")``, each bitwise the same call
  made outside the mode with the fresh-``up`` camera.

The file imports no JAX: ``python -m pytest tests/test_torch_render_no_sync.py
--noconftest -m cuda`` runs its ``cuda`` tests on a GPU machine."""

import contextlib
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from se195_raytracer_tpu_torch.core import types as T
from se195_raytracer_tpu_torch.core.config import RenderConfig
from se195_raytracer_tpu_torch.driver import grad_check
from se195_raytracer_tpu_torch.driver import optimize
from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk
from se195_raytracer_tpu_torch.scenes.registry import get_scene

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "benchmark" / "configs"
SIZES = ((512, 512), (640, 480), (37, 23))


def _update_camera_fresh_up(camera: T.Camera, width: int, height: int) -> T.CameraBasis:
    """``update_camera`` as it was written with ``up`` copied from the host on
    every call: the oracle."""
    d = camera.target - camera.orig
    d = d * (1.0 / T.sqrt_rn(T.dot3(d, d)))
    up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=d.device)
    fov = np.float32(np.pi / 180.0) * np.float32(45.0)
    cx = T._cross(d, up)
    cx = cx * (1.0 / T.sqrt_rn(T.dot3(cx, cx)))
    cx = cx * float(np.float32(width) * fov / np.float32(height))
    cy = T._cross(cx, d)
    cy = cy * (1.0 / T.sqrt_rn(T.dot3(cy, cy)))
    cy = cy * float(fov)
    return T.CameraBasis(orig=camera.orig, dir=d, x=cx, y=cy)


def _benchmark_camera(name):
    cam = json.loads((CONFIGS / f"{name}.json").read_text())["camera"]
    return cam["orig"], cam["target"]


def _random_camera(seed):
    rs = np.random.default_rng(seed)
    return rs.uniform(-300.0, 300.0, 3).tolist(), rs.uniform(-300.0, 300.0, 3).tolist()


CAMERAS = {
    "cornell": _benchmark_camera("cornell"),
    "complex783": _benchmark_camera("complex783"),
    "along+z": ([50.0, 40.0, -10.0], [50.0, 40.0, 90.0]),
    "along-z": ([0.0, 0.0, 0.0], [0.0, 0.0, -1.0]),
    "nearly+y": ([1.0, 2.0, 3.0], [1.001, 50.0, 3.0]),
    **{f"random{s}": _random_camera(s) for s in (0, 1, 2, 3)},
}


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.detach().contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit patterns: unlike ``torch.equal``, -0.0 differs from 0.0."""
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("name", list(CAMERAS))
def test_update_camera_bitwise_the_fresh_up_formula(name):
    orig, target = CAMERAS[name]
    cot = torch.from_numpy(np.random.default_rng(7).standard_normal((4, 3)).astype(np.float32))
    for w, h in SIZES:
        got, want = [], []
        for fn, out in ((T.update_camera, got), (_update_camera_fresh_up, want)):
            leaves = [torch.tensor(v, dtype=torch.float32, requires_grad=True)
                      for v in (orig, target)]
            basis = fn(T.Camera(*leaves), w, h)
            fields = [getattr(basis, k) for k in ("orig", "dir", "x", "y")]
            grads = torch.autograd.grad(fields, leaves, list(cot))
            out.extend(fields + list(grads))
        for k, a, b in zip(("orig", "dir", "x", "y", "d_orig", "d_target"), got, want):
            assert _same_bits(a, b), (name, (w, h), k, a, b)


def _refuse_host_tensor(*args, **kwargs):
    raise AssertionError("torch.tensor called: a copy from the host")


def test_update_camera_copies_nothing_once_up_is_kept(monkeypatch):
    camera = T.Camera.look_at(*CAMERAS["cornell"], device="cpu")
    first = T.update_camera(camera, 64, 48)
    monkeypatch.setattr(torch, "tensor", _refuse_host_tensor)
    again = T.update_camera(camera, 64, 48)
    assert all(_same_bits(getattr(first, k), getattr(again, k)) for k in ("dir", "x", "y"))
    up = T.device_copy((0.0, 1.0, 0.0), torch.float32, "cpu")
    assert up is T.device_copy([0.0, 1.0, 0.0], torch.float32, torch.device("cpu"))
    assert not up.requires_grad


def test_up_first_kept_under_inference_mode_still_takes_gradients():
    """A render under ``torch.inference_mode`` may be the first to ask for
    ``up``; the kept copy is a normal tensor, which autograd may save."""
    T._device_copy.cache_clear()
    with torch.inference_mode():
        T.update_camera(T.Camera.look_at(*CAMERAS["cornell"], device="cpu"), 64, 48)
    leaves = [torch.tensor(v, dtype=torch.float32, requires_grad=True)
              for v in CAMERAS["cornell"]]
    basis = T.update_camera(T.Camera(*leaves), 64, 48)
    grads = torch.autograd.grad(basis.x.sum() + basis.y.sum(), leaves)
    assert all(torch.isfinite(g).all() for g in grads)


def test_k2_tables_take_the_kept_light_list(monkeypatch):
    """Two renders' packs of one scene (``scene_table``, for two ``Scene``
    objects of the same tensors) share one build of K2's tables, which
    hands out ``light_list``'s tensor and copies nothing from the host."""
    scene = get_scene("complex").to_scene("cpu")
    lights = ptk.light_list(scene.light_indices, scene.device)
    ptk.pack_scene(scene)  # keeps its constants (``device_copy``)
    monkeypatch.setattr(torch, "tensor", _refuse_host_tensor)
    tab_a = ptk.scene_table(scene)
    tab_b = ptk.scene_table(dataclasses.replace(scene))
    a = ptk._k2_tables(tab_a, scene.light_indices)
    b = ptk._k2_tables(tab_b, scene.light_indices)
    assert tab_a is tab_b and all(x is y for x, y in zip(a, b))
    assert a[-1] is lights
    assert lights.dtype == torch.int32 and lights.tolist() == list(scene.light_indices)


# --- on the card ------------------------------------------------------------

CFG = RenderConfig(width=160, height=120, spp=4, seed=20261018)
PIXELS = (3001, 11017)


@contextlib.contextmanager
def _fresh_up_camera(monkeypatch):
    """The render path with the oracle's camera (``up`` copied per call)."""
    with monkeypatch.context() as m:
        m.setattr(ptk, "update_camera", _update_camera_fresh_up)
        m.setattr(optimize, "update_camera", _update_camera_fresh_up)
        yield


def _render(name, pixels):
    spec = get_scene(name)
    scene, camera = spec.to_scene("cuda"), spec.to_camera("cuda")
    assert (scene.num_spheres > ptk.UNROLL_MAX_SPHERES) == (name == "complex")

    def run():
        img, (s0, s1, acc, _) = ptk.render_cuda(scene, camera, CFG, device="cuda", pixels=pixels)
        return [img, s0, s1, acc]

    return run


def _step():
    """One ``GroupAdam`` step of an L2 image loss from the benchmark's start
    (the light moved, the left wall tinted) towards the Cornell render:
    the loss, the leaves' gradients and their values after the update."""
    spec = get_scene("cornell")
    scene, camera = spec.to_scene("cuda"), spec.to_camera("cuda")
    with torch.no_grad():
        target = optimize.render_differentiable(scene, camera, CFG, device="cuda")
    start = grad_check.grad_bench_start(scene)

    def adam(tr):
        return grad_check.GroupAdam({"geom": ([tr["center"]], 0.5), "mat": ([tr["color"]], 0.01)},
                                    220, 0.05)

    step = optimize.make_inverse_step(target, dataclasses.replace(CFG, seed=5), adam,
                                      lambda k: k in ("center", "color"), device="cuda")

    def run():
        st = step(optimize.OptState(start, camera, None, None))
        params = [p for g in st.opt_state.opt.param_groups for p in g["params"]]
        return [st.loss] + [p.grad for p in params] + [p.detach() for p in params]

    return run


CASES = {
    "k1": lambda: _render("cornell", None),
    "k1_pixels": lambda: _render("cornell", PIXELS),
    "k2": lambda: _render("complex", None),
    "k2_pixels": lambda: _render("complex", PIXELS),
    "step": _step,
}


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
@pytest.mark.parametrize("case", list(CASES))
def test_on_the_card_no_host_sync_and_the_same_bits(case, monkeypatch):
    run = CASES[case]()
    run()  # warm-up: the kernels' builds and the kept constants
    with _fresh_up_camera(monkeypatch):
        want = [t.clone() for t in run()]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert _same_bits(a, b), (case, i)

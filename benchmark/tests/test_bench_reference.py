"""The benchmark's plain reference against the program's plain path, on the
CPU: images bitwise, every leaf's gradient to the rounding of a sum's
order, seeds bit for bit numpy's PCG64, scenes the program's own."""

import json

import numpy as np
import pytest
import torch

from harness.manifest import BENCH_DIR
from reference import scenes
from reference import smallpt as ref

SIZE = 16


def config(name):
    return json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())


def arrays_of(name, cut=None):
    a = scenes.build(config(name)["scene"])
    return {k: v[:cut] for k, v in a.items()} if cut else a


def port_scene(a):
    from se195_raytracer_tpu_torch.core.types import Scene

    return Scene.from_arrays(a["center"], a["radius"], a["emission"], a["color"], a["refl"],
                             device="cpu")


def port_camera(name):
    from se195_raytracer_tpu_torch.core.types import Camera

    return Camera.look_at(*scenes.camera(config(name)), device="cpu")


CASES = [("cornell", None), ("complex783", 100)]


@pytest.mark.parametrize("name,cut", CASES)
def test_image_is_the_programs_plain_image(name, cut):
    from se195_raytracer_tpu_torch.core.config import RenderConfig
    from se195_raytracer_tpu_torch.driver.render import render

    a = arrays_of(name, cut)
    spp, seed = 3, 2**33 + 5
    cfg = RenderConfig(width=SIZE, height=SIZE, spp=spp, seed=seed)
    want, _ = render(port_scene(a), port_camera(name), cfg, device="cpu")
    frame = ref.Frame(SIZE, SIZE, spp)
    o, t = (torch.tensor(v) for v in scenes.camera(config(name)))
    got = ref.render_pixels(ref.make_scene(a, "cpu"), ref.camera_basis(o, t, SIZE, SIZE), frame,
                            seed, ref.all_pixels(frame, "cpu"), block=100)
    assert torch.equal(got, want.reshape(-1, 3))


@pytest.mark.parametrize("name,cut", CASES)
def test_every_leafs_gradient_is_the_programs_plain_gradient(name, cut):
    from se195_raytracer_tpu_torch.core.config import RenderConfig
    from se195_raytracer_tpu_torch.driver.optimize import _render_plain_diff

    a = arrays_of(name, cut)
    spp, seed = 2, 77
    cot = torch.from_numpy(np.random.default_rng(1).standard_normal((SIZE * SIZE, 3),
                                                                    dtype=np.float32))
    fields = ("center", "radius", "emission", "color")
    scene = port_scene(a)
    leaves = {k: getattr(scene, k).clone().requires_grad_(True) for k in fields}
    import dataclasses

    cfg = RenderConfig(width=SIZE, height=SIZE, spp=spp, seed=seed)
    img = _render_plain_diff(dataclasses.replace(scene, **leaves), port_camera(name), cfg,
                             remat=False)
    want = torch.autograd.grad((img.reshape(-1, 3) * cot).sum(), [leaves[k] for k in fields])

    rs = ref.make_scene(a, "cpu")
    rl = {k: getattr(rs, k).clone().requires_grad_(True) for k in fields}
    rs = rs._replace(**rl)
    frame = ref.Frame(SIZE, SIZE, spp)
    o, t = (torch.tensor(v) for v in scenes.camera(config(name)))
    out = ref.render_pixels(rs, ref.camera_basis(o, t, SIZE, SIZE), frame, seed,
                            ref.all_pixels(frame, "cpu"), mean="divide")
    got = torch.autograd.grad((out * cot).sum(), [rl[k] for k in fields])
    for k, g, w in zip(fields, got, want):
        scale = float(w.abs().max())
        assert scale > 0.0, k
        # The two sum each sphere's cotangents over the lanes in another
        # order: float32 round-off over 256 lanes.
        assert float((g - w).abs().max()) <= 1e-5 * scale, k


@pytest.mark.parametrize("seed", [0, 125, 2425, 2**31 + 12345, 2**40 + 7])
def test_seeds_are_numpys_pcg64_bit_for_bit(seed):
    """Against numpy's own draw and against the program's plain version of
    its seed kernel, which steps PCG64 itself (seeds 125 and 2425 reject a
    word of the frame's draws)."""
    from se195_raytracer_tpu_torch.kernels.seed_kernel import seed_lanes_reference

    n = 512 * 512
    s0, s1 = ref.seeds(seed, n)
    want = np.random.Generator(np.random.PCG64(seed)).integers(2, 2**31 - 1, size=2 * n,
                                                               dtype=np.uint32)
    assert np.array_equal(np.concatenate([s0, s1]), want)
    p0, p1 = seed_lanes_reference("mwc", seed, n, n)
    assert np.array_equal(p0.numpy().astype(np.int64), s0.astype(np.int64))
    assert np.array_equal(p1.numpy().astype(np.int64), s1.astype(np.int64))


@pytest.mark.parametrize("name,registry", [("cornell", "cornell"), ("complex783", "complex")])
def test_configured_scenes_are_the_programs_scenes(name, registry):
    from se195_raytracer_tpu_torch.scenes.registry import get_scene

    a, spec = arrays_of(name), get_scene(registry)
    for k in ("center", "radius", "emission", "color", "refl"):
        assert np.array_equal(a[k], getattr(spec, k).astype(a[k].dtype)), k
    o, t = scenes.camera(config(name))
    assert np.array_equal(o, spec.camera_orig) and np.array_equal(t, spec.camera_target)
    assert len(a["radius"]) == config(name)["scene"]["num_spheres"]


def test_bfloat16_reference_departs_from_float32():
    """The control's precision gives another image (what the check must
    refuse), from the same seeds."""
    a = arrays_of("cornell")
    frame = ref.Frame(SIZE, SIZE, 8)
    o, t = (torch.tensor(v) for v in scenes.camera(config("cornell")))
    px = ref.all_pixels(frame, "cpu")
    imgs = [ref.render_pixels(ref.make_scene(a, "cpu", dt),
                              ref.camera_basis(o.to(dt), t.to(dt), SIZE, SIZE), frame, 9, px,
                              dtype=dt) for dt in (torch.float32, torch.bfloat16)]
    assert ref.image_gap(imgs[1], imgs[0]) > 0.1


def test_image_gap():
    want = torch.tensor([[1.0, 2.0, 3.0], [0.0, 0.0, 4.0]])
    assert ref.image_gap(want, want) == 0.0
    assert ref.image_gap(torch.zeros_like(want), want) == 1.0
    assert ref.image_gap(want * 1.1, want) == pytest.approx(0.1)
    assert ref.image_gap(want * float("nan"), want) == float("inf")

"""The benchmark's plain reference of the Raytracer3.2 Whitted tracer
(``benchmark/reference/whitted.py``) against the port's ``render_whitted``
on the CPU (K3's plain twin, through the normal path), on seeded random
scenes and on the room, at the fixed camera and at drawn poses; a tree one
level short and the bfloat16 reference fail the same comparison; the
reference renders a sample of pixels as its whole frame has them; the
``room3`` configuration's rows build ``room_scene`` bit for bit; and with no
camera the render is the frame of the fixed viewpoint, bit for bit."""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from se195_raytracer_tpu_torch.core.config import RenderConfig
from se195_raytracer_tpu_torch.kernels import whitted_kernel as K
from se195_raytracer_tpu_torch.models import whitted as P
from se195_raytracer_tpu_torch.scenes import whitted_scenes as S

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness.manifest import load_module  # noqa: E402
from reference import smallpt as ref  # noqa: E402
from reference import whitted as refw  # noqa: E402

W, H, SS = 24, 18, 3
# The reference computes every node as the plain twin does, in the same
# float32 operations, and sums a ray's nodes breadth first where the port
# sums them depth first: up to 63 float32 sums in another order move a
# pixel by a few ulps, ~1e-7 of its value. 1e-6 of the frame's light holds
# that with room; a level of the tree left out moves 1e-4 or more of it.
TOLERANCE = 1e-6
CONFIG = json.loads((BENCH / "configs" / "room3.json").read_text())
WALK = json.loads((BENCH / "traffic" / "whitted.ss3.json").read_text())["camera_walk"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _driver():
    return load_module(BENCH / "drivers" / "whitted_loop.py")


def random_scene(seed: int) -> dict:
    """A configuration's scene of seeded random rows inside a box of planes
    (floor, ceiling, side, back and front walls) around the camera walk:
    three to five spheres of random materials, one or two refractive and
    one a mirror, and one to three small sphere lights near the ceiling."""
    rng = np.random.Generator(np.random.PCG64(seed))

    def u(lo, hi, n=None):
        v = rng.uniform(lo, hi, n)
        return [round(float(x), 3) for x in v] if n else round(float(v), 3)

    def row(kind, geo, **kw):
        base = dict(color=u(0.2, 1.2, 3), refl=0.0, refr=0.0, refr_index=0.0, diff=u(0.1, 1.0),
                    spec=u(0.0, 1.5), is_light=False)
        base.update(kw)
        return {"type": kind, **geo, **base}

    prims = [
        row("plane", {"normal": [0.0, 1.0, 0.0], "depth": u(4.0, 5.0)}),
        row("plane", {"normal": [0.0, -1.0, 0.0], "depth": 7.0}, refl=u(0.0, 0.3)),
        row("plane", {"normal": [1.0, 0.0, 0.0], "depth": u(6.0, 8.0)}),
        row("plane", {"normal": [-1.0, 0.0, 0.0], "depth": u(6.0, 8.0)}),
        row("plane", {"normal": [0.0, 0.0, -1.0], "depth": u(25.0, 35.0)}),
        row("plane", {"normal": [0.0, 0.0, 1.0], "depth": 8.0}),
        row("sphere", {"center": [u(-3, 3), u(-3, -1), u(12, 20)], "radius": u(1.0, 2.5)},
            refr=1.0, refr_index=u(1.1, 1.6), refl=u(0.05, 0.3), diff=0.0, spec=0.0,
            color=u(0.05, 0.3, 3)),
        row("sphere", {"center": [u(-5, -2), u(-3, 0), u(15, 25)], "radius": u(1.0, 2.0)},
            refl=u(0.5, 0.9), diff=0.0, spec=0.0),
        row("sphere", {"center": [u(2, 5), u(-3, 0), u(14, 24)], "radius": u(0.8, 1.6)}),
    ]
    for _ in range(int(rng.integers(0, 3))):
        prims.append(row("sphere", {"center": [u(-4, 4), u(-3, 1), u(10, 25)],
                                    "radius": u(0.5, 1.2)},
                         refr=float(rng.integers(0, 2)), refr_index=u(1.1, 1.5),
                         refl=u(0.0, 0.5)))
    for _ in range(int(rng.integers(1, 4))):
        prims.append(row("sphere", {"center": [u(-4, 4), 6.0, u(10, 24)], "radius": 0.3},
                         is_light=True, color=[u(0.5, 0.9)] * 3, diff=0.0, spec=1.0))
    return {"kind": "whitted", "num_primitives": len(prims), "primitives": prims}


def _port(scene_cfg, depth, bias, camera, **kw):
    scene = _driver().port_scene(scene_cfg, "cpu")
    cfg = RenderConfig(width=W, height=H, supersample=SS, trace_depth=depth, hit_bias=bias,
                       **kw)
    return P.render_whitted(scene, cfg, device="cpu", camera=camera).reshape(-1, 3)


def _reference(scene_cfg, depth, bias, camera, dtype=torch.float32):
    frame = refw.Frame(W, H, SS * SS, depth, bias)
    row = refw.camera_row(*camera) if camera is not None else refw.camera_row()
    return refw.render_pixels(refw.make_scene(scene_cfg, "cpu", dtype), frame, row,
                              refw.all_pixels(frame, "cpu"), dtype=dtype, block=97)


SCENES = {"room": CONFIG["scene"], "random_3": random_scene(3), "random_4": random_scene(4),
          "random_12": random_scene(12)}


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("depth", [1, 3, 5])
@pytest.mark.parametrize("bias", [0.0, 0.005])
def test_the_port_is_the_reference_and_a_level_short_is_not(name, depth, bias):
    scene_cfg = SCENES[name]
    for camera in (None, refw.pose(2**33 + 17 * depth, WALK)):
        got = _port(scene_cfg, depth, bias, camera)
        want = _reference(scene_cfg, depth, bias, camera)
        assert float(want.abs().sum()) > 0.0
        assert ref.image_gap(got, want) <= TOLERANCE, camera
        short = _port(scene_cfg, depth - 1, bias, camera)
        assert ref.image_gap(short, want) > TOLERANCE, camera


def test_random_scenes_hold_refraction_mirrors_and_one_to_three_lights():
    lights = set()
    for name, cfg in SCENES.items():
        prims = cfg["primitives"]
        assert any(p["refr"] > 0 for p in prims) and any(p["refl"] > 0 for p in prims), name
        assert {p["type"] for p in prims} == {"plane", "sphere"}, name
        lights.add(sum(p["is_light"] for p in prims))
    assert lights == {1, 2, 3}


def test_bfloat16_fails_the_comparison():
    camera = refw.pose(2**33 + 5, WALK)
    want = _reference(CONFIG["scene"], 5, 0.0, camera)
    low = _reference(CONFIG["scene"], 5, 0.0, camera, dtype=torch.bfloat16)
    assert not ref.image_gap(low, want) <= TOLERANCE


def test_the_plain_render_and_k3s_twin_agree_with_a_pose():
    """``use_kernel=False`` (``render_whitted_scene`` in ray tiles) and K3's
    CPU route (``whitted_frame_cuda``) give one frame for a pose and for a
    [12] row of it."""
    camera = refw.pose(2**35 + 1, WALK)
    a = _port(CONFIG["scene"], 5, 0.0, camera)
    b = _port(CONFIG["scene"], 5, 0.0, camera, use_kernel=False, ray_tile=1000)
    c = _port(CONFIG["scene"], 5, 0.0, torch.from_numpy(P.whitted_camera_row(*camera)))
    assert torch.equal(a, b) and torch.equal(a, c)


def test_no_camera_is_the_fixed_viewpoints_frame_bitwise():
    """``camera=None`` renders what ``render_whitted`` rendered before it
    took a camera: K3's entry with no row (its fixed host row) on the
    kernel route, ``render_whitted_scene`` with none on the plain one."""
    scene = S.room_scene("cpu")
    for depth, bias in ((5, 0.0), (2, 0.005)):
        cfg = RenderConfig(width=W, height=H, supersample=SS, trace_depth=depth, hit_bias=bias)
        got = P.render_whitted(scene, cfg, device="cpu")
        want = K.whitted_frame_cuda(scene, width=W, height=H, supersample=SS,
                                    trace_depth=depth, hit_bias=bias)
        assert torch.equal(got, want)
        assert torch.equal(got, P.render_whitted_scene(scene, W, H, SS, depth, bias))
        plain = dataclasses.replace(cfg, use_kernel=False, ray_tile=500)
        assert torch.equal(P.render_whitted(scene, plain, device="cpu"), got)


def test_a_camera_that_is_no_pose_or_row_raises():
    scene = S.room_scene("cpu")
    with pytest.raises(ValueError, match="camera"):
        P.render_whitted(scene, RenderConfig(width=4, height=3), device="cpu",
                         camera=[0.0] * 6)


def test_the_references_camera_is_the_ports():
    for camera in ((None, None), refw.pose(7, WALK), refw.pose(2**40 + 3, WALK)):
        assert np.array_equal(refw.camera_row(*camera), P.whitted_camera_row(*camera))


def test_poses_stay_inside_the_walk():
    eye, target = zip(*(refw.pose(s, WALK) for s in range(200)))
    for pts, bounds in ((eye, WALK["eye"]), (target, WALK["target"])):
        a = np.array(pts)
        assert (a >= np.array(bounds)[:, 0]).all() and (a <= np.array(bounds)[:, 1]).all()
    assert refw.pose(11, WALK) == refw.pose(11, WALK) != refw.pose(12, WALK)


def test_sampled_pixels_are_the_whole_frames():
    frame = refw.Frame(W, H, 9, 5, 0.0)
    scene = refw.make_scene(SCENES["random_4"], "cpu")
    row = refw.camera_row(*refw.pose(77, WALK))
    whole = refw.render_pixels(scene, frame, row, refw.all_pixels(frame, "cpu"), block=200)
    pixels = ref.sample_pixels(frame, 100, np.random.Generator(np.random.PCG64(5)), "cpu")
    some = refw.render_pixels(scene, frame, row, pixels, block=64)
    assert torch.equal(some, whole[pixels])


def test_room3_rows_build_room_scene_bitwise():
    got = _driver().port_scene(CONFIG["scene"], "cpu")
    want = S.room_scene("cpu")
    for f in S.FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert (got.ptype, got.is_light) == (want.ptype, want.is_light)
    assert CONFIG["scene"]["num_primitives"] == want.num_prims == 16
    mine = refw.make_scene(CONFIG["scene"], "cpu")
    for f in S.FIELDS:
        assert torch.equal(getattr(mine, f), getattr(want, f)), f
    assert (CONFIG["trace_depth"], CONFIG["supersample"], CONFIG["hit_bias"]) == (
        RenderConfig().trace_depth, RenderConfig().supersample, RenderConfig().hit_bias)

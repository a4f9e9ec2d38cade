"""The benchmark's plain reference of the raytracer5 tracer
(``benchmark/reference/whitted5.py``) against the port's ``render_whitted5``
on the CPU (K4's plain twin), on seeded random scenes; the bfloat16
reference fails the same comparison; the reference renders a sample of
pixels as its whole frame has them; and the ``room5`` configuration's rows
build ``room5_scene(textures="procedural")`` bit for bit."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from se195_raytracer_tpu_torch.models import whitted5 as P
from se195_raytracer_tpu_torch.scenes import whitted5_scenes as S

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness.manifest import load_module  # noqa: E402
from reference import smallpt as ref  # noqa: E402
from reference import whitted5 as ref5  # noqa: E402

W, H, SPP, DEPTH = 32, 24, 2, 4
# The reference is the plain twin's float32 operations in the same order,
# so on the CPU the two agree bit for bit in practice; 1e-6 of the frame's
# light only absorbs a last-bit difference of a transcendental (acos, cos,
# sin, exp) between torch's vectorized and scalar loops, which moves a pixel
# by ulps. A node sent another way moves a pixel's pass, 1/1536 of a
# 32x24 frame at spp 2, far above it.
TOLERANCE = 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _driver():
    return load_module(BENCH / "drivers" / "whitted5_loop.py")


def random_scene(seed: int) -> dict:
    """A configuration's scene of seeded random rows: a textured floor plane,
    a back plane, a refractive ceiling plane, a textured sphere, a glossy
    sphere, a refractive sphere, a mirror box, one to two box area lights
    and, for odd seeds, a sphere light; two random bitmaps, of one shape for
    even seeds (one atlas fetch in the port) and two shapes for odd."""
    rng = np.random.Generator(np.random.PCG64(seed))

    def u(lo, hi, n=None):
        v = rng.uniform(lo, hi, n)
        return [round(float(x), 3) for x in v] if n else round(float(v), 3)

    def row(kind, geo, **kw):
        base = dict(color=u(0.3, 1.0, 3), refl=0.0, refr=0.0, refr_index=1.5, diff=u(0.2, 1.0),
                    spec=u(0.0, 0.9), drefl=0.0, uv_scale=u(0.2, 1.0, 2), is_light=False,
                    texture=None)
        base.update(kw)
        return {"type": kind, **geo, **base}

    shapes = ([16, 16], [16, 16]) if seed % 2 == 0 else ([16, 24], [8, 8])
    prims = [
        row("plane", {"normal": [0.0, 1.0, 0.0], "depth": u(3.5, 4.5)}, texture="a"),
        row("sphere", {"center": [u(-1, 1), u(-1.5, 0), u(6, 8)], "radius": u(1.2, 2.0)},
            texture="b", refl=u(0.0, 0.2)),
        row("sphere", {"center": [u(-5, -3), u(-1.5, 0), u(6, 8)], "radius": u(1.0, 2.0)},
            refl=0.5, drefl=u(0.2, 0.6)),
        row("sphere", {"center": [u(2, 4), u(-1, 0.5), u(4, 6)], "radius": u(0.8, 1.5)},
            refr=0.8, refr_index=u(1.2, 1.6), diff=0.1),
        row("box", {"box_pos": [-1.0, 5.0, u(3, 5)], "box_size": [2.0, 0.1, 2.0]},
            is_light=True, color=[0.5, 0.5, 0.5]),
        row("plane", {"normal": [0.0, 0.0, -1.0], "depth": u(9, 11)}),
        row("box", {"box_pos": [u(3, 5), -2.0, 0.5], "box_size": [0.25, 3.5, u(6, 12)]},
            refl=0.3),
        row("plane", {"normal": [0.0, 1.0, 0.0], "depth": 5.5}, refr=0.5, diff=0.0),
    ]
    if seed % 3 != 0:
        prims.append(row("box", {"box_pos": [u(-7, -5), 5.0, 4.0], "box_size": [2.0, 0.1, 2.0]},
                         is_light=True, color=[0.4, 0.4, 0.5]))
    if seed % 2:
        prims.append(row("sphere", {"center": [u(-2, 2), 3.0, u(2, 4)], "radius": 0.1},
                         is_light=True, color=[0.6, 0.6, 0.6]))
    return {"textures": [{"name": "a", "generator": "noise", "size": shapes[0], "seed": seed},
                         {"name": "b", "generator": "noise", "size": shapes[1], "seed": seed + 1}],
            "primitives": prims}


def _frame():
    return ref5.Frame(W, H, SPP, DEPTH, P.samples_per_level(DEPTH))


@pytest.mark.parametrize("seed", [11, 12, 15])
def test_the_plain_twin_is_the_reference_and_bfloat16_is_not(seed):
    cfg = random_scene(seed)
    scene = _driver().port_scene(cfg, "cpu")
    kinds = set(scene.ptype)
    assert kinds == {S.SPHERE5, S.PLANE5, S.BOX5} and any(scene.is_light)
    render_seed = 2**40 + seed
    got = P.render_whitted5(scene, W, H, spp=SPP, trace_depth=DEPTH, seed=render_seed,
                            device="cpu").reshape(-1, 3)
    frame = _frame()
    pixels = ref5.all_pixels(frame, "cpu")
    want = ref5.render_pixels(ref5.make_scene(cfg, "cpu"), frame, render_seed, pixels)
    assert float(want.abs().sum()) > 0.0
    assert ref.image_gap(got, want) <= TOLERANCE
    low = ref5.render_pixels(ref5.make_scene(cfg, "cpu", torch.bfloat16), frame, render_seed,
                             pixels, dtype=torch.bfloat16)
    assert ref.image_gap(low, want) > TOLERANCE


def test_sampled_pixels_are_the_whole_frames():
    cfg = random_scene(12)
    frame = _frame()
    scene = ref5.make_scene(cfg, "cpu")
    whole = ref5.render_pixels(scene, frame, 77, ref5.all_pixels(frame, "cpu"), block=200)
    pixels = ref.sample_pixels(frame, 100, np.random.Generator(np.random.PCG64(5)), "cpu")
    some = ref5.render_pixels(scene, frame, 77, pixels, block=64)
    assert torch.equal(some, whole[pixels])


def test_room5_rows_build_room5_scene_bitwise():
    cfg = json.loads((BENCH / "configs" / "room5.json").read_text())
    got = _driver().port_scene(cfg["scene"], "cpu")
    want = S.room5_scene(textures="procedural", device="cpu")
    for f in S.FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert len(got.textures) == len(want.textures)
    assert all(torch.equal(a, b) for a, b in zip(got.textures, want.textures))
    assert (got.ptype, got.is_light, got.tex_id) == (want.ptype, want.is_light, want.tex_id)
    assert cfg["scene"]["num_primitives"] == want.num_prims == 11
    # The reference's own scene of the rows holds the same numbers.
    mine = ref5.make_scene(cfg["scene"], "cpu")
    for f in S.FIELDS:
        assert torch.equal(getattr(mine, f), getattr(want, f)), f
    assert all(torch.equal(a, b) for a, b in zip(mine.textures, want.textures))
    assert (cfg["trace_depth"], tuple(cfg["area_samples"])) == (
        P.TRACEDEPTH5, P.samples_per_level(P.TRACEDEPTH5))

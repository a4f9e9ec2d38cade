"""K3's debug taps in the port (``models/whitted.whitted_taps`` and its
wrapper ``kernels/whitted_kernel.whitted_taps_cuda``) against the JAX
kernel's tap entry, ``whitted_trace_pallas_padded(..., debug_tap=...)`` in
interpret mode on the CPU.

The rays: one 8 x 128 tile of the room, 480 rays of the reference camera,
480 of a moved one (``MOVED`` of tests/test_torch_whitted.py) and 64 pad
lanes (o = d = 0), for hit_bias 0 and 0.005. The bars:
- ``tres``: the result and the plane flag exact; the distance within rtol
  1e-6, float32 max on the same lanes (the misses);
- ``attr``: red, diffuse factor and light flag exact (table values);
- ``shade``: rtol 1e-3 and atol 2e-2 on every component, the bound of
  tests/test_torch_whitted.py.

The interpret-mode kernel is jitted XLA. XLA's CPU fusions contract
products into FMAs, and in the room's far small spheres the quadratic
b*b - v.v + r^2 cancels: the contracted kernel's distances move by up to
1.2e-5 relative (36 of the 960 rays). So the JAX kernel is compiled here
without the fusion pass (``compiler_options={"xla_disable_hlo_passes":
"fusion"}``, for this compile only), which leaves each float32 operation
rounded on its own, as the port does: the taps then agree bitwise, well
inside the bars above.

The tap kernel takes the scene's light and occluder lists from its wrapper
(``tap_lists``), held here to the order of the kernel's own ``load_scene``.

The JAX package is imported inside the tests that use it, so that the
``cuda`` tests run on a GPU machine without JAX:
``python -m pytest tests/test_torch_whitted_taps.py --noconftest -m cuda``."""

import numpy as np
import pytest
import torch

from se195_raytracer_tpu_torch.kernels import whitted_kernel as wk
from se195_raytracer_tpu_torch.models import whitted as W
from se195_raytracer_tpu_torch.scenes.whitted_scenes import WHITTED_SCENES


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several pytest workers
    at once, whose OpenMP teams otherwise stall each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MOVED = dict(orig=(1.5, 1.0, -6.0), target=(0.0, 0.0, 2.0))
RTOL, ATOL = 1e-3, 2e-2
F32_MAX = np.finfo(np.float32).max


def _tile():
    """[6, 8, 128]: the reference camera's 12 x 10 x 2^2 rays, the moved
    camera's, then 64 inert pad lanes."""
    rays = [W.whitted_camera_rays_device(12, 10, 2, torch.from_numpy(row), device="cpu")
            for row in (W.whitted_camera_row(), W.whitted_camera_row(**MOVED))]
    o = torch.cat([r[0] for r in rays])
    d = torch.cat([r[1] for r in rays])
    tiles = wk.rays_to_tiles(o, d)
    assert tiles.shape == (6, 8, 128) and o.shape[0] == 960
    return tiles


def _jax_taps(tiles, tap, hit_bias):
    """JAX's ``whitted_trace_pallas_padded(debug_tap=tap)`` in interpret mode
    on ``tiles``, compiled without XLA's fusion pass (the module's docstring
    says why)."""
    import jax.numpy as jnp

    from se195_raytracer_tpu.kernels.whitted_kernel import (pack_whitted_scene,
                                                           whitted_trace_pallas_padded)
    from se195_raytracer_tpu.scenes.whitted_scenes import WHITTED_SCENES as J_SCENES

    js = J_SCENES["room"]()
    tab, rays = pack_whitted_scene(js), jnp.asarray(tiles.numpy())
    compiled = whitted_trace_pallas_padded.lower(
        tab, rays, ptype=js.ptype, is_light=js.is_light, trace_depth=1, hit_bias=hit_bias,
        sublanes=8, interpret=True, debug_tap=tap,
    ).compile(compiler_options={"xla_disable_hlo_passes": "fusion"})
    return np.asarray(compiled(tab, rays))


@pytest.mark.parametrize("hit_bias", [0.0, 0.005])
@pytest.mark.parametrize("tap", W.TAPS)
def test_taps_match_jax_kernel(tap, hit_bias):
    ps = WHITTED_SCENES["room"]("cpu")
    tiles = _tile()
    got = wk.whitted_taps_cuda(ps, tiles, tap=tap, hit_bias=hit_bias)
    assert got.shape == (3, 8, 128) and got.dtype == torch.float32
    flat = tiles.reshape(6, -1)
    plain = W.whitted_taps(ps, flat[0:3].T, flat[3:6].T, tap, hit_bias)
    assert torch.equal(got.reshape(3, -1).T, plain)  # the CPU wrapper is the plain version
    a, b = got.numpy().reshape(3, -1), _jax_taps(tiles, tap, hit_bias).reshape(3, -1)
    if tap == "tres":
        np.testing.assert_array_equal(a[1:], b[1:])
        miss = a[1] == 0.0
        assert miss[960:].all() and not miss[:960].all()  # pad lanes miss, rays hit
        np.testing.assert_array_equal(a[0][miss], np.full(miss.sum(), F32_MAX, np.float32))
        np.testing.assert_array_equal(b[0][miss], a[0][miss])
        np.testing.assert_allclose(a[0][~miss], b[0][~miss], rtol=1e-6)
        assert set(np.unique(a[1])) <= {-1.0, 0.0, 1.0} and a[2].max() == 1.0
    elif tap == "attr":
        np.testing.assert_array_equal(a, b)
        assert a[2].max() == 1.0  # some rays see the light
    else:
        assert np.isfinite(a).all() and a.max() > 0.1
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_unknown_tap_raises():
    ps = WHITTED_SCENES["room"]("cpu")
    tiles = _tile()
    with pytest.raises(ValueError, match="unknown debug tap"):
        wk.whitted_taps_cuda(ps, tiles, tap="normals")
    with pytest.raises(ValueError, match="unknown debug tap"):
        W.whitted_taps(ps, tiles[0:3, 0].T, tiles[3:6, 0].T, "normals")
    with pytest.raises(ValueError):  # as the JAX kernel does (whitted_kernel.py:370)
        _jax_taps(tiles, "normals", 0.0)


def test_shade_tap_is_the_first_tree_node():
    """At trace_depth 0 the tree is its root: the shade tap equals the
    explicit-ray entry's color on the camera rays (not the pad lanes)."""
    ps = WHITTED_SCENES["grid"]("cpu")
    tiles = _tile()
    shade = wk.whitted_taps_cuda(ps, tiles, tap="shade", hit_bias=0.005)
    root = wk.whitted_trace_cuda(ps, tiles, trace_depth=0, hit_bias=0.005)
    assert torch.equal(shade.reshape(3, -1)[:, :960], root.reshape(3, -1)[:, :960])


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
@pytest.mark.parametrize("name", ["room", "grid"])
@pytest.mark.parametrize("hit_bias", [0.0, 0.005])
def test_tap_kernel_bitwise_on_cuda(name, hit_bias):
    """Each tap of K3's tap entry bitwise equal to the plain version on the
    card (a 160 x 120 x 3^2 frame's rays, a partial last block), one launch
    a tap."""
    ps = WHITTED_SCENES[name]("cuda")
    o, d = W.whitted_camera_rays_device(160, 120, 3, device="cuda")
    tiles = wk.rays_to_tiles(o, d)
    for tap in W.TAPS:
        before = wk.whitted_taps_cuda.launches
        got = wk.whitted_taps_cuda(ps, tiles, tap=tap, hit_bias=hit_bias)
        torch.cuda.synchronize()
        assert wk.whitted_taps_cuda.launches == before + 1
        flat = tiles.reshape(6, -1)
        plain = W.whitted_taps(ps, flat[0:3].T, flat[3:6].T, tap, hit_bias)
        assert torch.equal(got.reshape(3, -1).T, plain), tap


def _load_scene_lists(ptype, is_light):
    """The light and occluder lists as ``load_scene`` (csrc/whitted_kernel.cu)
    builds them for K3: one pass over the primitives, a light to the light
    list and a non-light sphere to the occluders, then a pass adding the
    non-light planes."""
    lights, occ = [], []
    for j in range(len(ptype)):
        if is_light[j]:
            lights.append(j)
        elif ptype[j] != 0:
            occ.append(j)
    occ += [j for j in range(len(ptype)) if not is_light[j] and ptype[j] == 0]
    return lights + occ, len(lights), len(occ)


@pytest.mark.parametrize("name", ["room", "grid", "mixed", "big"])
def test_tap_lists_in_load_scene_order(name):
    """Lights first by index, then the non-light spheres, then the non-light
    planes, each by index: the order ``load_scene`` builds."""
    if name in WHITTED_SCENES:
        scene = WHITTED_SCENES[name]("cpu")
        ptype, is_light = scene.ptype, scene.is_light
    elif name == "mixed":  # a plane light and lights after occluders
        ptype, is_light = [1, 0, 1, 0, 1, 1, 0], [False, True, False, False, True, False, False]
    else:
        scene = _big_scene("cpu")
        ptype, is_light = scene.ptype, scene.is_light
    got = wk.tap_lists(ptype, is_light)
    assert got == _load_scene_lists(ptype, is_light)
    lists, nl, no = got
    assert sorted(lists) == list(range(len(ptype))) and nl + no == len(ptype)


def _big_scene(device):
    """Past 48 KB of a block's shared memory: grid's kind of room (3 planes,
    2 lights, 3 spheres) and a 24 x 25 grid of small spheres, 608
    primitives."""
    from se195_raytracer_tpu_torch.scenes.whitted_scenes import WhittedSceneBuilder, _adders, _mat

    b = WhittedSceneBuilder()
    plane, sphere = _adders(b)
    plane(_mat(0.4, 0.3, 0.3, 0.0, 0.0, 1.0, 1.0, 0.8), False, 0.0, 1.0, 0.0, 4.4)
    sphere(_mat(0.7, 0.7, 1.0, 0.0, 1.0, 1.3, 0.2, 0.8), False, 2.0, 0.8, 3.0, 2.5)
    sphere(_mat(0.4, 0.4, 0.4, 0.0, 0.0, 1.0, 0.0, 0.0), True, 0.0, 5.0, 5.0, 0.1)
    sphere(_mat(0.6, 0.6, 0.8, 0.0, 0.0, 1.0, 0.0, 0.0), True, -3.0, 5.0, 1.0, 0.1)
    sphere(_mat(1.0, 0.4, 0.4, 0.5, 0.0, 1.0, 0.2, 0.8), False, -1.5, -3.8, 1.0, 1.5)
    plane(_mat(0.5, 0.3, 0.5, 0.0, 0.0, 1.0, 0.6, 0.0), False, 0.4, 0.0, -1.0, 12.0)
    plane(_mat(0.4, 0.7, 0.7, 0.0, 0.0, 1.0, 0.5, 0.0), False, 0.0, -1.0, 0.0, 7.4)
    sphere(_mat(0.7, 0.7, 1.0, 0.5, 0.0, 1.0, 0.1, 0.8), False, -5.5, -0.5, 7.0, 2.0)
    for x in range(24):
        for y in range(25):
            sphere(_mat(0.3 + 0.02 * (x % 8), 1.0, 0.4, 0.2 * (y % 2), 0.0, 1.0, 0.6, 0.6),
                   False, -4.2 + x * 0.35, -3.6 + y * 0.3, 10.0, 0.12)
    scene = b.build(device)
    assert scene.num_prims == 608 and wk.shared_memory_bytes(608) > 48 * 1024
    return scene


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
@pytest.mark.parametrize("name", ["room", "big"])
def test_tap_persistent_grid_bitwise_on_cuda(name):
    """The persistent grid striding over more rays than the card holds
    threads: 640 x 480 camera rays (307,200, in 300 tiles of 1,024: no
    multiple of 33 tiles, so of no grid of 132 SMs x 256 threads), on room
    and on a 608-primitive scene past 48 KB of shared memory; every tap
    bitwise the plain ``whitted_taps``, one launch a tap."""
    scene = WHITTED_SCENES[name]("cuda") if name == "room" else _big_scene("cuda")
    o, d = W.whitted_camera_rays_device(640, 480, 1, device="cuda")
    tiles = wk.rays_to_tiles(o, d)
    assert tiles.shape[1] * 128 == 300 * 1024 and 300 % 33
    flat = tiles.reshape(6, -1)
    for tap in W.TAPS:
        for hit_bias in (0.0, 0.005):
            before = wk.whitted_taps_cuda.launches
            got = wk.whitted_taps_cuda(scene, tiles, tap=tap, hit_bias=hit_bias)
            torch.cuda.synchronize()
            assert wk.whitted_taps_cuda.launches == before + 1
            plain = W.whitted_taps(scene, flat[0:3].T, flat[3:6].T, tap, hit_bias)
            assert torch.equal(got.reshape(3, -1).T, plain), (tap, hit_bias)

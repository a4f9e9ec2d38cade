"""The Whitted tracer of the port (scenes, plain tracer, K3's plain twin)
against the JAX package on the CPU.

Tolerances and their reasons:
- scene tables, ``pack_whitted_scene``, the host camera rays and the
  device camera rays against the JAX generator evaluated op by op: bitwise
  (the same float32 operations in the same order). XLA's fused CPU code
  rewrites 1/sqrt into an rsqrt and contracts products into sums, so
  against the jitted generator the directions agree within 2 ulp (2.5e-7).
- ``whitted_nearest``: hit indices and results equal, distances within
  1e-6 relative.
- ``whitted_trace`` and the frame against the JAX jnp tracer evaluated op by
  op (``jax.disable_jit``): the bound tests/test_pallas_kernel.py:96 sets,
  rtol 1e-3 and atol 2e-2 on the 0..255 frame, for every component (the two
  differ only in exp and pow rounding: x^20 is the multiply chain of the
  kernels here).
- the frame against the JAX Pallas kernel in interpret mode (jitted):
  >= 99.5% of components within that bound and the mean within rtol 1e-3.
  Jitted XLA contracts the sphere quadratic b*b - v.v + r^2 into FMAs; at a
  near-tangent hit, where b - sqrt(det) cancels, that moves the hit
  distance by ~1e-4 relative and can flip a shadow or silhouette decision
  of a ray (4 of the 4800 rays at 40x30, 2x2), which moves a pixel by up to
  256/ss^2 times a color.

The JAX package is imported inside the tests that use it, so that the
``cuda`` tests run on a GPU machine without JAX:
``python -m pytest tests/test_torch_whitted.py --noconftest -m cuda``."""

import numpy as np
import pytest
import torch

from se195_raytracer_tpu_torch.kernels import whitted_kernel as wk
from se195_raytracer_tpu_torch.models import whitted as W
from se195_raytracer_tpu_torch.scenes.whitted_scenes import WHITTED_SCENES


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test runs the port's CPU code on one intra-op thread: the suite
    runs several pytest workers at once, and torch's OpenMP threads, one
    team per worker, then stall each other on the plain tracers' many small
    ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIELDS = ("normal", "depth", "center", "radius", "color", "refl", "diff", "refr",
          "refr_index", "spec")
FRAME = dict(width=40, height=30, supersample=2, trace_depth=3)
MOVED = dict(orig=(1.5, 1.0, -6.0), target=(0.0, 0.0, 2.0))
RTOL, ATOL = 1e-3, 2e-2


def _jax_scene(name):
    from se195_raytracer_tpu.scenes.whitted_scenes import WHITTED_SCENES as J_SCENES

    return J_SCENES[name]()


def _row(moved):
    return W.whitted_camera_row(**MOVED) if moved else W.whitted_camera_row()


@pytest.mark.parametrize("name", ["room", "grid"])
def test_whitted_tables_match_jax(name):
    from se195_raytracer_tpu.kernels.whitted_kernel import pack_whitted_scene as j_pack

    js, ps = _jax_scene(name), WHITTED_SCENES[name]("cpu")
    for f in FIELDS + ("sq_radius", "r_radius"):
        np.testing.assert_array_equal(getattr(ps, f).numpy(), np.asarray(getattr(js, f)), err_msg=f)
    assert ps.ptype == js.ptype and ps.is_light == js.is_light
    assert ps.light_indices == js.light_indices
    np.testing.assert_array_equal(wk.pack_whitted_scene(ps).numpy(), np.asarray(j_pack(js)))


@pytest.mark.parametrize("moved", [False, True])
def test_camera_rays_match_jax(moved):
    import jax
    import jax.numpy as jnp

    from se195_raytracer_tpu.models import whitted as J

    jrow = J.whitted_camera_row(**MOVED) if moved else J.whitted_camera_row()
    np.testing.assert_array_equal(_row(moved), jrow)
    o, d = W.whitted_camera_rays_device(40, 30, 3, torch.from_numpy(_row(moved)), device="cpu")
    with jax.disable_jit():
        jo, jd = J.whitted_camera_rays_device(40, 30, 3, jnp.asarray(jrow))
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    _, jd_jit = J.whitted_camera_rays_device(40, 30, 3, jnp.asarray(jrow))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd_jit), rtol=0, atol=2.5e-7)
    if not moved:
        ho, hd = J.whitted_camera_rays(40, 30, 3)
        po, pd = W.whitted_camera_rays(40, 30, 3)
        np.testing.assert_array_equal(po, np.asarray(ho))
        np.testing.assert_array_equal(pd, np.asarray(hd))
        np.testing.assert_array_equal(d.numpy(), np.asarray(hd))


@pytest.mark.parametrize("name", ["room", "grid"])
def test_whitted_nearest_and_trace_match_jax(name):
    """whitted_nearest and the unrolled tree against the JAX jnp functions,
    on the same rays (a moved camera, so rays also start inside the room
    at other angles), hit_bias 0.005."""
    import jax.numpy as jnp

    from se195_raytracer_tpu.models import whitted as J

    js, ps = _jax_scene(name), WHITTED_SCENES[name]("cpu")
    o, d = W.whitted_camera_rays_device(40, 30, 2, torch.from_numpy(_row(True)), device="cpu")
    o = o.contiguous()
    jo, jd = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    idx, res, dist = W.whitted_nearest(ps, o, d, 0.005)
    jidx, jres, jdist = J.whitted_nearest(js, jo, jd, 0.005)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=1e-6)
    acc = W.whitted_trace(ps, o, d, 3, 0.005)
    jacc = np.asarray(J.whitted_trace(js, jo, jd, 3, 0.005))
    assert np.abs(jacc).max() > 0.1
    np.testing.assert_allclose(acc.numpy(), jacc, rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("moved", [False, True])
@pytest.mark.parametrize("hit_bias", [0.0, 0.005])
def test_frame_matches_jax_jnp(moved, hit_bias):
    """render_whitted_scene and K3's plain twin (render_whitted_cuda on the
    CPU) against the JAX jnp frame, room, 40x30, 2x2, depth 3."""
    import jax
    import jax.numpy as jnp

    from se195_raytracer_tpu.models import whitted as J

    ps = WHITTED_SCENES["room"]("cpu")
    row = torch.from_numpy(_row(moved))
    img = W.render_whitted_scene(ps, cam_row=row, hit_bias=hit_bias, **FRAME)
    twin = wk.render_whitted_cuda(ps, cam_row=row, hit_bias=hit_bias, device="cpu", **FRAME)
    np.testing.assert_array_equal(twin.numpy(), img.numpy())
    with jax.disable_jit():
        jimg = np.asarray(J.render_whitted_scene(
            _jax_scene("room"), cam_row=jnp.asarray(_row(moved)), hit_bias=hit_bias, **FRAME))
    assert jimg.max() > 1.0  # the scene is visible from the camera
    np.testing.assert_allclose(img.numpy(), jimg, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hit_bias", [0.0, 0.005])
def test_frame_matches_jax_pallas(hit_bias):
    """The port's frame against the JAX Pallas kernel in interpret mode, for
    the reference camera and a moved one (one compile per hit_bias)."""
    import jax.numpy as jnp

    from se195_raytracer_tpu.kernels.whitted_kernel import render_whitted_pallas

    ps, js = WHITTED_SCENES["room"]("cpu"), _jax_scene("room")
    for moved in (False, True):
        img = W.render_whitted_scene(ps, cam_row=torch.from_numpy(_row(moved)),
                                     hit_bias=hit_bias, **FRAME).numpy()
        jimg = np.asarray(render_whitted_pallas(js, cam_row=jnp.asarray(_row(moved)),
                                                hit_bias=hit_bias, interpret=True, **FRAME))
        close = np.isclose(img, jimg, rtol=RTOL, atol=ATOL).mean()
        assert close >= 0.995, f"{1 - close:.3%} components differ"
        np.testing.assert_allclose(img.mean(), jimg.mean(), rtol=1e-3)


def test_explicit_ray_entry_matches_frame_entry():
    """K3's two entries agree on the CPU twin: the camera rays laid out in
    tiles, traced and reduced, give the frame entry's frame."""
    ps = WHITTED_SCENES["grid"]("cpu")
    o, d = W.whitted_camera_rays_device(20, 10, 3, device="cpu")
    tiles = wk.rays_to_tiles(o, d)
    assert tiles.shape == (6, 16, 128)  # 1800 rays in two 1024-ray tiles
    acc = wk.whitted_trace_cuda(ps, tiles, trace_depth=3, hit_bias=0.005)
    assert acc.shape == (3, 16, 128) and float(acc.reshape(3, -1)[:, 1800:].abs().max()) == 0.0
    frame = wk.whitted_frame_cuda(ps, width=20, height=10, supersample=3, trace_depth=3,
                                  hit_bias=0.005)
    np.testing.assert_array_equal(wk.tiles_to_frame(acc, 20, 10, 3).numpy(), frame.numpy())


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
@pytest.mark.parametrize("name", ["room", "grid"])
@pytest.mark.parametrize("hit_bias", [0.0, 0.005])
def test_k3_matches_plain_on_cuda(name, hit_bias):
    """K3's two entries against the plain tracer on the card, same scene and
    rays, within rtol 1e-3 and atol 2e-2 on the frame; one launch each."""
    ps = WHITTED_SCENES[name]("cuda")
    kw = dict(width=160, height=120, supersample=3, trace_depth=5, hit_bias=hit_bias)
    plain = W.render_whitted_scene(ps, **kw)
    before = (wk.whitted_frame_cuda.launches, wk.whitted_trace_cuda.launches)
    frame = wk.whitted_frame_cuda(ps, **kw)
    o, d = W.whitted_camera_rays_device(160, 120, 3, device="cuda")
    acc = wk.whitted_trace_cuda(ps, wk.rays_to_tiles(o, d), trace_depth=5, hit_bias=hit_bias)
    torch.cuda.synchronize()
    assert (wk.whitted_frame_cuda.launches, wk.whitted_trace_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    for img in (frame, wk.tiles_to_frame(acc, 160, 120, 3)):
        np.testing.assert_allclose(img.cpu().numpy(), plain.cpu().numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
@pytest.mark.parametrize("supersample", [1, 2, 3, 4])
def test_k3_bitwise_on_cuda(supersample):
    """K3 (one thread per subsample ray, the repacked scene, the 12-word
    stack) bitwise equal to the plain tracer on the card, at a size whose
    last block is partial, through both entries, grid and hit_bias 0.005,
    trace_depth 0 and 5."""
    ps = WHITTED_SCENES["grid"]("cuda")
    for depth in (0, 5):
        kw = dict(width=37, height=23, supersample=supersample, trace_depth=depth,
                  hit_bias=0.005)
        plain = W.render_whitted_scene(ps, **kw)
        frame = wk.whitted_frame_cuda(ps, **kw)
        o, d = W.whitted_camera_rays_device(37, 23, supersample, device="cuda")
        acc = wk.whitted_trace_cuda(ps, wk.rays_to_tiles(o, d), trace_depth=depth, hit_bias=0.005)
        torch.cuda.synchronize()
        assert torch.equal(frame, plain)
        assert torch.equal(wk.tiles_to_frame(acc, 37, 23, supersample), plain)

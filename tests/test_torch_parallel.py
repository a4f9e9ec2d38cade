"""The port's sharded rendering (parallel/mesh.py, parallel/render_sharded.py)
on the CPU, over an in-process mesh of 8 shards on one device.

Every route is held BITWISE to the port's own single-device render (each
shard traces its absolute pixel or ray ids from seeds drawn over the whole
frame): the plain path, K1's and K2's plain version (``pt_pass_reference``
with the lane offset, and with the pix table and the pad tiles of
``tile_multiple``), K3's explicit-ray entry and the plain Whitted tracer,
and whitted5 on K4's route and the plain route. Each route is also held to
the JAX package's single-device render, which tests/test_sharding.py ties
to JAX's sharded one, under the port's existing contracts: smallpt's
(tests/test_torch_smallpt.py:5-8), the Whitted frame's op-by-op bound
(tests/test_torch_whitted.py:12-16) and whitted5's (tests/test_torch_whitted5.py:
18-25). Sharded gradients summed over the shards equal the single-device
gradient within rtol 1e-5 (tests/test_sharding.py:127)."""

import numpy as np
import pytest
import torch

from se195_raytracer_tpu_torch.core.config import RenderConfig
from se195_raytracer_tpu_torch.driver.optimize import LEAVES, CAMERA_LEAVES, l2_image_loss, merge
from se195_raytracer_tpu_torch.driver.render import render
from se195_raytracer_tpu_torch.kernels.pt_kernel import ray_layout, render_cuda
from se195_raytracer_tpu_torch.models.whitted import render_whitted_scene
from se195_raytracer_tpu_torch.models.whitted5 import render_whitted5
from se195_raytracer_tpu_torch.parallel import render_sharded as rs
from se195_raytracer_tpu_torch.parallel.mesh import make_mesh, replicate, shard_bounds
from se195_raytracer_tpu_torch.scenes.generator import complex_scene
from se195_raytracer_tpu_torch.scenes.registry import get_scene
from se195_raytracer_tpu_torch.scenes.whitted5_scenes import room5_scene
from se195_raytracer_tpu_torch.scenes.whitted_scenes import WHITTED_SCENES

SHARDS = 8


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


@pytest.fixture(scope="module")
def mesh():
    return make_mesh("cpu", n_devices=SHARDS)


def assert_smallpt_contract(a, b):
    """tests/test_torch_smallpt.py's radiance contract: >= 97% of components
    within isclose(2e-3), the means within rtol 2e-3."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.isfinite(a).all()
    frac = 1.0 - np.isclose(a, b, rtol=2e-3, atol=2e-3).mean()
    assert frac <= 0.03, f"{frac:.3%} components differ"
    np.testing.assert_allclose(a.mean(), b.mean(), rtol=2e-3)


def _jax_smallpt(scene_name, cfg, spec=None):
    """The JAX package's single-device plain render of the same scene."""
    from se195_raytracer_tpu.core.config import RenderConfig as JConfig
    from se195_raytracer_tpu.core.types import SceneSpec as JSpec
    from se195_raytracer_tpu.driver.render import render as j_render
    from se195_raytracer_tpu.scenes.registry import get_scene as j_get_scene

    if spec is None:
        jspec = j_get_scene(scene_name)
    else:
        jspec = JSpec(**{f: getattr(spec, f) for f in ("camera_orig", "camera_target", "radius",
                                                       "center", "emission", "color", "refl")})
    jcfg = JConfig(width=cfg.width, height=cfg.height, spp=cfg.spp, seed=cfg.seed,
                   max_depth=cfg.max_depth)
    img, _ = j_render(jspec.to_scene(), jspec.to_camera(), jcfg)
    return np.asarray(img)


def test_make_mesh_and_shard_bounds():
    m = make_mesh("cpu", n_devices=4)
    assert m.size == 4 and m.local_shards == (0, 1, 2, 3) and not m.process_group
    assert shard_bounds(32, m) == [(0, 8), (8, 16), (16, 24), (24, 32)]
    with pytest.raises(ValueError, match="divide evenly"):
        shard_bounds(30, m)
    scene = get_scene("simple").to_scene("cpu")
    reps = replicate(scene, m)
    assert list(reps) == [torch.device("cpu")]  # one copy per distinct device
    assert make_mesh(["cpu", "cpu"]).size == 2


def test_plain_route_bitwise(mesh):
    """render_sharded (the plain path), Cornell 32x16 spp 2, and its resume:
    bitwise the single-device render; the JAX render under smallpt's
    contract."""
    spec = get_scene("cornell")
    scene, cam = spec.to_scene("cpu"), spec.to_camera("cpu")
    cfg = RenderConfig(width=32, height=16, spp=2, seed=6, use_kernel=False)
    img1, st1 = render(scene, cam, cfg, device="cpu")
    img8, st8 = rs.render_sharded(scene, cam, cfg, mesh)
    np.testing.assert_array_equal(img8.numpy(), img1.numpy())
    for f in ("accum", "s0", "s1"):
        assert torch.equal(getattr(st8, f), getattr(st1, f)), f
    assert st8.sample == 2
    img1b, _ = render(scene, cam, cfg, device="cpu", state=st1)
    img8b, st8b = rs.render_sharded(scene, cam, cfg, mesh, state=st8)
    np.testing.assert_array_equal(img8b.numpy(), img1b.numpy())
    assert st8b.sample == 4
    assert_smallpt_contract(img8.numpy(), _jax_smallpt("cornell", cfg))


def test_plain_route_refuses_uneven_pixels(mesh):
    spec = get_scene("cornell")
    cfg = RenderConfig(width=5, height=3, spp=1, use_kernel=False)
    with pytest.raises(ValueError, match="pixel count 15 must divide evenly over 8"):
        rs.render_sharded(spec.to_scene("cpu"), spec.to_camera("cpu"), cfg, mesh)


def test_k1_route_bitwise(mesh):
    """render_cuda_sharded through K1's plain version with the lane offset,
    Cornell 64x32 spp 2 (one 16x128 tile, so 7 pad tiles over 8 shards):
    bitwise render_cuda, its resume too."""
    spec = get_scene("cornell")
    scene, cam = spec.to_scene("cpu"), spec.to_camera("cpu")
    cfg = RenderConfig(width=64, height=32, spp=2, seed=11)
    img1, st1 = render_cuda(scene, cam, cfg, device="cpu")
    img8, st8 = rs.render_cuda_sharded(scene, cam, cfg, mesh)
    np.testing.assert_array_equal(img8.numpy(), img1.numpy())
    rp = ray_layout(64, 32, False, SHARDS)[0]
    assert st8[0].shape == (rp,) and rp == SHARDS * 2048 and st8[3] == 2
    r = 64 * 32
    assert torch.equal(st8[0][:r], st1[0][:r]) and torch.equal(st8[1][:r], st1[1][:r])
    img1b, _ = render_cuda(scene, cam, cfg, device="cpu", state=st1)
    img8b, _ = rs.render_cuda_sharded(scene, cam, cfg, mesh, state=st8)
    np.testing.assert_array_equal(img8b.numpy(), img1b.numpy())


def test_k1_route_against_jax_pallas(mesh):
    """The K1 route's sharded frame (Cornell 64x32 spp 2, seed 11, the config
    of tests/test_sharding.py's Pallas shard test) against the JAX package's
    single-device kernel render, ``render_pallas`` in interpret mode, under
    smallpt's contract. (JAX's own jnp and Pallas renders of this config
    differ in their means by 0.58%, beyond the contract's 0.2%: the
    counterpart of K1 is the Pallas render.)"""
    from se195_raytracer_tpu.core.config import RenderConfig as JConfig
    from se195_raytracer_tpu.kernels.pt_kernel import render_pallas
    from se195_raytracer_tpu.scenes.registry import get_scene as j_get_scene

    spec = get_scene("cornell")
    cfg = RenderConfig(width=64, height=32, spp=2, seed=11)
    img8, _ = rs.render_cuda_sharded(spec.to_scene("cpu"), spec.to_camera("cpu"), cfg, mesh)
    jspec = j_get_scene("cornell")
    jimg, _ = render_pallas(jspec.to_scene(), jspec.to_camera(),
                            JConfig(width=64, height=32, spp=2, seed=11), interpret=True)
    assert_smallpt_contract(img8.numpy(), np.asarray(jimg))


def test_k2_route_bitwise_with_pad_tiles(mesh):
    """render_cuda_sharded through K2's plain version (pix table), the
    158-sphere complex_scene(max_depth=3) at 64x32 spp 2: one image tile
    and 7 pad tiles from tile_multiple; bitwise render_cuda; the JAX render
    under smallpt's contract."""
    spec = complex_scene(max_depth=3.0)
    assert len(spec.radius) == 158
    scene, cam = spec.to_scene("cpu"), spec.to_camera("cpu")
    cfg = RenderConfig(width=64, height=32, spp=2, seed=4)
    rp, pix, _ = ray_layout(64, 32, True, SHARDS)
    assert rp == SHARDS * 2048 and (pix[2048:] == 64 * 32).all()
    img1, _ = render_cuda(scene, cam, cfg, device="cpu")
    img8, st8 = rs.render_cuda_sharded(scene, cam, cfg, mesh)
    np.testing.assert_array_equal(img8.numpy(), img1.numpy())
    assert st8[2].shape == (3, rp // 128, 128)
    assert_smallpt_contract(img8.numpy(), _jax_smallpt(None, cfg, spec))


@pytest.mark.parametrize("use_kernel", [True, False])
def test_whitted_route_bitwise(mesh, use_kernel):
    """render_whitted_sharded, room 40x30 3x3 depth 5 (10,800 rays, 1,350 a
    shard): K3's explicit-ray entry (its plain version here) and the plain
    tracer, bitwise the single-device frame."""
    scene = WHITTED_SCENES["room"]("cpu")
    img1 = render_whitted_scene(scene, 40, 30, 3, 5, 0.0)
    img8 = rs.render_whitted_sharded(scene, 40, 30, 3, 5, mesh=mesh, use_kernel=use_kernel)
    np.testing.assert_array_equal(img8.numpy(), img1.numpy())


def test_whitted_route_against_jax(mesh):
    """The sharded Whitted frame at tests/test_torch_whitted.py's FRAME
    (room 40x30, 2x2, depth 3; 4,800 rays, 600 a shard) against the JAX jnp
    frame op by op: rtol 1e-3, atol 2e-2 on the 0..255 scale."""
    import jax

    from se195_raytracer_tpu.models import whitted as J
    from se195_raytracer_tpu.scenes.whitted_scenes import WHITTED_SCENES as J_SCENES

    scene = WHITTED_SCENES["room"]("cpu")
    img8 = rs.render_whitted_sharded(scene, 40, 30, 2, 3, mesh=mesh)
    with jax.disable_jit():
        jimg = np.asarray(J.render_whitted_scene(J_SCENES["room"](), width=40, height=30,
                                                 supersample=2, trace_depth=3))
    assert jimg.max() > 1.0
    np.testing.assert_allclose(img8.numpy(), jimg, rtol=1e-3, atol=2e-2)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_whitted5_route_bitwise(mesh, use_kernel):
    """render_whitted5_sharded, room5 40x30 spp 2 (1,200 rays, 150 a
    shard): K4's route (its plain version here) and the plain route,
    bitwise render_whitted5."""
    scene = room5_scene("procedural", device="cpu")
    img1 = render_whitted5(scene, 40, 30, spp=2, seed=3, device="cpu", use_kernel=use_kernel)
    img8 = rs.render_whitted5_sharded(scene, 40, 30, spp=2, seed=3, mesh=mesh,
                                      use_kernel=use_kernel)
    np.testing.assert_array_equal(img8.numpy(), img1.numpy())


def test_whitted5_uneven_shards_pad():
    """30x5 = 150 rays over 8 shards: 2 inert pad lanes (state 2, zero
    rays), sliced off; bitwise render_whitted5."""
    scene = room5_scene("procedural", device="cpu")
    img1 = render_whitted5(scene, 30, 5, spp=1, seed=1, trace_depth=2, device="cpu")
    img8 = rs.render_whitted5_sharded(scene, 30, 5, spp=1, seed=1, trace_depth=2,
                                      mesh=make_mesh("cpu", n_devices=SHARDS))
    np.testing.assert_array_equal(img8.numpy(), img1.numpy())


def test_whitted5_route_against_jax(mesh):
    """The sharded whitted5 frame (room5 40x30 spp 2, seed 3, trace depth 2)
    against the JAX jnp render op by op, under whitted5's contract: p99 of
    |diff| < 1e-4, max < 3e-3."""
    import jax

    from se195_raytracer_tpu.models import whitted5 as J
    from se195_raytracer_tpu.scenes.whitted5_scenes import room5_scene as j_room5

    img8 = rs.render_whitted5_sharded(room5_scene("procedural", device="cpu"), 40, 30, spp=2,
                                      seed=3, trace_depth=2, mesh=mesh)
    with jax.disable_jit():
        jimg = np.asarray(J.render_whitted5(j_room5("procedural"), 40, 30, spp=2, trace_depth=2,
                                            seed=3))
    d = np.abs(img8.numpy() - jimg)
    assert np.isfinite(img8.numpy()).all()
    assert float(np.percentile(d, 99)) < 1e-4 and float(d.max()) < 3e-3


@pytest.mark.parametrize("use_kernel", [True, False])
def test_sharded_gradient_sums_to_single_device(mesh, use_kernel):
    """l2_image_loss_sharded over 8 shards (each shard's forward, K1's plain
    version or the plain path, and recompute cover its 32 pixels only):
    the loss and every leaf's gradient equal the single-device
    l2_image_loss's within rtol 1e-5, simple 16x16 spp 1 (the config of
    tests/test_sharding.py::test_scene_gradient_psum_across_shards)."""
    spec = get_scene("simple")
    scene, cam = spec.to_scene("cpu"), spec.to_camera("cpu")
    cfg = RenderConfig(width=16, height=16, spp=1, seed=2, max_depth=3, use_kernel=use_kernel)
    target = torch.zeros((16, 16, 3))
    leaves = {k: getattr(cam if k in CAMERA_LEAVES else scene, k).detach().clone()
              .requires_grad_(True) for k in LEAVES}
    sc, c = merge(scene, cam, leaves)
    loss1 = l2_image_loss(sc, c, target, cfg, device="cpu")
    grads1 = torch.autograd.grad(loss1, list(leaves.values()))
    loss8, grads8 = rs.l2_image_loss_sharded(scene, cam, target, cfg, mesh)
    np.testing.assert_allclose(loss8.item(), loss1.item(), rtol=1e-5)
    for k, g in zip(LEAVES, grads1):
        assert torch.isfinite(grads8[k]).all()
        np.testing.assert_allclose(grads8[k].numpy(), g.numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_sharded_kernel_forward_is_the_shard_of_the_frame(mesh):
    """render_differentiable(pixels=...) through K1's plain version: the
    shard's rows are the full frame's rows, bitwise."""
    from se195_raytracer_tpu_torch.driver.optimize import render_differentiable

    spec = get_scene("cornell")
    scene, cam = spec.to_scene("cpu"), spec.to_camera("cpu")
    cfg = RenderConfig(width=16, height=8, spp=1, seed=3)
    full = render_differentiable(scene, cam, cfg, device="cpu").reshape(-1, 3)
    for lo, hi in shard_bounds(128, mesh):
        part = render_differentiable(scene, cam, cfg, device="cpu", pixels=(lo, hi))
        assert torch.equal(part, full[lo:hi])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("scene_name", ["cornell", "complex"])
def test_k1_k2_sharded_bitwise_on_cuda(cuda, scene_name):
    """8 shards on cuda:0 through K1 (Cornell) and K2 (complex783, the pad
    tiles of 640x480): bitwise the one-launch render."""
    spec = get_scene(scene_name)
    scene, cam = spec.to_scene("cuda"), spec.to_camera("cuda")
    cfg = RenderConfig(width=640, height=480, spp=2, seed=5)
    img1, _ = render_cuda(scene, cam, cfg, device="cuda")
    img8, _ = rs.render_cuda_sharded(scene, cam, cfg, make_mesh("cuda:0", n_devices=SHARDS))
    assert torch.equal(img8, img1)


@pytest.mark.cuda
def test_k3_sharded_bitwise_on_cuda(cuda):
    """8 shards of room 800x600 3x3 through K3's explicit-ray entry: bitwise
    the frame entry's single launch."""
    from se195_raytracer_tpu_torch.kernels.whitted_kernel import render_whitted_cuda

    scene = WHITTED_SCENES["room"]("cuda")
    img1 = render_whitted_cuda(scene, 800, 600, 3, 5, device="cuda")
    img8 = rs.render_whitted_sharded(scene, 800, 600, 3, 5,
                                     mesh=make_mesh("cuda:0", n_devices=SHARDS))
    assert torch.equal(img8, img1)


@pytest.mark.cuda
def test_k4_sharded_bitwise_on_cuda(cuda):
    """8 shards of room5 800x600 spp 8 through K4: bitwise render_whitted5."""
    scene = room5_scene("procedural", device="cuda")
    img1 = render_whitted5(scene, 800, 600, spp=8, seed=3, device="cuda")
    img8 = rs.render_whitted5_sharded(scene, 800, 600, spp=8, seed=3,
                                      mesh=make_mesh("cuda:0", n_devices=SHARDS))
    assert torch.equal(img8, img1)

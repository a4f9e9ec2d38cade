"""K1b, the backward of the hard-estimator render (kernels/pt_backward_kernel.py,
csrc/pt_backward_kernel.cu), and the differentiable path's route through it.

On the CPU: the flat gradient layout, the running mean's weights against
autograd, the camera chain (the basis's gradient pushed through
``update_camera``'s autograd), the plain version ``pt_backward_reference``
against ``jax.vjp`` of the JAX package's ``_render_jnp_diff`` and its shards
against the whole frame, the CPU route of ``_KernelForward.backward`` (the
plain recompute, no K1b), and ``pt_backward_cuda`` refusing CPU tensors.

Tolerances and their reasons:
- the running-mean weights: bitwise (the same float32 operations in the same
  order as autograd's);
- the camera chain: 1e-6 of the gradient's scale (the same cotangents taken
  through the basis in one autograd call or two);
- the plain version against JAX: 1e-3 of each leaf's largest gradient, the
  bar of tests/test_torch_grad.py (JAX op by op, ``jax.disable_jit``);
- shards summed against the whole frame: 1e-5 of scale (the same terms
  summed in another order);
- on the card, K1b against its plain version: the replayed primal bitwise,
  each sphere's row of each leaf within ``GRAD_ROW_REL`` of that row's
  largest plain gradient (``grad_row_error``: K1b's derivatives take a
  sqrt's in float32 and sum in another order; the bar sits between that
  reading and the faults tools/k1b_fault_check.py plants in the kernel),
  and finite. A plain VJP with one term dropped (the CPU mirror of such a
  fault) fails that bar.

The ``cuda`` tests run on a GPU machine without JAX:
``python -m pytest tests/test_torch_pt_backward.py --noconftest -m cuda``."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from se195_raytracer_tpu_torch.core.config import RenderConfig
from se195_raytracer_tpu_torch.core.types import Camera, CameraBasis, update_camera
from se195_raytracer_tpu_torch.driver import optimize as O
from se195_raytracer_tpu_torch.kernels import pt_backward_kernel as K
from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk
from se195_raytracer_tpu_torch.kernels import seed_kernel as sk
from se195_raytracer_tpu_torch.models import smallpt
from se195_raytracer_tpu_torch.scenes.registry import get_scene


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test runs the port's CPU code on one intra-op thread: the suite
    runs several pytest workers at once, and torch's OpenMP threads, one
    team per worker, then stall each other on the plain path's many small
    ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(name, device="cpu"):
    spec = get_scene(name)
    return spec.to_scene(device), spec.to_camera(device)


def _cotangent(shape, seed=0, device="cpu"):
    rs = np.random.default_rng(seed)
    return torch.from_numpy(rs.standard_normal(shape).astype(np.float32)).to(device)


def _basis(camera, cfg):
    b = update_camera(camera, cfg.width, cfg.height)
    return CameraBasis(*(getattr(b, k).detach() for k in K.BASIS_FIELDS))


def _leaves(scene, camera):
    leaves = {k: getattr(scene if k in O.SCENE_LEAVES else camera, k).detach().clone()
              .requires_grad_(True) for k in O.LEAVES}
    return leaves, *O.merge(scene, camera, leaves)


def _rel(a, b):
    return float((a - b).abs().max()) / (float(b.abs().max()) or 1.0)


# ------------------------------------------------------------- layout ----
@pytest.mark.parametrize("n", [1, 9, 96])
def test_flat_layout_round_trip(n):
    """``pack_grad`` then ``unpack_grad`` gives each field back, in its shape,
    and the flat vector has ``grad_size(n)`` entries in the documented
    order."""
    rs = np.random.default_rng(n)
    shapes = dict(center=(n, 3), radius=(n,), emission=(n, 3), color=(n, 3), orig=(3,),
                  dir=(3,), x=(3,), y=(3,))
    parts = {k: torch.from_numpy(rs.standard_normal(s).astype(np.float32))
             for k, s in shapes.items()}
    flat = K.pack_grad(*parts.values())
    assert flat.shape == (K.grad_size(n),)
    back = K.unpack_grad(flat, n)
    assert tuple(back) == K.SCENE_FIELDS + K.BASIS_FIELDS
    for k, v in parts.items():
        assert torch.equal(back[k], v), k
    assert torch.equal(flat[3 * n:4 * n], parts["radius"])
    assert torch.equal(flat[10 * n:10 * n + 3], parts["orig"])


@pytest.mark.parametrize("spp", range(1, 9))
def test_running_mean_weights_are_autograds(spp):
    """d accum / d r_k of ``_render_plain_diff``'s running mean, for a
    cotangent of 1, is ``running_mean_weights(spp)`` bit for bit."""
    rs = [torch.zeros((1, 3), requires_grad=True) for _ in range(spp)]
    accum = torch.zeros((1, 3))
    for k, r in enumerate(rs):
        accum = (accum * float(k) + r) / (float(k) + 1.0)
    grads = torch.autograd.grad(accum, rs, torch.ones((1, 3)))
    want = torch.tensor(K.running_mean_weights(spp), dtype=torch.float32)
    got = torch.stack([g[0, 0] for g in grads])
    assert torch.equal(got, want), (got, want)
    assert all(torch.equal(g, g[0, 0].expand(1, 3)) for g in grads)


# ------------------------------------------------------- camera chain ----
@pytest.mark.parametrize("needs", [(True, True), (True, False), (False, True)])
def test_camera_chain_through_update_camera(needs):
    """The camera's gradient by way of the basis (``pt_backward_reference``'s
    basis gradient pushed through ``update_camera``'s autograd, as
    ``_k1b_backward`` does with K1b's) equals autograd of the plain path to
    ``orig`` and ``target`` directly, within 1e-6 of its scale; a leaf that
    asks for no gradient gets None."""
    scene, camera = _scene("cornell")
    cfg = RenderConfig(width=16, height=12, spp=2, seed=3)
    g = _cotangent((12, 16, 3))
    leaves, sc, cam = _leaves(scene, camera)
    want = dict(zip(O.LEAVES, torch.autograd.grad(O._render_plain_diff(sc, cam, cfg),
                                                  list(leaves.values()), g)))
    ctx = types.SimpleNamespace(
        saved_tensors=(scene.center, scene.radius, scene.emission, scene.color, camera.orig,
                       camera.target),
        refl=scene.refl, light_indices=scene.light_indices, config=cfg, pixels=None)
    real = K.pt_backward_cuda
    K.pt_backward_cuda = K.pt_backward_reference  # the kernel's plain version, on the CPU
    try:
        got = O._k1b_backward(ctx, g, (True, False, True, False) + needs)
    finally:
        K.pt_backward_cuda = real
    got = dict(zip(O.LEAVES, got))
    assert got["radius"] is None and got["color"] is None
    for k in ("center", "emission"):
        assert torch.equal(got[k], want[k]), k
    for k, need in zip(O.CAMERA_LEAVES, needs):
        if not need:
            assert got[k] is None
            continue
        assert _rel(got[k], want[k]) <= 1e-6, (k, _rel(got[k], want[k]))


# ------------------------------------------------ the plain version ----
@pytest.mark.parametrize("scene_name,integrator", [("cornell", "pt"), ("simple", "dl")])
def test_reference_matches_jax_vjp(scene_name, integrator):
    """``pt_backward_reference`` against ``jax.vjp`` of ``_render_jnp_diff``
    for the same cotangent, 16 x 16, spp 2, mwc: the scene's leaves
    directly, the camera's after the basis's gradient is pushed through
    ``update_camera``; the primal too."""
    import jax
    import jax.numpy as jnp

    from se195_raytracer_tpu.core.config import RenderConfig as JConfig
    from se195_raytracer_tpu.driver.optimize import _render_jnp_diff
    from se195_raytracer_tpu.scenes.registry import get_scene as j_get_scene

    w = h = 16
    spec = j_get_scene(scene_name)
    js, jc = spec.to_scene(), spec.to_camera()
    jcfg = JConfig(width=w, height=h, spp=2, seed=3, integrator=integrator)
    g = _cotangent((h, w, 3), seed=1)

    def f(center, radius, emission, color, orig, target):
        s = js.replace(center=center, radius=radius, emission=emission, color=color)
        return _render_jnp_diff(s, jc.replace(orig=orig, target=target), jcfg)

    with jax.disable_jit():
        jimg, vjp = jax.vjp(f, js.center, js.radius, js.emission, js.color, jc.orig, jc.target)
        jg = vjp(jnp.asarray(g.numpy()))
    scene, camera = _scene(scene_name)
    cfg = RenderConfig(width=w, height=h, spp=2, seed=3, integrator=integrator)
    orig = camera.orig.clone().requires_grad_(True)
    target = camera.target.clone().requires_grad_(True)
    basis = update_camera(Camera(orig, target), w, h)
    flat, img = K.pt_backward_reference(scene, CameraBasis(
        *(getattr(basis, k).detach() for k in K.BASIS_FIELDS)), cfg, g, image=True)
    parts = K.unpack_grad(flat, scene.num_spheres)
    cam = torch.autograd.grad([getattr(basis, k) for k in K.BASIS_FIELDS], [orig, target],
                              [parts[k] for k in K.BASIS_FIELDS])
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg).reshape(-1, 3), rtol=1e-4,
                               atol=1e-4)
    got = [parts[k] for k in K.SCENE_FIELDS] + list(cam)
    for k, a, b in zip(O.LEAVES, got, jg):
        b = np.asarray(b)
        scale = float(np.abs(b).max()) or 1.0
        err = float(np.abs(a.numpy() - b).max())
        assert np.isfinite(a.numpy()).all(), k
        assert err <= 1e-3 * scale, f"{k}: max |diff| {err:.3g} > 1e-3 x scale {scale:.3g}"


def test_row_error_sees_a_fault_in_one_sphere():
    """``grad_row_error`` measures each sphere's row against its own
    gradient: an error of 1% of one small row fails the bar, though it is
    far below the bar against the field's largest gradient; noise at the
    floor does not."""
    rs = np.random.default_rng(5)
    want = K.unpack_grad(torch.from_numpy(rs.standard_normal(K.grad_size(4)).astype(np.float32)),
                         4)
    want["radius"][1] *= 1e-2
    got = {k: v.clone() for k, v in want.items()}
    got["radius"][1] += 1e-2 * want["radius"][1].abs()
    assert K.grad_row_error(got, want)["radius"] > K.GRAD_ROW_REL
    assert float((got["radius"] - want["radius"]).abs().max()) < (
        K.GRAD_ROW_REL * float(want["radius"].abs().max()))
    got = {k: v + 0.5 * K.GRAD_ROW_REL * K.GRAD_ROW_FLOOR * v.abs().max() for k, v in want.items()}
    got["radius"][1] = want["radius"][1]
    assert max(K.grad_row_error(got, want).values()) <= K.GRAD_ROW_REL


def test_dropped_adjoint_term_fails_the_bar():
    """The CPU mirror of a planted fault: the plain VJP with the diffuse
    bounce's direction cut from the hit normal (``cosine_sample_dir`` of a
    detached ``nl``, the term K1b's reverse sweep adds as ``g_nl += g_w``)
    fails ``GRAD_ROW_REL`` against the whole VJP, on Cornell 16 x 16 spp
    2."""
    scene, camera = _scene("cornell")
    cfg = RenderConfig(width=16, height=16, spp=2, seed=3)
    g = _cotangent((16, 16, 3), seed=1)
    basis = _basis(camera, cfg)
    want = K.unpack_grad(K.pt_backward_reference(scene, basis, cfg, g), scene.num_spheres)
    real = smallpt.cosine_sample_dir
    smallpt.cosine_sample_dir = lambda nl, r1, r2: real(nl.detach(), r1, r2)
    try:
        got = K.unpack_grad(K.pt_backward_reference(scene, basis, cfg, g), scene.num_spheres)
    finally:
        smallpt.cosine_sample_dir = real
    err = K.grad_row_error(got, want)
    assert err["center"] > 10 * K.GRAD_ROW_REL and err["radius"] > 10 * K.GRAD_ROW_REL, err
    assert err["emission"] == err["color"] == 0.0, err


def test_reference_shards_sum_to_the_whole():
    """``pt_backward_reference`` over the rows of four shards (one of them
    ragged), each with its rows of the cotangent, sums to the whole frame's
    gradient within 1e-5 of its scale, and each shard's primal is the whole
    primal's rows bit for bit."""
    scene, camera = _scene("cornell")
    cfg = RenderConfig(width=16, height=16, spp=2, seed=4)
    g = _cotangent((256, 3), seed=2)
    basis = _basis(camera, cfg)
    whole, img = K.pt_backward_reference(scene, basis, cfg, g.reshape(16, 16, 3), image=True)
    total = torch.zeros_like(whole)
    for lo, hi in ((0, 100), (100, 128), (128, 200), (200, 256)):
        part, rows = K.pt_backward_reference(scene, basis, cfg, g[lo:hi], (lo, hi), image=True)
        assert torch.equal(rows, img[lo:hi]), (lo, hi)
        total = total + part
    assert _rel(total, whole) <= 1e-5


# ---------------------------------------------------------- the route ----
def test_cpu_backward_keeps_the_plain_recompute():
    """On CPU tensors ``_KernelForward.backward`` runs the plain path's
    recompute and autograd, as before K1b: it never calls
    ``pt_backward_cuda`` and equals the plain route bit for bit."""
    scene, camera = _scene("cornell")
    cfg = RenderConfig(width=12, height=8, spp=2, seed=6)
    g = _cotangent((8, 12, 3), seed=3)
    out = []
    real = K.pt_backward_cuda

    def refuse(*args, **kw):
        raise AssertionError("K1b called on CPU tensors")

    K.pt_backward_cuda = refuse
    try:
        for use_kernel in (True, False):
            leaves, sc, cam = _leaves(scene, camera)
            img = O.render_differentiable(sc, cam, dataclasses.replace(cfg, use_kernel=use_kernel),
                                          device="cpu")
            out.append(torch.autograd.grad(img, list(leaves.values()), g))
    finally:
        K.pt_backward_cuda = real
    for k, a, b in zip(O.LEAVES, *out):
        assert torch.isfinite(a).all() and torch.equal(a, b), k


def test_pt_backward_cuda_refuses_cpu_tensors():
    """The kernel's wrapper raises on CPU tensors, on the relaxed
    estimator, on K2's scenes and on inputs that require grad, before it
    seeds or launches anything."""
    scene, camera = _scene("cornell")
    cfg = RenderConfig(width=8, height=8, spp=1)
    g = torch.zeros((8, 8, 3))
    basis = _basis(camera, cfg)
    sk.seed_lanes.launches = 0
    with pytest.raises(ValueError, match="CUDA tensors only"):
        K.pt_backward_cuda(scene, basis, cfg, g)
    with pytest.raises(RuntimeError, match="requires grad"):
        K.pt_backward_cuda(scene, basis, cfg, g.clone().requires_grad_(True))
    assert sk.seed_lanes.launches == 0 and K.pt_backward_cuda.launches == 0


# --------------------------------------------------------- on the card ----
@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
@pytest.mark.parametrize("integrator,rng,spp", [("pt", "mwc", 2), ("pt", "mwc", 5),
                                                ("dl", "mwc", 2), ("pt", "counter", 2),
                                                ("dl", "counter", 1)])
def test_card_k1b_against_plain(integrator, rng, spp):
    """K1b's replayed primal is the plain path's bit for bit, and its
    gradient's every row within ``GRAD_ROW_REL`` of the plain VJP's
    (``grad_row_error``), finite, on Cornell 64 x 48; a shard's gradients
    sum to the frame's."""
    scene, camera = _scene("cornell", "cuda")
    cfg = RenderConfig(width=64, height=48, spp=spp, seed=1, integrator=integrator, rng=rng)
    g = _cotangent((48, 64, 3), seed=4, device="cuda")
    basis = _basis(camera, cfg)
    flat, img = K.pt_backward_cuda(scene, basis, cfg, g, image=True)
    ref, rimg = K.pt_backward_reference(scene, basis, cfg, g, image=True)
    with torch.no_grad():
        prim = O._render_plain_basis(scene, basis, cfg).reshape(-1, 3)
    assert torch.equal(img, prim) and torch.equal(rimg, prim)
    assert torch.isfinite(flat).all()
    err = K.grad_row_error(K.unpack_grad(flat, scene.num_spheres),
                           K.unpack_grad(ref, scene.num_spheres))
    assert max(err.values()) <= K.GRAD_ROW_REL, err
    flat_g = g.reshape(-1, 3)
    parts = sum(K.pt_backward_cuda(scene, basis, cfg, flat_g[lo:hi], (lo, hi))
                for lo, hi in ((0, 1000), (1000, 3072)))
    assert _rel(parts, flat) <= 1e-5


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
def test_card_backward_is_one_seeding_and_one_k1b_launch():
    """A hard differentiable step on the card: the forward is one seeding and
    one K1 launch, the backward one seeding and one K1b launch and no plain
    ``radiance``; on ``complex`` (K2) the backward keeps the plain
    recompute."""
    from se195_raytracer_tpu_torch.driver import render as dr

    calls = {"n": 0}
    real = dr.radiance  # the plain path's passes call it from driver.render

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    for name, k1b in (("cornell", 1), ("complex", 0)):
        scene, camera = _scene(name, "cuda")
        leaves, sc, cam = _leaves(scene, camera)
        cfg = RenderConfig(width=32, height=32, spp=2, seed=1)
        img = O.render_differentiable(sc, cam, cfg)
        ptk.pt_multi_pass.launches = sk.seed_lanes.launches = K.pt_backward_cuda.launches = 0
        dr.radiance = counted
        calls["n"] = 0
        try:
            torch.autograd.grad(torch.mean(img ** 2), list(leaves.values()))
        finally:
            dr.radiance = real
        assert K.pt_backward_cuda.launches == k1b and sk.seed_lanes.launches == 1
        assert ptk.pt_multi_pass.launches == 0
        assert calls["n"] == (0 if k1b else cfg.spp), (name, calls["n"])


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
def test_card_deep_paths_keep_the_plain_backward():
    """Past K1b's record (``max_depth`` 20 > ``MAX_DEPTH``) a hard
    differentiable step on the card still computes its gradient: the
    backward takes the plain recompute (no K1b launch, one seeding), equal
    to the plain path's VJP of the same cotangent within rtol 1e-5 and 1e-6
    of each leaf's largest gradient."""
    assert 20 > K.MAX_DEPTH
    scene, camera = _scene("cornell", "cuda")
    cfg = RenderConfig(width=32, height=32, spp=1, seed=1, max_depth=20)
    g = _cotangent((32, 32, 3), seed=6, device="cuda")
    leaves, sc, cam = _leaves(scene, camera)
    img = O.render_differentiable(sc, cam, cfg)
    sk.seed_lanes.launches = K.pt_backward_cuda.launches = 0
    ga = torch.autograd.grad(img, list(leaves.values()), g)
    assert K.pt_backward_cuda.launches == 0 and sk.seed_lanes.launches == 1
    leaves_b, sc_b, cam_b = _leaves(scene, camera)
    gb = torch.autograd.grad(O._render_plain_diff(sc_b, cam_b, cfg), list(leaves_b.values()), g)
    for k, a, b in zip(O.LEAVES, ga, gb):
        assert torch.isfinite(a).all(), k
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()))

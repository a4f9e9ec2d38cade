"""The port's differentiable path (driver/optimize.py, the soft-edge
relaxation of models/smallpt.py and ops/intersect.py, driver/grad_check.py)
against the JAX package on the CPU, and the kernel wrappers' refusal of
inputs that need a gradient.

The JAX side runs op by op (``jax.disable_jit``) where it is compared to a
tight tolerance: jitted XLA on the CPU contracts float math into FMAs, which
moves a few Cornell lanes onto another path and a 1e5-radius wall's centre
gradient by ~0.5% of its scale; op by op, the two packages agree to ~1e-5
of scale.

Tolerances and their reasons:
- the soft pieces (``_smax0``, ``_soft_light_weight``, ``_soft_transmittance``,
  ``_sphere_intersect_gradsafe``, ``intersect_nearest_excluding``): values
  within rtol 1e-5 (hit ids equal), gradients within 1e-4 of their scale;
- ``radiance`` soft: the radiance contract of tests/test_torch_smallpt.py
  (>= 97% of components within isclose(2e-3), the mean within rtol 2e-3);
- ``render_differentiable`` gradients of every leaf against ``jax.grad`` of
  ``_render_jnp_diff``: max |diff| <= 1e-3 of the JAX gradient's max |.|;
- the kernel-forward route against the plain route, remat against no remat:
  bitwise (the same backward code on the same cotangent);
- finite-difference twins of tests/test_grad.py: their own tolerances.

The JAX package is imported inside the tests that use it, so that the
``cuda`` tests run on a GPU machine without JAX:
``python -m pytest tests/test_torch_grad.py --noconftest -m cuda``."""

import dataclasses

import numpy as np
import pytest
import torch

from se195_raytracer_tpu_torch import cli
from se195_raytracer_tpu_torch.core.config import RenderConfig
from se195_raytracer_tpu_torch.driver import grad_check as G
from se195_raytracer_tpu_torch.driver import optimize as O
from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk
from se195_raytracer_tpu_torch.kernels import texel_kernel as tk
from se195_raytracer_tpu_torch.kernels import whitted5_kernel as w5k
from se195_raytracer_tpu_torch.kernels import whitted_kernel as wk
from se195_raytracer_tpu_torch.models import smallpt as tpt
from se195_raytracer_tpu_torch.ops import intersect as tint
from se195_raytracer_tpu_torch.scenes.registry import get_scene
from se195_raytracer_tpu_torch.scenes.whitted5_scenes import room5_scene
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


CFG = RenderConfig(width=32, height=32, spp=2, seed=3, use_kernel=False)


def _scene(name, device="cpu"):
    spec = get_scene(name)
    return spec.to_scene(device), spec.to_camera(device)


def _leaves(scene, camera, names=O.LEAVES):
    """Fresh leaf copies of the named fields, in place in scene and camera."""
    leaves = {k: getattr(scene if k in O.SCENE_LEAVES else camera, k).detach().clone()
              .requires_grad_(True) for k in names}
    return leaves, *O.merge(scene, camera, leaves)


def _random_rays(seed, n=512):
    rs = np.random.default_rng(seed)
    o = rs.uniform([5, 5, 5], [95, 75, 160], size=(n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _close_grad(a, b, frac, tag):
    a, b = np.asarray(a), np.asarray(b)
    assert np.isfinite(a).all(), f"{tag}: not finite"
    scale = float(np.abs(b).max()) or 1.0
    err = float(np.abs(a - b).max())
    assert err <= frac * scale, f"{tag}: max |diff| {err:.3g} > {frac} x scale {scale:.3g}"


# ------------------------------------------------------- the soft pieces ----
def test_soft_pieces_match_jax():
    """``_smax0``, ``_sphere_intersect_gradsafe``, ``intersect_nearest_excluding``,
    ``_soft_light_weight`` and ``_soft_transmittance`` on random rays in the
    Cornell box: values, and gradients with respect to the centres and radii
    against ``jax.grad``."""
    import jax
    import jax.numpy as jnp

    from se195_raytracer_tpu.models import smallpt as jpt
    from se195_raytracer_tpu.ops import intersect as jint
    from se195_raytracer_tpu.scenes.registry import get_scene as j_get_scene

    jscene = j_get_scene("cornell").to_scene()
    tscene, _ = _scene("cornell")
    o, d = _random_rays(21)
    rs = np.random.default_rng(22)
    max_t = rs.uniform(1, 200, size=o.shape[0]).astype(np.float32)
    hid = rs.integers(0, tscene.num_spheres, size=o.shape[0]).astype(np.int32)
    t_excl = rs.uniform(1, 300, size=o.shape[0]).astype(np.float32)
    li = tscene.light_indices[0]
    w = 0.5
    wts = np.linspace(0.5, 1.5, o.shape[0], dtype=np.float32)
    x = rs.normal(scale=3.0, size=4096).astype(np.float32)
    with jax.disable_jit():
        np.testing.assert_allclose(tpt._smax0(torch.from_numpy(x), w).numpy(),
                                   np.asarray(jpt._smax0(jnp.asarray(x), w)), rtol=1e-6)
        jd = jint._sphere_intersect_gradsafe(jscene, jnp.asarray(o), jnp.asarray(d))
        td = tint._sphere_intersect_gradsafe(tscene, torch.from_numpy(o), torch.from_numpy(d))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5)
        jt, jid, jhit = jint.intersect_nearest_excluding(jscene, jnp.asarray(o), jnp.asarray(d),
                                                         jscene.light_indices)
        tt, tid, thit = tint.intersect_nearest_excluding(tscene, torch.from_numpy(o),
                                                         torch.from_numpy(d), tscene.light_indices)
        np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
        np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
        assert not np.isin(tid.numpy()[thit.numpy()], tscene.light_indices).any()
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5)

        def j_all(center, radius):
            s = jscene.replace(center=center, radius=radius)
            g, adp = jpt._soft_light_weight(s, li, jnp.asarray(o), jnp.asarray(d),
                                            jnp.asarray(t_excl), w)
            tr = jpt._soft_transmittance(s, jnp.asarray(o), jnp.asarray(d), jnp.asarray(max_t),
                                         jnp.asarray(hid), li, w)
            dd = jint._sphere_intersect_gradsafe(s, jnp.asarray(o), jnp.asarray(d))
            return g, adp, tr, dd

        def weighted(k):
            def f(c, r):
                v = j_all(c, r)[k]
                return jnp.sum(v * (wts[:, None] if v.ndim == 2 else wts))
            return f

        j_vals = j_all(jscene.center, jscene.radius)
        j_grads = [jax.grad(weighted(k), argnums=(0, 1))(jscene.center, jscene.radius)
                   for k in range(4)]

    def t_all(center, radius):
        s = dataclasses.replace(tscene, center=center, radius=radius)
        ot, dt = torch.from_numpy(o), torch.from_numpy(d)
        g, adp = tpt._soft_light_weight(s, li, ot, dt, torch.from_numpy(t_excl), w)
        tr = tpt._soft_transmittance(s, ot, dt, torch.from_numpy(max_t),
                                     torch.from_numpy(hid).long(), li, w)
        return g, adp, tr, tint._sphere_intersect_gradsafe(s, ot, dt)

    tw = torch.from_numpy(wts)
    for k, name in enumerate(("g", "|dp|", "transmittance", "distance")):
        c = tscene.center.clone().requires_grad_(True)
        r = tscene.radius.clone().requires_grad_(True)
        val = t_all(c, r)[k]
        np.testing.assert_allclose(val.detach().numpy(), np.asarray(j_vals[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        gc, gr = torch.autograd.grad(torch.sum(val * (tw[:, None] if val.dim() == 2 else tw)),
                                     (c, r))
        _close_grad(gc.numpy(), j_grads[k][0], 1e-4, f"{name} d/d center")
        _close_grad(gr.numpy(), j_grads[k][1], 1e-4, f"{name} d/d radius")


@pytest.mark.parametrize("scene_name", ["simple", "cornell"])
def test_radiance_soft_matches_jax(scene_name):
    """``radiance`` with the relaxation (w = 0.5) on the same camera rays and
    seeds as the JAX package's, at 16 x 16, under the radiance contract."""
    from se195_raytracer_tpu.core import rng as jrng
    from se195_raytracer_tpu.core.types import update_camera as j_update_camera
    from se195_raytracer_tpu.driver.render import pixel_coords as j_pixel_coords
    from se195_raytracer_tpu.models import smallpt as jpt
    from se195_raytracer_tpu.scenes.registry import get_scene as j_get_scene
    import jax.numpy as jnp

    w = h = 16
    spec = j_get_scene(scene_name)
    jb = j_update_camera(spec.to_camera(), w, h)
    js = jrng.init_state("mwc", (w * h,), 17)
    o, d, js = jpt.generate_camera_rays(jb, js, w, h, *j_pixel_coords(w, h))
    o, d = np.array(o), np.array(d)
    s0, s1 = (np.array(x) for x in js)
    jrad, jst = jpt.radiance(spec.to_scene(), jnp.asarray(o), jnp.asarray(d),
                             (jnp.asarray(s0), jnp.asarray(s1)), soft_edges=0.5)
    tscene, _ = _scene(scene_name)
    trad, tst = tpt.radiance(tscene, torch.from_numpy(o), torch.from_numpy(d),
                             (torch.from_numpy(s0), torch.from_numpy(s1)), soft_edges=0.5)
    a, b = trad.numpy().astype(np.float64), np.asarray(jrad, np.float64)
    assert np.isfinite(a).all()
    assert 1.0 - np.isclose(a, b, rtol=2e-3, atol=2e-3).mean() <= 0.03
    np.testing.assert_allclose(a.mean(), b.mean(), rtol=2e-3)
    assert (np.asarray(jst[0]).astype(np.int64) != tst[0].numpy()).mean() <= 0.01
    hard, _ = tpt.radiance(tscene, torch.from_numpy(o), torch.from_numpy(d),
                           (torch.from_numpy(s0), torch.from_numpy(s1)))
    assert not torch.equal(hard, trad)  # the relaxation took effect


# ---------------------------------------------- render_differentiable ----
@pytest.mark.parametrize("scene_name,soft,spp", [("simple", 0.0, 2), ("simple", 0.5, 1),
                                                 ("cornell", 0.0, 1), ("cornell", 0.5, 1)])
def test_render_differentiable_grads_match_jax(scene_name, soft, spp):
    """d(sum(W * img))/d(center, radius, emission, color, orig, target) for a
    fixed random W, through ``render_differentiable`` (hard: the
    kernel-forward Function, the kernel's plain version on CPU tensors),
    against ``jax.grad`` of ``_render_jnp_diff``: 16 x 16, mwc, hard and
    soft; spp 2 once for the running mean."""
    import jax
    import jax.numpy as jnp

    from se195_raytracer_tpu.core.config import RenderConfig as JConfig
    from se195_raytracer_tpu.driver.optimize import _render_jnp_diff
    from se195_raytracer_tpu.scenes.registry import get_scene as j_get_scene

    w = h = 16
    spec = j_get_scene(scene_name)
    js, jc = spec.to_scene(), spec.to_camera()
    jcfg = JConfig(width=w, height=h, spp=spp, seed=3, soft_edges=soft)
    wts = np.random.default_rng(0).standard_normal((h, w, 3)).astype(np.float32)

    def jloss(center, radius, emission, color, orig, target):
        s = js.replace(center=center, radius=radius, emission=emission, color=color)
        return jnp.mean(_render_jnp_diff(s, jc.replace(orig=orig, target=target), jcfg) * wts)

    with jax.disable_jit():
        jv, jg = jax.value_and_grad(jloss, argnums=tuple(range(6)))(
            js.center, js.radius, js.emission, js.color, jc.orig, jc.target)
    leaves, scene, camera = _leaves(*_scene(scene_name))
    cfg = RenderConfig(width=w, height=h, spp=spp, seed=3, soft_edges=soft)
    img = O.render_differentiable(scene, camera, cfg, device="cpu")
    loss = torch.mean(img * torch.from_numpy(wts))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jv), rtol=1e-4)
    for (k, t), g in zip(leaves.items(), jg):
        _close_grad(t.grad.numpy(), g, 1e-3, k)


@pytest.mark.parametrize("soft", [0.0, 0.5])
def test_kernel_route_grads_equal_plain_route(soft):
    """With ``use_kernel`` (hard: the Function, whose forward is K1's plain
    version here) and without, the gradients of a loss linear in the image
    are bitwise equal: both backwards run ``_render_plain_diff``'s autograd
    on the same cotangent."""
    wts = torch.from_numpy(np.random.default_rng(1).standard_normal((16, 24, 3))
                           .astype(np.float32))
    grads = []
    for use_kernel in (True, False):
        leaves, scene, camera = _leaves(*_scene("cornell"))
        cfg = RenderConfig(width=24, height=16, spp=2, seed=4, soft_edges=soft,
                           use_kernel=use_kernel)
        torch.sum(O.render_differentiable(scene, camera, cfg, device="cpu") * wts).backward()
        grads.append({k: t.grad for k, t in leaves.items()})
    for k in O.LEAVES:
        assert torch.isfinite(grads[0][k]).all()
        assert torch.equal(grads[0][k], grads[1][k]), k


def test_kernel_route_forward_is_the_kernel_and_k2_above_96_spheres():
    """The Function's forward is ``render_cuda``: its image is the kernel
    path's bitwise (K1's plain version on the CPU), and on ``complex`` (783
    spheres) it takes K2's lane layout; the backward still reaches every
    leaf that asks for a gradient and only those."""
    scene, camera = _scene("cornell")
    cfg = RenderConfig(width=16, height=8, spp=2, seed=2)
    img = O.render_differentiable(scene, camera, cfg, device="cpu")
    ref, _ = ptk.render_cuda(scene, camera, cfg, device="cpu")
    assert torch.equal(img, ref)
    scene, camera = _scene("complex")
    cfg = RenderConfig(width=8, height=8, spp=1, seed=2, max_depth=2)
    leaves, scene, camera = _leaves(scene, camera, ("center", "color"))
    img = O.render_differentiable(scene, camera, cfg, device="cpu")
    with torch.no_grad():
        ref, _ = ptk.render_cuda(scene, camera, cfg, device="cpu")
    assert torch.equal(img, ref)
    torch.mean(img ** 2).backward()
    for t in leaves.values():
        assert torch.isfinite(t.grad).all() and t.grad.abs().max() > 0
    assert scene.radius.grad is None


@pytest.mark.parametrize("rng", ["mwc", "counter"])
def test_forward_and_recompute_draw_one_stream(rng):
    """The kernel forward and the backward's recompute (seeded with
    ``init_state(config.rng, ...)``) give the same primal under both RNGs,
    within K1's contract (on the CPU: equal up to the running mean's
    reciprocal)."""
    scene, camera = _scene("cornell")
    cfg = RenderConfig(width=24, height=16, spp=3, seed=5, rng=rng)
    with torch.no_grad():
        fwd = O.render_differentiable(scene, camera, cfg, device="cpu")
        rec = O._render_plain_diff(scene, camera, cfg)
    np.testing.assert_allclose(fwd.numpy(), rec.numpy(), rtol=1e-6, atol=1e-6)
    other = O._render_plain_diff(scene, camera, dataclasses.replace(
        cfg, rng="mwc" if rng == "counter" else "counter"))
    assert not torch.allclose(fwd, other, atol=1e-2)


def test_remat_matches_no_remat():
    """Per-bounce checkpointing changes neither the image nor the gradients:
    bitwise, with the relaxation on, and ``radiance`` alone (the twin of
    tests/test_grad.py::test_remat_matches_no_remat)."""
    o = torch.tensor([[20.0, 80.0, 300.0]]).repeat(8, 1)
    d = torch.tensor([[0.0, -0.2, -1.0]]).repeat(8, 1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    from se195_raytracer_tpu_torch.core.rng import init_mwc_state

    st = init_mwc_state((8,), 1)
    scene, camera = _scene("simple")
    r1, _ = tpt.radiance(scene, o, d, st, remat=False)
    r2, _ = tpt.radiance(scene, o, d, st, remat=True)
    assert torch.equal(r1, r2)
    cfg = dataclasses.replace(CFG, width=16, height=16, soft_edges=0.5)
    out = []
    for remat in (True, False):
        leaves, s, c = _leaves(scene, camera)
        img = O._render_plain_diff(s, c, cfg, remat=remat)
        torch.sum(img * img).backward()
        out.append((img.detach(), {k: t.grad for k, t in leaves.items()}))
    assert torch.equal(out[0][0], out[1][0])
    for k in O.LEAVES:
        assert torch.equal(out[0][1][k], out[1][1][k]), k


# ------------------------------------- twins of tests/test_grad.py ----
def _fd(fn, x, idx, eps):
    xp, xm = x.detach().clone(), x.detach().clone()
    xp[idx] += eps
    xm[idx] -= eps
    return (float(fn(xp)) - float(fn(xm))) / (2 * eps)


def _loss_of(field, scene, camera, cfg=CFG):
    def loss(v):
        return torch.mean(O.render_differentiable(
            dataclasses.replace(scene, **{field: v}), camera, cfg, device="cpu"))
    return loss


def _grad(loss, v):
    v = v.detach().clone().requires_grad_(True)
    loss(v).backward()
    return v.grad.numpy()


def test_color_gradient_matches_fd():
    scene, camera = _scene("simple")
    loss = _loss_of("color", scene, camera)
    g = _grad(loss, scene.color)
    for idx in [(1, 0), (2, 1), (0, 1)]:
        fd = _fd(loss, scene.color, idx, 1e-3)
        assert abs(g[idx] - fd) <= 0.02 * abs(fd) + 1e-6, (idx, g[idx], fd)


def test_emission_gradient_matches_fd_for_lights():
    scene, camera = _scene("simple")
    loss = _loss_of("emission", scene, camera)
    g = _grad(loss, scene.emission)
    li = scene.light_indices[0]
    for k in range(3):
        fd = _fd(loss, scene.emission, (li, k), 1e-2)
        assert abs(g[li, k] - fd) <= 0.02 * abs(fd) + 1e-7, (k, g[li, k], fd)


def test_center_gradient_matches_fd_small_spheres():
    """The small diffuse spheres' centres, away from shadow and silhouette
    boundaries (tests/test_grad.py's components and tolerance)."""
    scene, camera = _scene("simple")
    loss = _loss_of("center", scene, camera)
    g = _grad(loss, scene.center)
    assert np.isfinite(g).all()
    for idx in [(1, 1), (2, 1), (3, 0), (3, 2)]:
        fd = _fd(loss, scene.center, idx, 1e-2)
        assert abs(g[idx] - fd) <= 0.1 * abs(fd) + 2e-5, (idx, g[idx], fd)


def test_camera_and_refraction_gradients_finite():
    """Camera pose gradients flow through the derived basis; on the
    refractive caustic3 scene the centre gradients stay finite (TIR and miss
    lanes exercise the guarded square roots)."""
    scene, camera = _scene("simple")
    cfg = dataclasses.replace(CFG, width=16, height=16)
    leaves, s, c = _leaves(scene, camera, ("orig", "target"))
    torch.mean(O.render_differentiable(s, c, cfg, device="cpu")).backward()
    for t in leaves.values():
        assert torch.isfinite(t.grad).all() and t.grad.abs().max() > 0
    scene, camera = _scene("caustic3")
    leaves, s, c = _leaves(scene, camera, ("center",))
    torch.mean(O.render_differentiable(s, c, cfg, device="cpu")).backward()
    assert torch.isfinite(leaves["center"].grad).all()


def test_inverse_rendering_recovers_color():
    """Perturb a sphere's albedo and recover it from the target image (the
    twin of tests/test_grad.py's, at 16 x 16)."""
    scene, camera = _scene("simple")
    cfg = RenderConfig(width=16, height=16, spp=2, seed=7)
    with torch.no_grad():
        target = O.render_differentiable(scene, camera, cfg, device="cpu")
    color = scene.color.clone()
    color[1] = torch.tensor([0.2, 0.6, 0.6])
    perturbed = dataclasses.replace(scene, color=color)
    loss0 = float(O.l2_image_loss(perturbed, camera, target, cfg, device="cpu"))
    st = O.run_inverse_rendering(perturbed, camera, target, cfg, steps=60, learning_rate=5e-2,
                                 param_filter=lambda n: n == "color", device="cpu")
    assert float(st.loss) < loss0 * 0.05, (loss0, float(st.loss))
    np.testing.assert_allclose(st.scene.color[1].detach().numpy(), scene.color[1].numpy(),
                               atol=0.08)
    assert torch.equal(perturbed.color, color)  # the caller's scene is not written


def test_inverse_rendering_matches_jax():
    """Five Adam steps of ``run_inverse_rendering`` (torch.optim.Adam) against
    the JAX package's (optax.adam) from the same start: simple 12 x 12, spp
    1, the colours train. The perturbed sphere's colour moves ~0.2 per
    channel and agrees within 1e-3. (Components whose gradient is near zero
    are not compared: Adam normalises each step to ~lr, so there the sign of
    a rounding-level gradient decides the step.)"""
    import jax.numpy as jnp

    from se195_raytracer_tpu.core.config import RenderConfig as JConfig
    from se195_raytracer_tpu.driver.optimize import run_inverse_rendering
    from se195_raytracer_tpu.scenes.registry import get_scene as j_get_scene

    spec = j_get_scene("simple")
    js, jc = spec.to_scene(), spec.to_camera()
    scene, camera = _scene("simple")
    cfg = RenderConfig(width=12, height=12, spp=1, seed=7)
    with torch.no_grad():
        target = O.render_differentiable(scene, camera, cfg, device="cpu")
    color = scene.color.clone()
    color[1] = torch.tensor([0.2, 0.6, 0.6])
    start = dataclasses.replace(scene, color=color)
    pf = lambda n: n == "color"  # noqa: E731
    st = O.run_inverse_rendering(start, camera, target, cfg, steps=5, learning_rate=5e-2,
                                 param_filter=pf, device="cpu")
    jst = run_inverse_rendering(js.replace(color=jnp.asarray(color.numpy())), jc,
                                jnp.asarray(target.numpy()),
                                JConfig(width=12, height=12, spp=1, seed=7), steps=5,
                                learning_rate=5e-2, param_filter=pf)
    a = st.scene.color[1].detach().numpy()
    b = np.asarray(jst.scene.color[1])
    assert np.abs(b - color[1].numpy()).min() > 0.1
    np.testing.assert_allclose(a, b, atol=1e-3)


def test_soft_edges_silhouette_gradients_match_fd():
    """The relaxation's JVP agrees with central FD of the same relaxed
    forward, silhouettes included (tests/test_grad.py's check, at 32 x 32),
    through ``pixel_grad_check``."""
    scene, camera = _scene("cornell")
    cfg = RenderConfig(width=32, height=32, spp=1, seed=5, soft_edges=0.5)
    li = scene.light_indices[0]
    for param, idx in [("emission", (li, 0)), ("center", (li, 1))]:
        mx, _, scale, jvp = G.pixel_grad_check(scene, camera, cfg, param, idx, 1e-2, soft=0.5)
        assert torch.isfinite(jvp).all(), param
        assert mx < 0.05 * scale, (param, mx, scale)


def test_soft_edges_approaches_hard_far_from_silhouettes():
    scene, camera = _scene("cornell")
    cfg_hard = RenderConfig(width=32, height=32, spp=1, seed=5, use_kernel=False)
    with torch.no_grad():
        hard = O.render_differentiable(scene, camera, cfg_hard, device="cpu").numpy()
        soft = O.render_differentiable(scene, camera, dataclasses.replace(
            cfg_hard, soft_edges=0.05), device="cpu").numpy()
    close = np.abs(hard - soft).max(axis=-1) < 0.02 * (hard.max() + 1.0)
    assert close.mean() > 0.93, float(close.mean())


def test_soft_transmittance_semantics():
    """~1 for a clear segment, ~0 through a deep occluder, and the
    originating sphere does not occlude."""
    scene, _ = _scene("cornell")
    c7 = scene.center[7].numpy()
    o = torch.from_numpy(np.stack([c7 + np.array([-30.0, 0.0, 0.0], np.float32),
                                   np.array([50.0, 40.0, 100.0], np.float32)]))
    d = torch.tensor([[1.0, 0, 0], [0, 0, 1.0]])
    maxt = torch.tensor([50.0, 5.0])
    li = scene.light_indices[0]
    t = tpt._soft_transmittance(scene, o, d, maxt, torch.tensor([0, 0]), li, 0.5)
    assert t[0] < 0.05 and t[1] > 0.6, t
    t2 = tpt._soft_transmittance(scene, o, d, maxt, torch.tensor([7, 0]), li, 0.5)
    assert t2[0] > 0.6, t2


def test_soft_light_weight_semantics():
    """g ~ 1 straight into the light ahead of the winner, ~0 pointing away;
    a finite gradient in the centres."""
    scene, _ = _scene("cornell")
    li = scene.light_indices[0]
    o = torch.tensor([[50.0, 40.0, 81.6], [50.0, 40.0, 81.6]])
    toward = scene.center[li] - o[0]
    toward = toward / torch.linalg.norm(toward)
    d = torch.stack([toward, -toward])
    center = scene.center.clone().requires_grad_(True)
    g, _ = tpt._soft_light_weight(dataclasses.replace(scene, center=center), li, o, d,
                                  torch.tensor([1e4, 1e4]), 0.5)
    assert g[0] > 0.95 and g[1] < 0.05, g
    g.sum().backward()
    assert torch.isfinite(center.grad).all()


# ------------------------------------------ driver/grad_check.py ----
def test_grad_check_pieces_match_the_jax_bench():
    """``grad_bench_start``, ``light_capsule_mask`` and ``GroupAdam``
    against tools/grad_bench.py's construction, mask and optax chain."""
    import importlib.util
    import os

    import jax.numpy as jnp
    import optax

    from se195_raytracer_tpu.scenes.registry import get_scene as j_get_scene

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "tools", "grad_bench.py")
    spec_ = importlib.util.spec_from_file_location("grad_bench_jax", path)
    gb = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(gb)
    js, jc = j_get_scene("cornell").to_scene(), j_get_scene("cornell").to_camera()
    j0 = js.replace(center=js.center.at[8].add(jnp.array([8.0, -5.0, 0.0])),
                    color=js.color.at[0].set(jnp.array([0.3, 0.6, 0.3])))
    scene, camera = _scene("cornell")
    s0 = G.grad_bench_start(scene)
    np.testing.assert_array_equal(s0.center.numpy(), np.asarray(j0.center))
    np.testing.assert_array_equal(s0.color.numpy(), np.asarray(j0.color))
    mask = G.light_capsule_mask(scene, s0, camera, 48, 40, 8)
    jmask = np.asarray(gb.light_capsule_mask(js, j0, jc, 48, 40, 8))
    assert 0.0 < mask.mean() < 0.5
    assert (mask != jmask).mean() < 0.005

    rs = np.random.default_rng(3)
    p0 = {"a": rs.normal(size=(4, 3)).astype(np.float32), "b": rs.normal(size=5).astype(np.float32)}
    grads = [{k: (rs.normal(size=v.shape) * 8).astype(np.float32) for k, v in p0.items()}
             for _ in range(6)]
    grads[2]["a"][1, 1] = np.nan
    steps, alpha = 6, 0.25

    def chain(lr):
        return optax.chain(optax.zero_nans(), optax.clip_by_global_norm(10.0),
                           optax.adam(optax.cosine_decay_schedule(lr, steps, alpha)))

    opt = optax.multi_transform({"g": chain(0.3), "m": chain(0.1)}, {"a": "g", "b": "m"})
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = opt.init(jp)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in p0.items()}
    topt = G.GroupAdam({"g": ([tp["a"]], 0.3), "m": ([tp["b"]], 0.1)}, steps, alpha)
    for g in grads:
        upd, st = opt.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        topt.zero_grad()
        for k, v in g.items():
            tp[k].grad = torch.from_numpy(v.copy())
        topt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-5,
                                   atol=1e-6)


def test_pixel_grad_check_small_frame():
    """The BASELINE gradient metric's checks at 24 x 24: emission and albedo
    within 0.1% of the finite-difference scale, hard and soft; the light
    centre within 5% soft. The hard light centre is the silhouette case
    (its error depends on whether a silhouette crosses a pixel within eps):
    finite, not bounded."""
    scene, camera = _scene("cornell")
    cfg = RenderConfig(width=24, height=24, spp=1, seed=0)
    for label, param, idx, eps in G.PIXEL_CHECKS:
        for soft in (0.0, 0.5):
            mx, p99, scale, jvp = G.pixel_grad_check(scene, camera, cfg, param, idx, eps, soft)
            assert torch.isfinite(jvp).all() and p99 <= mx
            pct = 100.0 * mx / scale
            if param != "center":
                assert pct <= 0.1, (label, soft, pct)
            elif soft > 0.0:
                assert pct <= 5.0, (label, soft, pct)


# ---------------------------------------------- Step 0: the refusals ----
def _refusal_cases(device):
    scene, camera = _scene("cornell", device)
    cfg = RenderConfig(width=8, height=8, spp=1)
    tab = ptk.pack_scene(scene)
    cam = ptk.pack_camera(ptk.update_camera(camera, 8, 8))
    s0, s1, acc = ptk.init_pt_state(cfg, device)
    kw = dict(num_samples=1, width=8, height=8, max_depth=2, direct_only=False,
              light_indices=scene.light_indices)
    cscene, ccam = _scene("complex", device)
    ctab = ptk.pack_scene(cscene)
    ccfg = RenderConfig(width=8, height=8, spp=1)
    cs0, cs1, cacc = ptk.init_pt_state(ccfg, device, blocked=True)
    pix = torch.from_numpy(ptk.ray_layout(8, 8, True)[1]).to(device)
    wscene = WHITTED_SCENES["room"](device)
    w5 = room5_scene(textures="procedural", device=device)
    o5 = torch.zeros((4, 3), device=device)
    d5 = torch.tensor([[0.0, 0.0, 1.0]] * 4, device=device)
    st5 = (torch.zeros(4, dtype=torch.int64, device=device),) * 2
    atlas, textab = tk.pack_texel_atlas(w5.textures)
    n = 4
    tex_args = (torch.zeros(n, dtype=torch.int32, device=device),
                torch.rand(n, device=device), torch.rand(n, device=device),
                torch.ones(n, dtype=torch.bool, device=device))
    g = lambda t: t.detach().clone().requires_grad_(True)  # noqa: E731
    return {
        "pt_multi_pass": lambda: ptk.pt_multi_pass(g(tab), cam, 0, s0, s1, acc, **kw),
        "pt_blocked_pass": lambda: ptk.pt_blocked_pass(ctab, cam, 0, cs0, cs1, g(cacc), pix,
                                                       **kw),
        "render_cuda": lambda: ptk.render_cuda(dataclasses.replace(scene, color=g(scene.color)),
                                               camera, cfg, device=device),
        "whitted_trace_cuda": lambda: wk.whitted_trace_cuda(
            wscene, g(torch.zeros((6, 1, wk.LANES), device=device))),
        "whitted_frame_cuda": lambda: wk.whitted_frame_cuda(
            dataclasses.replace(wscene, center=g(wscene.center)), width=8, height=8,
            supersample=1),
        "whitted5_trace_cuda": lambda: w5k.whitted5_trace_cuda(
            dataclasses.replace(w5, box_pos=g(w5.box_pos)), o5, d5, st5),
        "texel_fetch_cuda": lambda: tk.texel_fetch_cuda(g(atlas), textab.to(device), *tex_args),
    }


REFUSING = ("pt_multi_pass", "pt_blocked_pass", "render_cuda", "whitted_trace_cuda",
            "whitted_frame_cuda", "whitted5_trace_cuda", "texel_fetch_cuda")


@pytest.mark.parametrize("entry", REFUSING)
def test_kernel_wrapper_refuses_grad_inputs(entry):
    """Every kernel wrapper raises on an input that requires grad, on the CPU
    as on the card (its output would have no autograd history there), names
    the ways out, and runs under torch.no_grad."""
    call = _refusal_cases("cpu")[entry]
    with pytest.raises(RuntimeError, match="render_differentiable.*use_kernel=False"):
        call()
    with torch.no_grad():
        call()


def test_soft_edges_with_the_kernel_raises():
    """The kernels implement the hard estimator: ``render`` and
    ``render_cuda`` with soft_edges > 0 and the kernel raise; the plain path
    renders the relaxed estimator."""
    from se195_raytracer_tpu_torch.driver.render import render

    scene, camera = _scene("cornell")
    cfg = RenderConfig(width=8, height=8, spp=1, soft_edges=0.5)
    for fn in (lambda: render(scene, camera, cfg, device="cpu"),
               lambda: ptk.render_cuda(scene, camera, cfg, device="cpu")):
        with pytest.raises(NotImplementedError, match="hard estimator"):
            fn()
    img, _ = render(scene, camera, dataclasses.replace(cfg, use_kernel=False), device="cpu")
    hard, _ = render(scene, camera, dataclasses.replace(cfg, use_kernel=False, soft_edges=0.0),
                     device="cpu")
    assert torch.isfinite(img).all() and not torch.equal(img, hard)


def test_cli_soft(tmp_path, capsys):
    """``--soft 0.5 --device cpu`` renders for pt and whitted5 on the plain
    path, with a note; with ``--adaptive`` it exits 2."""
    for extra in (["--scene", "cornell"], ["--integrator", "whitted5"]):
        out = tmp_path / f"s{len(extra[1])}.png"
        assert cli.main(["render", *extra, "--width", "12", "--height", "8", "--spp", "1",
                         "--soft", "0.5", "--device", "cpu", "--out", str(out)]) == 0
        assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
        assert "kernels implement the hard estimator" in capsys.readouterr().err
    assert cli.main(["render", "--integrator", "whitted5", "--adaptive", "--width", "12",
                     "--height", "8", "--soft", "0.5", "--device", "cpu", "--out", ""]) == 2


# ---------------------------------------------------------- on the card ----
def _card_leaves():
    return _leaves(*_scene("cornell", "cuda"))


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
def test_card_function_grads_equal_plain_vjp():
    """On the card: the Function's gradients, K1b's (one launch in the
    backward, no K1 launch), equal the plain path's VJP of the same
    cotangent within K1b's bar (``grad_row_error`` within
    ``GRAD_ROW_REL``: each sphere's row against its own largest gradient;
    K1b takes a sqrt's derivative in float32 and sums in another order,
    tests/test_torch_pt_backward.py), and its forward is one K1 launch."""
    from se195_raytracer_tpu_torch.kernels import pt_backward_kernel as pbk

    cfg = RenderConfig(width=64, height=64, spp=2, seed=1)
    leaves, scene, camera = _card_leaves()
    ptk.pt_multi_pass.launches = pbk.pt_backward_cuda.launches = 0
    img = O.render_differentiable(scene, camera, cfg)
    assert ptk.pt_multi_pass.launches == 1
    cot = {}
    img.register_hook(lambda g: cot.setdefault("g", g))
    ga = torch.autograd.grad(torch.mean(img ** 2), list(leaves.values()))
    assert ptk.pt_multi_pass.launches == 1 and pbk.pt_backward_cuda.launches == 1
    leaves_b, scene_b, camera_b = _card_leaves()
    gb = torch.autograd.grad(O._render_plain_diff(scene_b, camera_b, cfg),
                             list(leaves_b.values()), cot["g"])
    for a in ga:
        assert torch.isfinite(a).all()
    err = pbk.grad_row_error(dict(zip(leaves, ga)), dict(zip(leaves, gb)))
    assert max(err.values()) <= pbk.GRAD_ROW_REL, err


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
def test_card_one_k1_launch_per_differentiable_forward():
    cfg = RenderConfig(width=64, height=32, spp=3, seed=1)
    _, scene, camera = _card_leaves()
    ptk.pt_multi_pass.launches = ptk.pt_blocked_pass.launches = 0
    for i in range(3):
        O.render_differentiable(scene, camera, cfg)
        assert ptk.pt_multi_pass.launches == i + 1 and ptk.pt_blocked_pass.launches == 0


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
@pytest.mark.parametrize("entry", REFUSING)
def test_card_kernel_wrapper_refuses_grad_inputs(entry):
    call = _refusal_cases("cuda")[entry]
    with pytest.raises(RuntimeError, match="render_differentiable"):
        call()

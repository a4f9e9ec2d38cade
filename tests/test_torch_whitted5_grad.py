"""Differentiability of the port's whitted5 (raytracer5) tracer and its
soft-shadow relaxation, against the JAX package on the CPU (the twins of
tests/test_whitted5_grad.py).

The plain tracer (``use_kernel=False``) is differentiable dataflow: texture
bitmaps, materials and geometry are tensors. With ``soft_edges > 0``
CalcShade's visibility becomes the smooth transmittance
(``models/whitted5._soft_shadow_transmittance``), so an area light's
position optimizes through where its shadow falls.

Tolerances: ``_soft_shadow_transmittance`` values within rtol 1e-5 and its
gradients within 1e-4 of their scale, against the JAX function op by op;
the soft trace under the whitted5 contract of tests/test_torch_whitted5.py
(p99 of |diff| < 1e-4, max < 3e-3), against the JAX jnp tracer op by op at
48 x 36, depth 1: the relaxation is in the shading of a node, and what the
tree's deeper levels add is the hard path's, held there.

The JAX package is imported inside the tests that use it."""

import dataclasses

import numpy as np
import pytest
import torch

from se195_raytracer_tpu_torch.models import whitted5 as P
from se195_raytracer_tpu_torch.scenes import whitted5_scenes as S


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


W, H = 64, 48
LIGHT = 4  # room5's first box light


def _room5():
    return S.room5_scene("procedural", device="cpu")


def _render(scene, **kw):
    return P.render_whitted5(scene, width=kw.pop("width", W), height=kw.pop("height", H),
                             spp=1, use_kernel=False, device="cpu", **kw)


def test_soft_shadow_transmittance_matches_jax():
    """Random shadow segments in room5 (spheres, planes, boxes) towards each
    light: the transmittance, and its gradient with respect to the sphere
    centres, plane depths and box positions, against the JAX function."""
    import jax
    import jax.numpy as jnp

    from se195_raytracer_tpu.models import whitted5 as J
    from se195_raytracer_tpu.scenes import whitted5_scenes as JS

    js, ps = JS.room5_scene("procedural"), _room5()
    rs = np.random.default_rng(4)
    n = 384
    o = rs.uniform([-8, -4, -2], [8, 4.5, 10], size=(n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    max_t = rs.uniform(0.5, 15, size=n).astype(np.float32)
    wts = np.linspace(0.5, 1.5, n, dtype=np.float32)
    fields = ("center", "depth", "box_pos")
    for target in (LIGHT, 5):
        def jfn(center, depth, box_pos):
            s = js.replace(center=center, depth=depth, box_pos=box_pos)
            return J._soft_shadow_transmittance(s, jnp.asarray(o), jnp.asarray(d),
                                                jnp.asarray(max_t), target, 0.3)

        with jax.disable_jit():
            jv = np.asarray(jfn(js.center, js.depth, js.box_pos))
            jg = jax.grad(lambda *a: jnp.sum(jfn(*a) * wts), argnums=(0, 1, 2))(
                js.center, js.depth, js.box_pos)
        leaves = {f: getattr(ps, f).clone().requires_grad_(True) for f in fields}
        tv = P._soft_shadow_transmittance(dataclasses.replace(ps, **leaves), torch.from_numpy(o),
                                          torch.from_numpy(d), torch.from_numpy(max_t), target,
                                          0.3)
        np.testing.assert_allclose(tv.detach().numpy(), jv, rtol=1e-5, atol=1e-6)
        assert 0.02 < float((jv < 0.5).mean()) < 0.98  # both lit and shadowed segments
        torch.sum(tv * torch.from_numpy(wts)).backward()
        for f, g in zip(fields, jg):
            a, b = leaves[f].grad.numpy(), np.asarray(g)
            assert np.isfinite(a).all(), f
            scale = float(np.abs(b).max())
            assert scale > 0 and float(np.abs(a - b).max()) <= 1e-4 * scale, (target, f)


def test_soft_trace_matches_jax():
    """The soft trace (w 0.3) of room5 at 48 x 36, depth 1 (every light and
    primitive class shades), against the JAX jnp tracer op by op, on the
    same rays and counter state."""
    import jax

    from se195_raytracer_tpu.models import whitted5 as J
    from se195_raytracer_tpu.scenes import whitted5_scenes as JS

    w, h = 48, 36
    js, ps = JS.room5_scene("procedural"), _room5()
    o, d = P.camera_rays5(w, h)
    key, ctr = P._init_state5_np(w * h, 5)
    with jax.disable_jit():
        jcol, _ = J.whitted5_trace(js, o, d, (key, ctr), 1, soft_edges=0.3)
    tcol, _ = P.whitted5_trace(ps, torch.from_numpy(o), torch.from_numpy(d),
                               (torch.from_numpy(key.astype(np.int64)),
                                torch.from_numpy(ctr.astype(np.int64))), 1, soft_edges=0.3)
    hard, _ = P.whitted5_trace(ps, torch.from_numpy(o), torch.from_numpy(d),
                               (torch.from_numpy(key.astype(np.int64)),
                                torch.from_numpy(ctr.astype(np.int64))), 1)
    a, b = tcol.numpy(), np.asarray(jcol)
    assert np.isfinite(a).all()
    diff = np.abs(a - b)
    assert float(np.percentile(diff, 99)) < 1e-4 and float(diff.max()) < 3e-3
    assert not torch.equal(tcol, hard)


def test_texture_gradient_recovers_floor():
    """Gradients flow through the bilinear texel fetch to the texels the
    camera sees; Adam recovers the floor texture from grey."""
    scene = _room5()
    with torch.no_grad():
        target = _render(scene)
    tex0 = scene.textures[0]
    tex = torch.full_like(tex0, 0.5).requires_grad_(True)
    opt = torch.optim.Adam([tex], lr=0.5)
    losses, seen = [], None
    for _ in range(8):
        opt.zero_grad()
        img = _render(dataclasses.replace(scene, textures=(tex,) + scene.textures[1:]))
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        if seen is None:
            seen = (tex.grad.abs().sum(-1) > 0).numpy()
        losses.append(loss.item())
        opt.step()
    assert seen.mean() > 0.005, "no texels received gradient"
    assert losses[-1] < 0.35 * losses[0], losses
    err0 = float(np.abs(0.5 - tex0.numpy())[seen].mean())
    err1 = float(np.abs(tex.detach().numpy() - tex0.numpy())[seen].mean())
    assert err1 < 0.7 * err0, (err0, err1)


def test_soft_shadow_light_position_gradient():
    """The first box light's x carries a usable gradient through its shadow
    with the relaxation on (positive 1.5 units to the right of the truth,
    as in the JAX test), and clipped gradient descent recovers it."""
    scene = _room5()
    soft = 0.3
    with torch.no_grad():
        target = _render(scene, soft_edges=soft)
    true_x = float(scene.box_pos[LIGHT, 0])

    def loss_and_grad(x):
        xt = torch.tensor(x, requires_grad=True)
        row = torch.cat([xt[None], scene.box_pos[LIGHT, 1:]])
        box_pos = torch.cat([scene.box_pos[:LIGHT], row[None], scene.box_pos[LIGHT + 1:]])
        loss = torch.mean((_render(dataclasses.replace(scene, box_pos=box_pos),
                                   soft_edges=soft) - target) ** 2)
        loss.backward()
        return loss.item(), xt.grad.item()

    x = true_x + 1.5
    _, g0 = loss_and_grad(x)
    assert np.isfinite(g0) and g0 > 0.0, g0
    for _ in range(15):
        _, g = loss_and_grad(x)
        x = x - float(np.clip(g * 300.0, -0.3, 0.3))
    assert abs(x - true_x) < 0.3, (x, true_x)


def test_soft_matches_hard_away_from_shadow_edges():
    """The relaxation only perturbs ~w-wide bands: most pixels match the
    hard estimator closely at small w."""
    scene = _room5()
    with torch.no_grad():
        hard = _render(scene).numpy()
        soft = _render(scene, soft_edges=0.05).numpy()
    d = np.abs(hard - soft).max(-1)
    assert np.median(d) < 2e-2, np.median(d)
    assert (d < 0.1).mean() > 0.85, (d < 0.1).mean()


def test_soft_with_the_kernel_raises_and_hard_grads_flow():
    """K4 implements the hard estimator: soft_edges > 0 with the kernel
    raises; the kernel refuses a scene that needs a gradient, and the plain
    tracer gives box_pos and colour gradients (hard)."""
    scene = _room5()
    with pytest.raises(NotImplementedError, match="hard estimator"):
        P.render_whitted5(scene, 8, 6, soft_edges=0.3, device="cpu")
    box_pos = scene.box_pos.clone().requires_grad_(True)
    color = scene.color.clone().requires_grad_(True)
    moved = dataclasses.replace(scene, box_pos=box_pos, color=color)
    with pytest.raises(RuntimeError, match="use_kernel=False"):
        P.render_whitted5(moved, 16, 12, device="cpu")
    torch.mean(_render(moved, width=16, height=12)).backward()
    assert torch.isfinite(box_pos.grad).all() and torch.isfinite(color.grad).all()
    assert color.grad.abs().max() > 0

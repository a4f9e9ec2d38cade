"""K1, K2 and the render driver of the port against the JAX package on the
CPU.

On the CPU the kernels' wrappers run their plain version (pt_pass_reference),
which is held against the JAX kernel run in interpret mode
(``render_pallas(interpret=True)``), as tests/test_pallas_kernel.py runs it.
K2 (scenes over 96 spheres) is checked on ``complex_scene(max_depth=3.0)``
(158 spheres) at 32x16, 1 spp, max_depth 3, the shape of
``test_pallas_loop_kernel_matches_jnp``; its lanes are in the blocked
layout, which is the JAX package's, so states compare lane for lane and
pixel states through ``inv``.
Tolerance, the one tests/test_pallas_kernel.py states for Pallas against
XLA: >= 97% of components within isclose(rtol=2e-3, atol=2e-3), the mean
within rtol 2e-3, and <= 1% of lanes with a different RNG state (ulp-level
sin/cos/sqrt differences can flip a Russian-roulette or TIR decision).
Progressive resume is exact arithmetic on both sides: within 1e-6.

The JAX package is imported inside the tests that use it, so that the
``cuda`` tests run on a GPU machine without JAX:
``python -m pytest tests/test_torch_pt_kernel.py --noconftest -m cuda``."""

import numpy as np
import pytest
import torch

from se195_raytracer_tpu_torch import convert
from se195_raytracer_tpu_torch.core.config import RenderConfig
from se195_raytracer_tpu_torch.driver.render import render
from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk
from se195_raytracer_tpu_torch.scenes.registry import get_scene


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


# 1536 pixels in 2048 lanes: the pad lanes are exercised too.
W, H = 48, 32
CASES = [("pt", "mwc"), ("dl", "mwc"), ("pt", "counter")]
_PALLAS = {}


def _pallas(integrator, rng, spp, seed=4):
    """JAX K1 in interpret mode, cached per module run. Each new
    configuration compiles for ~15 s, so spp > 1 continues the cached
    (spp - 1) render from its state: the same jitted kernel, and equal to
    one spp-pass render within 1e-6 (test_pallas_progressive_resume)."""
    import jax.numpy as jnp

    from se195_raytracer_tpu.core.config import RenderConfig as JConfig
    from se195_raytracer_tpu.kernels.pt_kernel import render_pallas
    from se195_raytracer_tpu.scenes.registry import get_scene as j_get_scene

    key = (integrator, rng, spp, seed)
    if key not in _PALLAS:
        spec = j_get_scene("cornell")
        cfg = JConfig(width=W, height=H, spp=1, seed=seed, integrator=integrator, rng=rng)
        state = None
        if spp > 1:
            state = tuple(jnp.asarray(x) for x in _pallas(integrator, rng, spp - 1, seed)[1])
        img, st = render_pallas(spec.to_scene(), spec.to_camera(), cfg, state=state, interpret=True)
        _PALLAS[key] = (np.asarray(img), tuple(np.asarray(x) for x in st[:3]) + (int(st[3]),))
    return _PALLAS[key]


def _port(integrator, rng, spp, seed=4, use_kernel=True, state=None):
    spec = get_scene("cornell")
    cfg = RenderConfig(width=W, height=H, spp=spp, seed=seed, integrator=integrator,
                       rng=rng, use_kernel=use_kernel)
    return render(spec.to_scene("cpu"), spec.to_camera("cpu"), cfg, state=state, device="cpu")


def assert_contract(a, b, state_a, state_b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.isfinite(b).all()
    frac = 1.0 - np.isclose(a, b, rtol=2e-3, atol=2e-3).mean()
    assert frac <= 0.03, f"{frac:.3%} components differ"
    np.testing.assert_allclose(a.mean(), b.mean(), rtol=2e-3)
    assert (np.asarray(state_a) != np.asarray(state_b)).mean() <= 0.01


@pytest.mark.parametrize("integrator,rng", CASES)
def test_plain_k1_matches_pallas(integrator, rng):
    """render(use_kernel=True) on the CPU (the plain K1) against the JAX
    kernel, state compared over every lane, pad lanes included."""
    jimg, (js0, js1, jacc, jsample) = _pallas(integrator, rng, 1)
    img, (s0, s1, acc, sample) = _port(integrator, rng, 1)
    assert s0.shape == js0.shape and acc.shape == jacc.shape and sample == jsample == 1
    which = (s1, js1) if rng == "counter" else (s0, js0)  # the counter RNG advances s1
    assert_contract(jimg, img.numpy(), which[1], which[0].numpy())
    assert_contract(jacc, acc.numpy(), which[1], which[0].numpy())  # pad lanes too


@pytest.mark.parametrize("integrator,rng", CASES)
def test_plain_twin_matches_jnp(integrator, rng):
    """render(use_kernel=False) against the JAX render(use_pallas=False)."""
    from se195_raytracer_tpu.core.config import RenderConfig as JConfig
    from se195_raytracer_tpu.driver.render import render as j_render
    from se195_raytracer_tpu.scenes.registry import get_scene as j_get_scene

    spec = j_get_scene("cornell")
    cfg = JConfig(width=W, height=H, spp=2, seed=5, integrator=integrator, rng=rng)
    jimg, jst = j_render(spec.to_scene(), spec.to_camera(), cfg)
    img, st = _port(integrator, rng, 2, seed=5, use_kernel=False)
    assert st.sample == int(jst.sample) == 2
    which = (st.s1, jst.s1) if rng == "counter" else (st.s0, jst.s0)
    assert_contract(np.asarray(jimg), img.numpy(), np.asarray(which[1]), which[0].numpy())


@pytest.mark.parametrize("use_kernel", [True, False])
def test_progressive_resume(use_kernel):
    """1 + 1 spp equals 2 spp, for both the kernel state and the plain
    RenderState (test_pallas_progressive_resume's contract)."""
    img_a, st = _port("pt", "mwc", 1, seed=9, use_kernel=use_kernel)
    img_a2, st = _port("pt", "mwc", 1, seed=9, use_kernel=use_kernel, state=st)
    img_b, st_b = _port("pt", "mwc", 2, seed=9, use_kernel=use_kernel)
    np.testing.assert_allclose(img_a2.numpy(), img_b.numpy(), rtol=1e-6, atol=1e-6)
    words = slice(0, 2) if use_kernel else slice(1, 3)  # (s0, s1) in either state
    for x, y in zip(st[words], st_b[words]):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_carry_state_across_from_jax():
    """1 spp in JAX, the state carried through convert, 1 more spp in the
    port, against 2 spp in JAX."""
    from se195_raytracer_tpu.scenes.registry import get_scene as j_get_scene

    _, (s0, s1, acc, sample) = _pallas("pt", "mwc", 1)
    state = convert.pallas_state_from_numpy(s0, s1, acc, sample, device="cpu")
    spec = j_get_scene("cornell")
    scene = convert.scene_from_numpy(*(np.asarray(getattr(spec.to_scene(), f)) for f in
                                       ("center", "radius", "emission", "color", "refl")),
                                     device="cpu")
    camera = convert.camera_from_numpy(spec.camera_orig, spec.camera_target, device="cpu")
    cfg = RenderConfig(width=W, height=H, spp=1, seed=4)
    img, st = ptk.render_cuda(scene, camera, cfg, state=state, device="cpu")
    jimg2, (js0, _, jacc, jsample) = _pallas("pt", "mwc", 2)
    assert st[3] == jsample == 2
    assert_contract(jimg2, img.numpy(), js0, st[0].numpy())
    back = convert.pallas_state_to_numpy(st)
    assert back[0].dtype == np.uint32 and back[2].shape == jacc.shape and back[3] == 2


def test_render_cuda_refuses_what_it_does_not_port():
    """``complex`` (783 spheres) renders through K2's plain twin; soft edges
    belong to a later slice and are refused."""
    spec = get_scene("complex")
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=2)
    img, (s0, s1, acc, sample) = ptk.render_cuda(
        spec.to_scene("cpu"), spec.to_camera("cpu"), cfg, device="cpu")
    rp, pix, inv = ptk.ray_layout(8, 8, blocked=True)
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all()) and sample == 1
    assert s0.shape == (rp,) and acc.shape == (3, rp // ptk.LANES, ptk.LANES)
    np.testing.assert_array_equal(img.reshape(-1, 3).numpy(), acc.reshape(3, -1)[:, inv].T.numpy())
    spec = get_scene("cornell")
    with pytest.raises(NotImplementedError):
        render(spec.to_scene("cpu"), spec.to_camera("cpu"),
               RenderConfig(width=8, height=8, soft_edges=0.5), device="cpu")


# ---------------------------------------------------------------- K2 ----
_PALLAS_K2 = {}
K2_W, K2_H, K2_SEED = 32, 16, 5


def _complex_spec(jax_side):
    if jax_side:
        from se195_raytracer_tpu.scenes.generator import complex_scene
    else:
        from se195_raytracer_tpu_torch.scenes.generator import complex_scene
    return complex_scene(max_depth=3.0)  # 158 spheres


def _pallas_k2(rng, spp):
    """JAX K2 (the loop-scene kernel) in interpret mode, cached per module
    run; spp > 1 continues the cached (spp - 1) render from its state."""
    import jax.numpy as jnp

    from se195_raytracer_tpu.core.config import RenderConfig as JConfig
    from se195_raytracer_tpu.kernels.pt_kernel import render_pallas

    key = (rng, spp)
    if key not in _PALLAS_K2:
        spec = _complex_spec(True)
        cfg = JConfig(width=K2_W, height=K2_H, spp=1, seed=K2_SEED, max_depth=3, rng=rng)
        state = None
        if spp > 1:
            state = tuple(jnp.asarray(x) for x in _pallas_k2(rng, spp - 1)[1])
        img, st = render_pallas(spec.to_scene(), spec.to_camera(), cfg, state=state, interpret=True)
        _PALLAS_K2[key] = (np.asarray(img), tuple(np.asarray(x) for x in st[:3]) + (int(st[3]),))
    return _PALLAS_K2[key]


def test_block_bounds_and_layout_match_jax():
    """block_bounds (inflation included) and ray_layout bitwise equal to the
    JAX package's, for the 158- and 783-sphere fractals and three frames."""
    from se195_raytracer_tpu.kernels import pt_kernel as jptk
    from se195_raytracer_tpu.scenes.generator import complex_scene as j_complex
    from se195_raytracer_tpu_torch.scenes.generator import complex_scene

    for depth in (3.0, 4.0):
        jb = np.asarray(jptk.block_bounds(jptk.pack_scene(j_complex(max_depth=depth).to_scene())))
        pb = ptk.block_bounds(ptk.pack_scene(complex_scene(max_depth=depth).to_scene("cpu")))
        assert pb.shape == jb.shape
        np.testing.assert_array_equal(pb.numpy(), jb)
    for w, h in ((K2_W, K2_H), (512, 512), (100, 70)):
        for blocked in (False, True):
            jrp, jpix, jinv = jptk.ray_layout(w, h, jptk.DEF_SUBLANES, blocked)
            rp, pix, inv = ptk.ray_layout(w, h, blocked)
            assert rp == jrp
            np.testing.assert_array_equal(pix, jpix)
            if blocked:
                np.testing.assert_array_equal(inv, jinv)
            else:
                assert inv is None and jinv is None


@pytest.mark.parametrize("rng", ["mwc", "counter"])
def test_plain_k2_matches_pallas(rng):
    """render(use_kernel=True) on the CPU (K2's plain twin) against the JAX
    loop-scene kernel: the contract above, the image, every lane's
    accumulator, and the per-pixel RNG state through ``inv``."""
    jimg, (js0, js1, jacc, jsample) = _pallas_k2(rng, 1)
    spec = _complex_spec(False)
    cfg = RenderConfig(width=K2_W, height=K2_H, spp=1, seed=K2_SEED, max_depth=3, rng=rng)
    img, (s0, s1, acc, sample) = render(spec.to_scene("cpu"), spec.to_camera("cpu"), cfg,
                                        device="cpu")
    _, _, inv = ptk.ray_layout(K2_W, K2_H, blocked=True)
    assert s0.shape == js0.shape and acc.shape == jacc.shape and sample == jsample == 1
    which = (s1, js1) if rng == "counter" else (s0, js0)
    assert_contract(jimg, img.numpy(), which[1][inv], which[0].numpy()[inv])
    assert_contract(jacc, acc.numpy(), which[1], which[0].numpy())


def test_carry_blocked_state_across_from_jax():
    """1 spp of the JAX loop-scene kernel, its state carried through convert,
    1 more spp in the port, against the JAX kernel's own continuation."""
    from se195_raytracer_tpu_torch.scenes.generator import complex_scene

    _, (s0, s1, acc, sample) = _pallas_k2("mwc", 1)
    state = convert.pallas_state_from_numpy(s0, s1, acc, sample, device="cpu")
    spec = complex_scene(max_depth=3.0)
    cfg = RenderConfig(width=K2_W, height=K2_H, spp=1, seed=K2_SEED, max_depth=3)
    img, st = ptk.render_cuda(spec.to_scene("cpu"), spec.to_camera("cpu"), cfg, state=state,
                              device="cpu")
    jimg2, (js0, _, jacc, jsample) = _pallas_k2("mwc", 2)
    assert st[3] == jsample == 2
    _, _, inv = ptk.ray_layout(K2_W, K2_H, blocked=True)
    assert_contract(jimg2, img.numpy(), js0[inv], st[0].numpy()[inv])
    assert_contract(jacc, st[2].numpy(), js0, st[0].numpy())
    back = convert.pallas_state_to_numpy(st)
    assert back[0].shape == js0.shape and back[2].shape == jacc.shape and back[3] == 2


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
@pytest.mark.parametrize("integrator,rng", CASES)
def test_kernel_matches_plain_on_cuda(integrator, rng):
    """The CUDA kernel against its plain version on the card, same inputs."""
    spec = get_scene("cornell")
    scene, camera = spec.to_scene("cuda"), spec.to_camera("cuda")
    cfg = RenderConfig(width=64, height=32, spp=1, seed=4, integrator=integrator, rng=rng)
    scene_tab = ptk.pack_scene(scene)
    cam_tab = ptk.pack_camera(ptk.update_camera(camera, cfg.width, cfg.height))
    s0, s1, acc = ptk.init_pt_state(cfg, "cuda")
    kw = dict(num_samples=2, width=cfg.width, height=cfg.height, max_depth=cfg.max_depth,
              direct_only=integrator == "dl", light_indices=scene.light_indices, rng=rng)
    before = ptk.pt_multi_pass.launches
    k = ptk.pt_multi_pass(scene_tab, cam_tab, 0, s0, s1, acc, **kw)
    torch.cuda.synchronize()
    assert ptk.pt_multi_pass.launches == before + 1
    p = ptk.pt_pass_reference(scene_tab, cam_tab, 0, s0, s1, acc, **kw)
    which = 1 if rng == "counter" else 0
    assert_contract(p[2].cpu().numpy(), k[2].cpu().numpy(),
                    p[which].cpu().numpy(), k[which].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
@pytest.mark.parametrize("rng", ["mwc", "counter"])
def test_k2_matches_plain_on_cuda(rng):
    """K2 against its plain version on the card, same inputs, and the cull
    bitwise equal to the full sweep."""
    from se195_raytracer_tpu_torch.scenes.generator import complex_scene

    spec = complex_scene()
    scene, camera = spec.to_scene("cuda"), spec.to_camera("cuda")
    cfg = RenderConfig(width=64, height=32, spp=1, seed=4, rng=rng)
    scene_tab = ptk.pack_scene(scene)
    cam_tab = ptk.pack_camera(ptk.update_camera(camera, cfg.width, cfg.height))
    s0, s1, acc = ptk.init_pt_state(cfg, "cuda", blocked=True)
    pix = torch.from_numpy(ptk.ray_layout(cfg.width, cfg.height, True)[1]).cuda()
    kw = dict(num_samples=2, width=cfg.width, height=cfg.height, max_depth=cfg.max_depth,
              direct_only=False, light_indices=scene.light_indices, rng=rng)
    before = (ptk.pt_blocked_pass.launches, ptk.pt_multi_pass.launches)
    k = ptk.pt_multi_pass(scene_tab, cam_tab, 0, s0, s1, acc, pix, **kw)
    off = ptk.pt_blocked_pass(scene_tab, cam_tab, 0, s0, s1, acc, pix, cull=False, **kw)
    torch.cuda.synchronize()
    assert (ptk.pt_blocked_pass.launches, ptk.pt_multi_pass.launches) == (before[0] + 2, before[1])
    assert all(bool(torch.equal(a, b)) for a, b in zip(k, off))
    p = ptk.pt_pass_reference(scene_tab, cam_tab, 0, s0, s1, acc, pix, **kw)
    which = 1 if rng == "counter" else 0
    assert_contract(p[2].cpu().numpy(), k[2].cpu().numpy(),
                    p[which].cpu().numpy(), k[which].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
@pytest.mark.parametrize("integrator,rng", CASES)
def test_k1_records_bitwise_on_cuda(integrator, rng, monkeypatch):
    """K1's sweep over its float4 sphere records, unrolled, gives the bits of
    K2's blocked sweep (cull on and off) on the same lanes: the Cornell
    scene, 64x32, 3 spp, every lane's pixel its own (the identity layout);
    and 1 + 2 passes give the bits of 3. Both sweeps come from one build,
    K1's: K2 ships from csrc/pt_kernel.cu built with its sphere test and
    path geometry rounded as its plain version rounds them
    (csrc/pt_blocked_kernel.cu), otherwise than K1, and is held to its plain
    version instead."""
    monkeypatch.setattr(ptk, "_k2_lib", ptk._kernel_lib)
    spec = get_scene("cornell")
    scene, camera = spec.to_scene("cuda"), spec.to_camera("cuda")
    cfg = RenderConfig(width=64, height=32, spp=1, seed=4, integrator=integrator, rng=rng)
    scene_tab = ptk.pack_scene(scene)
    cam_tab = ptk.pack_camera(ptk.update_camera(camera, cfg.width, cfg.height))
    s0, s1, acc = ptk.init_pt_state(cfg, "cuda")
    pix = torch.arange(s0.shape[0], dtype=torch.int32, device="cuda")
    kw = dict(width=cfg.width, height=cfg.height, max_depth=cfg.max_depth,
              direct_only=integrator == "dl", light_indices=scene.light_indices, rng=rng)
    k1 = ptk.pt_multi_pass(scene_tab, cam_tab, 0, s0, s1, acc, num_samples=3, **kw)
    for cull in (True, False):
        k2 = ptk.pt_blocked_pass(scene_tab, cam_tab, 0, s0, s1, acc, pix, num_samples=3,
                                 cull=cull, **kw)
        assert all(bool(torch.equal(a, b)) for a, b in zip(k1, k2)), cull
    a = ptk.pt_multi_pass(scene_tab, cam_tab, 0, s0, s1, acc, num_samples=1, **kw)
    a = ptk.pt_multi_pass(scene_tab, cam_tab, 1, *a, num_samples=2, **kw)
    assert all(bool(torch.equal(x, y)) for x, y in zip(a[:2], k1[:2]))


# ------------------------------------------------- K2's bounds and cull ----
def _bound_sets(scene_tab):
    """{level: (bounds [4, k], sphere index sets [k, s])} of K2's sweep."""
    n = scene_tab.shape[1]
    nb = n // ptk.SPHERE_BLOCK
    m = nb * ptk.SPHERE_BLOCK
    half = ptk.SPHERE_BLOCK // 2
    size = ptk.GROUP_BLOCKS * ptk.SPHERE_BLOCK
    ng = (nb + ptk.GROUP_BLOCKS - 1) // ptk.GROUP_BLOCKS
    groups = torch.clamp(torch.arange(ng)[:, None] * size + torch.arange(size)[None], max=m - 1)
    return {
        "half": (ptk.half_bounds(scene_tab), torch.arange(m).reshape(2 * nb, half)),
        "block": (ptk.block_bounds(scene_tab), torch.arange(m).reshape(nb, ptk.SPHERE_BLOCK)),
        "group": (ptk.group_bounds(scene_tab), groups),
        "remainder": (ptk.remainder_bound(scene_tab), torch.arange(m, n)[None]),
    }


@pytest.mark.parametrize("level", ["half", "block", "group", "remainder"])
def test_k2_bounds_hold_their_spheres(level):
    """Every bound of K2's sweep holds every sphere of its set with the
    inflation (x1.001 + 0.01) to spare, and is made the same way twice."""
    from se195_raytracer_tpu_torch.scenes.generator import complex_scene

    for depth in (3.0, 4.0):  # 158 and 783 spheres
        tab = ptk.pack_scene(complex_scene(max_depth=depth).to_scene("cpu"))
        bounds, idx = _bound_sets(tab)[level]
        again, _ = _bound_sets(tab)[level]
        np.testing.assert_array_equal(bounds.numpy(), again.numpy())
        c = tab[0:3].T[idx]  # [k, s, 3]
        reach = torch.linalg.norm(c - bounds[:3].T[:, None, :], dim=-1) + tab[3][idx]
        radius = bounds[3][:, None]
        assert bool((reach <= (radius - 0.01) / 1.001 * (1 + 1e-6)).all()), level
        assert bool((reach + 0.01 <= radius).all()), level


@pytest.mark.parametrize("placement", ["as_built", "far"])
@pytest.mark.parametrize("level", ["half", "block", "group", "remainder"])
def test_k2_distance_cull_is_exact(level, placement):
    """On every sweep of a small complex render, K2's predicate (the ray
    misses the bound, or enters it beyond the running best t of the
    descending sweep, or at max_t or beyond for a shadow ray) never skips a
    set that holds a sphere the sweep would take: a hit closer than the
    best t before the set, or an occluder closer than max_t. ``far`` scales
    the scene and the camera's position 10x and moves them 1000 along each
    axis: the rounding of a sphere's t and of a bound's entry grows with the
    distance, which the widening of the bound (CULL_REACH) must cover. Its
    seed sends shadow rays from ~1.4e5 out on the ground sphere, where the
    bound without the widening enters ~50 beyond a sphere's computed hit
    and skips an occluder."""
    from se195_raytracer_tpu_torch.core.types import Scene
    from se195_raytracer_tpu_torch.ops.intersect import sphere_intersect

    spec = get_scene("complex")
    cfg = RenderConfig(width=24, height=16, spp=1, seed=K2_SEED if placement == "as_built" else 7)
    scene = spec.to_scene("cpu")
    tab = ptk.pack_scene(scene)
    cam = ptk.pack_camera(ptk.update_camera(spec.to_camera("cpu"), cfg.width, cfg.height))
    if placement == "far":
        tab, cam = tab.clone(), cam.reshape(12).clone()
        tab[0:4] *= 10.0
        tab[0:3] += 1000.0
        cam[0:3] = cam[0:3] * 10.0 + 1000.0
    bounds, idx = _bound_sets(tab)[level]
    plain = Scene(center=tab[0:3].T, radius=tab[3], emission=tab[4:7].T, color=tab[7:10].T,
                  refl=tab[10])
    checked = {"nearest": 0, "shadow": 0, "skipped": 0, "slack": float("inf")}

    def hook(o, d, mask, max_t):
        o, d = o[mask], d[mask]
        meets, entry = ptk.bound_entry(bounds, o, d)
        t = sphere_intersect(plain, o, d)
        tm = torch.where(t != 0.0, t, float("inf"))
        set_min = tm[:, idx].amin(dim=2)  # [R, k]: the set's nearest hit
        # Where the ray hits a sphere of the set, it enters the widened,
        # inflated bound at least half the inflation's 0.01 before: rounding
        # is far smaller.
        hit = torch.isfinite(set_min)
        assert bool((meets | ~hit).all()), level
        slack = torch.where(hit, set_min - entry, float("inf"))
        checked["slack"] = min(checked["slack"], float(slack.min()))
        assert checked["slack"] >= 0.005, (level, placement, checked["slack"])
        if max_t is None:
            # The sweep runs in descending sphere order: the best t before a
            # set is the minimum over the spheres above its highest one.
            top = idx.amax(dim=1)
            above = torch.stack([tm[:, j + 1:].amin(dim=1) if j + 1 < tm.shape[1] else
                                 torch.full((tm.shape[0],), float("inf")) for j in top.tolist()], 1)
            skipped = ~meets | (entry > above)
            assert not bool((skipped & (set_min < above)).any()), level
            checked["nearest"] += o.shape[0]
        else:
            mt = max_t[mask][:, None]
            skipped = ~meets | (entry >= mt)
            assert not bool((skipped & (set_min < mt)).any()), level
            checked["shadow"] += o.shape[0]
        checked["skipped"] += int(skipped.sum())

    s0, s1, acc = ptk.init_pt_state(cfg, "cpu", blocked=True)
    pix = torch.from_numpy(ptk.ray_layout(cfg.width, cfg.height, True)[1])
    ptk.pt_pass_reference(tab, cam, 0, s0, s1, acc, pix, num_samples=1, width=cfg.width,
                          height=cfg.height, max_depth=cfg.max_depth, direct_only=False,
                          light_indices=scene.light_indices, on_sweep=hook)
    assert checked["nearest"] > 0 and checked["shadow"] > 0 and checked["skipped"] > 0


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
@pytest.mark.parametrize("integrator,max_depth", [("pt", 1), ("pt", 7), ("dl", 7)])
def test_k2_cull_bitwise_on_cuda(integrator, max_depth):
    """K2's groups, half blocks, remainder bound and distance cull, and its
    one loop over all passes' bounces, give the bits of the full sweep, and
    K1's contract against the plain version, at 64x32 and 3 spp."""
    from se195_raytracer_tpu_torch.scenes.generator import complex_scene

    spec = complex_scene()
    scene, camera = spec.to_scene("cuda"), spec.to_camera("cuda")
    cfg = RenderConfig(width=64, height=32, spp=1, seed=6, integrator=integrator)
    scene_tab = ptk.pack_scene(scene)
    cam_tab = ptk.pack_camera(ptk.update_camera(camera, cfg.width, cfg.height))
    s0, s1, acc = ptk.init_pt_state(cfg, "cuda", blocked=True)
    pix = torch.from_numpy(ptk.ray_layout(cfg.width, cfg.height, True)[1]).cuda()
    kw = dict(num_samples=3, width=cfg.width, height=cfg.height, max_depth=max_depth,
              direct_only=integrator == "dl", light_indices=scene.light_indices)
    on = ptk.pt_blocked_pass(scene_tab, cam_tab, 0, s0, s1, acc, pix, **kw)
    off = ptk.pt_blocked_pass(scene_tab, cam_tab, 0, s0, s1, acc, pix, cull=False, **kw)
    torch.cuda.synchronize()
    assert all(bool(torch.equal(a, b)) for a, b in zip(on, off))
    p = ptk.pt_pass_reference(scene_tab, cam_tab, 0, s0, s1, acc, pix, **kw)
    assert_contract(p[2].cpu().numpy(), on[2].cpu().numpy(), p[0].cpu().numpy(),
                    on[0].cpu().numpy())

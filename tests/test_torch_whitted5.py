"""The raytracer5 ("whitted5") tracer of the port (TGA loader, scenes, plain
tracer and renderers, K4's and K5's plain versions) against the JAX package
on the CPU.

The JAX side is the jnp tracer run op by op (``jax.disable_jit``), never a
Pallas kernel in interpret mode; the JAX package's own tests hold its Pallas
kernels to that tracer (tests/test_whitted5_kernel.py). Every JAX result is
computed once per module, at one frame shape (32x24), so the op-by-op
compiles are paid once (and the depths are cut, see DEPTH below).

Tolerances and their reasons:
- scene arrays, ``pack_whitted5_scene``, ``BOX_LIGHT_GRID``, camera rays,
  RNG state and the TGA loader: bitwise (the same numpy or float32
  operations in the same order);
- ``find_nearest``: indices and codes equal, distances within 1e-6 relative;
- ``_texel``, ``get_color`` and K5's plain version: bitwise (the same gather
  and blend order);
- the tracer and the renderers: equal RNG counters and edge fractions, and
  the colour under the contract of tests/test_whitted5_kernel.py:18-25 (p99
  of |diff| < 1e-4, max < 3e-3): x^20 is a multiply chain here and
  ``jnp.power`` there, and torch's and XLA's acos/cos/sin/exp differ by
  ulps, which at a shadow sample or texel boundary can move one lane. The
  deterministic scene (no Monte-Carlo visibility) within rtol and atol 1e-5.

The JAX package is imported inside the tests that use it, so that the
``cuda`` tests run on a GPU machine without JAX:
``python -m pytest tests/test_torch_whitted5.py --noconftest -m cuda``."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from se195_raytracer_tpu_torch import convert
from se195_raytracer_tpu_torch.io.tga import load_tga, write_tga
from se195_raytracer_tpu_torch.kernels import texel_kernel as tk
from se195_raytracer_tpu_torch.kernels import whitted5_kernel as wk
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


W, H = 32, 24
MOVED = dict(pos=(0.5, 0.3, -0.5), target=(0.0, -0.5, 6.0))
# The op-by-op JAX compiles cost ~6 s per tree level. The explicit-ray
# trace runs to depth 3, which already has every kind of node (glossy
# levels 1-2, the non-glossy level 3, refraction, the leaves); the renders
# run to depth 2: what they add (passes, sub-pixel rays, select, blend)
# does not depend on the depth. K4 against the plain tracer at the default
# depth 4 is chip_smoke.py's.
DEPTH = 3
RENDER_DEPTH = 2


def _robust_close(a, b, tag, p99=1e-4, mx=3e-3):
    a, b = np.asarray(a), np.asarray(b)
    assert np.isfinite(a).all(), f"{tag}: non-finite"
    d = np.abs(a - b)
    assert float(np.percentile(d, 99)) < p99, f"{tag}: p99 {np.percentile(d, 99):.2e}"
    assert float(d.max()) < mx, f"{tag}: max {d.max():.2e}"


def _det_rows(mod):
    """The deterministic scene of tests/test_whitted5_kernel.py:76-81 (a
    sphere light, a mirror, a refractive sphere; no Monte-Carlo)."""
    b5 = mod.Whitted5Builder()
    b5.plane((0.0, 1.0, 0.0), 4.4, color=(0.4, 0.3, 0.3), diff=1.0, spec=0.4)
    b5.sphere((1.0, -0.8, 3.0), 2.5, color=(0.7, 0.7, 1.0), refl=0.4, diff=0.2)
    b5.sphere((-2.0, 0.5, 6.0), 1.5, color=(1.0, 0.4, 0.4), refr=0.8, refr_index=1.3, diff=0.1)
    b5.sphere((0.0, 5.0, 5.0), 0.1, color=(0.6, 0.6, 0.6), is_light=True)
    return b5


def _u8_textures():
    """Two u8/256 textures (the reference's TGA texels), from a numpy seed."""
    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, size=(32, 32, 3)).astype(np.float32) / 256.0 for _ in range(2)]


def _scenes(kind):
    """(JAX scene, port scene) of one kind."""
    from se195_raytracer_tpu.scenes import whitted5_scenes as JS

    if kind == "room5":
        return JS.room5_scene("procedural"), S.room5_scene("procedural", device="cpu")
    if kind == "det":
        return _det_rows(JS).build(), _det_rows(S).build("cpu")
    # room5's primitives with other textures: "u8" two same-shaped u8/256
    # textures (atlas mode), "mixed" two shapes (one fetch per texture).
    texs = _u8_textures() if kind == "u8" else [S.checker_texture(48, 6), S.marble_texture(64)]
    out = []
    for mod, dev in ((JS, None), (S, "cpu")):
        b = mod.Whitted5Builder()
        ids = [b.add_texture(t) for t in texs]
        b.plane((0, 1, 0), 4.4, diff=1.0, spec=0.5, color=(0.7, 0.7, 0.7), tex=ids[0],
                uv_scale=(0.45, 0.45))
        b.sphere((0, -0.8, 7), 2.0, refl=0.05, refr_index=1.3, diff=0.5, spec=0.8,
                 color=(2.7, 2.7, 3.0), tex=ids[1], uv_scale=(0.8, 0.8))
        b.box((-1, 5.0, 4), (2, 0.1, 2), is_light=True, color=(0.5, 0.5, 0.5))
        b.plane((0, 0, -1), 10.4, diff=1.7, color=(0.4, 0.3, 0.3))
        out.append(b.build() if dev is None else b.build(dev))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _jax_results():
    """Every JAX frame of this module, computed op by op, once."""
    import jax

    from se195_raytracer_tpu.models import whitted5 as J

    js, _ = _scenes("room5")
    jdet, _ = _scenes("det")
    jo, jd = J.camera_rays5(W, H, **MOVED)
    key, ctr = J._init_state5_np(W * H, 5)
    res = {}
    with jax.disable_jit():
        col, st = J.whitted5_trace(js, jo, jd, (key, ctr), DEPTH)
        res["trace"] = (np.asarray(col), np.asarray(st[0]), np.asarray(st[1]))
        res["nearest_moved"] = np.asarray(J.find_nearest(js, jo, jd)[0])
        res["spp2"] = np.asarray(J.render_whitted5(js, W, H, spp=2, trace_depth=RENDER_DEPTH,
                                                   seed=3))
        res["4ray"] = np.asarray(J.render_whitted5_4ray(js, W, H, trace_depth=RENDER_DEPTH,
                                                        seed=3))
        img, frac = J.render_whitted5_adaptive(js, W, H, trace_depth=RENDER_DEPTH, seed=3,
                                               min_bucket=W * H, compaction="host")
        res["adaptive"] = (np.asarray(img), frac)
        res["det"] = np.asarray(J.render_whitted5(jdet, W, H, spp=1, trace_depth=RENDER_DEPTH,
                                                  seed=0))
    return res


def _moved_inputs():
    o, d = P.camera_rays5(W, H, **MOVED)
    key, ctr = P._init_state5_np(W * H, 5)
    return (torch.from_numpy(o), torch.from_numpy(d),
            (torch.from_numpy(key.astype(np.int64)), torch.from_numpy(ctr.astype(np.int64))))


@pytest.mark.parametrize("kind", ["room5", "det", "u8"])
def test_scene_tables_match_jax(kind):
    from se195_raytracer_tpu.kernels.whitted5_kernel import pack_whitted5_scene as j_pack
    from se195_raytracer_tpu.scenes.whitted5_scenes import BOX_LIGHT_GRID as J_GRID

    js, ps = _scenes(kind)
    for f in S.FIELDS:
        np.testing.assert_array_equal(getattr(ps, f).numpy(), np.asarray(getattr(js, f)),
                                      err_msg=f)
    assert len(ps.textures) == len(js.textures)
    for a, b in zip(ps.textures, js.textures):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (ps.ptype, ps.is_light, ps.tex_id) == (js.ptype, js.is_light, js.tex_id)
    np.testing.assert_array_equal(wk.pack_whitted5_scene(ps).numpy(), np.asarray(j_pack(js)))
    np.testing.assert_array_equal(S.BOX_LIGHT_GRID, J_GRID)


@pytest.mark.parametrize("moved", [False, True])
def test_camera_rays_and_state_match_jax(moved):
    from se195_raytracer_tpu.models import whitted5 as J

    kw = MOVED if moved else {}
    for a, b in zip(P.camera_frame5(W, H, **kw), J.camera_frame5(W, H, **kw)):
        np.testing.assert_array_equal(a, b)
    for sub in ((0.5, 0.5), (0.0, 0.0), (-0.5, -0.5)):
        o, d = P.camera_rays5(W, H, sub=sub, **kw)
        jo, jd = J.camera_rays5(W, H, sub=sub, **kw)
        np.testing.assert_array_equal(o, np.asarray(jo))
        np.testing.assert_array_equal(d, np.asarray(jd))
    for seed in (0, 7):
        for a, b in zip(P._init_state5_np(W * H, seed), J._init_state5_np(W * H, seed)):
            np.testing.assert_array_equal(a, np.asarray(b))
    key, ctr = P._state5(W * H, 7, "cpu")
    np.testing.assert_array_equal(key.numpy(), np.asarray(J._init_state5_np(W * H, 7)[0]))
    assert key.dtype == torch.uint32 and not ctr.any()


def test_load_tga_matches_jax(tmp_path):
    from se195_raytracer_tpu.io.tga import load_tga as j_load

    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, size=(5, 7, 3)).astype(np.uint8)
    path = str(tmp_path / "t.tga")
    write_tga(path, img)
    ours = load_tga(path)
    np.testing.assert_array_equal(ours, j_load(path))
    np.testing.assert_array_equal(ours, img.astype(np.float32) / 256.0)
    with open(path, "r+b") as f:  # truncate: both loaders refuse
        f.truncate(40)
    with pytest.raises(ValueError, match="expected"):
        load_tga(path)


def test_room5_real_textures_from_tga(tmp_path, monkeypatch):
    """textures='real' reads the reference's checker and marble TGA files from
    the named directory through io/tga; 'auto' takes them when it exists."""
    rng = np.random.default_rng(4)
    texs = {}
    for name in ("checker", "marble"):
        texs[name] = rng.integers(0, 256, size=(20, 20, 3)).astype(np.uint8)
        write_tga(str(tmp_path / f"{name}.tga"), texs[name])
    real = S.room5_scene("real", device="cpu", textures_dir=str(tmp_path))
    for t, name in zip(real.textures, ("checker", "marble")):
        np.testing.assert_array_equal(t.numpy(), texs[name].astype(np.float32) / 256.0)
    monkeypatch.setenv(S.REF_TEXTURES_ENV, str(tmp_path))
    auto = S.room5_scene(device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(auto.textures, real.textures))
    monkeypatch.delenv(S.REF_TEXTURES_ENV)
    assert S.room5_scene(device="cpu").textures[0].shape == (64, 64, 3)


def test_find_nearest_matches_jax():
    """Random rays from inside and around the room, against room5."""
    import jax.numpy as jnp

    from se195_raytracer_tpu.models import whitted5 as J

    js, ps = _scenes("room5")
    rng = np.random.default_rng(5)
    o = rng.uniform(-8.0, 8.0, size=(W * H, 3)).astype(np.float32)
    d = rng.normal(size=(W * H, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    idx, code, dist = P.find_nearest(ps, torch.from_numpy(o), torch.from_numpy(d))
    jidx, jcode, jdist = J.find_nearest(js, jnp.asarray(o), jnp.asarray(d))
    assert (idx.numpy() >= 0).mean() > 0.5
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(code.numpy(), np.asarray(jcode))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=1e-6)


def _uv_lanes(n, seed):
    """Random texture coordinates; 1% far negative (a floor modulo, not C's
    truncating %, keeps them inside the texture)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-3.0, 3.0, n).astype(np.float32)
    v = rng.uniform(-3.0, 3.0, n).astype(np.float32)
    far = rng.random(n) < 0.01
    u[far] = rng.uniform(-5000.0, -1001.0, far.sum()).astype(np.float32)
    v[far[::-1]] = rng.uniform(-5000.0, -1001.0, far.sum()).astype(np.float32)
    return u, v


@pytest.mark.parametrize("kind", ["u8", "room5"])
def test_texel_matches_jax(kind):
    """_texel in atlas mode (two textures, the second row-offset) and per
    texture, bitwise; K5's plain version gives the same values."""
    import jax.numpy as jnp

    from se195_raytracer_tpu.models import whitted5 as J

    js, ps = _scenes(kind)
    n = W * H
    u, v = _uv_lanes(n, 6)
    tex = (np.arange(n) % 2).astype(np.int32)
    th, tw = ps.textures[0].shape[:2]
    atlas = torch.cat(list(ps.textures))
    ours = P._texel(atlas, torch.from_numpy(u), torch.from_numpy(v),
                    row_offset=torch.from_numpy(tex * th), wrap_shape=(th, tw))
    theirs = J._texel(jnp.concatenate(list(js.textures)), jnp.asarray(u), jnp.asarray(v),
                      row_offset=jnp.asarray(tex * th), wrap_shape=(th, tw))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    one = P._texel(ps.textures[1], torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_array_equal(one.numpy(), np.asarray(J._texel(js.textures[1], u, v)))
    flat, textab = tk.pack_texel_atlas(ps.textures)
    live = torch.ones(n, dtype=torch.bool)
    k5 = tk.texel_fetch_cuda(flat, textab, torch.from_numpy(tex), torch.from_numpy(u),
                             torch.from_numpy(v), live)
    assert tk.texel_fetch_cuda.launches == 0  # CPU tensors: the plain version
    np.testing.assert_array_equal(k5.numpy(), ours.numpy().T)


@pytest.mark.parametrize("kind", ["room5", "u8", "mixed"])
def test_get_color_matches_jax(kind):
    """get_color on random lanes of every primitive, bitwise: atlas mode
    (room5, u8) and one fetch per texture of another shape (mixed)."""
    import jax.numpy as jnp

    from se195_raytracer_tpu.models import whitted5 as J

    js, ps = _scenes(kind)
    rng = np.random.default_rng(8)
    idx = rng.integers(0, ps.num_prims, W * H)
    point = rng.uniform(-6.0, 6.0, size=(W * H, 3)).astype(np.float32)
    point[::50] *= 400.0  # far plane hits: u + 1000.5 < 0
    ours = P.get_color(ps, torch.from_numpy(idx), torch.from_numpy(point))
    theirs = J.get_color(js, jnp.asarray(idx.astype(np.int32)), jnp.asarray(point))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    normals = P.get_normal(ps, torch.from_numpy(idx), torch.from_numpy(point))
    jn = J.get_normal(js, jnp.asarray(idx.astype(np.int32)), jnp.asarray(point))
    np.testing.assert_array_equal(normals.numpy(), np.asarray(jn))


def test_whitted5_trace_matches_jax():
    """The tree on explicit rays (a moved camera, seed 5): the same streams
    (counters equal), the colour under the robust contract, and the level-1
    hit ids of ``return_primary_idx`` equal to JAX's find_nearest."""
    _, ps = _scenes("room5")
    o, d, state = _moved_inputs()
    col, st, idx = P.whitted5_trace(ps, o, d, state, DEPTH, return_primary_idx=True)
    jcol, jkey, jctr = _jax_results()["trace"]
    assert jcol.max() > 0.1
    _robust_close(col.numpy(), jcol, "whitted5_trace")
    np.testing.assert_array_equal(st[0].numpy(), jkey.astype(np.int64))
    np.testing.assert_array_equal(st[1].numpy(), jctr.astype(np.int64))
    assert int(st[1][0]) == P.PASS_DRAW_BUDGET
    np.testing.assert_array_equal(idx.numpy(), _jax_results()["nearest_moved"])


def test_kernel_wrapper_on_cpu_is_the_plain_version():
    """K4's wrapper on CPU tensors: ``trace_passes`` bitwise, for shared and
    per-pass rays, mean and sum; no launch counted."""
    _, ps = _scenes("room5")
    o, d, state = _moved_inputs()
    before = wk.whitted5_trace_cuda.launches
    a = wk.whitted5_trace_cuda(ps, o, d, state, spp=2, return_primary_idx=True)
    b = P.trace_passes(ps, o, d, state, spp=2, return_primary_idx=True)
    for x, y in zip((a[0], a[1][0], a[1][1], a[2]), (b[0], b[1][0], b[1][1], b[2])):
        assert torch.equal(x, y)
    assert int(a[1][1][0]) == 2 * P.PASS_DRAW_BUDGET
    o2, d2 = torch.stack([o, o.flip(0)]), torch.stack([d, d.flip(0)])
    s, _ = wk.whitted5_trace_cuda(ps, o2, d2, state, spp=2, mean=False)
    p0, st = P.whitted5_trace(ps, o, d, state)
    p1, _ = P.whitted5_trace(ps, o.flip(0), d.flip(0), st)
    assert torch.equal(s, p0 + p1)
    assert wk.whitted5_trace_cuda.launches == before
    with pytest.raises(ValueError, match="need"):
        wk.whitted5_trace_cuda(ps, o2, d2, state, spp=3)


def test_render_whitted5_matches_jax():
    """render_whitted5 at spp 2, seed 3, through K4's plain version and the
    plain passes (bitwise equal), against JAX's jnp render."""
    _, ps = _scenes("room5")
    img = P.render_whitted5(ps, W, H, spp=2, trace_depth=RENDER_DEPTH, seed=3, device="cpu")
    plain = P.render_whitted5(ps, W, H, spp=2, trace_depth=RENDER_DEPTH, seed=3, device="cpu",
                              use_kernel=False)
    assert img.shape == (H, W, 3) and torch.equal(img, plain)
    _robust_close(img.numpy(), _jax_results()["spp2"], "render spp2")


def test_render_4ray_matches_jax():
    _, ps = _scenes("room5")
    img = P.render_whitted5_4ray(ps, W, H, trace_depth=RENDER_DEPTH, seed=3, device="cpu")
    _robust_close(img.numpy(), _jax_results()["4ray"], "4ray")


def test_render_adaptive_matches_jax():
    """render_whitted5_adaptive against JAX's exact host-compaction path: the
    same edge fraction, the frame under the robust contract. Its edge pixels
    are the 4-ray frame's (same rays, same streams, summed in another order);
    the others the 1-ray primary."""
    _, ps = _scenes("room5")
    img, frac = P.render_whitted5_adaptive(ps, W, H, trace_depth=RENDER_DEPTH, seed=3,
                                           device="cpu")
    jimg, jfrac = _jax_results()["adaptive"]
    assert frac == jfrac and 0.0 < frac < 0.5
    _robust_close(img.numpy(), jimg, "adaptive")
    four = P.render_whitted5_4ray(ps, W, H, trace_depth=RENDER_DEPTH, seed=3, device="cpu")
    o, d = P._cached_rays5(W, H, (0.0, 0.0), "cpu")
    idx = P.find_nearest(ps, o, d)[0]
    edge = (idx != torch.cat([torch.tensor([-1]), idx[:-1]])).reshape(H, W)
    assert frac == edge.double().mean().item()
    # (c0 + (c1 + c2 + c3)) x 0.25 against (c0 + c1 + c2 + c3) x 0.25
    torch.testing.assert_close(img[edge], four[edge], rtol=1e-6, atol=1e-7)
    primary = P.trace_passes(ps, o, d, P._state5(W * H, 3, "cpu"),
                             trace_depth=RENDER_DEPTH)[0].reshape(H, W, 3)
    assert torch.equal(img[~edge], primary[~edge])


def test_adaptive_bucket_overflow_keeps_one_ray():
    """Edges past the bucket keep their primary sample; the first ``bucket``
    edges in scan order get the 4-ray blend."""
    _, ps = _scenes("room5")
    full, frac = P.render_whitted5_adaptive(ps, W, H, seed=3, device="cpu")
    small, frac2 = P.render_whitted5_adaptive(ps, W, H, seed=3, min_bucket=8, device="cpu")
    assert frac == frac2 and P.adaptive_bucket(W, H, 8) == 16
    o, d = P._cached_rays5(W, H, (0.0, 0.0), "cpu")
    state = P._state5(W * H, 3, "cpu")
    col0, _, idx = P.trace_passes(ps, o, d, state, return_primary_idx=True)
    edge = idx != torch.cat([torch.tensor([-1]), idx[:-1]])
    rank = torch.cumsum(edge.long(), 0) - 1
    used = edge & (rank < 16)
    flat, flat_full = small.reshape(-1, 3), full.reshape(-1, 3)
    assert torch.equal(flat[used], flat_full[used])
    assert torch.equal(flat[~used], col0[~used])


def test_deterministic_scene_matches_jax():
    _, ps = _scenes("det")
    img = P.render_whitted5(ps, W, H, spp=1, trace_depth=RENDER_DEPTH, seed=0, device="cpu")
    jimg = _jax_results()["det"]
    assert jimg.max() > 0.1
    np.testing.assert_allclose(img.numpy(), jimg, rtol=1e-5, atol=1e-5)


def test_convert_round_trip():
    """A JAX scene and state carry across as numpy and back, bitwise."""
    from se195_raytracer_tpu.models import whitted5 as J

    js, ps = _scenes("room5")
    fields = {f: np.asarray(getattr(js, f)) for f in convert.WHITTED5_FIELDS}
    scene = convert.whitted5_scene_from_numpy(fields, [np.asarray(t) for t in js.textures],
                                              js.ptype, js.is_light, js.tex_id, device="cpu")
    np.testing.assert_array_equal(wk.pack_whitted5_scene(scene).numpy(),
                                  wk.pack_whitted5_scene(ps).numpy())
    back = convert.whitted5_scene_to_numpy(scene)
    for f in convert.WHITTED5_FIELDS:
        np.testing.assert_array_equal(back[0][f], fields[f])
    assert back[2:] == (js.ptype, js.is_light, js.tex_id)
    key, ctr = J._init_state5_np(W * H, 9)
    ctr = ctr + np.uint32(3 * P.PASS_DRAW_BUDGET)
    state = convert.whitted5_state_from_numpy(np.asarray(key), np.asarray(ctr), device="cpu")
    for a, b in zip(convert.whitted5_state_to_numpy(state), (key, ctr)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_refusals():
    """soft_edges > 0 with the kernel raises (K4 is the hard estimator; the
    plain tracer renders the relaxed one); the kernel holds at most depth 5."""
    _, ps = _scenes("room5")
    with pytest.raises(NotImplementedError, match="soft_edges"):
        P.render_whitted5(ps, 4, 4, soft_edges=0.5, device="cpu")
    assert wk.MAX_TRACE_DEPTH == 5
    assert P.samples_per_level(4) == (2, 1, 1, 1)  # level l takes entry min(l, 3)


# ------------------------------------------- K4's shadow test and prefilter ----
def _far(scene):
    """``scene`` scaled 10x and moved 1000 along each axis: the rounding of
    a slab distance and of a hit point grows with the coordinates."""
    n = scene.normal
    return dataclasses.replace(
        scene, center=scene.center * 10.0 + 1000.0, radius=scene.radius * 10.0,
        depth=scene.depth * 10.0 - 1000.0 * (n[:, 0] + n[:, 1] + n[:, 2]),
        box_pos=scene.box_pos * 10.0 + 1000.0, box_size=scene.box_size * 10.0)


def _tie_scenes():
    """Two scenes in which a copy of the light, a box light and a sphere
    light each, sits at index 0 (before the light) or 2 (after it): every
    shadow ray meets the copy at exactly the light's distance."""
    out = []
    for light_at in (0, 1):
        b = S.Whitted5Builder()
        for slot in range(3):
            lit = slot == light_at
            if slot == 2:
                b.plane((0, 1, 0), 4.4, diff=1.0)
            else:
                b.box((-1, 5.0, 4), (2, 0.1, 2), is_light=lit, color=(0.5, 0.5, 0.5))
        b.sphere((10.0, 0.0, -5.0), 0.5, is_light=True, color=(0.6, 0.6, 0.6))
        b.sphere((10.0, 0.0, -5.0), 0.5)
        out.append(b.build("cpu"))
    return out


def _shadow_rays(scene, target, n=512, seed=12):
    """Shadow rays from the floor of room5 to points of light ``target``
    (its box's bottom face or its sphere's center), origins offset by
    EPSILON along the ray, as CalcShade makes them."""
    rng = np.random.default_rng(seed)
    p = np.stack([rng.uniform(-6, 6, n), np.full(n, -4.4), rng.uniform(0, 10, n)], 1)
    if scene.ptype[target] == S.BOX5:
        pos, size = scene.box_pos[target].numpy(), scene.box_size[target].numpy()
        g = pos + rng.uniform(0, 1, (n, 3)) * size
        g[:, 1] = pos[1]
    else:
        g = np.broadcast_to(scene.center[target].numpy(), (n, 3))
    p, g = torch.from_numpy(p.astype(np.float32)), torch.from_numpy(g.astype(np.float32))
    v = g - p
    dist = torch.sqrt((v * v).sum(1))
    d = v / dist[:, None]
    return p + d * P._EPS, d, dist


def test_k4_shadow_test_matches_nearest_is():
    """K4's target-first shadow test (its torch mirror, ``shadow_visible``)
    equals CalcShade's ``_nearest_is`` on every shadow ray of a small room5
    trace, and where another primitive ties the light's distance before or
    after it in index order."""
    scene = S.room5_scene("procedural", device="cpu")
    o, d = P._cached_rays5(24, 18, (0.0, 0.0), "cpu")
    seen = {"rays": 0, "lit": 0}

    def hook(o_, d_, mask, max_t, target):
        if max_t is None:
            return
        o_, d_, mt = o_[mask], d_[mask], max_t[mask]
        vis = wk.shadow_visible(scene, o_, d_, mt, target)
        assert torch.equal(vis, P._nearest_is(scene, o_, d_, mt, target))
        seen["rays"] += o_.shape[0]
        seen["lit"] += int(vis.sum())

    P.trace_passes(scene, o, d, P._state5(24 * 18, 3, "cpu"), trace_depth=3,
                   on_sweep=hook)
    assert seen["rays"] > 1000 and 0 < seen["lit"] < seen["rays"]
    for tie, light_at in zip(_tie_scenes(), (0, 1)):
        for target in (light_at, 3):
            o_, d_, dist = _shadow_rays(tie, target)
            copy = {0: 1, 1: 0, 3: 4}[target]
            dj, _, valid = P._prim_candidates(tie, o_, d_)
            tied = valid[:, copy] & (dj[:, copy] == dj[:, target])
            assert bool(tied.all())
            vis = wk.shadow_visible(tie, o_, d_, dist + 1.0, target)
            assert torch.equal(vis, P._nearest_is(tie, o_, d_, dist + 1.0, target))
            # The first minimum takes the lower index of a tie.
            assert bool((vis == (target < copy)).all()), (light_at, target)


def _box_slack(scene, o, d, margin):
    """Slack of every valid box candidate of rays (o, d) inside K4's
    prefilter interval (negative: outside it, a hit the prefilter loses)."""
    boxes, _ = wk.box_records(scene)
    dist, _, valid = P._prim_candidates(scene, o, d)
    lo_t, hi_t = wk.box_slab_bounds(scene, o, d, margin)
    bd, bv = dist[:, list(boxes)], valid[:, list(boxes)]
    return torch.minimum(bd - lo_t, hi_t - bd)[bv]


def _nearest_wrong(scene, o, d, margin):
    """Rays whose hit the mirror's nearest sweep gets other than
    ``find_nearest``."""
    best, amin, _ = wk.nearest_keeps(scene, o, d, margin)
    idx, _, ref = P.find_nearest(scene, o, d)
    return int(((idx >= 0) & ((amin != idx) | (best != ref))).sum())


def _check_sweeps(scene, o, d, margin):
    """Every nearest sweep and shadow ray of a room5 trace from rays (o, d)
    against K4's box prefilter: (least slack of a valid box candidate inside
    its interval, valid box candidates outside it, sweeps whose result the
    mirror's nearest sweep or shadow test gets wrong, sweeps)."""
    stats = dict(slack=float("inf"), outside=0, wrong=0, sweeps=0, axis=0)

    def hook(o_, d_, mask, max_t, target):
        o_, d_ = o_[mask], d_[mask]
        slack = _box_slack(scene, o_, d_, margin)
        if slack.numel():
            stats["slack"] = min(stats["slack"], float(slack.min()))
        stats["outside"] += int((slack < 0).sum())
        stats["sweeps"] += o_.shape[0]
        stats["axis"] += int((d_ == 0).any(dim=1).sum())
        if max_t is None:
            stats["wrong"] += _nearest_wrong(scene, o_, d_, margin)
        else:
            vis = wk.shadow_visible(scene, o_, d_, max_t[mask], target, margin)
            stats["wrong"] += int((vis != P._nearest_is(scene, o_, d_, max_t[mask],
                                                         target)).sum())

    P.trace_passes(scene, o, d, P._state5(o.shape[0], 3, "cpu"), trace_depth=3,
                   on_sweep=hook)
    return stats


def _edge_rays(scene, back, n=1000, seed=5):
    """For each box, ``n`` rays in random directions that pass within about
    2 EPSILON of one of its edges, starting ``back`` before that point:
    grazing hits, where the slab interval is thinnest."""
    rng = np.random.default_rng(seed)
    _, rec = wk.box_records(scene)
    os_, ds = [], []
    for v1, v2 in rec[:, :2].numpy().astype(np.float64):
        p = v1 + rng.uniform(0, 1, (n, 3)) * (v2 - v1)
        a1 = rng.integers(0, 3, n)
        a2 = (a1 + rng.integers(1, 3, n)) % 3
        rows = np.arange(n)
        for a in (a1, a2):
            p[rows, a] = np.where(rng.integers(0, 2, n) == 1, v2[a], v1[a]) + rng.normal(0, 2e-3, n)
        d = rng.normal(0, 1, (n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        os_.append(p - d * back)
        ds.append(d)
    return (torch.from_numpy(np.concatenate(os_).astype(np.float32)),
            torch.from_numpy(np.concatenate(ds).astype(np.float32)))


@pytest.mark.parametrize("placement", ["as_built", "far"])
def test_k4_box_prefilter_is_exact(placement):
    """On every sweep of a small room5 trace (24x18 at sub-pixel (0, 0),
    whose middle column and row are axis-parallel rays, and their mirror
    children), and on rays grazing the boxes' edges, every valid box
    candidate lies inside K4's prefilter interval, so a skipped box never
    holds a hit that the sweep would take: the mirror's nearest sweep gives
    ``find_nearest``'s hits and its shadow test ``_nearest_is``. ``far``
    scales the scene 10x, moves it 1000 away and starts every primary and
    grazing ray 1e5 before where it would start: the rounding of a slab
    distance then exceeds the EPSILON widening, and without its rounding
    margins (margin 0) the prefilter loses hits of the trace and of the
    grazing rays and gets grazing rays' nearest hits wrong. Least slack as
    built: 1.3e-3 (room5 trace), 1.4e-4 (its grazing rays), 2.7e-3 and 0.195
    (far); at margin 0 (far): -7.8e-3 in the trace, 1048 of 7906 grazing
    hits lost, 72 nearest hits wrong."""
    scene = S.room5_scene("procedural", device="cpu")
    o, d = P._cached_rays5(24, 18, (0.0, 0.0), "cpu")
    back = 0.0
    if placement == "far":
        back = 1e5
        scene, o = _far(scene), o * 10.0 + 1000.0 - d * back
    stats = _check_sweeps(scene, o, d, 1.0)
    assert stats["sweeps"] > 3000 and stats["axis"] > 30, stats
    assert stats["outside"] == 0 and stats["wrong"] == 0 and stats["slack"] >= 0.0, stats
    eo, ed = _edge_rays(scene, max(back, 10.0))
    slack = _box_slack(scene, eo, ed, 1.0)
    assert slack.numel() > 1000 and float(slack.min()) >= 0.0
    assert _nearest_wrong(scene, eo, ed, 1.0) == 0
    if placement == "far":
        bare = _check_sweeps(scene, o, d, 0.0)
        assert bare["outside"] > 0 and bare["slack"] < 0.0, bare
        assert int((_box_slack(scene, eo, ed, 0.0) < 0).sum()) > 0
        assert _nearest_wrong(scene, eo, ed, 0.0) > 0


def test_k4_box_records_are_the_kernels_sums():
    """``box_records``, which the prefilter mirror reads and K4 makes once
    per block, are the float32 sums of the exact box test: v2 = v1 + size,
    lo = v1 - EPSILON, hi = v2 + EPSILON, bitwise (numpy float32)."""
    for scene in (S.room5_scene("procedural", device="cpu"),
                  _far(S.room5_scene("procedural", device="cpu"))):
        boxes, rec = wk.box_records(scene)
        assert boxes == tuple(j for j, t in enumerate(scene.ptype) if t == S.BOX5)
        pos = scene.box_pos.numpy()[list(boxes)]
        size = scene.box_size.numpy()[list(boxes)]
        eps = np.float32(0.001)
        v2 = pos + size
        assert v2.dtype == np.float32
        for k, want in enumerate((pos, v2, pos - eps, v2 + eps)):
            np.testing.assert_array_equal(rec[:, k].numpy(), want)


def test_k4_shared_memory_capacity():
    """K4's wrapper takes a scene of up to 1117 primitives with two textures
    (a block's shared memory opted in past 48 KB to the 227 KB sm_90
    allows) and refuses one more: the 384 that fit at 32 words per
    primitive, before the geometry records and index lists, still fit."""
    assert wk.shared_memory_bytes(384, 2) > 48 * 1024
    assert wk.shared_memory_bytes(1117, 2) <= 227 * 1024
    with pytest.raises(ValueError, match="1118 primitives"):
        wk.shared_memory_bytes(1118, 2)


def _large_scene(device):
    """401 primitives (more than fit in 48 KB of shared memory): a floor,
    a box light, 200 spheres and 199 boxes in front of the camera."""
    b = S.Whitted5Builder()
    b.plane((0, 1, 0), 4.4, diff=1.0, color=(0.6, 0.6, 0.6))
    b.box((-1, 5.0, 4), (2, 0.1, 2), is_light=True, color=(0.9, 0.9, 0.9))
    for k in range(200):
        b.sphere((-5.0 + 0.5 * (k % 20), -3.0 + 0.6 * (k // 20), 9.0), 0.2, diff=0.8,
                 spec=0.3, refl=0.2, color=(0.3 + 0.003 * k, 0.5, 0.7))
    for k in range(199):
        b.box((-5.0 + 0.5 * (k % 20), -3.0 + 0.6 * (k // 20), 6.0), (0.2, 0.2, 0.2),
              diff=0.7, color=(0.8, 0.4, 0.2))
    return b.build(device)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_k5_matches_plain_on_cuda(cuda):
    """K5 alone against _texel on the card, bitwise, one launch."""
    scene = S.room5_scene("procedural", device="cuda")
    n = 1 << 16
    u, v = (torch.from_numpy(a).cuda() for a in _uv_lanes(n, 6))
    tex = (torch.arange(n, device="cuda") % 2).to(torch.int32)
    flat, textab = tk.pack_texel_atlas(scene.textures)
    before = tk.texel_fetch_cuda.launches
    live = torch.ones(n, dtype=torch.bool, device="cuda")
    out = tk.texel_fetch_cuda(flat, textab, tex, u, v, live)
    torch.cuda.synchronize()
    assert tk.texel_fetch_cuda.launches == before + 1
    th, tw = scene.textures[0].shape[:2]
    ref = P._texel(torch.cat(list(scene.textures)), u, v, row_offset=tex * th, wrap_shape=(th, tw))
    assert torch.equal(out, ref.T.contiguous())


@pytest.mark.cuda
def test_k4_matches_plain_on_cuda(cuda):
    """K4 against the plain tracer on the card, room5 160x120, spp 2: one
    launch, the same counters, the colour under the robust contract."""
    scene = S.room5_scene("procedural", device="cuda")
    o, d = P._cached_rays5(160, 120, (0.5, 0.5), "cuda")
    state = P._state5(160 * 120, 3, "cuda")
    before = wk.whitted5_trace_cuda.launches
    col, st, idx = wk.whitted5_trace_cuda(scene, o, d, state, spp=2, return_primary_idx=True)
    torch.cuda.synchronize()
    assert wk.whitted5_trace_cuda.launches == before + 1
    pcol, pst, pidx = P.trace_passes(scene, o, d, state, spp=2, return_primary_idx=True)
    assert torch.equal(st[1], pst[1])
    assert (idx.long() == pidx).double().mean().item() >= 0.9999
    _robust_close(col.cpu().numpy(), pcol.cpu().numpy(), "K4 vs plain")


@pytest.mark.cuda
def test_k4_bitwise_on_cuda(cuda):
    """K4 against the plain tracer on the card, bitwise: colour, counters
    and primary ids at 160x120, spp 2, sub-pixel (0, 0) (axis-parallel rays
    in the middle column and row), for room5, the deterministic scene and
    the two tie scenes; one launch each."""
    o, d = P._cached_rays5(160, 120, (0.0, 0.0), "cuda")
    state = P._state5(160 * 120, 3, "cuda")
    scenes = [S.room5_scene("procedural", device="cuda"), _det_rows(S).build("cuda")]
    scenes += [t.to("cuda") for t in _tie_scenes()]
    for scene in scenes:
        before = wk.whitted5_trace_cuda.launches
        col, st, idx = wk.whitted5_trace_cuda(scene, o, d, state, spp=2,
                                              return_primary_idx=True)
        torch.cuda.synchronize()
        assert wk.whitted5_trace_cuda.launches == before + 1
        pcol, pst, pidx = P.trace_passes(scene, o, d, state, spp=2, return_primary_idx=True)
        assert torch.equal(st[1], pst[1])
        assert torch.equal(idx.long(), pidx)
        assert torch.equal(col, pcol), (col - pcol).abs().max().item()


@pytest.mark.cuda
def test_k4_large_scene_on_cuda(cuda):
    """A scene of 401 primitives, whose block needs more than the default
    48 KB of shared memory, renders in one K4 launch bitwise equal to the
    plain tracer (64x48, spp 1)."""
    scene = _large_scene("cuda")
    assert wk.shared_memory_bytes(scene.num_prims, 0) > 48 * 1024
    o, d = P._cached_rays5(64, 48, (0.5, 0.5), "cuda")
    state = P._state5(64 * 48, 3, "cuda")
    before = wk.whitted5_trace_cuda.launches
    col, st, idx = wk.whitted5_trace_cuda(scene, o, d, state, return_primary_idx=True)
    torch.cuda.synchronize()
    assert wk.whitted5_trace_cuda.launches == before + 1
    pcol, pst, pidx = P.trace_passes(scene, o, d, state, return_primary_idx=True)
    assert torch.equal(st[1], pst[1])
    assert torch.equal(idx.long(), pidx)
    assert bool((pidx >= 2).any())  # the rays meet the grid
    assert torch.equal(col, pcol), (col - pcol).abs().max().item()

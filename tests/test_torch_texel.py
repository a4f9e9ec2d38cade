"""K5's texel units (``kernels/texel_kernel.py``) against K5's plain version
and the JAX ``_texel`` on the CPU, and K5 and K4 on the card.

A texture whose texels are all k/256 is stored as u8 quads, each texel's
four bilinear corners with GetTexel's wrap baked in; any other as float32
RGBA texels. Read back by ``texel_fetch_units_reference`` (the kernel's
reads and arithmetic in torch) the units must give the same floats as
``texel_fetch_reference`` on the [texels, 3] atlas and as the JAX
package's ``models/whitted5._texel``: bitwise, since the corners are the
same floats (k * 2^-8 is exact) and the blend keeps GetTexel's order.

The JAX package is imported inside the tests that use it, so that the
``cuda`` tests run on a GPU machine without JAX:
``python -m pytest tests/test_torch_texel.py --noconftest -m cuda``."""

import dataclasses

import numpy as np
import pytest
import torch

from se195_raytracer_tpu_torch.io.tga import write_tga
from se195_raytracer_tpu_torch.kernels import texel_kernel as tk
from se195_raytracer_tpu_torch.kernels import whitted5_kernel as wk
from se195_raytracer_tpu_torch.models import whitted5 as P
from se195_raytracer_tpu_torch.scenes import whitted5_scenes as S

I32_MIN, I32_MAX = -(2 ** 31), 2 ** 31 - 1


def _u8(rng, th, tw):
    return rng.integers(0, 256, size=(th, tw, 3)).astype(np.float32) / 256.0


def _f32(rng, th, tw):
    return rng.uniform(0.0, 1.5, size=(th, tw, 3)).astype(np.float32)


def _textures(kind):
    """numpy [Th, Tw, 3] textures of one kind, from a seed: two sizes in
    one table, Th != Tw, and Tw = 1 and Th = 1."""
    rng = np.random.default_rng(21)
    if kind == "u8":
        return [_u8(rng, 5, 7), _u8(rng, 16, 16), _u8(rng, 9, 4)]
    if kind == "procedural":
        return [S.checker_texture(48, 6), S.marble_texture(64), _f32(rng, 3, 11)]
    if kind == "mixed":
        return [_u8(rng, 7, 5), S.marble_texture(32), _u8(rng, 12, 12), _f32(rng, 4, 9)]
    # "thin": Tw = 1 and Th = 1 in both forms
    return [_u8(rng, 6, 1), _f32(rng, 1, 5), _f32(rng, 8, 1), _u8(rng, 1, 3)]


def _uv_lanes(n, n_tex, seed):
    """Texture ids and coordinates: uniform in [-3, 3], 1% far negative
    (u + 1000.5 < 0: the floor modulo keeps them inside the texture), and
    the coordinates whose scaled value is an exact integer."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-3.0, 3.0, n).astype(np.float32)
    v = rng.uniform(-3.0, 3.0, n).astype(np.float32)
    far = rng.random(n) < 0.01
    u[far] = rng.uniform(-5000.0, -1001.0, far.sum()).astype(np.float32)
    v[far[::-1]] = rng.uniform(-5000.0, -1001.0, far.sum()).astype(np.float32)
    u[:4] = (-1000.5, 0.0, -2000.5, 1.0)
    v[:4] = (-1000.0, 0.0, -3000.0, 1.0)
    tex = rng.integers(0, n_tex, n).astype(np.int32)
    return tex, u, v


@pytest.mark.parametrize("kind", ["u8", "procedural", "mixed", "thin"])
def test_texel_units_match_plain_and_jax(kind):
    """The packed units read back as the kernel reads them equal K5's plain
    version and the JAX _texel per texture, bitwise, on every lane; dead
    lanes give 0."""
    import jax.numpy as jnp

    from se195_raytracer_tpu.models import whitted5 as J

    textures = _textures(kind)
    tt = [torch.from_numpy(t) for t in textures]
    layout = tk.pack_texel_units(tt)
    flat, textab = tk.pack_texel_atlas(tt)
    n = 4096
    tex, u, v = _uv_lanes(n, len(tt), 3)
    live = np.ones(n, bool)
    live[5::17] = False
    args = [torch.from_numpy(a) for a in (tex, u, v, live)]
    units = tk.texel_fetch_units_reference(layout, *args)
    plain = tk.texel_fetch_reference(flat, textab, *args)
    assert torch.equal(units, plain)
    for t, bitmap in enumerate(textures):
        m = (tex == t) & live
        theirs = np.asarray(J._texel(jnp.asarray(bitmap), jnp.asarray(u[m]), jnp.asarray(v[m])))
        np.testing.assert_array_equal(units[:, torch.from_numpy(m)].numpy().T, theirs)
    assert not bool(units[:, ~torch.from_numpy(live)].any())


def test_texel_units_rows_and_forms():
    """Each texture's table row (texel offset, Th, Tw, form), in order, one
    16-byte unit per texel; a u8 unit holds the four wrapped corners' k,
    channel-major, then four zero bytes; a float unit the texel's (r, g, b,
    0)."""
    rng = np.random.default_rng(4)
    a, b, c = _u8(rng, 3, 5), _f32(rng, 2, 2), _u8(rng, 1, 1)
    layout = tk.pack_texel_units([torch.from_numpy(t) for t in (a, b, c)])
    assert layout.table.tolist() == [[0, 3, 5, tk.TEX_U8], [15, 2, 2, tk.TEX_F32],
                                     [19, 1, 1, tk.TEX_U8]]
    assert layout.units.shape == (20, tk.UNIT_BYTES) and layout.units.dtype == torch.uint8
    k = (a * 256).astype(np.uint8)
    quad = layout.units[2 * 5 + 4].numpy()  # (v, u) = (2, 4): v2 = 0, u2 = 0
    want = np.stack([k[2, 4], k[2, 0], k[0, 4], k[0, 0]], axis=-1).reshape(12)
    np.testing.assert_array_equal(quad[:12], want)
    assert not quad[12:].any()
    texel = layout.units[15 + 1 * 2 + 0].view(torch.float32).numpy()  # (v, u) = (1, 0)
    np.testing.assert_array_equal(texel, np.append(b[1, 0], 0.0).astype(np.float32))
    np.testing.assert_array_equal(layout.units[19, :12].numpy(),
                                  np.repeat((c[0, 0] * 256).astype(np.uint8), 4))


@pytest.mark.parametrize("value,form", [
    (0.0, tk.TEX_U8), (255.0 / 256.0, tk.TEX_U8), (17.0 / 256.0, tk.TEX_U8),
    (1.0, tk.TEX_F32), (0.2, tk.TEX_F32), (-0.0, tk.TEX_F32), (-1.0 / 256.0, tk.TEX_F32),
    (0.5 / 256.0, tk.TEX_F32), (float("nan"), tk.TEX_F32), (float("inf"), tk.TEX_F32),
])
def test_u8_form_only_for_k_over_256(value, form):
    """The u8 form is chosen only where every texel is k/256 with integer k
    in 0..255 and no sign bit: one texel of another value (1.0, 0.2, -0.0,
    ...) in an otherwise u8/256 texture gives the float form, and the
    units still read back equal to the plain version."""
    rng = np.random.default_rng(9)
    t = _u8(rng, 6, 5)
    t[3, 2, 1] = value
    tt = [torch.from_numpy(t)]
    assert tk.texel_forms(tt) == [form]
    if np.isfinite(value):
        layout = tk.pack_texel_units(tt)
        flat, textab = tk.pack_texel_atlas(tt)
        tex, u, v = _uv_lanes(512, 1, 5)
        args = [torch.from_numpy(x) for x in (tex, u, v, np.ones(512, bool))]
        assert torch.equal(tk.texel_fetch_units_reference(layout, *args),
                           tk.texel_fetch_reference(flat, textab, *args))


def test_floor_mod_matches_torch_mod():
    """The kernel's one-division floor modulo equals torch's % over int32
    edge values, for sizes from 1 to 2^31 - 1."""
    rng = np.random.default_rng(2)
    a = np.concatenate([
        [I32_MIN, I32_MIN + 1, -(2 ** 24) - 1, -800_000, -1001, -200, -199, -1, 0, 1, 63, 64,
         199, 200, 2 ** 24 + 1, I32_MAX - 1, I32_MAX],
        rng.integers(I32_MIN, I32_MAX, 2000, endpoint=True),
    ]).astype(np.int32)
    for m in (1, 2, 3, 7, 64, 199, 200, 65537, I32_MAX):
        at = torch.from_numpy(a)
        mt = torch.full_like(at, m)
        got = tk.floor_mod(at, mt)
        assert torch.equal(got, at % mt), m
        assert bool(((got >= 0) & (got < m)).all())


def test_fetch_wrapper_on_cpu_is_the_plain_version():
    """texel_fetch_cuda on CPU tensors, with or without a layout, is K5's
    plain version and launches nothing."""
    tt = [torch.from_numpy(t) for t in _textures("mixed")]
    flat, textab = tk.pack_texel_atlas(tt)
    tex, u, v = (torch.from_numpy(x) for x in _uv_lanes(300, len(tt), 8))
    live = torch.ones(300, dtype=torch.bool)
    before = tk.texel_fetch_cuda.launches
    want = tk.texel_fetch_reference(flat, textab, tex, u, v, live)
    assert torch.equal(tk.texel_fetch_cuda(flat, textab, tex, u, v, live), want)
    assert torch.equal(tk.texel_fetch_cuda(flat, textab, tex, u, v, live,
                                           layout=tk.pack_texel_units(tt)), want)
    assert tk.texel_fetch_cuda.launches == before


def test_texel_stream_hook():
    """on_texel sees one lane per texel fetch that ``work`` counts, and the
    stream read from the units equals the plain fetch: K4's own lane set
    for K5 (room5 with u8/256 textures)."""
    b = S.Whitted5Builder()
    rng = np.random.default_rng(1)
    ids = [b.add_texture(_u8(rng, 20, 20)) for _ in range(2)]
    b.plane((0, 1, 0), 4.4, diff=1.0, spec=0.5, color=(0.7, 0.7, 0.7), tex=ids[0],
            uv_scale=(0.45, 0.45))
    b.sphere((0, -0.8, 7), 2.0, refl=0.05, refr=0.5, refr_index=1.3, diff=0.5, spec=0.8,
             color=(2.7, 2.7, 3.0), tex=ids[1], uv_scale=(0.8, 0.8))
    b.box((-1, 5.0, 4), (2, 0.1, 2), is_light=True, color=(0.5, 0.5, 0.5))
    b.plane((0, 0, -1), 10.4, diff=1.7, color=(0.4, 0.3, 0.3))
    scene = b.build("cpu")
    o, d = P._cached_rays5(24, 18, (0.5, 0.5), "cpu")
    state = P._state5(24 * 18, 3, "cpu")
    lanes, work = [], {}
    P.trace_passes(scene, o, d, state, spp=2, trace_depth=3, work=work,
                   on_texel=lambda t, u, v: lanes.append((t, u, v)))
    tex, u, v = (torch.cat(x) for x in zip(*lanes))
    assert tex.shape[0] == work["texels"] > 0
    assert set(tex.tolist()) == {0, 1} and tex.dtype == torch.int32
    layout = tk.pack_texel_units(scene.textures)
    assert layout.table[:, 3].tolist() == [tk.TEX_U8, tk.TEX_U8]
    flat, textab = tk.pack_texel_atlas(scene.textures)
    live = torch.ones_like(u, dtype=torch.bool)
    assert torch.equal(tk.texel_fetch_units_reference(layout, tex, u, v, live),
                       tk.texel_fetch_reference(flat, textab, tex, u, v, live))


def test_k4_packs_the_texel_units():
    """K4's per-scene tables carry the texel units: room5 with TGA textures
    (u8/256) packs them in the u8 form, the procedural room5 in the float
    form, and each is packed once per scene."""
    rng = np.random.default_rng(0)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        for name in ("checker", "marble"):
            write_tga(f"{tmp}/{name}.tga", rng.integers(0, 256, (12, 10, 3)).astype(np.uint8))
        real = S.room5_scene("real", device="cpu", textures_dir=tmp)
    proc = S.room5_scene("procedural", device="cpu")
    for scene, form, n in ((real, tk.TEX_U8, 2 * 12 * 10), (proc, tk.TEX_F32, 2 * 64 * 64)):
        _, _, _, (units, table) = wk._packed(scene)
        assert table[:, 3].tolist() == [form, form]
        assert units.shape == (n, tk.UNIT_BYTES)
        assert wk._packed(scene)[3][0] is units
    twin = dataclasses.replace(proc, tex_id=tuple(-1 for _ in proc.tex_id))
    assert wk._packed(twin)[3][1].shape == (2, 4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _room5_u8(device, tmp_path, size=200):
    rng = np.random.default_rng(0)
    for name in ("checker", "marble"):
        write_tga(str(tmp_path / f"{name}.tga"),
                  rng.integers(0, 256, size=(size, size, 3)).astype(np.uint8))
    return S.room5_scene("real", device=device, textures_dir=str(tmp_path))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["u8", "f32"])
def test_k5_lane_sets_on_cuda(cuda, tmp_path, form):
    """K5 alone against _texel on the card, bitwise, in each form, on the
    three lane sets chip_smoke.py times: 2^18 and 2^22 random lanes and
    K4's own fetches at room5 800x600 spp 1; one launch each."""
    scene = (_room5_u8("cuda", tmp_path) if form == "u8"
             else S.room5_scene("procedural", device="cuda"))
    layout = tk.pack_texel_units(scene.textures)
    assert layout.table[:, 3].tolist() == [tk.TEX_U8 if form == "u8" else tk.TEX_F32] * 2
    flat, textab = tk.pack_texel_atlas(scene.textures)
    o, d = P._cached_rays5(800, 600, (0.5, 0.5), "cuda")
    lanes = []
    P.trace_passes(scene, o, d, P._state5(800 * 600, 3, "cuda"),
                   on_texel=lambda t, u, v: lanes.append((t, u, v)))
    sets = [tuple(torch.from_numpy(x).cuda() for x in _uv_lanes(n, 2, 6))
            for n in (1 << 18, 1 << 22)]
    sets.append(tuple(torch.cat(x) for x in zip(*lanes)))
    th, tw = scene.textures[0].shape[:2]
    atlas = torch.cat(list(scene.textures))
    for tex, u, v in sets:
        live = torch.ones_like(u, dtype=torch.bool)
        before = tk.texel_fetch_cuda.launches
        out = tk.texel_fetch_cuda(flat, textab, tex, u, v, live, layout=layout)
        torch.cuda.synchronize()
        assert tk.texel_fetch_cuda.launches == before + 1
        ref = P._texel(atlas, u, v, row_offset=tex * th, wrap_shape=(th, tw))
        assert torch.equal(out, ref.T.contiguous())


@pytest.mark.cuda
def test_k4_u8_room5_bitwise_on_cuda(cuda, tmp_path):
    """K4 on room5 with u8/256 200x200 TGA textures (the reference's assets'
    form) against the plain tracer, bitwise: colour, counters and primary
    ids at 160x120, spp 2; one launch."""
    scene = _room5_u8("cuda", tmp_path)
    o, d = P._cached_rays5(160, 120, (0.5, 0.5), "cuda")
    state = P._state5(160 * 120, 3, "cuda")
    before = (wk.whitted5_trace_cuda.launches, wk.whitted5_trace_cuda.texel_launches)
    col, st, idx = wk.whitted5_trace_cuda(scene, o, d, state, spp=2, return_primary_idx=True)
    torch.cuda.synchronize()
    assert (wk.whitted5_trace_cuda.launches, wk.whitted5_trace_cuda.texel_launches) == (
        before[0] + 1, before[1] + 1)
    pcol, pst, pidx = P.trace_passes(scene, o, d, state, spp=2, return_primary_idx=True)
    assert torch.equal(st[1], pst[1])
    assert torch.equal(idx.long(), pidx)
    assert torch.equal(col, pcol), (col - pcol).abs().max().item()

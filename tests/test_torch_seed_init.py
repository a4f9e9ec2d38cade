"""The seed init of K1/K2's lane state (kernels/seed_kernel.py) against the
JAX package's ``init_mwc_state`` / ``init_counter_state`` and against the
host route the port took before (``init_pt_state_host``), all bitwise.

- the plain PyTorch version (``seed_lanes_reference``: the kernel's runs of
  PCG64 outputs, a jump in 16-bit limbs then steps, XSL-RR, Lemire, each
  run's count of rejected words, their prefix by blocks, and the tail past
  the pass) against JAX's ``init_mwc_state`` on several shapes and seeds,
  and at 512^2 on the three seeds below 2600 whose stream rejects a word
  there; without the shift those seeds fail; at slack 0 their last draw
  comes from the tail; runs cut so that the rejected word opens or closes
  a block;
- the counter keys against JAX's ``init_counter_state``, with a pixel
  offset;
- the lane layouts (K1 padded, K2's blocked ``pix`` order, ``tile_multiple``,
  a pixel range, each shard of a split) against ``init_pt_state_host``;
- the jump tables; the device caches of ``pt_kernel``;
- the kernel on the card (``cuda``; skips here): bitwise numpy, the tail at
  slack 0, and no host sync in a seeding.

The JAX package is imported inside the tests that use it, so that the
``cuda`` tests run on a GPU machine without JAX:
``python -m pytest tests/test_torch_seed_init.py --noconftest -m cuda``."""

import numpy as np
import pytest
import torch

from se195_raytracer_tpu_torch.core.config import RenderConfig
from se195_raytracer_tpu_torch.core.rng import init_state
from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk
from se195_raytracer_tpu_torch.kernels import seed_kernel as sk

SIDE = 512
# Seeds whose first 2 * 512^2 draws meet exactly one rejected word, and its
# raw index: the first flat draw that the rejection shifts.
REJECTING = {125: 434578, 2425: 305335, 2508: 252319}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def _jax_mwc(shape, seed):
    from se195_raytracer_tpu.core import rng as jrng

    s0, s1 = jrng.init_mwc_state(shape, seed)
    return np.asarray(s0).reshape(-1), np.asarray(s1).reshape(-1)


@pytest.mark.parametrize("shape", [(1,), (37, 5), (480 * 640,)])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_plain_mwc_matches_jax(shape, seed):
    n = int(np.prod(shape))
    s0, s1 = sk.seed_lanes_reference("mwc", seed, n, n)
    j0, j1 = _jax_mwc(shape, seed)
    np.testing.assert_array_equal(_np(s0), j0)
    np.testing.assert_array_equal(_np(s1), j1)


@pytest.mark.parametrize("seed", sorted(REJECTING))
def test_plain_mwc_rejecting_seeds_at_512(seed):
    """One rejected word, at the index the stream gives it; every draw
    bitwise JAX's, and the draws from that index on wrong without the
    shift."""
    n = SIDE * SIDE
    w, value, rejected = sk.mwc_words_reference(seed, 2 * n + sk.SLACK)
    assert w[rejected].tolist() == [REJECTING[seed]]
    s0, s1 = sk.seed_lanes_reference("mwc", seed, n, n)
    want = np.concatenate(_jax_mwc((n,), seed))
    np.testing.assert_array_equal(np.concatenate([_np(s0), _np(s1)]), want)
    order = torch.argsort(w.reshape(-1))
    unshifted = value.reshape(-1)[order][:2 * n].numpy().astype(np.uint32)
    wrong = np.nonzero(unshifted != want)[0]
    assert wrong[0] == REJECTING[seed] and wrong.size == 2 * n - REJECTING[seed]


def test_rejection_constants():
    assert sk.RANGE == 2**31 - 1 - 2 and sk.REJECT_BELOW == 6
    assert sk.pcg64_state(3) == (int(np.random.PCG64(3).state["state"]["state"]),
                                 int(np.random.PCG64(3).state["state"]["inc"]))


@pytest.mark.parametrize("seed", [0, 7, 2**40 + 3])
@pytest.mark.parametrize("shape,offset", [((37, 5), 0), ((1000,), 12345)])
def test_plain_counter_matches_jax(seed, shape, offset):
    from se195_raytracer_tpu.core import rng as jrng

    count = int(np.prod(shape))
    key, ctr = sk.seed_lanes_reference("counter", seed, offset + count, count,
                                       lane_offset=offset)
    jkey, jctr = jrng.init_counter_state(shape, seed, pixel_offset=offset)
    np.testing.assert_array_equal(_np(key), np.asarray(jkey).reshape(-1))
    np.testing.assert_array_equal(_np(ctr), np.asarray(jctr).reshape(-1))


def _cfg(w, h, rng, seed):
    return RenderConfig(width=w, height=h, spp=1, seed=seed, rng=rng)


@pytest.mark.parametrize("rng", ["mwc", "counter"])
@pytest.mark.parametrize("blocked,tile_multiple", [(False, 1), (True, 1), (False, 8), (True, 8)])
def test_lane_layouts_match_host_route(rng, blocked, tile_multiple):
    """K1 (identity, padded) and K2 (blocked pix order) lanes, with and
    without 8-tile rounding: the plain version, the CPU route and the host
    route give the same state, pad lanes 2."""
    cfg = _cfg(100, 70, rng, 125)
    r = cfg.width * cfg.height
    rp, pix, _ = ptk.ray_layout(cfg.width, cfg.height, blocked, tile_multiple)
    h0, h1, hacc = ptk.init_pt_state_host(cfg, "cpu", blocked, tile_multiple)
    c0, c1, cacc = ptk.init_pt_state(cfg, "cpu", blocked, tile_multiple)
    p0, p1 = sk.seed_lanes_reference(rng, cfg.seed, r, rp,
                                     pix=torch.from_numpy(pix) if blocked else None)
    assert h0.shape == (rp,) and h0.dtype == c0.dtype == p0.dtype == torch.uint32
    for a, b, c in ((h0, c0, p0), (h1, c1, p1)):
        np.testing.assert_array_equal(_np(a), _np(b))
        np.testing.assert_array_equal(_np(a), _np(c))
    assert torch.equal(hacc, cacc) and not hacc.any()
    pad = np.asarray(pix) >= r
    assert pad.any() and (_np(h0)[pad] == 2).all() and (_np(h1)[pad] == 2).all()


@pytest.mark.parametrize("rng", ["mwc", "counter"])
def test_pixel_range_and_shards_match_whole_frame(rng):
    """A pixel range (``render_cuda(pixels=...)``'s seeding) and each of 8
    shards of the 8-tile layouts seed only their own lanes, bitwise the
    whole frame's state at those lanes."""
    cfg = _cfg(100, 70, rng, 2508)
    r = cfg.width * cfg.height
    w0, w1 = init_state(rng, (r,), cfg.seed, device="cpu")
    lo, hi = 1234, 5678
    for fn in (sk.seed_lanes, sk.seed_lanes_reference):
        s0, s1 = fn(rng, cfg.seed, r, hi - lo, lane_offset=lo, device="cpu")
        assert torch.equal(s0, w0[lo:hi]) and torch.equal(s1, w1[lo:hi])
    for blocked in (False, True):
        rp, pix, _ = ptk.ray_layout(cfg.width, cfg.height, blocked, 8)
        h0, h1, _ = ptk.init_pt_state_host(cfg, "cpu", blocked, 8)
        per = rp // 8
        for k in range(8):
            a, b = k * per, (k + 1) * per
            kw = (dict(pix=torch.from_numpy(pix[a:b])) if blocked
                  else dict(lanes=per, lane_offset=a))
            for fn in (sk.seed_lanes, sk.seed_lanes_reference):
                s0, s1 = fn(rng, cfg.seed, r, device="cpu", **kw)
                assert torch.equal(s0, h0[a:b]) and torch.equal(s1, h1[a:b]), (blocked, k)


@pytest.mark.parametrize("part", ["frame", "last pixels"])
@pytest.mark.parametrize("seed", sorted(REJECTING))
def test_plain_tail_at_slack_0(seed, part):
    """At slack 0 the pass covers exactly the 2n words of the draws and
    meets one rejection, so the last draw (s1 of the last pixel) comes from
    the tail: bitwise numpy over the whole frame and over a lane range that
    holds the last pixel and runs past it into pad lanes."""
    n = SIDE * SIDE
    calls = []
    tail = sk._tail_reference

    def spy(*args):
        calls.append(args[1:3])
        return tail(*args)

    lo, lanes = (0, n) if part == "frame" else (n - 300, 512)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sk, "_tail_reference", spy)
        s0, s1 = sk.seed_lanes_reference("mwc", seed, n, lanes, lane_offset=lo, slack=0)
    assert calls == [(2 * n, 1)]
    w0, w1 = init_state("mwc", (n,), seed, device="cpu")
    real = min(lanes, n - lo)
    assert torch.equal(s0[:real], w0[lo:lo + real]) and torch.equal(s1[:real], w1[lo:lo + real])
    assert (s0[real:] == sk.PAD).all() and (s1[real:] == sk.PAD).all()


@pytest.mark.parametrize("seed,run,block_runs,where", [
    (2508, sk.RUN, 190, "the last word of block 82"),
    (125, 1, 1439, "the first word of block 151"),
    (2425, 4, 38167, "the last word of block 0"),
])
def test_plain_rejection_at_a_block_boundary(seed, run, block_runs, where):
    """Runs and blocks cut so that the seed's one rejected word sits at a
    block's edge: the block prefix carries it across, bitwise numpy."""
    n = SIDE * SIDE
    w, _, rejected = sk.mwc_words_reference(seed, 2 * n + sk.SLACK, run)
    t, k = (int(i) for i in rejected.nonzero()[0])
    words = 2 * run * block_runs
    first = t % block_runs == 0 and k == 0
    last = t % block_runs == block_runs - 1 and k == 2 * run - 1
    assert (first if "first" in where else last) and int(w[t, k]) // words == int(
        where.split()[-1])
    s0, s1 = sk.seed_lanes_reference("mwc", seed, n, n, run=run, block_runs=block_runs)
    w0, w1 = init_state("mwc", (n,), seed, device="cpu")
    assert torch.equal(s0, w0) and torch.equal(s1, w1)


def test_jump_tables():
    """Entry i of the jump tables moves PCG64's state 2^i outputs on, as
    2^i steps do; the multipliers do not depend on the increment."""
    _, inc = sk.pcg64_state(125)
    state = 0x1234_5678_9ABC_DEF0_0FED_CBA9_8765_4321
    stepped = state
    for i, (mult, plus) in enumerate(sk.jump_tables(inc)[:6]):
        for _ in range(1 << max(i - 1, 0)):  # 2^i steps in all
            stepped = (stepped * sk.PCG_MULT + inc) & sk._M128
        assert (state * mult + plus) & sk._M128 == stepped, i
    assert len(sk.jump_tables(inc)) == sk.MAX_JUMP_BITS
    assert [m for m, _ in sk.jump_tables(7)] == [m for m, _ in sk.jump_tables(inc)]


def test_draws_needed():
    n = 1000
    assert sk.draws_needed(n, 10, True, 0) == 2 * n
    assert sk.draws_needed(n, n, False, 0) == 2 * n
    assert sk.draws_needed(n, 24, False, 990) == 2 * n  # runs past the last pixel
    assert sk.draws_needed(n, 10, False, 100) == n + 110
    assert sk.draws_needed(n, 10, False, n) == 0  # pad lanes only
    with pytest.raises(ValueError, match="slack"):
        sk.seed_lanes("mwc", 0, 10, 4, device="cpu", slack=-1)


def test_seed_lanes_arguments():
    with pytest.raises(ValueError, match="lane_offset"):
        sk.seed_lanes("mwc", 0, 10, pix=torch.arange(4, dtype=torch.int32), lane_offset=1,
                      device="cpu")
    with pytest.raises(ValueError, match="int32"):
        sk.seed_lanes("mwc", 0, 10, pix=torch.arange(4), device="cpu")
    with pytest.raises(ValueError, match="rng kind"):
        sk.seed_lanes("threefry", 0, 10, 4, device="cpu")


def test_seed_lanes_on_cuda_without_a_card_raises():
    """No host fallback: asked for a CUDA device, it launches or raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        sk.seed_lanes("mwc", 0, 64, 64, device="cuda")


def test_device_caches():
    """``lane_layout`` and K1's light list are made once per key and equal
    what they replace; a new light tuple gets its own list."""
    layout = ptk.lane_layout(100, 70, True, 1, "cpu")
    rp, pix_np, inv_np = ptk.ray_layout(100, 70, True)
    assert layout.blocked and layout.rp == rp
    assert layout.pix.dtype == torch.int32 and layout.inv.dtype == torch.int64
    np.testing.assert_array_equal(layout.pix.numpy(), pix_np)
    np.testing.assert_array_equal(layout.inv.numpy(), inv_np)
    assert ptk.lane_layout(100, 70, True, 1, "cpu").pix is layout.pix
    assert ptk.lane_layout(100, 70, False, 1, "cpu")[2:] == (None, None)
    a = ptk.light_list((3, 7), "cpu")
    b = ptk.light_list((3, 7), "cpu")
    c = ptk.light_list((8,), "cpu")
    assert a is b and a.tolist() == [3, 7] and a.dtype == torch.int32 and c.tolist() == [8]


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
@pytest.mark.parametrize("seed", [0, 125, 2425, 2508])
def test_seed_kernel_bitwise_on_cuda(seed):
    """The kernel against numpy's draw (the host route) at 512^2: K1 and K2
    layouts, both RNGs, 8 shards; at slack 0 (the tail finds the last draw
    of seeds 125, 2425, 2508) whole and in 8 shards; no host sync in a
    seeding or in ``init_pt_state``."""
    for rng in ("mwc", "counter"):
        cfg = _cfg(SIDE, SIDE, rng, seed)
        for blocked in (False, True):
            h0, h1, _ = ptk.init_pt_state_host(cfg, "cpu", blocked)
            ptk.init_pt_state(cfg, "cuda", blocked)  # the lane tables, once
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                k0, k1, _ = ptk.init_pt_state(cfg, "cuda", blocked)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            assert torch.equal(k0.cpu(), h0) and torch.equal(k1.cpu(), h1), (rng, blocked)
            rp, pix, _ = ptk.ray_layout(SIDE, SIDE, blocked, 8)
            h0, h1, _ = ptk.init_pt_state_host(cfg, "cpu", blocked, 8)
            per = rp // 8
            for slack in (sk.SLACK, 0):
                for k in range(8):
                    a, b = k * per, (k + 1) * per
                    kw = (dict(pix=torch.from_numpy(pix[a:b]).cuda()) if blocked
                          else dict(lanes=per, lane_offset=a))
                    s0, s1 = sk.seed_lanes(rng, seed, SIDE * SIDE, device="cuda", slack=slack,
                                           **kw)
                    assert torch.equal(s0.cpu(), h0[a:b]) and torch.equal(s1.cpu(), h1[a:b])


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
@pytest.mark.parametrize("seed", sorted(REJECTING))
def test_seed_kernel_tail_on_cuda(seed):
    """Slack 0 on the card, whole frame in both layouts and a lane range
    that holds the last pixel: bitwise numpy and the plain version, under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    n = SIDE * SIDE
    w0, w1 = init_state("mwc", (n,), seed, device="cpu")
    rp, pix, _ = ptk.ray_layout(SIDE, SIDE, True)
    pix = torch.from_numpy(pix).cuda()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        whole = sk.seed_lanes("mwc", seed, n, n, device="cuda", slack=0)
        blocked = sk.seed_lanes("mwc", seed, n, pix=pix, slack=0)
        last = sk.seed_lanes("mwc", seed, n, 512, lane_offset=n - 300, device="cuda", slack=0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(whole[0].cpu(), w0) and torch.equal(whole[1].cpu(), w1)
    p = pix.cpu().to(torch.int64)
    real = p < n
    for got, want in zip(blocked, (w0, w1)):
        got = got.cpu()
        assert torch.equal(got[real], want[p[real]]) and (got[~real] == sk.PAD).all()
    plain = sk.seed_lanes_reference("mwc", seed, n, 512, lane_offset=n - 300, device="cuda",
                                    slack=0)
    for got, ref, want in zip(last, plain, (w0, w1)):
        assert torch.equal(got, ref)
        assert torch.equal(got[:300].cpu(), want[n - 300:]) and (got[300:] == sk.PAD).all()


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
def test_seed_kernel_under_jvp_on_cuda():
    """The pixel-gradient check runs the plain recompute, and so the seed
    kernel, under torch.func.jvp: the seeds come out as plain tensors, the
    same words as outside it (s1 of pixels 172400.. crosses seed 125's
    rejection at draw 434578)."""
    want = sk.seed_lanes("mwc", 125, SIDE * SIDE, 64, lane_offset=172400, device="cuda")

    def f(x):
        s0, s1 = sk.seed_lanes("mwc", 125, SIDE * SIDE, 64, lane_offset=172400, device="cuda")
        assert torch.equal(s0, want[0]) and torch.equal(s1, want[1])
        return x * 2.0

    x = torch.ones(3, device="cuda")
    _, tangent = torch.func.jvp(f, (x,), (x,))
    assert torch.equal(tangent, 2.0 * x)

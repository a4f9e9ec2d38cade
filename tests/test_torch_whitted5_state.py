"""The whitted5 counter-RNG state is seeded where the frame is traced.

``models.whitted5._state5`` makes a render's (key, counter) state: on a
CUDA device the seed kernel (``kernels.seed_kernel.seed_lanes``) hashes it
on the card, one launch and no copy from the host, so that two renders in
flight never wait on each other; on the CPU numpy hashes it. Either way
its bits are the host hash ``_init_state5_np``, and every image is the one
the host-hashed state gave.

- on the CPU: ``_state5`` bitwise ``_init_state5_np`` and
  ``seed_lanes_reference`` over frame sizes and seeds up to 2^62 - 1; each
  shard's lanes (``lane_offset``, pad lanes past the frame) bitwise the
  whole frame's state sliced and padded with 2; the three renderers
  (``use_kernel=False``) bitwise their renders with the host-hashed int64
  state put back in;
- on the card (``cuda``; skips here): ``render_whitted5``,
  ``render_whitted5_4ray`` and ``adaptive_pipeline`` of the benchmark's
  room5 at 800x600 with fresh seeds under
  ``torch.cuda.set_sync_debug_mode("error")``, each bitwise the same call
  made outside the mode with the host-hashed state, and one seeding a
  render.

The file imports no JAX: ``python -m pytest tests/test_torch_whitted5_state.py
--noconftest -m cuda`` runs its ``cuda`` tests on a GPU machine."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from se195_raytracer_tpu_torch.kernels import seed_kernel as sk
from se195_raytracer_tpu_torch.models import whitted5 as P
from se195_raytracer_tpu_torch.parallel.render_sharded import _ray_shards
from se195_raytracer_tpu_torch.parallel.mesh import make_mesh

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
SEEDS = (0, 5, 2147000011, 2**62 - 1)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host_state5(n, seed, device="cpu"):
    """The state as it was made before the seed kernel took it over: numpy's
    hash copied to the device as int64 words. The oracle."""
    key, ctr = P._init_state5_np(n, seed)
    return (torch.from_numpy(key.astype(np.int64)).to(device),
            torch.from_numpy(ctr.astype(np.int64)).to(device))


def _room5(device):
    """The benchmark's room5 configuration, built as its whitted5 loop builds it."""
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    from harness.manifest import load_module

    cfg = json.loads((BENCH / "configs" / "room5.json").read_text())
    return load_module(BENCH / "drivers" / "whitted5_loop.py").port_scene(cfg["scene"], device)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 37 * 23, 800 * 600])
def test_state5_is_the_host_hash(n, seed):
    key, ctr = P._state5(n, seed, "cpu")
    want_key, want_ctr = P._init_state5_np(n, seed)
    ref_key, ref_ctr = sk.seed_lanes_reference("counter", seed, n, n)
    assert key.dtype == ctr.dtype == torch.uint32 and key.shape == ctr.shape == (n,)
    np.testing.assert_array_equal(key.numpy(), want_key)
    np.testing.assert_array_equal(ctr.numpy(), want_ctr)
    assert torch.equal(key, ref_key) and torch.equal(ctr, ref_ctr)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [5, 37 * 23, 800 * 600])
def test_a_shards_lanes_are_the_frames_slice_padded(n, seed):
    """8 shards of an ``n``-pixel frame (5 pixels: three shards hold only
    pad lanes): each shard's seeding equals the whole frame's state sliced
    to its rays and padded with 2, as ``render_whitted5_sharded`` seeds."""
    key, ctr = P._state5(n, seed, "cpu")
    per, ranges = _ray_shards(n, make_mesh("cpu", n_devices=8))
    assert sum(hi - lo for lo, hi in ranges) == n
    for lo, hi in ranges:
        pad = torch.full((per - (hi - lo),), 2, dtype=torch.uint32)
        want = (torch.cat([key[lo:hi], pad]), torch.cat([ctr[lo:hi], pad]))
        for fn in (sk.seed_lanes, sk.seed_lanes_reference):
            got = fn("counter", seed, n, per, lane_offset=lo, device="cpu")
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (fn.__name__, lo)


def _render(kind, scene, w, h, seed, device, **kw):
    if kind == "render":
        return [P.render_whitted5(scene, w, h, spp=2, seed=seed, device=device, **kw)]
    if kind == "4ray":
        return [P.render_whitted5_4ray(scene, w, h, seed=seed, device=device, **kw)]
    img, n_edge = P.adaptive_pipeline(scene, w, h, seed=seed, device=device, **kw)
    return [img, n_edge]


@pytest.mark.parametrize("kind", ["render", "4ray", "adaptive"])
def test_plain_renders_are_the_host_hashed_states(kind, monkeypatch):
    """Room5 24x18 on the plain tracer: bitwise the render made with the
    host-hashed int64 state."""
    scene = _room5("cpu")
    got = _render(kind, scene, 24, 18, 2147000011, "cpu", trace_depth=3, use_kernel=False)
    monkeypatch.setattr(P, "_state5", _host_state5)
    want = _render(kind, scene, 24, 18, 2147000011, "cpu", trace_depth=3, use_kernel=False)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# --- on the card ------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")
@pytest.mark.parametrize("kind", ["render", "4ray", "adaptive"])
def test_on_the_card_no_host_sync_one_seeding_and_the_same_bits(kind, monkeypatch):
    """Room5 800x600 (spp 2 for ``render_whitted5``): fresh seeds under the
    sync check's "error" mode, each bitwise the render with the host-hashed
    state, and one seed-kernel launch a render."""
    scene = _room5("cuda")
    w, h = 800, 600
    _render(kind, scene, w, h, 1, "cuda")  # warm-up: the builds, K4's tables, the rays
    for seed in (20261018, 2**62 - 1):
        with monkeypatch.context() as m:
            m.setattr(P, "_state5", _host_state5)
            want = [t.clone() for t in _render(kind, scene, w, h, seed, "cuda")]
        torch.cuda.synchronize()
        before = sk.seed_lanes.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = _render(kind, scene, w, h, seed, "cuda")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert sk.seed_lanes.launches == before + 1
        assert all(torch.equal(g, x) for g, x in zip(got, want)), (kind, seed)

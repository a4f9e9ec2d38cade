"""One owner for a smallpt frame (``kernels/pt_kernel.py``), on the CPU:

- ``core.types.derived`` keeps a scene's table and K2's tables: lookups of
  one scene build once, and build again after an in-place write, on
  another device or under another static key; its bound holds, and a
  stale entry is replaced, not kept beside the new one;
- ``uses_k2`` alone decides K1 or K2: patched so that Cornell takes K2's
  layout, ``render_cuda``, ``RenderSession`` and ``render_cuda_sharded``
  all follow it, bitwise the unpatched images (the plain version traces
  absolute pixel ids);
- ``k1b_takes`` routes a backward to K1b only on a CUDA device, for K1's
  scenes, K1b's bounces and the hard estimator.

The file imports no JAX."""

import dataclasses

import numpy as np
import pytest
import torch

from se195_raytracer_tpu_torch.core import types as T
from se195_raytracer_tpu_torch.core.config import RenderConfig
from se195_raytracer_tpu_torch.driver.session import RenderSession
from se195_raytracer_tpu_torch.kernels import pt_backward_kernel as K
from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk
from se195_raytracer_tpu_torch.parallel import render_sharded as rs
from se195_raytracer_tpu_torch.parallel.mesh import make_mesh
from se195_raytracer_tpu_torch.scenes.generator import complex_scene
from se195_raytracer_tpu_torch.scenes.registry import get_scene

CFG = RenderConfig(width=40, height=24, spp=2, seed=3, max_depth=3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _counted(monkeypatch, name):
    """Count the calls of ``pt_kernel.<name>``: [count]."""
    calls, real = [0], getattr(ptk, name)

    def wrapped(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(ptk, name, wrapped)
    return calls


def test_a_scenes_tables_build_once_and_again_after_a_write(monkeypatch):
    """Lookups through the tables of one ``Scene`` (two ``Scene`` objects of
    the same tensors, as two renders hold them) pack the scene and build
    K2's tables once; an in-place write to ``scene.center``, another device
    and another light tuple each build again."""
    scene = complex_scene(max_depth=3.0).to_scene("cpu")
    assert ptk.uses_k2(scene.num_spheres)
    packs, builds = _counted(monkeypatch, "pack_scene"), _counted(monkeypatch, "block_bounds")

    def lookup(sc, lights=None):
        lights = sc.light_indices if lights is None else lights
        return ptk.scene_table(sc), ptk._k2_tables(ptk.scene_table(sc), lights)

    first = lookup(scene)
    again = lookup(dataclasses.replace(scene))
    assert (packs[0], builds[0]) == (1, 1)
    assert first[0] is again[0] and all(a is b for a, b in zip(first[1], again[1]))
    scene.center.add_(0.0)
    written = lookup(scene)
    assert (packs[0], builds[0]) == (2, 2) and written[0] is not first[0]
    assert torch.equal(written[0], first[0])
    lookup(scene.to("meta"))
    assert (packs[0], builds[0]) == (3, 3)
    lookup(scene, lights=(1,))
    assert (packs[0], builds[0]) == (3, 4)
    lookup(scene)
    assert (packs[0], builds[0]) == (3, 4)


def test_derived_keeps_its_bound_and_replaces_a_stale_entry(monkeypatch):
    """At most ``DERIVED_ENTRIES`` entries, the least recently used dropped
    first; a write makes the entry of the same tensors anew in its place."""
    monkeypatch.setattr(T, "_DERIVED", [])
    t = torch.zeros(3)
    made = []

    def build(i):
        made.append(i)
        return i

    for i in range(T.DERIVED_ENTRIES):
        T.derived("test", (), (i,), lambda: build(i))
    T.derived("test", (), (0,), lambda: build(-1))  # a hit: 0 is now the newest
    T.derived("test", (), (T.DERIVED_ENTRIES,), lambda: build(T.DERIVED_ENTRIES))
    assert len(T._DERIVED) == T.DERIVED_ENTRIES and -1 not in made
    T.derived("test", (), (1,), lambda: build(1))  # dropped: made again
    T.derived("test", (), (0,), lambda: build(-1))
    assert made.count(1) == 2 and -1 not in made
    T.derived("test", (t,), (), lambda: build("t"))
    t.add_(1.0)
    T.derived("test", (t,), (), lambda: build("t"))
    assert made.count("t") == 2
    assert sum(1 for e in T._DERIVED if e[2] and e[2][0] is t) == 1


def test_one_predicate_routes_every_caller(monkeypatch):
    """With ``uses_k2`` patched to pick K2 for Cornell, ``render_cuda``,
    ``RenderSession.step`` and ``render_cuda_sharded`` (8 shards of the CPU)
    all take K2's layout and route, and give the unpatched images bitwise."""
    spec = get_scene("cornell")
    scene, cam = spec.to_scene("cpu"), spec.to_camera("cpu")
    mesh = make_mesh("cpu", n_devices=8)

    def renders():
        img, st = ptk.render_cuda(scene, cam, CFG, device="cpu")
        sess = RenderSession(scene, cam, CFG, device="cpu")
        sess.step(2)
        img8, st8 = rs.render_cuda_sharded(scene, cam, CFG, mesh)
        return [img, torch.from_numpy(sess.step(1)), img8], [st[0], sess.state[0], st8[0]]

    k1_images, k1_states = renders()
    blocked = _counted(monkeypatch, "pt_blocked_pass")
    monkeypatch.setattr(ptk, "uses_k2", lambda n: True)
    k2_images, k2_states = renders()
    assert blocked[0] == 1 + 2 + 8
    for a, b in zip(k1_images, k2_images):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # The states hold K2's lanes: lane l holds pixel pix[l], whose stream
    # K1's state holds at lane pix[l].
    r = CFG.width * CFG.height
    for got, k1, tiles in zip(k2_states, k1_states, (1, 1, 8)):
        _, pix, _ = ptk.ray_layout(CFG.width, CFG.height, True, tiles)
        real = pix < r
        assert not np.array_equal(np.flatnonzero(real), pix[real])  # not the identity
        assert torch.equal(got[torch.from_numpy(real)], k1[torch.from_numpy(pix[real]).long()])


@pytest.mark.parametrize("device,spheres,depth,soft,takes", [
    ("cuda", 9, 7, 0.0, True),
    ("cuda:0", ptk.UNROLL_MAX_SPHERES, K.MAX_DEPTH, 0.0, True),
    ("cpu", 9, 7, 0.0, False),
    ("cuda", ptk.UNROLL_MAX_SPHERES + 1, 7, 0.0, False),
    ("cuda", 9, K.MAX_DEPTH + 1, 0.0, False),
    ("cuda", 9, 7, 0.5, False),
])
def test_k1b_takes(device, spheres, depth, soft, takes):
    """K1b's route: a CUDA device, K1's scenes, at most ``MAX_DEPTH``
    bounces and the hard estimator."""
    assert K.k1b_takes(torch.device(device), spheres, depth, soft) is takes

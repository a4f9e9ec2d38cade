"""The port's interactive session (driver/session.py): twins of the eight
tests of tests/test_session.py (on the plain route, as the JAX session
renders), the plain-route session against the JAX session after the same
key sequence, the kernel route (K1's plain version on the CPU) against the
plain route under K1's contract, and ReInit keeping the seeds in both
state forms."""

import numpy as np
import pytest
import torch

from se195_raytracer_tpu_torch.core.config import RenderConfig
from se195_raytracer_tpu_torch.driver.render import RenderState, render
from se195_raytracer_tpu_torch.driver.session import RenderSession
from se195_raytracer_tpu_torch.scenes.registry import get_scene

KEYS = ("w", "d", "+", "6", "left", "up", "pageup", "r", "9", "-", "a", "down", "s")


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


def make_session(use_kernel=False, name="simple", size=16):
    spec = get_scene(name)
    cfg = RenderConfig(width=size, height=size, spp=1, seed=2, use_kernel=use_kernel)
    return RenderSession(spec.to_scene("cpu"), spec.to_camera("cpu"), cfg, device="cpu")


def assert_k1_contract(a, b):
    """K1's contract against its plain version (chip_smoke.py, PERF.md §2):
    >= 97% of components within isclose(2e-3), the means within rtol 2e-3."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.isfinite(a).all()
    assert 1.0 - np.isclose(a, b, rtol=2e-3, atol=2e-3).mean() <= 0.03
    np.testing.assert_allclose(a.mean(), b.mean(), rtol=2e-3)


def test_progressive_then_edit_resets_accumulation():
    s = make_session()
    s.step(2)
    assert s.current_sample == 2
    img_before = s._image.copy()
    s.key("w")  # move camera forward
    assert s.current_sample == 0
    img_after = s.step(2)
    assert not np.allclose(img_before, img_after)


def test_edit_keeps_seeds_refresh_resets_them():
    s = make_session()
    s.step(1)
    seeds_before = s.state.s0.clone()
    s.key("4")  # move selected sphere: ReInitScene keeps seeds
    assert torch.equal(s.state.s0, seeds_before)
    s.key(" ")  # refresh: ReInit(1) reallocates seeds, and they reset to init
    assert torch.equal(s.state.s0, make_session().state.s0)


def test_step_for_adaptive_batching():
    """step_for: one pass per call before 20 samples, batches within the
    budget after (smallptGPU.cpp:739-755)."""
    s = make_session()
    s.step_for(0.05)
    assert s.current_sample == 1
    s.step(25)
    before = s.current_sample
    img = s.step_for(0.02)
    assert s.current_sample > before
    assert img.shape == (16, 16, 3)


def test_sphere_selection_and_move():
    s = make_session()
    s.key("+")
    s.key("+")
    assert s.current_sphere == 2
    before = s.scene.center[2].clone()
    s.key("6")
    np.testing.assert_allclose((s.scene.center[2] - before).numpy(), [5.0, 0.0, 0.0])
    s.key("-")
    assert s.current_sphere == 1


def test_rotation_changes_target_only():
    s = make_session()
    orig, tgt = s.camera.orig.clone(), s.camera.target.clone()
    s.key("left")
    assert torch.equal(s.camera.orig, orig)
    assert not torch.allclose(s.camera.target, tgt)


def test_save_image(tmp_path):
    from se195_raytracer_tpu_torch.io.image import read_ppm

    s = make_session()
    s.step(1)
    out = tmp_path / "snap.ppm"
    s.key("p", path=str(out))
    assert read_ppm(str(out)).shape == (16, 16, 3)


def test_esc_returns_false():
    assert make_session().key("\x1b") is False


def test_step_for_uses_the_ladder(monkeypatch):
    """step_for only ever asks for spp values of STEP_LADDER."""
    s = make_session()
    requested = set()
    orig_step = RenderSession.step

    def spy(self, samples=1):
        requested.add(samples)
        return orig_step(self, samples)

    monkeypatch.setattr(RenderSession, "step", spy)
    s.step(25)
    requested.clear()
    for _ in range(3):
        s.step_for(0.05)
    assert requested <= set(RenderSession.STEP_LADDER)


def test_plain_session_matches_jax_session():
    """The same key sequence in the port's plain-route session and the JAX
    session, simple 32x32 (the size of tests/test_torch_smallpt.py's
    contract: at 16x16 one firefly component moves the mean of 768 by
    1.6%): the camera and scene bitwise (the same float32 ops, the
    reference's t.y-then-t.z rotation included), the image after the last
    edit under smallpt's contract."""
    from se195_raytracer_tpu.core.config import RenderConfig as JConfig
    from se195_raytracer_tpu.driver.session import RenderSession as JSession
    from se195_raytracer_tpu.scenes.registry import get_scene as j_get_scene

    jspec = j_get_scene("simple")
    js = JSession(jspec.to_scene(), jspec.to_camera(), JConfig(width=32, height=32, spp=1, seed=2))
    s = make_session(size=32)
    for sess in (s, js):
        sess.step(2)
        for k in KEYS:
            sess.key(k)
    for a, b in ((s.camera.orig, js.camera.orig), (s.camera.target, js.camera.target),
                 (s.scene.center, js.scene.center)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert s.current_sphere == js.current_sphere and s.current_sample == js.current_sample == 0
    img, jimg = s.step(2), js.step(2)
    assert_k1_contract(img, jimg)


def test_kernel_session_matches_plain_session():
    """The kernel route (K1's state and its plain version here) against the
    plain route, Cornell 32x32, through steps and edits: the same camera,
    the images under K1's contract."""
    sk, sp = make_session(True, "cornell", 32), make_session(False, "cornell", 32)
    assert isinstance(sk.state, tuple) and isinstance(sp.state, RenderState)
    for sess in (sk, sp):
        sess.step(2)
        for k in ("d", "up", "+", "8"):
            sess.key(k)
    assert torch.equal(sk.camera.target, sp.camera.target)
    assert sk.current_sample == 0
    assert_k1_contract(sk.step(2), sp.step(2))
    assert sk.current_sample == sp.current_sample == 2


@pytest.mark.parametrize("use_kernel", [True, False])
def test_reinit_keeps_seeds_and_restarts(use_kernel):
    """ReInit(0) zeroes the accumulator and the sample and keeps the seeds,
    in both state forms, so the image after an edit is a fresh render of
    the edited scene from the kept seeds, bitwise."""
    s = make_session(use_kernel, "cornell", 32)
    s.step(3)
    s.key("w")
    s.key("6")
    if use_kernel:
        s0, s1, acc, sample = s.state
        assert not acc.any() and sample == 0
        fresh = (s0, s1, torch.zeros_like(acc), 0)
    else:
        assert not s.state.accum.any() and s.state.sample == 0
        fresh = s.state._replace(accum=torch.zeros_like(s.state.accum))
    cfg = RenderConfig(width=32, height=32, spp=2, seed=2, use_kernel=use_kernel)
    ref, _ = render(s.scene, s.camera, cfg, state=fresh, device="cpu")
    np.testing.assert_array_equal(s.step(2), ref.numpy())
    s.refresh()
    assert s.current_sample == 0

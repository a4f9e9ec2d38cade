"""The port's checkpoint (driver/checkpoint.py), metrics and profiling
(utils/), image readers (io/image.py) and the CLI's ``bench``, on the CPU.

A checkpoint has the JAX package's npz format, so a render checkpointed by
either package resumes in the other: the resumed image is held to the
uninterrupted render of the other package under smallpt's contract
(tests/test_torch_smallpt.py:5-8; the two packages' passes agree to that
contract, not bitwise), and within the port a resume is bitwise."""

import json
import os

import numpy as np
import pytest
import torch

from se195_raytracer_tpu_torch.core.config import RenderConfig
from se195_raytracer_tpu_torch.driver.checkpoint import load_render_state, save_render_state
from se195_raytracer_tpu_torch.driver.render import RenderState, render
from se195_raytracer_tpu_torch.scenes.registry import get_scene

SIZE = dict(width=32, height=32)


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


def assert_smallpt_contract(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.isfinite(a).all()
    assert 1.0 - np.isclose(a, b, rtol=2e-3, atol=2e-3).mean() <= 0.03
    np.testing.assert_allclose(a.mean(), b.mean(), rtol=2e-3)


def _port(name="cornell"):
    spec = get_scene(name)
    return spec.to_scene("cpu"), spec.to_camera("cpu")


def _jax(name="cornell"):
    from se195_raytracer_tpu.scenes.registry import get_scene as j_get_scene

    spec = j_get_scene(name)
    return spec.to_scene(), spec.to_camera()


@pytest.mark.parametrize("use_kernel", [True, False])
def test_roundtrip_and_resume_bitwise(tmp_path, use_kernel):
    """Both state forms: save, load, and the resumed render equals resuming
    the live state, bitwise; the state's kind survives."""
    scene, cam = _port()
    cfg = RenderConfig(spp=2, seed=3, use_kernel=use_kernel, **SIZE)
    _, st = render(scene, cam, cfg, device="cpu")
    path = str(tmp_path / "ckpt.npz")
    save_render_state(path, st)
    with np.load(path) as z:
        assert str(z["kind"]) == ("pallas" if use_kernel else "jnp")
        assert sorted(z.files) == ["accum", "kind", "s0", "s1", "sample"]
    st2 = load_render_state(path, device="cpu")
    assert type(st2) is type(st)
    a, sa = render(scene, cam, cfg, state=st, device="cpu")
    b, sb = render(scene, cam, cfg, state=st2, device="cpu")
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (sa.sample if isinstance(sa, RenderState) else sa[3]) == 4


def test_jax_plain_checkpoint_resumes_in_port_and_back(tmp_path):
    """kind "jnp": a JAX plain render of 1 spp, saved by the JAX package,
    resumed for 1 more in the port, against JAX's uninterrupted 2 spp; and
    the reverse."""
    from se195_raytracer_tpu.core.config import RenderConfig as JConfig
    from se195_raytracer_tpu.driver import checkpoint as jck
    from se195_raytracer_tpu.driver.render import render as j_render

    jscene, jcam = _jax()
    scene, cam = _port()
    jcfg1, jcfg2 = (JConfig(spp=s, seed=5, **SIZE) for s in (1, 2))
    cfg1, cfg2 = (RenderConfig(spp=s, seed=5, use_kernel=False, **SIZE) for s in (1, 2))
    path = str(tmp_path / "j.npz")
    _, jst = j_render(jscene, jcam, jcfg1)
    jck.save_render_state(path, jst)
    img, st = render(scene, cam, cfg1, state=load_render_state(path, device="cpu"), device="cpu")
    assert st.sample == 2
    assert_smallpt_contract(img.numpy(), np.asarray(j_render(jscene, jcam, jcfg2)[0]))

    _, pst = render(scene, cam, cfg1, device="cpu")
    save_render_state(path, pst)
    jimg, jst2 = j_render(jscene, jcam, jcfg1, state=jck.load_render_state(path))
    assert int(jst2.sample) == 2
    assert_smallpt_contract(np.asarray(jimg), render(scene, cam, cfg2, device="cpu")[0].numpy())


def _kernel_case():
    from se195_raytracer_tpu.core.config import RenderConfig as JConfig

    jscene, jcam = _jax()
    scene, cam = _port()
    cfg1, cfg2 = (RenderConfig(spp=s, seed=5, **SIZE) for s in (1, 2))
    return jscene, jcam, JConfig(spp=1, seed=5, **SIZE), scene, cam, cfg1, cfg2


def test_jax_kernel_checkpoint_resumes_in_port(tmp_path):
    """kind "pallas": JAX's kernel state (``render_pallas`` in interpret mode,
    1 spp), saved by the JAX package, resumed in the port's K1 route (its
    plain version here) for 1 more spp, against the port's uninterrupted
    2 spp. The lane layouts agree (16 x 128 tiles)."""
    from se195_raytracer_tpu.driver import checkpoint as jck
    from se195_raytracer_tpu.kernels.pt_kernel import render_pallas

    jscene, jcam, jcfg, scene, cam, cfg1, cfg2 = _kernel_case()
    path = str(tmp_path / "k.npz")
    _, jst = render_pallas(jscene, jcam, jcfg, interpret=True)
    jck.save_render_state(path, jst)
    st = load_render_state(path, device="cpu")
    assert st[0].shape == (2048,) and st[2].shape == (3, 16, 128) and st[3] == 1
    img, st2 = render(scene, cam, cfg1, state=st, device="cpu")
    assert st2[3] == 2
    assert_smallpt_contract(img.numpy(), render(scene, cam, cfg2, device="cpu")[0].numpy())


def test_port_kernel_checkpoint_resumes_in_jax(tmp_path):
    """The port's K1 state after 1 spp, saved by the port, resumed by JAX's
    kernel (interpret mode) for 1 more spp, against the port's
    uninterrupted 2 spp."""
    from se195_raytracer_tpu.driver import checkpoint as jck
    from se195_raytracer_tpu.kernels.pt_kernel import render_pallas

    jscene, jcam, jcfg, scene, cam, cfg1, cfg2 = _kernel_case()
    path = str(tmp_path / "k.npz")
    _, pst = render(scene, cam, cfg1, device="cpu")
    save_render_state(path, pst)
    jimg, jst = render_pallas(jscene, jcam, jcfg, state=jck.load_render_state(path),
                              interpret=True)
    assert jst[3] == 2
    assert_smallpt_contract(np.asarray(jimg), render(scene, cam, cfg2, device="cpu")[0].numpy())


def test_device_inventory_has_jax_keys():
    from se195_raytracer_tpu.utils.metrics import device_inventory as j_inventory
    from se195_raytracer_tpu_torch.utils.metrics import device_inventory

    inv, jinv = device_inventory(), j_inventory()
    assert set(inv) == set(jinv)
    assert set(inv["devices"][0]) == set(jinv["devices"][0]) == {"id", "platform", "kind",
                                                                 "process"}
    assert inv["device_count"] >= 1 and inv["process_count"] == 1 and inv["process_index"] == 0
    if not torch.cuda.is_available():
        assert inv["backend"] == "cpu" and inv["devices"][0]["platform"] == "cpu"


@pytest.mark.parametrize("args", [(64, 64, 4, 0.5, 3), (800, 600, 8, 0.0123, None),
                                  (16, 8, 1, 0.0, None)])
def test_render_metrics_equal_jax(args):
    from se195_raytracer_tpu.utils.metrics import render_metrics as j_metrics
    from se195_raytracer_tpu_torch.utils.metrics import render_metrics

    assert render_metrics(*args) == j_metrics(*args)
    assert render_metrics(64, 64, 4, 0.5, pass_index=3)["rays_per_sec"] == 32768.0


def test_maybe_trace_writes_a_trace_on_cpu(tmp_path):
    from se195_raytracer_tpu_torch.utils.profiling import maybe_trace, span

    d = tmp_path / "prof"
    with maybe_trace(str(d)):
        with span("render"):
            render(*_port("simple"), RenderConfig(width=8, height=8, use_kernel=False),
                   device="cpu")
    trace = json.loads((d / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "render" in names
    with maybe_trace(""):  # off: nothing written
        pass


@pytest.mark.parametrize("shape", [(5, 7), (4, 8)])
def test_readers_read_jax_writers(tmp_path, shape):
    """read_bmp and read_ppm on files written by the JAX package's writers
    (odd widths pad BMP rows)."""
    from se195_raytracer_tpu.io import image as jimage
    from se195_raytracer_tpu_torch.io.image import read_bmp, read_ppm

    img = np.random.default_rng(3).integers(0, 256, size=shape + (3,), dtype=np.uint8)
    jimage.write_bmp(img, str(tmp_path / "a.bmp"))
    jimage.write_ppm(img, str(tmp_path / "a.ppm"))
    np.testing.assert_array_equal(read_bmp(str(tmp_path / "a.bmp")), img)
    np.testing.assert_array_equal(read_ppm(str(tmp_path / "a.ppm")), img)
    np.testing.assert_array_equal(read_ppm(str(tmp_path / "a.ppm")),
                                  jimage.read_ppm(str(tmp_path / "a.ppm")))
    with pytest.raises(ValueError, match="not a BMP"):
        read_bmp(str(tmp_path / "a.ppm"))


def test_render_image_returns_host_float32():
    from se195_raytracer_tpu_torch.driver.render import render_image

    img = render_image(*_port("simple"), RenderConfig(width=8, height=4), device="cpu")
    assert isinstance(img, np.ndarray) and img.dtype == np.float32 and img.shape == (4, 8, 3)


@pytest.mark.parametrize("integ", ["pt", "whitted", "whitted5"])
def test_bench_prints_jax_keys(capsys, tmp_path, integ):
    """``bench`` prints one JSON line with the JAX CLI's keys (smallpt:
    spp; the Whitted families: supersample), and --profile writes a
    trace."""
    from se195_raytracer_tpu_torch import cli

    prof = tmp_path / "prof"
    argv = ["bench", "--integrator", integ, "--width", "16", "--height", "8", "--spp", "1",
            "--supersample", "1", "--reps", "1", "--device", "cpu", "--profile", str(prof)]
    assert cli.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    size = {"spp"} if integ == "pt" else {"supersample"}
    assert set(rec) == {"scene", "width", "height", "integrator", "device", "elapsed_s",
                        "rays_per_sec"} | size
    assert rec["device"] == "cpu" and rec["rays_per_sec"] > 0
    assert os.path.exists(prof / "trace.json")

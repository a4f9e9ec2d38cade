"""The port stands alone: importing it (every submodule) and chip_smoke.py
loads neither jax nor any module of the JAX package, and its entry points
refuse to run on the CPU unless asked to."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import se195_raytracer_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "se195_raytracer_tpu"))
print(len(names), bad)
"""


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


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 30  # every module of the three slices was imported
    assert bad == "[]", f"port pulled in {bad}"


def test_entry_points_default_to_cuda():
    """device=None means CUDA: with no GPU present they raise rather than
    fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from se195_raytracer_tpu_torch import cli
    from se195_raytracer_tpu_torch.core.config import RenderConfig
    from se195_raytracer_tpu_torch.driver.render import render
    from se195_raytracer_tpu_torch.scenes.registry import get_scene

    spec = get_scene("cornell")
    scene, camera = spec.to_scene("cpu"), spec.to_camera("cpu")
    for use_kernel in (True, False):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            render(scene, camera, RenderConfig(width=8, height=8, use_kernel=use_kernel))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spec.to_scene()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["render", "--width", "8", "--height", "8", "--out", ""])

    # The sharded renders (a mesh of None is every CUDA device), the session
    # and render_image.
    from se195_raytracer_tpu_torch.driver.render import render_image
    from se195_raytracer_tpu_torch.driver.session import RenderSession
    from se195_raytracer_tpu_torch.parallel import render_sharded as rs
    from se195_raytracer_tpu_torch.scenes.whitted5_scenes import room5_scene
    from se195_raytracer_tpu_torch.scenes.whitted_scenes import WHITTED_SCENES

    cfg = RenderConfig(width=8, height=8)
    for fn in (rs.render_sharded, rs.render_cuda_sharded):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(scene, camera, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rs.render_whitted_sharded(WHITTED_SCENES["room"]("cpu"), 8, 8, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rs.render_whitted5_sharded(room5_scene("procedural", device="cpu"), 8, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RenderSession(scene, camera, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_image(scene, camera, cfg)


def test_cli_renders_on_cpu_when_asked(tmp_path):
    from se195_raytracer_tpu_torch import cli

    out = tmp_path / "c.png"
    argv = ["render", "--scene", "cornell", "--width", "16", "--height", "8",
            "--spp", "1", "--device", "cpu", "--out", str(out)]
    assert cli.main(argv) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    out = tmp_path / "w.png"
    argv = ["render", "--integrator", "whitted", "--width", "16", "--height", "12",
            "--supersample", "1", "--device", "cpu", "--out", str(out)]
    assert cli.main(argv) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    for extra in ([], ["--adaptive"]):
        out = tmp_path / f"w5{len(extra)}.png"
        argv = ["render", "--integrator", "whitted5", "--width", "16", "--height", "12",
                "--spp", "1", "--device", "cpu", "--out", str(out), *extra]
        assert cli.main(argv) == 0
        assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    # --soft renders the relaxed estimator on the plain tracer; the adaptive
    # renderer runs the hard estimator only and refuses it.
    assert cli.main(["render", "--integrator", "whitted5", "--width", "16", "--height", "12",
                     "--spp", "1", "--soft", "0.5", "--device", "cpu", "--out", ""]) == 0
    assert cli.main(["render", "--integrator", "whitted5", "--width", "16", "--height", "12",
                     "--soft", "0.5", "--adaptive", "--device", "cpu", "--out", ""]) != 0
    assert cli.main(["scenes"]) == 0

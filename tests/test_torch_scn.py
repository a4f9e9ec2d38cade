"""The port's `.scn` parser and writer (scenes/parser.py) against the JAX
package's on the fixture zoo, the CLI's ``--scene path.scn``, and the
shared-memory capacity of K2 and K3, which opt in past 48 KB since the
parser lets users load a scene of any size."""

import glob
import os

import numpy as np
import pytest
import torch

from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk
from se195_raytracer_tpu_torch.kernels import whitted_kernel as wk
from se195_raytracer_tpu_torch.scenes.generator import complex_scene
from se195_raytracer_tpu_torch.scenes.parser import load_scn, parse_scn, write_scn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = sorted(glob.glob(os.path.join(ROOT, "tests", "fixtures", "scenes", "*.scn")))
FIELDS = ("camera_orig", "camera_target", "radius", "center", "emission", "color", "refl")


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


def test_six_fixtures():
    assert [os.path.basename(p) for p in FIXTURES] == [
        "caustic.scn", "caustic3.scn", "complex.scn", "cornell_large.scn", "cornell_scn.scn",
        "simple.scn"]


@pytest.mark.parametrize("path", FIXTURES, ids=os.path.basename)
def test_parse_matches_jax_bitwise(path):
    from se195_raytracer_tpu.scenes.parser import load_scn as j_load_scn

    mine, theirs = load_scn(path), j_load_scn(path)
    for f in FIELDS:
        a, b = getattr(mine, f), np.asarray(getattr(theirs, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    with open(path) as fh:
        text = fh.read()
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(parse_scn(text), f), getattr(mine, f))


@pytest.mark.parametrize("path", FIXTURES, ids=os.path.basename)
def test_write_scn_roundtrip_and_matches_jax_writer(path, tmp_path):
    from se195_raytracer_tpu.scenes.parser import write_scn as j_write_scn

    spec = load_scn(path)
    out, jout = str(tmp_path / "a.scn"), str(tmp_path / "b.scn")
    write_scn(spec, out)
    j_write_scn(spec, jout)
    with open(out) as a, open(jout) as b:
        assert a.read() == b.read()
    back = load_scn(out)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(back, f), getattr(spec, f))


def test_generated_scene_roundtrips(tmp_path):
    """The 158-sphere fractal through write_scn and load_scn, bitwise (%.9g
    holds every float32)."""
    spec = complex_scene(max_depth=3.0)
    write_scn(spec, str(tmp_path / "c.scn"))
    back = load_scn(str(tmp_path / "c.scn"))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(back, f), getattr(spec, f))


@pytest.mark.parametrize("text, match", [
    ("camera 0 0 0  0 0 1\nsize 1\nsphere 1  0 0 0  0 0 0  1 1 1  3\n", "bad material 3"),
    ("camera 0 0 0  0 0 1\nsize 1\nball 1  0 0 0  0 0 0  1 1 1  0\n",
     "expected 'sphere' at token 9, got 'ball'"),
    ("camera 0 0 0  0 0 1\nsize 2\nsphere 1  0 0 0  0 0 0  1 1 1  0\n",
     "expected 'sphere' at token 21, got '<eof>'"),
    ("size 1\n", "expected 'camera' at token 0"),
])
def test_parse_errors_match_jax(text, match):
    from se195_raytracer_tpu.scenes.parser import parse_scn as j_parse_scn

    with pytest.raises(ValueError, match=match):
        parse_scn(text)
    with pytest.raises(ValueError, match=match):
        j_parse_scn(text)


def test_cli_renders_a_scn_file_on_cpu(tmp_path):
    from se195_raytracer_tpu_torch import cli
    from se195_raytracer_tpu_torch.io.image import read_ppm

    out = tmp_path / "scn.ppm"
    path = os.path.join(ROOT, "tests", "fixtures", "scenes", "cornell_scn.scn")
    assert cli.main(["render", "--scene", path, "--width", "16", "--height", "8", "--spp", "1",
                     "--device", "cpu", "--out", str(out)]) == 0
    img = read_ppm(str(out))
    assert img.shape == (8, 16, 3) and img.max() > 0
    # The registry's cornell_scn is the same scene: the same bytes.
    ref = tmp_path / "reg.ppm"
    assert cli.main(["render", "--scene", "cornell_scn", "--width", "16", "--height", "8",
                     "--spp", "1", "--device", "cpu", "--out", str(ref)]) == 0
    np.testing.assert_array_equal(img, read_ppm(str(ref)))


def test_cli_unknown_scene_exits(capsys):
    from se195_raytracer_tpu_torch import cli

    assert cli.main(["render", "--scene", "no_such_scene.scn", "--device", "cpu",
                     "--out", ""]) == 2
    err = capsys.readouterr().err
    assert "unknown scene 'no_such_scene.scn'" in err and "no such file" in err


def test_k2_shared_memory_capacity():
    """K2 takes the 3,908-sphere complex_scene(max_depth=5) (past the 48 KB
    it held before its opt-in) and every scene up to the 227 KB a block may
    hold on sm_90; the first sphere count past that raises, naming it.
    complex_scene(max_depth=6)'s 19,533 spheres stay refused."""
    n5 = len(complex_scene(max_depth=5.0).radius)
    assert n5 == 3908
    assert ptk.k2_shared_memory_bytes(n5, 1) > 48 * 1024
    last = max(n for n in range(11000, 13000) if _k2_fits(n))
    assert ptk.k2_shared_memory_bytes(last, 1) <= 227 * 1024
    with pytest.raises(ValueError, match=f"{last + 1} spheres"):
        ptk.k2_shared_memory_bytes(last + 1, 1)
    assert last == 12073
    with pytest.raises(ValueError, match="19533 spheres"):
        ptk.k2_shared_memory_bytes(19533, 1)


def _k2_fits(n):
    try:
        ptk.k2_shared_memory_bytes(n, 1)
    except ValueError:
        return False
    return True


def test_k3_shared_memory_capacity():
    """K3's entries take scenes past the 48 KB they held before their opt-in
    (~500 primitives), up to 227 KB: 2,526 primitives through the
    explicit-ray entry and 2,493 through the 3x3 frame entry (which also
    holds its block's ray colours); one more raises, naming the count."""
    frame = 3 * wk.pixels_per_block(3) * 9
    assert wk.shared_memory_bytes(1000, frame) > 48 * 1024
    assert wk.shared_memory_bytes(2526) <= 227 * 1024
    with pytest.raises(ValueError, match="2527 primitives"):
        wk.shared_memory_bytes(2527)
    assert wk.shared_memory_bytes(2493, frame) <= 227 * 1024
    with pytest.raises(ValueError, match="2494 primitives"):
        wk.shared_memory_bytes(2494, frame)


def test_k2_route_takes_the_3908_sphere_scene_on_cpu():
    """K2's wrapper on CPU tensors (its plain version) renders the 3,908-
    sphere scene at a few pixels: the capacity check is the card's only."""
    from se195_raytracer_tpu_torch.core.config import RenderConfig

    spec = complex_scene(max_depth=5.0)
    img, _ = ptk.render_cuda(spec.to_scene("cpu"), spec.to_camera("cpu"),
                             RenderConfig(width=8, height=4, spp=1, max_depth=2), device="cpu")
    assert img.shape == (4, 8, 3) and torch.isfinite(img).all()

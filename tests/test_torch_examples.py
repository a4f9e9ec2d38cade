"""The port's examples run end to end on the CPU at a small size:
examples/whitted5_texture_recovery_torch.py (two Adam steps at 32 x 24, the
loss falls) and examples/inverse_rendering_torch.py (one step at 16 x 16,
both parameters move towards the truth, the three images are written)."""

import importlib.util
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several pytest workers
    at once, whose OpenMP teams otherwise stall each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_texture_recovery_example_on_cpu(tmp_path, capsys):
    out = _example("whitted5_texture_recovery_torch").main(
        ["--size", "32", "--steps", "2", "--device", "cpu", "--out-prefix", str(tmp_path / "tr")])
    assert out["device"] == "cpu" and len(out["losses"]) == 2
    assert out["losses"][1] < out["losses"][0], out["losses"]
    assert 0.05 < out["seen_frac"] < 1.0
    assert out["grad0"].shape == out["true"].shape and bool(torch.isfinite(out["grad0"]).all())
    printed = capsys.readouterr().out
    assert "of floor texels are camera-visible" in printed and "seen-texel MAE:" in printed
    for name in ("true", "recovered"):
        with open(tmp_path / f"tr_{name}.png", "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_inverse_rendering_example_on_cpu(tmp_path):
    out = _example("inverse_rendering_torch").main(
        ["--size", "16", "--steps", "1", "--device", "cpu", "--outdir", str(tmp_path)])
    assert out["err_center"] < 8.0 and out["err_color"] < 0.45, out
    assert out["loss"] == pytest.approx(out["loss0"], rel=1e-6)  # the loss before the update
    for tag in ("target", "init", "final"):
        assert (tmp_path / f"inverse_{tag}.png").stat().st_size > 0

"""A rehearsal of ``run.py``'s control flow on the CPU at a tiny frame,
through ``harness.runner.run_cell`` (the timed command never runs on the
CPU: it refuses without a card). The control and the faults a run can
have, planted in the program underneath, must each turn ``correct``
false under the cell's own limits."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from harness.manifest import BENCH_DIR, ROOT, Manifest
from harness.runner import emit, run_cell

CELLS = sorted(Manifest().cells)
SEED = 2**31 + 977


def tiny(cell):
    """A 16x16 frame at the cell's own samples a pixel."""
    if "grad" in cell:
        return {"width": 16, "height": 16, "restart_every": 4,
                "check": {"steps": 2, "block": 256}}
    return {"width": 16, "height": 16, "check": {"renders": 2, "pixels": 128, "block": 256}}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_run_on_the_cpu(cell, trace, capsys):
    res = run_cell(cell, SEED, 0.3, trace, device="cpu", overrides=tiny(cell))
    assert res["correct"] and res["attempted"] >= 1 and res["failed"] == 0
    man = Manifest()
    want = man.per_layer_for(cell) if trace else man.end_to_end_for(cell)
    assert set(res["metrics"]) <= {m["name"] for m in want}
    if not trace:
        assert set(res["metrics"]) == {m["name"] for m in want}
        assert all(m["value"] > 0 for m in res["metrics"].values())
    else:
        assert res["device"]["window_s"] > 0 and "breakdown" in res
    assert list(res)[-1] == "checked"
    emit(res)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert err.strip().splitlines()[-1].split()[0] == list(res["checked"])[-1]


def test_the_timed_command_refuses_without_a_card():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, timeout=300)
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]


def test_the_timed_command_fails_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]


# The faults, each planted in the program underneath the timed path.

def _render_fault(kind):
    from se195_raytracer_tpu_torch.driver import render as mod

    original = mod.render

    def broken(scene, camera, config, state=None, device=None):
        if kind == "unchanged":  # the state returned as it started
            img, st = original(scene, camera, dataclasses.replace(config, spp=1), state, device)
            return torch.zeros_like(img), st
        if kind == "half_samples":  # half of the passes, the mean over them
            config = dataclasses.replace(config, spp=config.spp // 2)
        if kind == "answer_altered":  # another seed's samples
            config = dataclasses.replace(config, seed=config.seed + 1)
        return original(scene, camera, config, state, device)

    return mod, "render", broken


def _grad_fault(kind):
    from se195_raytracer_tpu_torch.driver import grad_check, optimize

    if kind == "unchanged":  # the step leaves the parameters as they were
        def step(self):
            self.count += 1

        return grad_check.GroupAdam, "step", step

    def half_rows(scene, camera, target, config, device=None):  # half the pixels
        img = optimize.render_differentiable(scene, camera, config, device=device)
        h = config.height // 2
        return torch.mean((img[:h] - target[:h]) ** 2)

    return optimize, "l2_image_loss", half_rows


FAULTS = [(c, k) for c in CELLS if "render" in c
          for k in ("unchanged", "half_samples", "answer_altered")]
FAULTS += [(c, k) for c in CELLS if "grad" in c for k in ("unchanged", "half_rows")]


@pytest.mark.parametrize("cell,kind", FAULTS)
def test_a_fault_underneath_fails_the_check(cell, kind, monkeypatch):
    target, name, broken = (_grad_fault if "grad" in cell else _render_fault)(kind)
    monkeypatch.setattr(target, name, broken)
    res = run_cell(cell, SEED + 1, 0.3, False, device="cpu", overrides=tiny(cell))
    assert not res["correct"], res["checked"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_check(cell):
    """The control, the reference in bfloat16 in the program's place, fails
    one of the cell's numbers at its own limit (here at a tiny frame; on
    the card at the cell's own size, ``control.py``)."""
    import control

    man = Manifest()
    c = man.cell(cell)
    traffic = {**man.traffic(c), **tiny(cell)}
    job = man.driver(traffic).Job(man.config(c), traffic, SEED + 2, torch.device("cpu"))
    job.setup()
    if "grad" in cell:
        job.first_in_window = job.steps
        reading = control.grad_readings(job, True)
        over = [k for k, lim in traffic["limits"].items() if reading[f"bfloat16.{k}"] > lim]
        sound = [k for k, lim in traffic["limits"].items() if reading[f"sound.{k}"] > lim]
    else:
        job.window(0.2, __import__("harness.trace", fromlist=["Spans"]).Spans())
        reading = control.render_readings(job, True)
        over = ["image_gap"] if reading["bfloat16"] > traffic["limits"]["image_gap"] else []
        sound = ["image_gap"] if reading["sound"] > traffic["limits"]["image_gap"] else []
    assert over and not sound, reading

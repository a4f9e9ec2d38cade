"""The ``room3.whitted.ss3`` cell on the CPU: the control and the faults a
run can have (a tree one level short and an image left unchanged, planted
in the program's ``render_whitted``; the pose of the seed one off) each turn
``correct`` false at the cell's own limit; a program whose ``render_whitted``
takes no camera fails at once; K3's roofline counts repeat for a seed, are
the program's own live-work count, and charge the program's records'
constants."""

import dataclasses
import re

import pytest
import torch

from harness.manifest import Manifest
from harness.runner import run_cell
from harness.trace import Spans
from reference import whitted as refw

CELL = "room3.whitted.ss3"
SEED = 2**31 + 979
TINY = {"width": 16, "height": 12, "check": {"renders": 2, "pixels": 96, "block": 64}}


def _job(seed):
    man = Manifest()
    cell = man.cell(CELL)
    traffic = {**man.traffic(cell), **TINY}
    return man.driver(traffic), man.config(cell), traffic


@pytest.mark.parametrize("kind", ["unchanged", "depth_one_short", "pose_one_off"])
def test_a_fault_fails_the_check(kind, monkeypatch):
    from se195_raytracer_tpu_torch.models import whitted as mod

    original = mod.render_whitted

    def broken(scene, config, device=None, *, camera=None):
        if kind == "unchanged":  # the image as it started
            return torch.zeros_like(original(scene, config, device, camera=camera))
        # a tree one level short
        config = dataclasses.replace(config, trace_depth=config.trace_depth - 1)
        return original(scene, config, device, camera=camera)

    if kind == "pose_one_off":  # the render of the pose the seed one off draws
        driver = _job(SEED)[0]
        one = driver.Job.one
        monkeypatch.setattr(driver.Job, "one",
                            lambda self, seed, spans: one(self, seed + 1, spans))
    else:
        monkeypatch.setattr(mod, "render_whitted", broken)
    res = run_cell(CELL, SEED, 0.3, False, device="cpu", overrides=TINY)
    assert not res["correct"], res["checked"]


def test_the_control_and_the_readings_faults_fail_the_check():
    """``control.py``'s readings at a tiny frame: the sound run within the
    limit; the bfloat16 reference, the seed one off, a 2x2 grid in place of
    the 3x3 (its ``half_samples``) and the image unchanged beyond it."""
    import control

    driver, config, traffic = _job(SEED + 2)
    job = driver.Job(config, traffic, SEED + 2, torch.device("cpu"))
    job.setup()
    job.window(0.2, Spans())
    reading = control.render_readings(job, True)
    limit = traffic["limits"]["image_gap"]
    assert reading["sound"] <= limit, reading
    for k in ("bfloat16", "seed_off_by_one", "half_samples", "unchanged"):
        assert not reading[k] <= limit, (k, reading)


def test_a_program_without_a_camera_fails_at_once(monkeypatch):
    """The parent of this cell's program: ``render_whitted`` takes no
    ``camera``; set-up's first render raises."""
    from se195_raytracer_tpu_torch.models import whitted as mod

    original = mod.render_whitted
    monkeypatch.setattr(mod, "render_whitted",
                        lambda scene, config, device=None: original(scene, config, device))
    with pytest.raises(TypeError):
        run_cell(CELL, SEED, 0.3, False, device="cpu", overrides=TINY)


def _inputs(seed, width=12, height=9):
    driver, config, traffic = _job(seed)
    frame = driver.frame_of(config, {"width": width, "height": height})
    return {"config": config, "frame": frame, "seed": seed, "walk": traffic["camera_walk"],
            "device": torch.device("cpu")}


def test_k3_counts_repeat_exactly_for_a_seed():
    k3 = Manifest().roofline("k3")
    a = k3.count(_inputs(2**35 + 3))
    b = k3.count(_inputs(2**35 + 3))
    c = k3.count(_inputs(2**35 + 4))
    assert a == b and a != c


def test_k3_counts_are_the_programs_live_work():
    """The reference's count is the port's plain tracer's own ``work`` on the
    same render (K3 traces what it counts)."""
    from se195_raytracer_tpu_torch.models import whitted as P

    drv = _job(91)[0]
    inp = _inputs(91)
    f = inp["frame"]
    row = refw.camera_row(*refw.pose(91, inp["walk"]))
    got = refw.count_work(refw.make_scene(inp["config"]["scene"], "cpu"), f, row, "cpu")
    want = {}
    P.render_whitted_scene(drv.port_scene(inp["config"]["scene"], "cpu"), f.width, f.height,
                           f.supersample, f.trace_depth, f.hit_bias,
                           cam_row=torch.from_numpy(row), work=want)
    assert got == want
    assert got["nodes"] > f.width * f.height * f.spp and got["shadow_tests"] > 0


def test_k3_counts_charge_the_records_constants():
    """``chip_smoke.py``'s ``W_OPS_*`` and its sum: at the room (6 planes, 10
    spheres, 3 of them lights) a node's sweep and its own work are 6 x 15 +
    10 x 20 + 40 = 330 operations."""
    k3 = Manifest().roofline("k3")
    assert (k3.W_OPS_PLANE, k3.W_OPS_SPHERE, k3.W_OPS_LIGHT, k3.W_OPS_NODE) == (15, 20, 45, 40)
    inp = _inputs(5)
    scene = refw.make_scene(inp["config"]["scene"], "cpu")
    work = {"nodes": 7, "hit_nodes": 5, "shadow_tests": 11}
    assert k3.ops(scene.ptype, scene.is_light, work) == 7 * 330 + 5 * 3 * 45 + 11 * 15
    ops, nbytes = k3.count(inp)
    assert nbytes == 12 * 9 * 12 + 18 * 4 * 16
    row = refw.camera_row(*refw.pose(5, inp["walk"]))
    assert ops == k3.ops(scene.ptype, scene.is_light,
                         refw.count_work(scene, inp["frame"], row, "cpu"))


def test_kernel_names_match_k3s_frame_kernel_only():
    names = {
        "k3": "(anonymous namespace)::whitted_frame_kernel(float const*, int const*, int, float, "
              "int, float const*, int, int, int, float, float, float, float, float, float*)",
        "rays": "(anonymous namespace)::whitted_rays_kernel(float const*, int const*, int, "
                "float, int, float const*, float*, int)",
        "taps": "void (anonymous namespace)::whitted_taps_kernel<2>(float const*, int const*, "
                "int const*, int, int, int, float, float const*, float*, int, int*)",
        "k4": "(anonymous namespace)::whitted5_kernel(float const*, float const*, int const*, "
              "int, uint4 const*)",
    }
    mod = Manifest().roofline("k3")
    for other, name in names.items():
        assert any(re.search(p, name) for p in mod.NAMES) == (other == "k3"), other

"""The ``room5.whitted5.spp64`` cell on the CPU: the faults a run can have,
planted in the program's ``render_whitted5`` underneath the timed path,
each turn ``correct`` false at the cell's own limit; K4's roofline counts
repeat for a seed, are the program's own live-work count, and charge the
program's records' constants."""

import pytest
import torch

from harness.manifest import Manifest
from harness.runner import run_cell
from reference import whitted5 as ref5

CELL = "room5.whitted5.spp64"
SEED = 2**31 + 978
TINY = {"width": 16, "height": 16, "check": {"renders": 2, "pixels": 128, "block": 256}}


def _fault(kind):
    from se195_raytracer_tpu_torch.models import whitted5 as mod

    original = mod.render_whitted5

    def broken(scene, width, height, spp=1, trace_depth=4, seed=0, **kw):
        if kind == "unchanged":  # the image as it started
            img = original(scene, width, height, 1, trace_depth, seed, **kw)
            return torch.zeros_like(img)
        if kind == "half_samples":  # half of the passes, the mean over them
            spp //= 2
        if kind == "answer_altered":  # another seed's samples
            seed += 1
        return original(scene, width, height, spp, trace_depth, seed, **kw)

    return mod, broken


@pytest.mark.parametrize("kind", ["unchanged", "half_samples", "answer_altered"])
def test_a_fault_underneath_fails_the_check(kind, monkeypatch):
    mod, broken = _fault(kind)
    monkeypatch.setattr(mod, "render_whitted5", broken)
    res = run_cell(CELL, SEED, 0.3, False, device="cpu", overrides=TINY)
    assert not res["correct"], res["checked"]


def _inputs(seed, size=12, spp=2):
    man = Manifest()
    cell = man.cell(CELL)
    config = man.config(cell)
    frame = man.driver(man.traffic(cell)).frame_of(config, {"width": size, "height": size,
                                                            "spp": spp})
    return {"config": config, "frame": frame, "seed": seed, "device": torch.device("cpu")}


def test_k4_counts_repeat_exactly_for_a_seed():
    k4 = Manifest().roofline("k4")
    a = k4.count(_inputs(2**35 + 3))
    b = k4.count(_inputs(2**35 + 3))
    c = k4.count(_inputs(2**35 + 4))
    assert a == b and a != c


def test_k4_counts_are_the_programs_live_work():
    """The reference's count is the port's plain tracer's own ``work`` on the
    same render (K4 traces what it counts)."""
    from se195_raytracer_tpu_torch.models import whitted5 as P

    drv = Manifest().driver({"kind": "whitted5_loop"})
    inp = _inputs(91)
    f = inp["frame"]
    scene = ref5.make_scene(inp["config"]["scene"], "cpu")
    got = ref5.count_work(scene, f, 91, "cpu")
    want = {}
    P.render_whitted5(drv.port_scene(inp["config"]["scene"], "cpu"), f.width, f.height, spp=f.spp,
                      trace_depth=f.trace_depth, seed=91, use_kernel=False, device="cpu",
                      work=want)
    assert got == {k: want[k] for k in got}
    assert got["texels"] > 0 and got["glossy"] > 0 and got["shadow_sweeps_used"] > 0


def test_k4_counts_charge_the_records_constants():
    """``chip_smoke.py``'s ``W5_OPS_*`` and ``w5_work_ops``: at room5 (3
    spheres, 3 planes, 5 boxes, 3 of them lights) a sweep is 20 x 3 + 15 x 3
    + 120 x 5 = 705 operations."""
    k4 = Manifest().roofline("k4")
    assert (k4.W5_OPS_SPHERE, k4.W5_OPS_PLANE, k4.W5_OPS_BOX, k4.W5_OPS_NODE, k4.W5_OPS_LIGHT,
            k4.W5_OPS_SAMPLE, k4.W5_OPS_TEXEL, k4.W5_OPS_GLOSSY) == (20, 15, 120, 60, 45, 40, 60,
                                                                      50)
    inp = _inputs(5)
    scene = ref5.make_scene(inp["config"]["scene"], "cpu")
    work = {"nodes": 7, "lit": 5, "shadow_sweeps_used": 11, "texels": 3, "glossy": 2}
    assert k4.ops(scene.ptype, scene.is_light, work) == (7 * (705 + 60) + 5 * 3 * 45
                                                         + 11 * (705 + 40) + 3 * 60 + 2 * 50)
    ops, nbytes = k4.count(inp)
    assert nbytes == 12 * 12 * (24 + 8 + 12) + 4 * 2 * 64 * 64 * 3
    assert ops == k4.ops(scene.ptype, scene.is_light,
                         ref5.count_work(scene, inp["frame"], 5, "cpu"))


def test_kernel_names_match_k4_only():
    import re

    names = {
        "k4": "(anonymous namespace)::whitted5_kernel(float const*, float const*, int const*, "
              "int, uint4 const*)",
        "k5": "(anonymous namespace)::texel_fetch_kernel(uint4 const*, int4 const*)",
        "k1": "void (anonymous namespace)::pt_pass_kernel<false, 0, false>(float const*, int)",
    }
    mod = Manifest().roofline("k4")
    for other, name in names.items():
        assert any(re.search(p, name) for p in mod.NAMES) == (other == "k4"), other

"""The roofline functions: a frozen copy of the program's records' work
counts. They repeat exactly, keep the records' constants, and reproduce
the records' K1b counts and the program's own culled-sweep counter."""

import json

import pytest
import torch

from harness.manifest import BENCH_DIR, Manifest
from reference import scenes
from reference import smallpt as ref
from reference import work


def inputs(name, size, spp, seed, cut=None):
    cfg = json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())
    a = scenes.build(cfg["scene"])
    if cut:
        a = {k: v[:cut] for k, v in a.items()}
    return {"arrays": a, "cam": scenes.camera(cfg), "frame": ref.Frame(size, size, spp),
            "seed": seed, "device": torch.device("cpu")}


def test_counts_repeat_exactly_for_a_seed():
    man = Manifest()
    for kernel, name, cut in (("k1", "cornell", None), ("k1b", "cornell", None),
                              ("k2", "complex783", 120)):
        mod = man.roofline(kernel)
        a = mod.count(inputs(name, 12, 2, 2**35 + 3, cut))
        b = mod.count(inputs(name, 12, 2, 2**35 + 3, cut))
        c = mod.count(inputs(name, 12, 2, 2**35 + 4, cut))
        assert a == b and a != c, kernel


def test_k1_and_k2_charge_the_records_constants():
    man = Manifest()
    k1, k2 = man.roofline("k1"), man.roofline("k2")
    # chip_smoke.ops_per_bounce: 15 N + lights (12 N + 45) + 70 at Cornell.
    assert k1.ops_per_bounce(9, 1) == 15 * 9 + (12 * 9 + 45) + 70 == 358
    assert (k1.OPS_CAMERA, k1.STATE_BYTES_PER_LANE) == (25, 40)
    assert (k2.OPS_CAMERA, k2.OPS_SHADE, k2.OPS_SHADOW_SETUP, k2.OPS_SPHERE_NEAREST,
            k2.OPS_SPHERE_SHADOW, k2.OPS_BOUND, k2.STATE_BYTES_PER_LANE) == (25, 70, 45, 15, 12,
                                                                             14, 40)
    f = ref.Frame(512, 512, 8)
    assert k1.lanes(f) == k2.lanes(f) == 512 * 512


def test_k2_counts_are_the_programs_culled_sweep_yardstick():
    """``reference.work.k2`` against the program's own counter
    (``culled_work_counter``) on the same lanes, a 120-sphere cut of
    complex783 at 12x12, 2 spp."""
    from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk

    inp = inputs("complex783", 12, 2, 99, 120)
    got = work.k2(inp)
    a = inp["arrays"]
    scene = ref.make_scene(a, "cpu")
    tab = torch.cat([scene.center.T, scene.radius[None], scene.emission.T, scene.color.T,
                     scene.refl.float()[None],
                     torch.zeros(1, scene.center.shape[0]).index_fill_(
                         1, torch.tensor(scene.lights), 1.0)]).contiguous()
    hook, want = ptk.culled_work_counter(tab)
    o, t = (torch.tensor(v) for v in inp["cam"])
    frame = inp["frame"]
    ref.render_pixels(scene, ref.camera_basis(o, t, 12, 12), frame, 99,
                      ref.all_pixels(frame, "cpu"), on_sweep=hook)
    assert got == {k: want[k] for k in got}


RECORD_REPLAY, RECORD_ADJOINT = 9.43156e8, 6.69533e8


def k1b_split(device):
    k1b = Manifest().roofline("k1b")
    inp = inputs("cornell", 512, 2, 0)
    inp["device"] = device
    return k1b.split(work.k1b(inp), inp)


def test_k1b_counts_reproduce_the_records_at_cornell_512_spp2():
    """PR 11's counts at Cornell 512x512, spp 2, seed 0 (chip_smoke.py's
    k1b_bound, counted on the card): replay 9.43156e8 operations, reverse
    sweep 6.69533e8. On the CPU the plain path's cos and sin differ from the
    card's by ulps, which sends a few of 1.37 M shadow rays another way
    (67 lit samples and 3 bounces here): 7e-6 of the count."""
    torch.set_num_threads(max(torch.get_num_threads(), 4))
    replay, adjoint, nbytes = k1b_split(torch.device("cpu"))
    assert replay == pytest.approx(RECORD_REPLAY, rel=2e-5)
    assert adjoint == pytest.approx(RECORD_ADJOINT, rel=2e-5)
    assert nbytes == 20 * 512 * 512 + 4 * (10 * 9 + 12) + 4 * 12 * 9


@pytest.mark.cuda
def test_k1b_counts_reproduce_the_records_on_the_card(cuda_device):
    replay, adjoint, _ = k1b_split(cuda_device)
    assert f"{replay:.5e}" == f"{RECORD_REPLAY:.5e}"
    assert f"{adjoint:.5e}" == f"{RECORD_ADJOINT:.5e}"


@pytest.mark.parametrize("kernel", ["k1", "k2", "k1b"])
def test_kernel_names_match_the_programs_kernels(kernel):
    """The trace's demangled names of the program's kernels, as CUPTI gives
    them, each matched by its own kernel's pattern only."""
    names = {
        "k1": "void (anonymous namespace)::pt_pass_kernel<false, 0, false>(float const*, int)",
        "k2": "void (anonymous namespace)::pt_pass_kernel<false, 0, true>(float const*, int)",
        "k1b": "void (anonymous namespace)::pt_backward_kernel<false, 0>(float const*, int)",
    }
    import re

    mod = Manifest().roofline(kernel)
    for other, name in names.items():
        hit = any(re.search(p, name) for p in mod.NAMES)
        assert hit == (other == kernel), (kernel, other)

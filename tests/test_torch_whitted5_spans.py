"""The whitted5 renderers' spans (``utils/profiling.span``): under a
profiler session each render is one ``w5.render`` root holding the ray
lookup, the counter state and the trace's launch, the adaptive render's
root its two phases on the device too; a session changes no image; on the
card K4's table lookup lies inside the launch and builds only once a
scene."""

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from se195_raytracer_tpu_torch.models import whitted5 as P
from se195_raytracer_tpu_torch.scenes.whitted5_scenes import room5_scene

W, H = 16, 12


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spans(prof):
    """(name, start, end) of the session's ``w5.*`` spans on the host, in
    start order."""
    out = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.name.startswith("w5.") and e.device_type == DeviceType.CPU]
    return sorted(out, key=lambda s: s[1])


def _inside(spans, root, name):
    return [s for s in spans if s[0] == name and root[1] <= s[1] and s[2] <= root[2]]


def test_two_renders_give_two_roots_each_holding_its_layers():
    scene = room5_scene("procedural", device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for seed in (1, 2):
            P.render_whitted5(scene, W, H, spp=1, trace_depth=2, seed=seed, device="cpu")
    spans = _spans(prof)
    roots = [s for s in spans if s[0] == "w5.render"]
    assert len(roots) == 2 and roots[0][2] <= roots[1][1]
    for root in roots:
        for name in ("w5.rays", "w5.state", "w5.launch"):
            assert len(_inside(spans, root, name)) == 1, (name, spans)
    # K4's tables are a CUDA-only step; the adaptive phases are not run.
    assert not [s for s in spans if s[0] in ("w5.tables", "w5.select", "w5.blend")]


def test_the_4ray_render_is_one_root():
    scene = room5_scene("procedural", device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        P.render_whitted5_4ray(scene, W, H, trace_depth=2, seed=3, device="cpu")
    spans = _spans(prof)
    (root,) = [s for s in spans if s[0] == "w5.render"]
    for name in ("w5.rays", "w5.state", "w5.launch"):
        assert len(_inside(spans, root, name)) == 1, (name, spans)


def test_the_adaptive_render_is_one_root_holding_its_phases():
    scene = room5_scene("procedural", device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        P.render_whitted5_adaptive(scene, W, H, trace_depth=2, seed=3, device="cpu")
    spans = _spans(prof)
    (root,) = [s for s in spans if s[0] == "w5.render"]
    for name, count in (("w5.rays", 1), ("w5.state", 1), ("w5.launch", 2), ("w5.select", 1),
                        ("w5.blend", 1)):
        assert len(_inside(spans, root, name)) == count, (name, spans)
    (select,) = _inside(spans, root, "w5.select")
    (blend,) = _inside(spans, root, "w5.blend")
    first, extra = _inside(spans, root, "w5.launch")
    assert first[2] <= select[1] and select[2] <= extra[1] and extra[2] <= blend[1]


def test_a_session_changes_no_image():
    scene = room5_scene("procedural", device="cpu")
    calls = (lambda: P.render_whitted5(scene, W, H, spp=2, trace_depth=3, seed=7, device="cpu"),
             lambda: P.render_whitted5_adaptive(scene, W, H, trace_depth=2, seed=7,
                                                device="cpu")[0])
    for call in calls:
        plain = call()
        with profile(activities=[ProfilerActivity.CPU]):
            traced = call()
        assert torch.equal(plain, traced)


@pytest.mark.cuda
def test_on_the_card_k4s_tables_lie_inside_the_launch_and_build_once():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = room5_scene("procedural", device="cuda")  # fresh tensors: its first render builds
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for seed in (1, 2):
            P.render_whitted5(scene, 160, 120, spp=1, seed=seed, device="cuda")
        torch.cuda.synchronize()
    spans = _spans(prof)
    roots = [s for s in spans if s[0] == "w5.render"]
    assert len(roots) == 2
    for i, root in enumerate(roots):
        (launch,) = _inside(spans, root, "w5.launch")
        (tables,) = _inside(spans, launch, "w5.tables")
        assert len(_inside(spans, tables, "w5.tables.build")) == (1 if i == 0 else 0)

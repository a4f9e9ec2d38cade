"""The port's spans (``utils/profiling.span``), on the CPU: nothing recorded
and no ``record_function`` entered without a profiler session; under one,
a render, K2's table lookup and an inverse step each open the spans of
their layers, nested by time; and a profiler session changes no image and
no gradient."""

import dataclasses
import json

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from se195_raytracer_tpu_torch.core.config import RenderConfig
from se195_raytracer_tpu_torch.driver.optimize import (OptState, make_inverse_step,
                                                       render_differentiable)
from se195_raytracer_tpu_torch.kernels import pt_kernel as ptk
from se195_raytracer_tpu_torch.scenes.registry import get_scene
from se195_raytracer_tpu_torch.utils import profiling

CFG = RenderConfig(width=8, height=8, spp=2, seed=11)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cornell():
    spec = get_scene("cornell")
    return spec.to_scene("cpu"), spec.to_camera("cpu")


def _spans(prof, prefix=("pt.", "opt.", "k1b.")):
    """(name, start, end) of the session's program spans on the host, in
    start order (with CUDA activity a range also has a mirror on the
    device's timeline)."""
    out = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.name.startswith(prefix) and e.device_type == DeviceType.CPU]
    return sorted(out, key=lambda s: s[1])


def _inside(spans, root, name):
    return [s for s in spans if s[0] == name and root[1] <= s[1] and s[2] <= root[2]]


def test_without_a_session_a_span_is_the_shared_null_context(monkeypatch):
    def entered(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler session")

    monkeypatch.setattr(torch.profiler, "record_function", entered)
    assert not torch._C._autograd._profiler_enabled()
    assert profiling.span("pt.render") is profiling.span("opt.step")
    scene, camera = _cornell()
    img, _ = ptk.render_cuda(scene, camera, CFG, device="cpu")
    assert img.shape == (8, 8, 3)


def test_the_clis_profile_trace_holds_the_render_spans(tmp_path):
    """``render --profile DIR`` writes a Chrome trace holding the render's
    root and its layers."""
    from se195_raytracer_tpu_torch import cli

    prof = tmp_path / "prof"
    argv = ["render", "--scene", "cornell", "--width", "8", "--height", "8", "--spp", "1",
            "--device", "cpu", "--out", str(tmp_path / "x.ppm"), "--profile", str(prof)]
    assert cli.main(argv) == 0
    trace = json.loads((prof / profiling.TRACE_FILE).read_text())
    names = [e.get("name") for e in trace["traceEvents"]]
    for name in ("pt.render", "pt.seed", "pt.pack_scene", "pt.camera", "pt.gather"):
        assert names.count(name) >= 1, name


def test_two_renders_give_two_roots_each_holding_its_layers():
    scene, camera = _cornell()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for seed in (1, 2):
            ptk.render_cuda(scene, camera, dataclasses.replace(CFG, seed=seed), device="cpu")
    spans = _spans(prof)
    roots = [s for s in spans if s[0] == "pt.render"]
    assert len(roots) == 2 and roots[0][2] <= roots[1][1]
    for root in roots:
        for name in ("pt.seed", "pt.pack_scene", "pt.camera", "pt.gather"):
            assert len(_inside(spans, root, name)) == 1, (name, spans)
    # K1's launch and K2's tables are CUDA-only steps.
    assert not [s for s in spans if s[0] in ("pt.launch", "pt.k2_tables")]


def test_k2_tables_build_once_a_table_and_again_after_a_write():
    """K2's tables of one scene, looked up as a render looks them up
    (through ``scene_table``): two lookups open two ``pt.k2_tables`` and one
    ``pt.k2_tables.build``; after a write to the scene's centers the next
    lookup builds again."""
    scene, _ = _cornell()

    def lookup():
        return ptk._k2_tables(ptk.scene_table(scene), scene.light_indices)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        first = lookup()
        again = lookup()
    names = [s[0] for s in _spans(prof)]
    assert names.count("pt.k2_tables") == 2 and names.count("pt.k2_tables.build") == 1
    assert all(a is b for a, b in zip(first, again))
    scene.center.mul_(1.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lookup()
    names = [s[0] for s in _spans(prof)]
    assert names.count("pt.k2_tables") == 1 and names.count("pt.k2_tables.build") == 1


def _adam(trainable):
    return torch.optim.Adam(list(trainable.values()), lr=1e-2)


def _step_once(profiled):
    """One Adam step of an L2 image loss from the spheres moved down, with or
    without a profiler session: (session or None, the step's state, the
    leaves' gradients)."""
    scene, camera = _cornell()
    with torch.no_grad():
        target = render_differentiable(scene, camera, CFG, device="cpu")
    start = dataclasses.replace(scene, center=scene.center + torch.tensor([0.0, -2.0, 0.0]))
    step = make_inverse_step(target, dataclasses.replace(CFG, seed=5), _adam,
                             lambda name: name in ("center", "color"), device="cpu")
    st0 = OptState(start, camera, None, None)
    prof = None
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            st = step(st0)
    else:
        st = step(st0)
    grads = [p.grad.clone() for g in st.opt_state.param_groups for p in g["params"]]
    return prof, st, grads


def test_an_inverse_step_holds_forward_backward_and_update():
    prof, _, _ = _step_once(True)
    spans = _spans(prof)
    roots = [s for s in spans if s[0] == "opt.step"]
    assert len(roots) == 1
    for name in ("opt.forward", "opt.backward", "opt.update"):
        assert len(_inside(spans, roots[0], name)) == 1, (name, spans)
    fwd = _inside(spans, roots[0], "opt.forward")[0]
    assert len(_inside(spans, fwd, "pt.render")) == 1


def test_a_session_changes_no_image_and_no_gradient():
    scene, camera = _cornell()
    plain, _ = ptk.render_cuda(scene, camera, CFG, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        traced, _ = ptk.render_cuda(scene, camera, CFG, device="cpu")
    assert torch.equal(plain, traced)
    _, st_a, g_a = _step_once(False)
    _, st_b, g_b = _step_once(True)
    assert torch.equal(st_a.loss, st_b.loss)
    assert all(torch.equal(a, b) for a, b in zip(g_a, g_b))
    assert torch.equal(st_a.scene.center, st_b.scene.center)
    assert torch.equal(st_a.scene.color, st_b.scene.color)


def _card_session(fn):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


@pytest.mark.cuda
def test_on_the_card_k1b_spans_lie_inside_the_steps_backward():
    """On the card the backward runs on autograd's device thread: its
    ``k1b.*`` spans still lie inside ``opt.backward``, and K1's and K2's
    launches and K2's tables inside their ``pt.render``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = get_scene("cornell")
    scene, camera = spec.to_scene("cuda"), spec.to_camera("cuda")
    with torch.no_grad():
        target = render_differentiable(scene, camera, CFG, device="cuda")
    step = make_inverse_step(target, CFG, _adam, lambda name: name in ("center", "color"),
                             device="cuda")
    st0 = OptState(scene, camera, None, None)
    spans = _spans(_card_session(lambda: step(st0)))
    (root,) = [s for s in spans if s[0] == "opt.step"]
    (bwd,) = _inside(spans, root, "opt.backward")
    for name, count in (("k1b.backward", 1), ("k1b.camera", 1), ("k1b.launch", 1)):
        assert len(_inside(spans, bwd, name)) == count, (name, spans)
    (fwd,) = _inside(spans, root, "opt.forward")
    (render,) = _inside(spans, fwd, "pt.render")
    assert len(_inside(spans, render, "pt.launch")) == 1

    spec = get_scene("complex")
    big, cam = spec.to_scene("cuda"), spec.to_camera("cuda")
    assert big.num_spheres > ptk.UNROLL_MAX_SPHERES
    spans = _spans(_card_session(lambda: [ptk.render_cuda(big, cam, CFG) for _ in range(2)]))
    roots = [s for s in spans if s[0] == "pt.render"]
    assert len(roots) == 2
    for root in roots:
        for name in ("pt.k2_tables", "pt.launch", "pt.camera"):
            assert len(_inside(spans, root, name)) == 1, (name, spans)


@pytest.mark.cuda
def test_on_the_card_two_renders_of_one_scene_build_k2s_tables_once():
    """Two ``render_cuda`` calls of ``complex`` on the card open two
    ``pt.k2_tables`` and one ``pt.k2_tables.build``: the second render
    finds the scene's table (``scene_table``) and, by it, K2's tables."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = get_scene("complex")
    big, cam = spec.to_scene("cuda"), spec.to_camera("cuda")
    spans = _spans(_card_session(lambda: [ptk.render_cuda(big, cam, CFG) for _ in range(2)]))
    names = [s[0] for s in spans]
    assert names.count("pt.k2_tables") == 2 and names.count("pt.k2_tables.build") == 1

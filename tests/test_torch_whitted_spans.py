"""The Whitted render's spans (``utils/profiling.span``): under a profiler
session each ``render_whitted`` is one ``wh.render`` root holding the
camera's row (``wh.camera``) and the launch (``wh.launch``); K3's scene
table lookup is ``wh.tables``, with ``wh.tables.build`` inside it only when
it builds, and its counters see a second lookup of one scene hit; without a
session no ``record_function`` is entered; a session changes no image; K3's
route hands over the camera's row on the host; on the card the tables lie
inside the root and build once a scene, with one K3 launch a render, no
render syncs and each is the plain route's frame bitwise."""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from se195_raytracer_tpu_torch.core.config import RenderConfig
from se195_raytracer_tpu_torch.kernels import whitted_kernel as K
from se195_raytracer_tpu_torch.models import whitted as P
from se195_raytracer_tpu_torch.scenes.whitted_scenes import room_scene

CFG = RenderConfig(width=12, height=9, supersample=3, trace_depth=3)
POSE = ((0.5, 0.25, -6.0), (-0.5, 0.5, 0.0))


def _poses(n):
    """n poses drawn from fixed seeds inside the room (eye x in [-2, 2],
    y in [-0.75, 1.25], z in [-7, -5]; target x in [-2, 2], y in
    [-1.25, 1.75], z 0)."""
    out = []
    for seed in range(n):
        rng = np.random.Generator(np.random.PCG64(1000 + seed))
        eye = rng.uniform((-2.0, -0.75, -7.0), (2.0, 1.25, -5.0))
        target = rng.uniform((-2.0, -1.25, 0.0), (2.0, 1.75, 0.0))
        out.append((tuple(eye.tolist()), tuple(target.tolist())))
    return out


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spans(prof):
    """(name, start, end) of the session's ``wh.*`` spans on the host, in
    start order."""
    out = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.name.startswith("wh.") and e.device_type == DeviceType.CPU]
    return sorted(out, key=lambda s: s[1])


def _inside(spans, root, name):
    return [s for s in spans if s[0] == name and root[1] <= s[1] and s[2] <= root[2]]


@pytest.mark.parametrize("use_kernel", [True, False])
def test_two_renders_give_two_roots_each_holding_its_layers(use_kernel):
    scene = room_scene("cpu")
    cfg = RenderConfig(width=12, height=9, trace_depth=3, use_kernel=use_kernel)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for camera in (None, POSE):
            P.render_whitted(scene, cfg, device="cpu", camera=camera)
    spans = _spans(prof)
    roots = [s for s in spans if s[0] == "wh.render"]
    assert len(roots) == 2 and roots[0][2] <= roots[1][1]
    for root in roots:
        (camera,) = _inside(spans, root, "wh.camera")
        (launch,) = _inside(spans, root, "wh.launch")
        assert camera[2] <= launch[1]
    # On the CPU neither route looks K3's table up: the fixed camera's row is
    # a host constant, not one of the table's tensors.
    assert not [s for s in spans if s[0] == "wh.tables"]


def test_without_a_session_no_span_is_entered(monkeypatch):
    def entered(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler session")

    monkeypatch.setattr(torch.profiler, "record_function", entered)
    scene = room_scene("cpu")
    assert P.render_whitted(scene, CFG, device="cpu", camera=POSE).shape == (9, 12, 3)
    K._packed(scene)


def test_a_second_lookup_of_one_scene_hits_the_table():
    scene = room_scene("cpu")  # fresh tensors: the first lookup builds
    lookups, builds = K._packed.lookups, K._packed.builds
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        first = K._packed(scene)
        second = K._packed(scene)
    assert all(a is b for a, b in zip(first, second))
    assert (K._packed.lookups - lookups, K._packed.builds - builds) == (2, 1)
    spans = _spans(prof)
    tables = [s for s in spans if s[0] == "wh.tables"]
    assert len(tables) == 2
    assert len(_inside(spans, tables[0], "wh.tables.build")) == 1
    assert not _inside(spans, tables[1], "wh.tables.build")
    scene.color.mul_(1.0)  # written in place: built again
    K._packed(scene)
    assert K._packed.builds - builds == 2


def test_a_session_changes_no_image():
    scene = room_scene("cpu")
    for camera in (None, POSE):
        plain = P.render_whitted(scene, CFG, device="cpu", camera=camera)
        with profile(activities=[ProfilerActivity.CPU]):
            traced = P.render_whitted(scene, CFG, device="cpu", camera=camera)
        assert torch.equal(plain, traced)


@pytest.mark.parametrize("camera", ["none", "pose", "row", "wrong_size"])
def test_k3s_route_hands_over_the_camera_row_on_the_host(camera, monkeypatch):
    """The row that K3's route hands over (to the plain render on the CPU,
    the same ``host_camera_row`` that goes to the launch on the card) is a
    contiguous float32 [12] CPU tensor, bitwise ``whitted_camera_row`` of
    the camera; a row of another size raises ValueError."""
    want = P.whitted_camera_row() if camera == "none" else P.whitted_camera_row(*POSE)
    arg = {"none": None, "pose": POSE, "row": want.copy(),
           "wrong_size": torch.zeros(13)}[camera]
    seen = []

    def plain(scene, width, height, *args, cam_row=None, **kwargs):
        seen.append(cam_row)
        return torch.zeros((height, width, 3))

    monkeypatch.setattr(K, "render_whitted_scene", plain)
    scene = room_scene("cpu")
    if camera == "wrong_size":
        with pytest.raises(ValueError, match="camera"):
            P.render_whitted(scene, CFG, device="cpu", camera=arg)
        assert not seen
        return
    P.render_whitted(scene, CFG, device="cpu", camera=arg)
    handed = K.host_camera_row(P.camera_row(arg))
    for row in (seen[0], handed):
        assert row.device.type == "cpu" and row.dtype == torch.float32
        assert row.shape == (12,) and row.is_contiguous()
        assert np.array_equal(row.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.cuda
def test_on_the_card_the_tables_build_once_and_each_render_launches_k3_once():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = room_scene("cuda")  # fresh tensors: its first render builds
    cfg = RenderConfig(width=160, height=120)
    launches = K.whitted_frame_cuda.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for camera in (POSE, None):
            P.render_whitted(scene, cfg, device="cuda", camera=camera)
        torch.cuda.synchronize()
    assert K.whitted_frame_cuda.launches - launches == 2
    spans = _spans(prof)
    roots = [s for s in spans if s[0] == "wh.render"]
    assert len(roots) == 2
    for i, root in enumerate(roots):
        # One table lookup a render: the fixed camera's row is a host constant.
        tables = _inside(spans, root, "wh.tables")
        (launch,) = _inside(spans, root, "wh.launch")
        assert len(_inside(spans, root, "wh.camera")) == 1 and len(tables) == 1
        assert all(t[2] <= launch[1] for t in tables)
        assert len(_inside(spans, root, "wh.tables.build")) == (1 if i == 0 else 0)
    # With the tables built, a render makes no synchronizing copy: the row
    # reaches K3 as a launch parameter.
    cameras = [POSE, None, *_poses(3)]
    torch.cuda.set_sync_debug_mode("error")
    try:
        images = [P.render_whitted(scene, cfg, device="cuda", camera=c) for c in cameras]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    plain = RenderConfig(width=160, height=120, use_kernel=False)
    for camera, img in zip(cameras, images):
        want = P.render_whitted(scene, plain, device="cuda", camera=camera)
        assert torch.equal(img, want), camera

"""The readers of the program's spans (``harness.program`` and the metrics
that read it) on synthetic reduced traces with known spans and runtime
calls: counts, waits and the hit share per unit; nothing on a trace with
no device events or no roots; no sync counted outside every root."""

import pytest

from harness.manifest import Manifest
from harness.program import SYNC, units
from harness.trace import Event, Trace

MS = 1e-3


def render_trace(device=True):
    """A 100 ms window with two renders (10-30 ms, 50-70 ms) and a third cut
    by the window's end. The first: a 4 ms stream sync inside a 5 ms
    camera span, a table lookup that builds (2 ms), a 1 ms synchronous copy,
    a launch; the second: a 3 ms stream sync inside a 3.5 ms camera span, a
    lookup that hits (0.5 ms), a cudaMemcpyAsync (not a sync). Outside
    every render: an event sync of 9 ms (the client waiting for an image)
    and a device sync at the window's end."""
    host = [
        Event("pt.render", 10 * MS, 30 * MS),
        Event("pt.camera", 11 * MS, 16 * MS),
        Event("cudaStreamSynchronize", 11.5 * MS, 15.5 * MS),
        Event("pt.k2_tables", 17 * MS, 19 * MS),
        Event("pt.k2_tables.build", 17.1 * MS, 18.9 * MS),
        Event("cudaMemcpy", 17.5 * MS, 18.5 * MS),
        Event("cudaLaunchKernel", 20 * MS, 20.01 * MS),
        Event("cudaEventSynchronize", 31 * MS, 40 * MS),
        Event("pt.render", 50 * MS, 70 * MS),
        Event("pt.camera", 51 * MS, 54.5 * MS),
        Event("cudaStreamSynchronize", 51.2 * MS, 54.2 * MS),
        Event("pt.k2_tables", 55 * MS, 55.5 * MS),
        Event("cudaMemcpyAsync", 56 * MS, 57 * MS),
        Event("pt.render", 95 * MS, 105 * MS),
        Event("cudaStreamSynchronize", 96 * MS, 99 * MS),
        Event("cudaDeviceSynchronize", 99.5 * MS, 99.9 * MS),
    ]
    dev = [Event("kernel", 12 * MS, 45 * MS)] if device else []
    return Trace(dev, host, (0.0, 100 * MS))


def step_trace():
    """Two steps; the second's backward holds a sync on another thread (the
    reduced trace keeps no thread: inside the root's interval is inside)."""
    host = [
        Event("opt.step", 0 * MS, 20 * MS),
        Event("cudaStreamSynchronize", 1 * MS, 3 * MS),
        Event("opt.update", 15 * MS, 15.4 * MS),
        Event("opt.step", 20 * MS, 40 * MS),
        Event("opt.backward", 25 * MS, 35 * MS),
        Event("k1b.backward", 26 * MS, 34 * MS),
        Event("cudaStreamSynchronize", 27 * MS, 31 * MS),
        Event("opt.update", 36 * MS, 36.2 * MS),
        Event("pt.render", 21 * MS, 24 * MS),
    ]
    return Trace([Event("kernel", 0.0, 40 * MS)], host, (0.0, 50 * MS))


def read(name, trace):
    return Manifest().metric_reader(name).read(None, None, trace, None)


def test_the_sync_set():
    for name in ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                 "cudaMemcpy"):
        assert SYNC.match(name), name
    for name in ("cudaMemcpyAsync", "cudaLaunchKernel", "cudaStreamWaitEvent", "pt.render"):
        assert not SYNC.match(name), name


def test_render_readers_count_per_render_inside_the_roots():
    t = render_trace()
    assert units(t, "pt.render").n == 2  # the third ends past the window
    assert read("syncs.render", t) == pytest.approx(3 / 2)
    assert read("wait_ms.render", t) == pytest.approx((4 + 1 + 3) / 2)
    assert read("camera_ms.render", t) == pytest.approx((5 + 3.5) / 2)
    assert read("tables_ms.render", t) == pytest.approx((2 + 0.5) / 2)
    assert read("tables_hit_pct.render", t) == pytest.approx(50.0)


def test_step_readers_count_per_step_on_any_thread():
    t = step_trace()
    assert read("syncs.grad", t) == pytest.approx(2 / 2)
    assert read("wait_ms.grad", t) == pytest.approx((2 + 4) / 2)
    assert read("optimizer_ms.grad", t) == pytest.approx((0.4 + 0.2) / 2)


def test_a_sync_outside_every_root_is_not_counted():
    t = render_trace()
    outside = t.host + [Event("cudaStreamSynchronize", 80 * MS, 90 * MS),
                        Event("cudaMemcpy", 5 * MS, 6 * MS)]
    t2 = Trace(t.device, outside, t.window)
    assert read("syncs.render", t2) == read("syncs.render", t)
    assert read("wait_ms.render", t2) == read("wait_ms.render", t)


@pytest.mark.parametrize("name", ["wait_ms.render", "syncs.render", "camera_ms.render",
                                  "tables_ms.render", "tables_hit_pct.render", "wait_ms.grad",
                                  "syncs.grad", "optimizer_ms.grad"])
def test_nothing_without_device_events_or_without_the_spans(name):
    trace = render_trace if "render" in name else step_trace
    assert read(name, None) is None
    if "render" in name:
        assert read(name, render_trace(device=False)) is None
    t = trace()
    bare = Trace(t.device, [e for e in t.host if not e.name.startswith(("pt.", "opt."))],
                 t.window)
    assert read(name, bare) is None
    assert read(name, t) is not None


def test_cornell_has_no_table_lookups():
    t = render_trace()
    no_k2 = Trace(t.device, [e for e in t.host if not e.name.startswith("pt.k2")], t.window)
    assert read("tables_ms.render", no_k2) is None
    assert read("tables_hit_pct.render", no_k2) is None
    assert read("camera_ms.render", no_k2) is not None

"""Spans and the device trace of one run.

``Spans`` keeps the benchmark's own spans (name, start, end on the host
clock) in memory; in a traced run each is also a ``record_function`` range,
so the trace shows it. ``Tracer`` wraps the window in a ``torch.profiler``
session (CPU and CUDA activities) and reduces it once the window has
closed: the device's busy time inside the window, each device operation's
time, the kernels by name in launch order, and the idle gaps by the host
operation that was running while the device waited.
"""

from __future__ import annotations

import contextlib
import re
import time
from collections import defaultdict
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

WINDOW = "bench.window"


class Spans:
    def __init__(self, traced: bool = False):
        self.traced = traced
        self.items: Dict[str, List[Tuple[float, float]]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        rf = None
        if self.traced:
            from torch.profiler import record_function

            rf = record_function(name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items[name].append((t0, time.perf_counter()))
            if rf is not None:
                rf.__exit__(None, None, None)

    def durations(self, name: str) -> List[float]:
        return [b - a for a, b in self.items.get(name, [])]


class Event(NamedTuple):
    name: str
    start: float  # seconds, the trace's clock
    end: float


class Trace(NamedTuple):
    """A reduced trace: device events (kernels, copies, sets) and host
    events inside the window, the window's bounds."""
    device: List[Event]
    host: List[Event]
    window: Tuple[float, float]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> np.ndarray:
        """The union of the device events, clipped to the window, [k, 2]."""
        lo, hi = self.window
        iv = sorted((max(e.start, lo), min(e.end, hi)) for e in self.device
                    if e.end > lo and e.start < hi)
        out: List[List[float]] = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return np.array(out, dtype=np.float64).reshape(-1, 2)

    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) if len(iv) else 0.0

    def kernels(self, pattern: str) -> List[Event]:
        """Device events whose name matches ``pattern``, in start order."""
        rx = re.compile(pattern)
        return sorted((e for e in self.device if rx.search(e.name)), key=lambda e: e.start)

    def device_ops(self, top: int = 10) -> List[List]:
        tot: Dict[str, float] = defaultdict(float)
        for e in self.device:
            tot[e.name] += e.end - e.start
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10, longest_op_s: float = 0.01) -> List[List]:
        """The window's idle time by the innermost host operation (one
        shorter than ``longest_op_s``) running at each gap's midpoint;
        "host:python" where none was."""
        iv = self.busy_intervals()
        lo, hi = self.window
        edges = np.concatenate([[lo], iv.reshape(-1), [hi]]).reshape(-1, 2)
        ops = sorted((e for e in self.host if e.end - e.start < longest_op_s
                      and not e.name.startswith("bench.")), key=lambda e: e.start)
        starts = np.array([e.start for e in ops])
        ends = np.array([e.end for e in ops])
        tot: Dict[str, float] = defaultdict(float)
        for a, b in edges:
            if b <= a:
                continue
            m = 0.5 * (a + b)
            j = int(np.searchsorted(starts, m, side="right"))
            i = int(np.searchsorted(starts, m - longest_op_s, side="left"))
            name = "host:python"
            if j > i:
                cover = np.nonzero(ends[i:j] >= m)[0]
                if cover.size:
                    k = i + cover[np.argmin(ends[i:j][cover] - starts[i:j][cover])]
                    name = ops[k].name
            tot[name] += b - a
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


# Device activities that occupy the device; a span's mirror on the device
# ("gpu_user_annotation") does not.
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def _fields(ev):
    """(name, is_device_work, start_s, end_s) of a kineto event, across
    torch versions; None for a device event that is no work."""
    name = ev.name()
    dev = str(ev.device_type()).rsplit(".", 1)[-1].upper() != "CPU"
    if dev:
        kind = str(ev.activity_type()).lower() if hasattr(ev, "activity_type") else "kernel"
        if not any(k in kind for k in DEVICE_WORK):
            return None
    if hasattr(ev, "start_ns"):
        start = ev.start_ns() * 1e-9
        end = start + ev.duration_ns() * 1e-9
    else:
        start = ev.start_us() * 1e-6
        end = start + ev.duration_us() * 1e-6
    return name, dev, start, end


class Tracer:
    """A ``torch.profiler`` session around the window, when ``enabled``."""

    def __init__(self, enabled: bool, cuda: bool):
        self.enabled, self.cuda = enabled, cuda
        self.prof = None
        self.trace: Optional[Trace] = None

    @contextlib.contextmanager
    def window(self) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                yield
            if self.cuda:
                torch.cuda.synchronize()
        self.prof = prof

    def reduce(self) -> Optional[Trace]:
        """The reduced trace of the window (None for an untraced run)."""
        if self.prof is None:
            return None
        dev, host, window = [], [], None
        for ev in self.prof.profiler.kineto_results.events():
            fields = _fields(ev)
            if fields is None:
                continue
            name, on_device, a, b = fields
            if on_device:
                dev.append(Event(name, a, b))
            elif name == WINDOW:
                window = (a, b)
            else:
                host.append(Event(name, a, b))
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW} span")
        # A host range's mirror on the device's timeline (a span, the
        # optimizer's step) carries the host range's name; no kernel, copy
        # or set does.
        mirrored = {e.name for e in host} | {WINDOW}
        dev = [e for e in dev if e.name not in mirrored]
        self.prof = None
        self.trace = Trace(dev, host, window)
        return self.trace

"""Profiling on ``torch.profiler`` (twin of
se195_raytracer_tpu/utils/profiling.py): the device-trace upgrade of the
reference's wall-clock-only instrumentation (``WallClockTime`` captions,
displayfunc.cpp:69-80).

``trace`` records a region, CPU operators and, with a CUDA device, its
kernels, and writes a Chrome trace (``trace.json``, opened in Perfetto or
chrome://tracing) into a directory. ``maybe_trace`` is the no-op-when-
disabled form the CLI uses; ``annotate`` names a span inside a trace.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(trace_dir: str) -> Iterator[None]:
    """Capture a torch.profiler trace of the enclosed region into
    ``trace_dir/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """``trace`` when a directory is given, no-op otherwise."""
    if trace_dir:
        with trace(trace_dir):
            yield
    else:
        yield


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named sub-region inside a trace (a span on the timeline)."""
    from torch.profiler import record_function

    with record_function(name):
        yield

"""Profiling on ``torch.profiler`` (twin of
se195_raytracer_tpu/utils/profiling.py): the device-trace upgrade of the
reference's wall-clock-only instrumentation (``WallClockTime`` captions,
displayfunc.cpp:69-80).

``trace`` records a region, CPU operators and, with a CUDA device, its
kernels, and writes a Chrome trace (``trace.json``, opened in Perfetto or
chrome://tracing) into a directory. ``maybe_trace`` is the no-op-when-
disabled form the CLI uses.

``span`` is the program's one span primitive: a named range on the
profiler's own clock, the device trace's, recorded only while a profiler
session is open, into that session. The port opens one at each layer of a
render (``pt.*``, a Whitted render's ``wh.*``, a whitted5 render's
``w5.*``) and of an inverse step (``opt.*``, ``k1b.*``); a
``torch.profiler`` session around any caller (``trace``, the benchmark's
traced window) holds them beside the CUDA runtime's calls and the device's
kernels. A unit's spans are grouped by time: a render's or a step's root
(``pt.render``, ``wh.render``, ``w5.render``, ``opt.step``) holds its
children's intervals, those that autograd's thread opens during the step's
backward too.
"""

from __future__ import annotations

import contextlib
import os
from typing import ContextManager, Iterator, Optional

import torch

TRACE_FILE = "trace.json"

_IDLE = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name: str) -> ContextManager:
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler session is open on this thread (autograd's worker threads
    inherit the caller's), else one shared null context: one flag check,
    nothing recorded."""
    if not _profiling():
        return _IDLE
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(trace_dir: str) -> Iterator[None]:
    """Capture a torch.profiler trace of the enclosed region into
    ``trace_dir/trace.json``."""
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

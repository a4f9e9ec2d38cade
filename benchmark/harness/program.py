"""The program's own spans in a reduced trace, by unit of work.

The port opens a ``torch.profiler`` range at each layer of a render and of
an inverse step (``utils/profiling.span`` in the program: ``pt.*``,
``opt.*``, ``k1b.*``); a traced window holds them in ``trace.host``,
beside the CUDA runtime's calls, on the device trace's clock. A unit is
one root span inside the window: ``pt.render`` a render, ``opt.step`` a
step. A blocking sync is a runtime call that makes the host wait for the
device (``SYNC``); one counts where it lies inside a unit's root, on any
thread (the backward's calls run on autograd's thread, inside the step).

``units`` is None where the trace holds no device events (an untraced
run, a run on the CPU) or no root of that name (a program without the
spans), so a reader gives nothing there.
"""

from __future__ import annotations

import re
from typing import List, Optional

import numpy as np

from harness.trace import Event, Trace

RENDER, STEP = "pt.render", "opt.step"

# The runtime calls that block the host until the device has caught up:
# every synchronize (stream, device, event) and the synchronous copy.
SYNC = re.compile(r"^cuda\w*Synchronize$|^cudaMemcpy$")


class Units:
    """The window's roots named ``root`` (they never overlap: one unit runs
    at a time) and the host events inside them."""

    def __init__(self, trace: Trace, root: str):
        lo, hi = trace.window
        roots = sorted((e for e in trace.host if e.name == root and lo <= e.start
                        and e.end <= hi), key=lambda e: e.start)
        self.n = len(roots)
        self.starts = np.array([e.start for e in roots])
        self.ends = np.array([e.end for e in roots])
        self.host = trace.host

    def inside(self, events: List[Event]) -> List[Event]:
        """The events that lie inside one of the roots."""
        if not events or not self.n:
            return []
        a = np.array([e.start for e in events])
        b = np.array([e.end for e in events])
        k = np.searchsorted(self.starts, a, side="right") - 1
        ok = (k >= 0) & (b <= self.ends[np.maximum(k, 0)])
        return [e for e, keep in zip(events, ok) if keep]

    def named(self, name: str) -> List[Event]:
        return self.inside([e for e in self.host if e.name == name])

    def syncs(self) -> List[Event]:
        return self.inside([e for e in self.host if SYNC.match(e.name)])

    def ms(self, name: str) -> Optional[float]:
        """The time in spans ``name`` a unit, in ms; None where there are
        none."""
        spans = self.named(name)
        return 1e3 * sum(e.end - e.start for e in spans) / self.n if spans else None

    def wait_ms(self) -> float:
        return 1e3 * sum(e.end - e.start for e in self.syncs()) / self.n

    def sync_count(self) -> float:
        return len(self.syncs()) / self.n


def units(trace: Optional[Trace], root: str) -> Optional[Units]:
    if trace is None or not trace.device:
        return None
    u = Units(trace, root)
    return u if u.n else None

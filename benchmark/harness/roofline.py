"""A kernel's share of its roofline in one unit of work of the window.

The published H100 SXM peaks (NVIDIA's data sheet, dense, at the full
700 W): 67 TFLOP/s in float32 outside the tensor cores and 3.35 TB/s of
HBM3. Every operation is charged at the float32 rate, whatever the kernel
rounds or fuses, so that no implementation can read above 100%.

The unit (a render, a step) is the driver's ``roofline_unit``: its index in
the window and its inputs. ``rooflines/<kernel>.py`` gives ``NAMES`` (the
patterns of the kernel's device operations; the unit's time is the sum of
the index-th event of each) and ``count(inputs)`` (operations and bytes,
counted by the reference on those inputs).
"""

from __future__ import annotations

from typing import Optional

PEAK_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)


def share(kernel: str, job, trace, manifest) -> Optional[float]:
    """100 x bound / device time of ``kernel`` in the driver's unit, or None
    where the trace holds no such unit."""
    if trace is None or not hasattr(job, "roofline_unit"):
        return None
    unit = job.roofline_unit()
    if unit is None:
        return None
    index, inputs = unit
    mod = manifest.roofline(kernel)
    seconds = 0.0
    for pattern in mod.NAMES:
        events = trace.kernels(pattern)
        if index >= len(events):
            return None
        seconds += events[index].end - events[index].start
    if seconds <= 0.0:
        return None
    ops, nbytes = mod.count(inputs)
    return 100.0 * bound_s(ops, nbytes) / seconds

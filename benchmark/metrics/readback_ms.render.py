"""readback_ms.render: the device's time copying frames to the host (the
device-to-host copies of the trace), per render of the window, in ms."""

PATTERN = r"(?i)memcpy\s*dtoh"


def read(job, spans, trace, manifest):
    renders = len(spans.durations("bench.render"))
    if trace is None or not renders:
        return None
    copies = trace.kernels(PATTERN)
    if not copies:
        return None
    return 1e3 * sum(e.end - e.start for e in copies) / renders

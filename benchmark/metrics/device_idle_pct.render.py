"""device_idle_pct.render: the share of the traced window in which no
kernel, copy or set ran on the device, in %."""

from harness import idle


def read(job, spans, trace, manifest):
    return idle.pct(trace)

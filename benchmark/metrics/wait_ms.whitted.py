"""wait_ms.whitted: the host's time blocked on the device inside the
program's ``wh.render`` span (``harness.program.SYNC``), a render of the
window, in ms."""

from harness import program

ROOT = "wh.render"  # a Whitted render's root span


def read(job, spans, trace, manifest):
    u = program.units(trace, ROOT)
    return None if u is None else u.wait_ms()

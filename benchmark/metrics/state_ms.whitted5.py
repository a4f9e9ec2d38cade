"""state_ms.whitted5: the program's ``w5.state`` span (the lookup of the
seed's counter state and, on a miss, its hash on the host and its copies to
the device), a render of the window, in ms."""

from harness import program

ROOT = "w5.render"  # a whitted5 render's root span


def read(job, spans, trace, manifest):
    u = program.units(trace, ROOT)
    return None if u is None else u.ms("w5.state")

"""optimizer_ms.grad: the program's ``opt.update`` span (``GroupAdam``: NaN
zeroing, the clip, Adam), a step of the window, in ms."""

from harness import program


def read(job, spans, trace, manifest):
    u = program.units(trace, program.STEP)
    return None if u is None else u.ms("opt.update")

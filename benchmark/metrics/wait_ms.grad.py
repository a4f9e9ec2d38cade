"""wait_ms.grad: the host's time blocked on the device inside the
program's ``opt.step`` span, on any thread (``harness.program.SYNC``), a
step of the window, in ms."""

from harness import program


def read(job, spans, trace, manifest):
    u = program.units(trace, program.STEP)
    return None if u is None else u.wait_ms()

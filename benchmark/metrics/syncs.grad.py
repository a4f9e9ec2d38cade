"""syncs.grad: the blocking syncs (``harness.program.SYNC``) inside the
program's ``opt.step`` span, on any thread, a step of the window."""

from harness import program


def read(job, spans, trace, manifest):
    u = program.units(trace, program.STEP)
    return None if u is None else u.sync_count()

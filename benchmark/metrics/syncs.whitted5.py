"""syncs.whitted5: the blocking syncs (``harness.program.SYNC``) inside the
program's ``w5.render`` span, a render of the window."""

from harness import program

ROOT = "w5.render"  # a whitted5 render's root span


def read(job, spans, trace, manifest):
    u = program.units(trace, ROOT)
    return None if u is None else u.sync_count()

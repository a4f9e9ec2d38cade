"""syncs.whitted: the blocking syncs (``harness.program.SYNC``) inside the
program's ``wh.render`` span, a render of the window."""

from harness import program

ROOT = "wh.render"  # a Whitted render's root span


def read(job, spans, trace, manifest):
    u = program.units(trace, ROOT)
    return None if u is None else u.sync_count()

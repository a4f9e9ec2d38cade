"""syncs.render: the blocking syncs (``harness.program.SYNC``) inside the
program's ``pt.render`` span, a render of the window."""

from harness import program


def read(job, spans, trace, manifest):
    u = program.units(trace, program.RENDER)
    return None if u is None else u.sync_count()

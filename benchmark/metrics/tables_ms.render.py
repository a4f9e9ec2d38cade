"""tables_ms.render: the program's ``pt.k2_tables`` span (K2's cache
lookup, and the bounds and light list built on a miss), a render of the
window, in ms."""

from harness import program


def read(job, spans, trace, manifest):
    u = program.units(trace, program.RENDER)
    return None if u is None else u.ms("pt.k2_tables")

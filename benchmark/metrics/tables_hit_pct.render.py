"""tables_hit_pct.render: the share of K2's table lookups (``pt.k2_tables``
spans inside the window's renders) that built nothing (no
``pt.k2_tables.build`` inside), in %."""

from harness import program


def read(job, spans, trace, manifest):
    u = program.units(trace, program.RENDER)
    if u is None:
        return None
    lookups = len(u.named("pt.k2_tables"))
    if not lookups:
        return None
    return 100.0 * (1.0 - len(u.named("pt.k2_tables.build")) / lookups)

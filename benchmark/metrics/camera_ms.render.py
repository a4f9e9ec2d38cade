"""camera_ms.render: the program's ``pt.camera`` span (``update_camera``
and ``pack_camera``, the copy of its ``up`` vector included), a render of
the window, in ms."""

from harness import program


def read(job, spans, trace, manifest):
    u = program.units(trace, program.RENDER)
    return None if u is None else u.ms("pt.camera")

"""wait_ms.render: the host's time blocked on the device inside the
program's ``pt.render`` span (the runtime's synchronizes and synchronous
copies, ``harness.program.SYNC``), a render of the window, in ms."""

from harness import program


def read(job, spans, trace, manifest):
    u = program.units(trace, program.RENDER)
    return None if u is None else u.wait_ms()

"""camera_ms.whitted: the program's ``wh.camera`` span (the camera's row
made from the render's pose and copied to the device), a render of the
window, in ms."""

from harness import program

ROOT = "wh.render"  # a Whitted render's root span


def read(job, spans, trace, manifest):
    u = program.units(trace, ROOT)
    return None if u is None else u.ms("wh.camera")

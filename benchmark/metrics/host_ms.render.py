"""host_ms.render: the host's time in the program's ``render`` call, from
the call to its return (the seeding's launch, ``pack_scene``, the camera's
basis, K2's tables, the kernel's launch and the frame's gather), the mean
over the window's renders, in ms. The benchmark's own span ``bench.render``
on the host clock."""


def read(job, spans, trace, manifest):
    d = spans.durations("bench.render")
    return 1e3 * sum(d) / len(d) if d else None

"""k1b_roofline.grad: K1b's share of its roofline in one step of the window
(the first after a restart), in % (``harness.roofline``,
``rooflines/k1b.py``)."""

from harness import roofline


def read(job, spans, trace, manifest):
    return roofline.share("k1b", job, trace, manifest)

"""k4_roofline.whitted5: K4's share of its roofline in one render of the
window, in % (``harness.roofline``, ``rooflines/k4.py``)."""

from harness import roofline


def read(job, spans, trace, manifest):
    return roofline.share("k4", job, trace, manifest)

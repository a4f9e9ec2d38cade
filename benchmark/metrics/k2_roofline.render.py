"""k2_roofline.render: K2's share of its roofline in one render of the
window, in % (``harness.roofline``, ``rooflines/k2.py``)."""

from harness import roofline


def read(job, spans, trace, manifest):
    return roofline.share("k2", job, trace, manifest)

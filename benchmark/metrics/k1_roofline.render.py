"""k1_roofline.render: K1's share of its roofline in one render of the
window, in % (``harness.roofline``, ``rooflines/k1.py``)."""

from harness import roofline


def read(job, spans, trace, manifest):
    return roofline.share("k1", job, trace, manifest)

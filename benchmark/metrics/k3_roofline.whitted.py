"""k3_roofline.whitted: K3's share of its roofline in one render of the
window, in % (``harness.roofline``, ``rooflines/k3.py``)."""

from harness import roofline


def read(job, spans, trace, manifest):
    return roofline.share("k3", job, trace, manifest)

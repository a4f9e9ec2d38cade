"""K1b (``pt_backward_cuda``, csrc/pt_backward_kernel.cu): the hard
estimator's backward for scenes of at most 96 spheres, a replay of the
forward's passes and a reverse sweep of each pass's bounces; its time is
its kernel and the fixed-order sum of its blocks' partials.

Operations, as the program's records count them: the replay 25 a camera
ray, per nearest sweep 15 a sphere and 70 of shading, 45 a shadow ray's
set-up, 12 a sphere for each lit sample's full shadow sweep and 12 for
each occluded one; the reverse sweep 150 a recorded bounce, 90 a lit
sample, 40 a camera ray. Every operation is charged at the FMA rate.
Bytes: 20 a pixel (two seed words and the cotangent), the scene's
gradient and table.
"""

from reference import work

NAMES = (r"pt_backward_kernel", r"reduce_partials")
OPS_CAMERA = 25
OPS_SHADE = 70
OPS_SHADOW_SETUP = 45
OPS_SPHERE_NEAREST = 15
OPS_SPHERE_SHADOW = 12
OPS_ADJ_BOUNCE = 150
OPS_ADJ_LIGHT = 90
OPS_ADJ_CAMERA = 40
BYTES_PER_PIXEL = 8 + 12


def split(w: dict, inputs: dict):
    """(replay operations, reverse-sweep operations, bytes)."""
    frame = inputs["frame"]
    n = len(inputs["arrays"]["radius"])
    rays = frame.width * frame.height * frame.spp
    replay = (OPS_CAMERA * rays + w["sweeps"] * (OPS_SPHERE_NEAREST * n + OPS_SHADE)
              + w["shadow_rays"] * OPS_SHADOW_SETUP + w["lit"] * OPS_SPHERE_SHADOW * n
              + (w["shadow_rays"] - w["lit"]) * OPS_SPHERE_SHADOW)
    adjoint = w["bounces"] * OPS_ADJ_BOUNCE + w["lit"] * OPS_ADJ_LIGHT + rays * OPS_ADJ_CAMERA
    nbytes = BYTES_PER_PIXEL * frame.width * frame.height + 4 * (10 * n + 12) + 4 * 12 * n
    return replay, adjoint, nbytes


def count(inputs: dict):
    replay, adjoint, nbytes = split(work.k1b(inputs), inputs)
    return replay + adjoint, nbytes

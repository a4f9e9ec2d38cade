"""K2 (``pt_blocked_pass``, csrc/pt_kernel.cu built by
csrc/pt_blocked_kernel.cu): the pass for scenes of more than 96 spheres,
a sweep in blocks of 16 spheres culled per ray.

Operations, as the program's records count the culled sweep's work: 25 a
primary sample, 70 a nearest sweep's shading, 45 a shadow ray's set-up, 15
a sphere test of a nearest sweep, 12 of a shadow sweep, 14 a block-bound
test; the tests those the per-ray culled sweep must make
(``reference.work.k2``). Bytes: 40 a lane.
"""

from reference import work

NAMES = (r"pt_pass_kernel<\s*\w+\s*,\s*\d+\s*,\s*true",)
OPS_CAMERA = 25
OPS_SHADE = 70
OPS_SHADOW_SETUP = 45
OPS_SPHERE_NEAREST = 15
OPS_SPHERE_SHADOW = 12
OPS_BOUND = 14
STATE_BYTES_PER_LANE = 40
TILE = 16 * 128
TILE_W, TILE_H = 64, 32  # the blocked layout's image block a tile


def lanes(frame) -> int:
    gw = (frame.width + TILE_W - 1) // TILE_W
    gh = (frame.height + TILE_H - 1) // TILE_H
    return gw * gh * TILE


def ops_bytes(w: dict, inputs: dict):
    frame = inputs["frame"]
    ops = (OPS_CAMERA * frame.width * frame.height * frame.spp + OPS_SHADE * w["nearest_rays"]
           + OPS_SHADOW_SETUP * w["shadow_rays"] + OPS_SPHERE_NEAREST * w["nearest_tests"]
           + OPS_SPHERE_SHADOW * w["shadow_tests"] + OPS_BOUND * w["bound_tests"])
    return ops, STATE_BYTES_PER_LANE * lanes(frame)


def count(inputs: dict):
    return ops_bytes(work.k2(inputs), inputs)

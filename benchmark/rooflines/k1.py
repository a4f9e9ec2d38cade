"""K1 (``pt_multi_pass``, csrc/pt_kernel.cu): the fused path-tracing pass
for scenes of at most 96 spheres.

Operations, as the program's records count them (bench.py:46-54): 25 a
primary sample (the camera ray), and per live bounce a nearest sweep (15 a
sphere), one shadow sweep a light (12 a sphere and 45 of set-up) and 70 of
shading, RNG and bookkeeping. Bytes: 40 a lane (s0, s1 and the accumulator
read and written once).
"""

from reference import work

NAMES = (r"pt_pass_kernel<\s*\w+\s*,\s*\d+\s*,\s*false",)
OPS_CAMERA = 25
OPS_SHADE = 70
OPS_SHADOW_SETUP = 45
OPS_SPHERE_NEAREST = 15
OPS_SPHERE_SHADOW = 12
STATE_BYTES_PER_LANE = 40
TILE = 16 * 128  # the kernels' lanes come in whole tiles


def ops_per_bounce(n_spheres: int, n_lights: int) -> int:
    return (OPS_SPHERE_NEAREST * n_spheres
            + n_lights * (OPS_SPHERE_SHADOW * n_spheres + OPS_SHADOW_SETUP) + OPS_SHADE)


def lanes(frame) -> int:
    r = frame.width * frame.height
    return (r + TILE - 1) // TILE * TILE


def ops_bytes(counts: dict, inputs: dict):
    from reference import smallpt as ref

    frame = inputs["frame"]
    n = len(inputs["arrays"]["radius"])
    lights = len(ref.lights_of(inputs["arrays"]["emission"]))
    ops = (OPS_CAMERA * frame.width * frame.height * frame.spp
           + counts["live_bounces"] * ops_per_bounce(n, lights))
    return ops, STATE_BYTES_PER_LANE * lanes(frame)


def count(inputs: dict):
    return ops_bytes(work.k1(inputs), inputs)

"""K3 (``whitted_frame_cuda``, csrc/whitted_kernel.cu): a Whitted frame in
one launch, a thread a subsample ray, its tree on the thread's stack, the
subsamples of a pixel summed and tone-scaled in the block.

Operations, as the program's records charge them (``chip_smoke.py``'s
``W_OPS_*``, copied, and its sum): per live node a nearest sweep over every
primitive (15 a plane, 20 a sphere) and 40 of its own (hit point, normal,
contribution, children); per light of a lit node 45 (direction, N.L,
Phong); per primitive test of a shadow sweep the cheaper test's 15. The
live work is the reference's count over every subsample ray of the unit's
render. Bytes: the image (12 a pixel) and the scene's [18, N] table, once.
"""

from reference import whitted as refw

NAMES = (r"\bwhitted_frame_kernel\b",)
W_OPS_PLANE, W_OPS_SPHERE = 15, 20
W_OPS_LIGHT = 45
W_OPS_NODE = 40
IMAGE_BYTES = 12
TABLE_ROWS = 18
COUNT_BLOCK = 1 << 16  # pixels a block of the count on the card


def ops(ptype, is_light, work: dict) -> int:
    planes = sum(1 for t in ptype if t == refw.PLANE)
    spheres = len(ptype) - planes
    lights = sum(1 for x in is_light if x)
    return (work["nodes"] * (W_OPS_NODE + planes * W_OPS_PLANE + spheres * W_OPS_SPHERE)
            + work["hit_nodes"] * lights * W_OPS_LIGHT
            + work["shadow_tests"] * min(W_OPS_PLANE, W_OPS_SPHERE))


def nbytes(n_prims: int, frame: refw.Frame) -> int:
    return frame.width * frame.height * IMAGE_BYTES + TABLE_ROWS * 4 * n_prims


def count(inputs: dict):
    frame, dev = inputs["frame"], inputs["device"]
    scene = refw.make_scene(inputs["config"]["scene"], dev)
    row = refw.camera_row(*refw.pose(inputs["seed"], inputs["walk"]))
    block = COUNT_BLOCK if dev.type == "cuda" else 1 << 10
    work = refw.count_work(scene, frame, row, dev, block)
    return ops(scene.ptype, scene.is_light, work), nbytes(len(scene.ptype), frame)

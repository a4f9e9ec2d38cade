"""K4 (``whitted5_trace_cuda``, csrc/whitted5_kernel.cu): every pass of a
raytracer5 render in one launch, a thread a primary ray, K5's texel fetch
inside it.

Operations, as the program's records charge them (``chip_smoke.py``'s
``W5_OPS_*`` and ``w5_work_ops``, copied): per live node a nearest sweep
over every primitive (20 a sphere, 15 a plane, 120 a box) and 60 of
shading; per light of a lit node 45; per shadow sweep whose shade the
node's diffuse or specular term can use a sweep and 40 of sample set-up
(K4 traces no other); 60 a texel fetch; 50 a glossy disc sample. The live
work is the reference's count over every pass of the unit's render.
Bytes, as the records reckon them: per lane each ray set's origin and
direction (24), the counter state (8) and the image (12), once; the
textures once (4 a channel).
"""

from reference import whitted5 as ref5

NAMES = (r"\bwhitted5_kernel\b",)
W5_OPS_SPHERE, W5_OPS_PLANE, W5_OPS_BOX = 20, 15, 120
W5_OPS_NODE = 60
W5_OPS_LIGHT = 45
W5_OPS_SAMPLE = 40
W5_OPS_TEXEL = 60
W5_OPS_GLOSSY = 50
RAY_BYTES, STATE_BYTES, IMAGE_BYTES = 24, 8, 12
COUNT_BLOCK = 1 << 18  # pixels a block of the count on the card


def ops(ptype, is_light, work: dict) -> int:
    """``w5_work_ops`` of the live ``work``, the shadow sweeps that can add
    light."""
    n_sph = sum(1 for t in ptype if t == ref5.SPHERE)
    n_pla = sum(1 for t in ptype if t == ref5.PLANE)
    n_box = len(ptype) - n_sph - n_pla
    sweep = W5_OPS_SPHERE * n_sph + W5_OPS_PLANE * n_pla + W5_OPS_BOX * n_box
    lights = sum(1 for x in is_light if x)
    return (work["nodes"] * (sweep + W5_OPS_NODE) + work["lit"] * lights * W5_OPS_LIGHT
            + work["shadow_sweeps_used"] * (sweep + W5_OPS_SAMPLE)
            + work["texels"] * W5_OPS_TEXEL + work["glossy"] * W5_OPS_GLOSSY)


def nbytes(scene: ref5.Scene, frame: ref5.Frame) -> int:
    """One ray set a lane, as ``render_whitted5`` traces."""
    lanes = frame.width * frame.height
    texels = sum(t.numel() for t in scene.textures)
    return lanes * (RAY_BYTES + STATE_BYTES + IMAGE_BYTES) + 4 * texels


def count(inputs: dict):
    frame, dev = inputs["frame"], inputs["device"]
    scene = ref5.make_scene(inputs["config"]["scene"], dev)
    block = COUNT_BLOCK if dev.type == "cuda" else 1 << 12
    work = ref5.count_work(scene, frame, inputs["seed"], dev, block)
    return ops(scene.ptype, scene.is_light, work), nbytes(scene, frame)

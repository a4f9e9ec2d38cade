"""Scene arrays from a configuration file's ``scene`` entry, in numpy.

``spheres``: the list is the scene (smallpt's Cornell box, scene.h:30-40).
``hyper_sphere``: smallptGPU's ``scene_build_complex.pl`` fractal, a
depth-limited recursion that puts half-radius children on the six axis
directions of each sphere (never back where it came from), coloured by
depth, after the spheres listed under ``extra`` (its light and ground).

The benchmark hands the same arrays to the program and to the reference.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# The direction a child lies in, and the side it then came from.
_OFFSETS = ((-1.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, -1.0, 0.0), (0.0, 1.0, 0.0),
            (0.0, 0.0, -1.0), (0.0, 0.0, 1.0))
_BACK = (1, 0, 3, 2, 5, 4)
MATERIALS = {"DIFF": 0, "SPEC": 1, "REFR": 2}


def _fractal(max_depth: float, pos, radius: float, came_from: int) -> List[tuple]:
    out = []

    def rec(depth, p, rad, back):
        if depth > max_depth:
            return
        k = depth / max_depth
        out.append((rad, tuple(p), (0.75 * (1.0 - k), 0.0, 0.75 * k)))
        child = rad / 2.0
        for d, off in enumerate(_OFFSETS):
            if d == back:
                continue
            rec(depth + 1.0, tuple(p[i] + off[i] * (rad + child) for i in range(3)), child,
                _BACK[d])

    rec(0.0, tuple(pos), radius, came_from)
    return out


def build(scene: dict) -> Dict[str, np.ndarray]:
    """{center [N, 3], radius [N], emission [N, 3], color [N, 3], refl [N]}
    float32 (refl int32) of a configuration's ``scene`` entry."""
    spheres = [(s["radius"], s["center"], s["emission"], s["color"], MATERIALS[s["material"]])
               for s in scene.get("spheres", scene.get("extra", []))]
    if scene["kind"] == "hyper_sphere":
        f = scene["fractal"]
        spheres += [(r, p, (0.0, 0.0, 0.0), c, 0)
                    for r, p, c in _fractal(f["max_depth"], f["center"], f["radius"],
                                            f["came_from"])]
    elif scene["kind"] != "spheres":
        raise ValueError(f"unknown scene kind {scene['kind']!r}")
    if len(spheres) != scene["num_spheres"]:
        raise ValueError(f"built {len(spheres)} spheres, the file says {scene['num_spheres']}")
    return {
        "radius": np.array([s[0] for s in spheres], np.float32),
        "center": np.array([s[1] for s in spheres], np.float32).reshape(-1, 3),
        "emission": np.array([s[2] for s in spheres], np.float32).reshape(-1, 3),
        "color": np.array([s[3] for s in spheres], np.float32).reshape(-1, 3),
        "refl": np.array([s[4] for s in spheres], np.int32),
    }


def camera(config: dict):
    """(orig, target) float32 of a configuration's camera."""
    cam = config["camera"]
    return np.array(cam["orig"], np.float32), np.array(cam["target"], np.float32)

"""`.scn` scene file parser and writer, a numpy-only copy of the JAX
package's (se195_raytracer_tpu/scenes/parser.py).

Same grammar as the reference's ReadScene (displayfunc.cpp:120-180):

    camera ox oy oz  tx ty tz
    size N
    sphere rad  px py pz  ex ey ez  cx cy cz  mat      (N lines; mat 0|1|2)
"""

from __future__ import annotations

import io
from typing import Union

import numpy as np

from se195_raytracer_tpu_torch.core.types import SceneSpec


def parse_scn(text: str) -> SceneSpec:
    tokens = text.split()
    pos = 0

    def expect(word: str):
        nonlocal pos
        if pos >= len(tokens) or tokens[pos] != word:
            raise ValueError(
                f"expected {word!r} at token {pos}, got "
                f"{tokens[pos] if pos < len(tokens) else '<eof>'!r}"
            )
        pos += 1

    def floats(k: int) -> list:
        nonlocal pos
        vals = [float(tokens[pos + i]) for i in range(k)]
        pos += k
        return vals

    expect("camera")
    cam = floats(6)
    expect("size")
    n = int(tokens[pos])
    pos += 1

    rad, center, emission, color, refl = [], [], [], [], []
    for i in range(n):
        expect("sphere")
        v = floats(11)
        rad.append(v[0])
        center.append(v[1:4])
        emission.append(v[4:7])
        color.append(v[7:10])
        mat = int(v[10])
        if mat not in (0, 1, 2):
            raise ValueError(f"sphere #{i}: bad material {mat}")
        refl.append(mat)

    return SceneSpec(
        camera_orig=np.array(cam[:3], np.float32),
        camera_target=np.array(cam[3:], np.float32),
        radius=np.array(rad, np.float32),
        center=np.array(center, np.float32),
        emission=np.array(emission, np.float32),
        color=np.array(color, np.float32),
        refl=np.array(refl, np.int32),
    )


def load_scn(path_or_file: Union[str, io.TextIOBase]) -> SceneSpec:
    if hasattr(path_or_file, "read"):
        return parse_scn(path_or_file.read())
    with open(path_or_file) as f:
        return parse_scn(f.read())


def write_scn(spec: SceneSpec, path: str) -> None:
    """Write ``spec`` in the grammar above, every number as ``%.9g`` (enough
    digits that a float32 reads back to the same bits)."""
    with open(path, "w") as f:
        co, ct = spec.camera_orig, spec.camera_target
        f.write(f"camera {co[0]:.9g} {co[1]:.9g} {co[2]:.9g}  {ct[0]:.9g} {ct[1]:.9g} {ct[2]:.9g}\n")
        f.write(f"size {len(spec.radius)}\n")
        for i in range(len(spec.radius)):
            p, e, c = spec.center[i], spec.emission[i], spec.color[i]
            f.write(
                f"sphere {spec.radius[i]:.9g}  {p[0]:.9g} {p[1]:.9g} {p[2]:.9g}  "
                f"{e[0]:.9g} {e[1]:.9g} {e[2]:.9g}  {c[0]:.9g} {c[1]:.9g} {c[2]:.9g}  "
                f"{int(spec.refl[i])}\n"
            )

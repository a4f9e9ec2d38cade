"""TGA texture loader with the reference's own (quirky) semantics (twin of
se195_raytracer_tpu/io/tga.py).

``Texture::Texture(char*)`` (raytracer5/trunk/scene.cpp:38-60) does not parse
TGA properly: it takes width and height from header bytes 12-15, then treats
every byte from offset 18 (the id-field length in byte 0 is ignored) as
packed BGR pixels in file row order (no bottom-up flip), scaled by 1/256
(not 1/255):

    m_Bitmap[i] = Color(t[i*3+20], t[i*3+19], t[i*3+18]) / 256

This loader does the same byte for byte, so a textured render matches the
reference on files that a proper decoder would read otherwise.
"""

from __future__ import annotations

import numpy as np


def load_tga(path: str) -> np.ndarray:
    """Returns float32 [H, W, 3] RGB in [0, 1), reference semantics."""
    data = np.fromfile(path, dtype=np.uint8)
    if data.size < 18:
        raise ValueError(f"{path}: too short to be a TGA file")
    width = int(data[12]) + 256 * int(data[13])
    height = int(data[14]) + 256 * int(data[15])
    n = width * height * 3
    if data.size < 18 + n:
        raise ValueError(
            f"{path}: expected {18 + n} bytes for {width}x{height} 24-bpp, "
            f"got {data.size} (the reference loader assumes uncompressed type 2)"
        )
    bgr = data[18:18 + n].astype(np.float32) * (1.0 / 256.0)
    bgr = bgr.reshape(height, width, 3)
    return np.ascontiguousarray(bgr[..., ::-1])


def write_tga(path: str, rgb_u8: np.ndarray) -> None:
    """Write an uncompressed 24-bit TGA (type 2, BGR, rows in array order)
    that ``load_tga`` reads back as ``rgb_u8 / 256``."""
    rgb_u8 = np.asarray(rgb_u8, np.uint8)
    height, width, _ = rgb_u8.shape
    header = np.zeros(18, np.uint8)
    header[2] = 2
    header[12], header[13] = width & 0xFF, width >> 8
    header[14], header[15] = height & 0xFF, height >> 8
    header[16] = 24
    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(np.ascontiguousarray(rgb_u8[..., ::-1]).tobytes())

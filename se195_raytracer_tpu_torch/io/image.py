"""Image writers and readers, a numpy-only copy of the JAX package's: PPM
(displayfunc.cpp:254-270 / testapp.cpp:180-199 semantics), BMP
(bitmap.c:8-75 semantics — 24bpp bottom-up with row padding), and PNG
(via a minimal pure-python encoder, no external deps).

All writers take ``image``: uint8 [H, W, 3] with row 0 = top of image.
Use ops/tonemap.to_srgb_bytes to get bytes from radiance.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _as_u8(image: np.ndarray) -> np.ndarray:
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise TypeError("image must be uint8 [H, W, 3]; tone-map first")
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3], got {img.shape}")
    return img


def write_ppm(image: np.ndarray, path: str) -> None:
    """Binary P6 PPM, top row first."""
    img = _as_u8(image)
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())


def write_bmp(image: np.ndarray, path: str) -> None:
    """24-bpp BMP: BGR pixel order, bottom-up rows, 4-byte row padding —
    the layout hand-built by the reference's write_bmp_file (bitmap.c:8-75)."""
    img = _as_u8(image)
    h, w, _ = img.shape
    row_bytes = w * 3
    pad = (4 - row_bytes % 4) % 4
    image_size = (row_bytes + pad) * h
    file_size = 14 + 40 + image_size
    with open(path, "wb") as f:
        f.write(struct.pack("<2sIHHI", b"BM", file_size, 0, 0, 54))
        f.write(struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, image_size, 2835, 2835, 0, 0))
        bgr = img[:, :, ::-1]
        zeros = b"\x00" * pad
        for row in range(h - 1, -1, -1):  # bottom-up
            f.write(bgr[row].tobytes())
            f.write(zeros)


def write_png(image: np.ndarray, path: str) -> None:
    """Minimal RGB8 PNG encoder (zlib + filter 0)."""
    img = _as_u8(image)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[row].tobytes() for row in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def write_image(image: np.ndarray, path: str) -> None:
    """Dispatch on extension: .ppm / .bmp / .png."""
    low = path.lower()
    if low.endswith(".ppm"):
        write_ppm(image, path)
    elif low.endswith(".bmp"):
        write_bmp(image, path)
    elif low.endswith(".png"):
        write_png(image, path)
    else:
        raise ValueError(f"unsupported image extension: {path}")



def read_bmp(path: str) -> np.ndarray:
    """Reads a 24-bpp uncompressed BMP (the layout write_bmp/bitmap.c:8-75
    emits) -> uint8 [H, W, 3] RGB, top-down row order."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    (offset,) = struct.unpack_from("<I", data, 10)
    w, h = struct.unpack_from("<ii", data, 18)
    (bpp,) = struct.unpack_from("<H", data, 28)
    (compression,) = struct.unpack_from("<I", data, 30)
    if bpp != 24 or compression != 0:
        raise ValueError(f"{path}: only uncompressed 24-bpp supported")
    bottom_up = h > 0
    h = abs(h)
    row_bytes = w * 3
    stride = row_bytes + (4 - row_bytes % 4) % 4
    img = np.empty((h, w, 3), np.uint8)
    for row in range(h):
        src = offset + row * stride
        bgr = np.frombuffer(data, np.uint8, row_bytes, src).reshape(w, 3)
        dst = h - 1 - row if bottom_up else row
        img[dst] = bgr[:, ::-1]
    return img


def read_ppm(path: str) -> np.ndarray:
    """Read binary P6 PPM back into uint8 [H, W, 3]."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"P6"):
        raise ValueError("not a P6 PPM")
    # header: P6 <w> <h> <maxval> then raw bytes; comments allowed
    parts = []
    idx = 2
    while len(parts) < 3:
        while idx < len(data) and data[idx : idx + 1].isspace():
            idx += 1
        if data[idx : idx + 1] == b"#":
            while data[idx : idx + 1] != b"\n":
                idx += 1
            continue
        start = idx
        while idx < len(data) and not data[idx : idx + 1].isspace():
            idx += 1
        parts.append(int(data[start:idx]))
    idx += 1  # single whitespace after maxval
    w, h, _maxval = parts
    img = np.frombuffer(data, np.uint8, count=h * w * 3, offset=idx)
    return img.reshape(h, w, 3)

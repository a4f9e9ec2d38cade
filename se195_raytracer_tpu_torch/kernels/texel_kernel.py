"""K5: GetTexel's bilinear fetch (twin of se195_raytracer_tpu/kernels/
texel_kernel.py).

On the TPU the fetch is a set of one-hot bf16 matrix products against a
transposed, v-rolled atlas, because the TPU has no per-lane gather. On
Hopper it is a plain gather: the ``texel`` device function of
``csrc/whitted5_kernel.cu``, which K4 calls at every textured hit. The
one-hot formulation is not carried over; the function it computes is.

``pack_texel_atlas`` flattens all of a scene's textures into one float32
buffer with a (texel offset, Th, Tw) row per texture, which covers both JAX
paths: the same-shape atlas and the per-texture fetch. ``texel_fetch_cuda``
runs the device function alone over flat lanes, for its own check; on CPU
tensors it takes its plain version, ``texel_fetch_reference``, which gives
the values of ``models/whitted5._texel``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch


def pack_texel_atlas(textures: Sequence[torch.Tensor],
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """([texels, 3] float32 atlas, [T, 3] int32 table of (texel offset, Th,
    Tw)), the textures in order. With no textures, one black texel (never
    read: no primitive has a texture id)."""
    if not textures:
        dev = device if device is not None else "cpu"
        return (torch.zeros((1, 3), dtype=torch.float32, device=dev),
                torch.tensor([[0, 1, 1]], dtype=torch.int32, device=dev))
    rows, off = [], 0
    for t in textures:
        th, tw = int(t.shape[0]), int(t.shape[1])
        rows.append((off, th, tw))
        off += th * tw
    dev = textures[0].device
    atlas = torch.cat([t.to(torch.float32).reshape(-1, 3) for t in textures]).contiguous()
    return atlas, torch.tensor(rows, dtype=torch.int32, device=dev)


def texel_fetch_reference(atlas: torch.Tensor, textab: torch.Tensor, tex: torch.Tensor,
                          u: torch.Tensor, v: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """The plain version of K5: GetTexel at (u, v) of texture ``tex`` per
    lane, [3, R]; dead lanes give 0. The arithmetic of
    ``models/whitted5._texel`` (v scaled by the width, floor modulo wrap,
    blend c1 w1 + c2 w2 + c3 w3 + c4 w4)."""
    tex = tex.long()
    off, th, tw = textab[tex, 0], textab[tex, 1], textab[tex, 2]
    fu = (u + 1000.5) * tw.to(torch.float32)
    fv = (v + 1000.0) * tw.to(torch.float32)
    u1 = torch.floor(fu).to(torch.int32) % tw
    v1 = torch.floor(fv).to(torch.int32) % th
    u2 = (u1 + 1) % tw
    v2 = (v1 + 1) % th
    fracu = fu - torch.floor(fu)
    fracv = fv - torch.floor(fv)
    w1 = (1 - fracu) * (1 - fracv)
    w2 = fracu * (1 - fracv)
    w3 = (1 - fracu) * fracv
    w4 = fracu * fracv

    def at(vv, uu):
        return atlas[(off + vv * tw + uu).long()]

    out = (at(v1, u1) * w1[:, None] + at(v1, u2) * w2[:, None]
           + at(v2, u1) * w3[:, None] + at(v2, u2) * w4[:, None])
    return torch.where(live[:, None], out, 0.0).T.contiguous()


def texel_fetch_cuda(atlas: torch.Tensor, textab: torch.Tensor, tex: torch.Tensor,
                     u: torch.Tensor, v: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """K5 over R flat lanes -> [3, R] float32 (dead lanes 0). ``atlas`` and
    ``textab`` from ``pack_texel_atlas``; ``tex`` int32 texture ids, ``u``,
    ``v`` float32 texture coordinates, ``live`` bool, all [R] on one device.
    CPU tensors take ``texel_fetch_reference``."""
    r = u.shape[0]
    for name, t, dt in (("tex", tex, torch.int32), ("u", u, torch.float32),
                        ("v", v, torch.float32), ("live", live, torch.bool)):
        if t.shape != (r,) or t.dtype != dt or t.device != atlas.device:
            raise ValueError(f"{name}: need [{r}] {dt} on {atlas.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if atlas.dtype != torch.float32 or textab.dtype != torch.int32:
        raise ValueError("atlas must be float32 and textab int32")
    if atlas.device.type == "cpu":
        return texel_fetch_reference(atlas, textab, tex, u, v, live)
    if atlas.device.type != "cuda":
        raise ValueError(f"unsupported device {atlas.device}")
    args = [x.contiguous() for x in (atlas, textab, tex, u, v, live)]
    out = torch.empty((3, r), dtype=torch.float32, device=atlas.device)
    err = kernel_lib().texel_fetch_cuda(*(x.data_ptr() for x in args), r, out.data_ptr(),
                                        torch.cuda.current_stream(atlas.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"texel_fetch_cuda launch failed: cudaError {err}")
    texel_fetch_cuda.launches += 1
    return out


texel_fetch_cuda.launches = 0


def kernel_lib() -> ctypes.CDLL:
    """The library of ``csrc/whitted5_kernel.cu`` (K4 and K5), with its
    argument types set."""
    from se195_raytracer_tpu_torch.kernels._build import load

    lib = load("whitted5_kernel")
    if lib.whitted5_trace_cuda.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.whitted5_trace_cuda.argtypes = [p, p, p, i, p, p, i, p, p, i, i, p, p, i, i,
                                            ctypes.POINTER(ctypes.c_int), f, p, p, p]
        lib.texel_fetch_cuda.argtypes = [p, p, p, p, p, p, i, p, p]
        lib.whitted5_trace_cuda.restype = lib.texel_fetch_cuda.restype = ctypes.c_int
    return lib

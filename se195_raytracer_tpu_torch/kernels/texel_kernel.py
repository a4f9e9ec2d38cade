"""K5: GetTexel's bilinear fetch (twin of se195_raytracer_tpu/kernels/
texel_kernel.py).

On the TPU the fetch is a set of one-hot bf16 matrix products against a
transposed, v-rolled atlas, because the TPU has no per-lane gather. On
Hopper it is a gather: the ``texel`` device function of
``csrc/whitted5_kernel.cu``, which K4 calls at every textured hit. The
one-hot formulation is not carried over; the function it computes is, and
so are the two facts the TPU kernel rests on: the table is rolled so that
one lookup yields both bilinear rows, and the reference's TGA texels
(k/256) are exact in a narrow type.

``pack_texel_units`` builds the layout the kernel reads, once per scene:
one 16-byte unit per texel. Where every texel of a texture is k/256, unit
(v, u) holds the texel's bilinear quad, its four corners with the wrap
applied, as u8: a fetch is one 128-bit load. Any other texture keeps its
texels as float32 RGBA (A = 0): a fetch is four 128-bit loads, none across
a sector. ``pack_texel_atlas`` flattens the textures into the [texels, 3]
float32 atlas that K5's plain version, ``texel_fetch_reference``, reads;
it gives the values of ``models/whitted5._texel``.
``texel_fetch_units_reference`` reads the units in torch, as the kernel
does: a test oracle of the packing, never on the main path.
``texel_fetch_cuda`` runs the device function alone over flat lanes; on
CPU tensors it takes ``texel_fetch_reference``.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from se195_raytracer_tpu_torch.kernels._guard import refuse_grad

# Texture forms of the texel units (kTexF32, kTexU8 in csrc/whitted5_kernel.cu).
TEX_F32 = 0
TEX_U8 = 1
# Bytes of one texel unit: a u8 quad (12 bytes and 4 of padding) or a
# float32 RGBA texel.
UNIT_BYTES = 16


class TexelUnits(NamedTuple):
    """The texel units of a scene's textures (``pack_texel_units``)."""

    units: torch.Tensor  # [texels, 16] uint8
    table: torch.Tensor  # [T, 4] int32: (texel offset, th, tw, form)


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


def atlas_textures(atlas: torch.Tensor, textab: torch.Tensor) -> List[torch.Tensor]:
    """The [Th, Tw, 3] textures of a ``pack_texel_atlas`` atlas (views)."""
    return [atlas[off:off + th * tw].reshape(th, tw, 3) for off, th, tw in textab.tolist()]


def texel_forms(textures: Sequence[torch.Tensor]) -> List[int]:
    """Each texture's form: TEX_U8 where every texel is k/256 with integer
    k in 0..255 and no sign bit set (u8 * (1/256) then gives the same float
    bit for bit: a power-of-two scale is exact, and -0.0 would come back as
    +0.0), else TEX_F32. Tested on the textures' device, one read-back."""
    if not textures:
        return []
    ok = []
    for t in textures:
        t = t.to(torch.float32)
        k = t * 256.0
        ok.append(((k == torch.floor(k)) & (k >= 0.0) & (k <= 255.0)
                   & ~torch.signbit(t)).all())
    return [TEX_U8 if x else TEX_F32 for x in torch.stack(ok).tolist()]


def pack_texel_units(textures: Sequence[torch.Tensor], device=None) -> TexelUnits:
    """The texel units K5 reads: unit (v, u) of a texture, row major per
    texture, the textures one after another (so a texture's offset is its
    texel offset in ``pack_texel_atlas``). A u8 texture (``texel_forms``)
    stores there its corners (v, u), (v, u2), (v2, u), (v2, u2), u2 = (u +
    1) mod Tw and v2 = (v + 1) mod Th, channel-major (red of the four
    corners, then green, then blue) as 12 bytes k, then 4 zero bytes; any
    other texture its texel as float32 (r, g, b, 0). With no textures, one
    zero unit (never read)."""
    if not textures:
        dev = device if device is not None else "cpu"
        return TexelUnits(torch.zeros((1, UNIT_BYTES), dtype=torch.uint8, device=dev),
                          torch.tensor([[0, 1, 1, TEX_F32]], dtype=torch.int32, device=dev))
    parts, rows, off = [], [], 0
    for t, form in zip(textures, texel_forms(textures)):
        th, tw = int(t.shape[0]), int(t.shape[1])
        t = t.to(torch.float32)
        if form == TEX_U8:
            right = torch.roll(t, -1, dims=1)
            # [Th, Tw, 3 channels, 4 corners]
            q = torch.stack([t, right, torch.roll(t, -1, dims=0), torch.roll(right, -1, dims=0)],
                            dim=-1).reshape(th * tw, 12)
            q = (q * 256.0).to(torch.uint8)
            part = torch.cat([q, q.new_zeros((th * tw, 4))], dim=1)
        else:
            part = torch.cat([t.reshape(th * tw, 3), t.new_zeros((th * tw, 1))],
                             dim=1).view(torch.uint8)
        rows.append((off, th, tw, form))
        parts.append(part)
        off += th * tw
    dev = textures[0].device
    return TexelUnits(torch.cat(parts).contiguous(),
                      torch.tensor(rows, dtype=torch.int32, device=dev))


def floor_mod(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The kernel's floor modulo for m > 0: C's truncating remainder, then
    m added where it is negative (one division). Equals torch's ``a % m``
    for every int32 a."""
    r = torch.fmod(a, m)
    return torch.where(r < 0, r + m, r)


def _weights(tw: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """GetTexel's scaled coordinates (v scaled by the width), their floors
    and the four bilinear weights."""
    ftw = tw.to(torch.float32)
    fu = (u + 1000.5) * ftw
    fv = (v + 1000.0) * ftw
    fracu = fu - torch.floor(fu)
    fracv = fv - torch.floor(fv)
    w = ((1 - fracu) * (1 - fracv), fracu * (1 - fracv), (1 - fracu) * fracv, fracu * fracv)
    return torch.floor(fu).to(torch.int32), torch.floor(fv).to(torch.int32), w


def texel_fetch_reference(atlas: torch.Tensor, textab: torch.Tensor, tex: torch.Tensor,
                          u: torch.Tensor, v: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """The plain version of K5: GetTexel at (u, v) of texture ``tex`` per
    lane, [3, R]; dead lanes give 0. The arithmetic of
    ``models/whitted5._texel`` (v scaled by the width, floor modulo wrap,
    blend c1 w1 + c2 w2 + c3 w3 + c4 w4)."""
    tex = tex.long()
    off, th, tw = textab[tex, 0], textab[tex, 1], textab[tex, 2]
    iu, iv, (w1, w2, w3, w4) = _weights(tw, u, v)
    u1 = iu % tw
    v1 = iv % th
    u2 = (u1 + 1) % tw
    v2 = (v1 + 1) % th

    def at(vv, uu):
        return atlas[(off + vv * tw + uu).long()]

    out = (at(v1, u1) * w1[:, None] + at(v1, u2) * w2[:, None]
           + at(v2, u1) * w3[:, None] + at(v2, u2) * w4[:, None])
    return torch.where(live[:, None], out, 0.0).T.contiguous()


def texel_fetch_units_reference(layout: TexelUnits, tex: torch.Tensor, u: torch.Tensor,
                                v: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """GetTexel read from the texel units as the kernel reads them: the
    one-division ``floor_mod`` for u1 and v1; a u8 texture's quad at (v1,
    u1) times 1/256, a float texture's four texels at (v1 or v2, u1 or u2)
    with u2 and v2 wrapped by a compare; the same blend. [3, R], dead lanes
    0. A test oracle of ``pack_texel_units``."""
    row = layout.table[tex.long()]
    off, th, tw, form = row[:, 0], row[:, 1], row[:, 2], row[:, 3]
    iu, iv, (w1, w2, w3, w4) = _weights(tw, u, v)
    u1, v1 = floor_mod(iu, tw), floor_mod(iv, th)
    u2 = torch.where(u1 + 1 == tw, 0, u1 + 1)
    v2 = torch.where(v1 + 1 == th, 0, v1 + 1)
    c = torch.zeros((u.shape[0], 3, 4), dtype=torch.float32, device=u.device)
    u8 = form == TEX_U8
    quad = layout.units[(off + v1 * tw + u1)[u8].long()]
    c[u8] = quad[:, :12].to(torch.float32).reshape(-1, 3, 4) * (1.0 / 256.0)
    f = ~u8
    corners = torch.stack([v1 * tw + u1, v1 * tw + u2, v2 * tw + u1, v2 * tw + u2], dim=1)
    texels = layout.units[(off[:, None] + corners)[f].long()]  # [M, 4 corners, 16]
    c[f] = texels.view(torch.float32)[:, :, :3].transpose(1, 2)
    out = (c[:, :, 0] * w1[:, None] + c[:, :, 1] * w2[:, None]
           + c[:, :, 2] * w3[:, None] + c[:, :, 3] * w4[:, None])
    return torch.where(live[:, None], out, 0.0).T.contiguous()


def texel_fetch_cuda(atlas: torch.Tensor, textab: torch.Tensor, tex: torch.Tensor,
                     u: torch.Tensor, v: torch.Tensor, live: torch.Tensor,
                     layout: Optional[TexelUnits] = None) -> torch.Tensor:
    """K5 over R flat lanes -> [3, R] float32 (dead lanes 0). ``atlas`` and
    ``textab`` from ``pack_texel_atlas``; ``tex`` int32 texture ids, ``u``,
    ``v`` float32 texture coordinates, ``live`` bool, all [R] on one device.
    The kernel reads ``layout``, ``pack_texel_units`` of the same textures;
    when it is not given, it is packed here from the atlas (a caller that
    fetches more than once packs it once). CPU tensors take
    ``texel_fetch_reference``."""
    refuse_grad("texel_fetch_cuda", atlas, u, v)
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
    if layout is None:
        layout = pack_texel_units(atlas_textures(atlas, textab))
    units, table = layout
    if (units.device != atlas.device or table.device != atlas.device or units.dtype != torch.uint8
            or units.shape != (atlas.shape[0], UNIT_BYTES) or table.shape != (textab.shape[0], 4)):
        raise ValueError("layout: need pack_texel_units of the atlas's textures, on its device")
    args = [x.contiguous() for x in (units, table, tex, u, v, live)]
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

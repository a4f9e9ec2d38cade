"""The plain reference of the smallpt path tracer: a frozen copy, in plain
PyTorch, of the integrator the program under test implements.

smallptGPU v1.6 (geomfunc.h RadiancePathTracing:167-338,
RadianceDirectLighting:340-483, SampleLights:112-165, SphereIntersect:32-59;
rendering_kernel.cl GenerateCameraRay:29-51; simplernd.h GetRandom:34-48;
displayfunc.cpp UpdateCamera:182-195) with its per-pixel seeds drawn as
numpy's PCG64 draws them (``integers(2, 2**31 - 1)``, s0 for every pixel,
then s1). Every lane runs every bounce with masked selects in place of
branches, and the RNG advances under the same masks, so a lane draws
exactly the numbers the reference's work item draws.

It imports nothing of the program. ``dtype`` runs the floating-point parts
in another precision (the benchmark's control runs it in bfloat16); the RNG
stays integer. Gradients flow through the scene's and the camera's tensors
(``torch.where`` guards keep the backward finite where the reference's
values are kept).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

DIFF, SPEC, REFR = 0, 1, 2
EPSILON = 0.01  # geom.h:29
INF = 1e20  # geomfunc.h:80
FLOAT_PI = float(np.float32(np.pi))
TWO_PI = float(np.float32(2.0 * FLOAT_PI))
FOUR_PI = float(np.float32(4.0 * np.pi))
M32 = 0xFFFFFFFF


class Scene(NamedTuple):
    center: torch.Tensor  # [N, 3]
    radius: torch.Tensor  # [N]
    emission: torch.Tensor  # [N, 3]
    color: torch.Tensor  # [N, 3]
    refl: torch.Tensor  # [N] int64: DIFF, SPEC, REFR
    lights: Tuple[int, ...]  # emissive spheres, ascending


class Basis(NamedTuple):
    orig: torch.Tensor
    dir: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor


def lights_of(emission: np.ndarray) -> Tuple[int, ...]:
    """The spheres the reference treats as lights: its ``viszero`` macro
    (vec.h:44) tests x twice and never y."""
    e = np.asarray(emission, np.float32).reshape(-1, 3)
    return tuple(i for i in range(e.shape[0]) if not (e[i, 0] == 0.0 and e[i, 2] == 0.0))


def make_scene(arrays: dict, device, dtype=torch.float32) -> Scene:
    """A ``Scene`` from host arrays (``scenes.build``'s output)."""
    def f(k):
        return torch.tensor(np.asarray(arrays[k], np.float32), device=device).to(dtype)

    return Scene(f("center").reshape(-1, 3), f("radius").reshape(-1), f("emission").reshape(-1, 3),
                 f("color").reshape(-1, 3),
                 torch.tensor(np.asarray(arrays["refl"], np.int64), device=device),
                 lights_of(arrays["emission"]))


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root in ``x``'s precision (the float64
    root rounded, as the reference's IEEE sqrtf)."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Summed left to right, as the reference sums a dot product."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def sign(mask: torch.Tensor, dtype) -> torch.Tensor:
    """1 where ``mask``, else -1."""
    return torch.where(mask, 1.0, -1.0).to(dtype)


def seeds(seed: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """The per-pixel MWC seeds of a frame of ``n`` pixels: numpy's PCG64
    draw, s0 of every pixel and then s1, each in [2, 2**31 - 2]."""
    s = np.random.Generator(np.random.PCG64(seed)).integers(2, 2**31 - 1, size=(2, n),
                                                             dtype=np.uint32)
    return s[0], s[1]


def mwc_draw(s0: torch.Tensor, s1: torch.Tensor, mask: torch.Tensor, dtype):
    """GetRandom (simplernd.h:34-48) on int64 words; the state advances on
    ``mask`` only. Returns (value in ``dtype``, s0, s1)."""
    n0 = 36969 * (s0 & 0xFFFF) + (s0 >> 16)
    n1 = 18000 * (s1 & 0xFFFF) + (s1 >> 16)
    bits = ((((n0 << 16) + n1) & M32) & 0x007FFFFF) | 0x40000000
    value = ((bits.to(torch.int32).view(torch.float32) - 2.0) * 0.5).to(dtype)
    return value, torch.where(mask, n0, s0), torch.where(mask, n1, s1)


def camera_basis(orig: torch.Tensor, target: torch.Tensor, width: int, height: int) -> Basis:
    """UpdateCamera (displayfunc.cpp:182-195): fov 45 degrees, the x axis
    scaled by width * fov / height, the y axis by fov."""
    d = target - orig
    d = d * (1.0 / sqrt_rn(dot3(d, d)))
    up = torch.zeros(3, dtype=d.dtype, device=d.device)
    up[1] = 1.0
    fov = np.float32(np.pi / 180.0) * np.float32(45.0)
    cx = cross(d, up)
    cx = cx * (1.0 / sqrt_rn(dot3(cx, cx)))
    cx = cx * float(np.float32(width) * fov / np.float32(height))
    cy = cross(cx, d)
    cy = cy * (1.0 / sqrt_rn(dot3(cy, cy)))
    cy = cy * float(fov)
    return Basis(orig, d, cx, cy)


class _Rows(torch.autograd.Function):
    """``table[idx]``; the backward sums each row's cotangents with a one-hot
    product (deterministic, and fast where many lanes share a row)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        onehot = (torch.arange(ctx.rows, device=idx.device)[:, None] == idx[None, :])
        return onehot.to(grad.dtype) @ grad, None


def rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if table.requires_grad and torch.is_grad_enabled():
        return _Rows.apply(table, idx)
    return table[idx]


def sphere_t(scene: Scene, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """[R, N] hit distances, 0 for a miss (SphereIntersect)."""
    op = scene.center[None, :, :] - o[:, None, :]
    b = dot3(op, d[:, None, :])
    det = b * b - dot3(op, op) + (scene.radius * scene.radius)[None, :]
    pos = det > 0.0
    sq = torch.where(pos, sqrt_rn(torch.where(pos, det, 1.0)), 0.0)
    t1, t2 = b - sq, b + sq
    t = torch.where(t1 > EPSILON, t1, torch.where(t2 > EPSILON, t2, 0.0))
    return torch.where(det >= 0.0, t, 0.0)


def nearest(scene: Scene, o, d):
    """(t, id, hit): the sweep N-1 .. 0 keeps a new best on a strict ``<``,
    so the largest index wins a tie."""
    tm = sphere_t(scene, o, d)
    tm = torch.where(tm != 0.0, tm, INF)
    n = tm.shape[-1]
    hid = (n - 1) - torch.argmin(torch.flip(tm, dims=(-1,)), dim=-1)
    t = torch.gather(tm, -1, hid[:, None])[:, 0]
    return t, hid, t < INF


def occluded(scene: Scene, o, d, max_t) -> torch.Tensor:
    tm = sphere_t(scene, o, d)
    return torch.any((tm != 0.0) & (tm < max_t[:, None]), dim=-1)


def camera_rays(basis: Basis, s0, s1, width: int, height: int, pix: torch.Tensor, dtype):
    """GenerateCameraRay: two draws a pixel; camera y counts up from the
    image's bottom row."""
    on = torch.ones(pix.shape, dtype=torch.bool, device=pix.device)
    r1, s0, s1 = mwc_draw(s0, s1, on, dtype)
    r2, s0, s1 = mwc_draw(s0, s1, on, dtype)
    xs = (pix % width).to(dtype)
    ys = ((height - 1) - pix // width).to(dtype)
    kcx = (xs + (r1 - 0.5)) * float(np.float32(1.0 / width)) - 0.5
    kcy = (ys + (r2 - 0.5)) * float(np.float32(1.0 / height)) - 0.5
    d = basis.x[None, :] * kcx[:, None] + basis.y[None, :] * kcy[:, None] + basis.dir[None, :]
    o = 0.1 * d + basis.orig[None, :]
    d = d * (1.0 / sqrt_rn(dot3(d, d))[:, None])
    return o, d, s0, s1


def _sphere_point(u1, u2):
    """UniformSampleSphere (geomfunc.h:61-69)."""
    zz = 1.0 - 2.0 * u1
    r = sqrt_rn(torch.clamp(1.0 - zz * zz, min=0.0))
    phi = TWO_PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), zz], dim=-1)


def _cosine_dir(nl, r1u, r2):
    """The diffuse bounce's direction (geomfunc.h:242-265), not renormalised."""
    r1 = TWO_PI * r1u
    r2s = sqrt_rn(r2)
    ey = torch.zeros(3, dtype=nl.dtype, device=nl.device)
    ey[1] = 1.0
    ex = torch.zeros(3, dtype=nl.dtype, device=nl.device)
    ex[0] = 1.0
    a = torch.where((torch.abs(nl[:, 0]) > 0.1)[:, None], ey, ex)
    u = cross(a, nl)
    u = u * (1.0 / sqrt_rn(dot3(u, u))[:, None])
    v = cross(nl, u)
    return (u * (torch.cos(r1) * r2s)[:, None] + v * (torch.sin(r1) * r2s)[:, None]
            + nl * sqrt_rn(torch.clamp(1.0 - r2, min=0.0))[:, None])


Hook = Optional[Callable[[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]], None]]


def _lights(scene: Scene, s0, s1, hp, nl, mask, dtype, on_sweep: Hook):
    """SampleLights: two draws a light, in index order, the first one u2."""
    ld = torch.zeros_like(hp)
    for li in scene.lights:
        a, s0, s1 = mwc_draw(s0, s1, mask, dtype)
        b, s0, s1 = mwc_draw(s0, s1, mask, dtype)
        usp = _sphere_point(b, a)
        sdir = scene.radius[li] * usp + scene.center[li][None, :] - hp
        len2 = dot3(sdir, sdir)
        pos = len2 > 0.0
        length = torch.where(pos, sqrt_rn(torch.where(pos, len2, 1.0)), 0.0)
        safe = torch.clamp(length, min=1e-20)
        sdir = sdir / safe[:, None]
        wo = dot3(sdir, usp)
        wi = dot3(sdir, nl)
        s = FOUR_PI * scene.radius[li] * scene.radius[li] * wi * (-wo) / (safe * safe)
        shoot = ~(wo > 0.0) & (wi > 0.0) & mask
        blocked = occluded(scene, hp, sdir, length - EPSILON)
        if on_sweep is not None:
            on_sweep(hp, sdir, shoot, length - EPSILON)
        ld = ld + torch.where((shoot & ~blocked)[:, None], s[:, None] * scene.emission[li][None, :],
                              0.0)
    return ld, s0, s1


def _bounce(scene: Scene, direct_only: bool, o, d, rad, thr, alive, spec_b, s0, s1, dtype,
            on_sweep: Hook):
    """One pass of the bounce loop's body over all lanes."""
    if on_sweep is not None:
        on_sweep(o, d, alive, None)
    t, hid, hit = nearest(scene, o, d)
    act = alive & hit
    hp = o + torch.where(hit, t, 1.0)[:, None] * d
    n = hp - rows(scene.center, hid)
    n = n * (1.0 / sqrt_rn(torch.clamp(dot3(n, n), min=1e-38))[:, None])
    dp = dot3(n, d)
    nl = sign(~(dp > 0.0), dtype)[:, None] * n
    e = rows(scene.emission, hid)
    c = rows(scene.color, hid)
    emissive = (e[:, 0] != 0.0) | (e[:, 2] != 0.0)
    rad = rad + torch.where((act & emissive & spec_b)[:, None], torch.abs(dp)[:, None] * thr * e,
                            0.0)
    live = act & ~emissive
    mat = scene.refl[hid]
    is_diff = live & (mat == DIFF)
    is_spec = live & (mat == SPEC)
    is_refr = live & (mat != DIFF) & (mat != SPEC)

    thr_c = thr * c
    ld, s0, s1 = _lights(scene, s0, s1, hp, nl, is_diff, dtype, on_sweep)
    rad = rad + torch.where(is_diff[:, None], thr_c * ld, 0.0)
    if direct_only:
        nd_diff = d
    else:
        r1, s0, s1 = mwc_draw(s0, s1, is_diff, dtype)
        r2, s0, s1 = mwc_draw(s0, s1, is_diff, dtype)
        nd_diff = _cosine_dir(nl, r1, r2)
    refl_dir = d - (2.0 * dp)[:, None] * n

    into = dot3(n, nl) > 0.0
    nnt = torch.where(into, float(np.float32(1.0 / 1.5)), 1.5).to(dtype)
    ddn = dot3(d, nl)
    cos2t = 1.0 - nnt * nnt * (1.0 - ddn * ddn)
    tir = cos2t < 0.0
    kk = sign(into, dtype) * (ddn * nnt + sqrt_rn(torch.where(tir, 1.0, cos2t)))
    tdir = nnt[:, None] * d - kk[:, None] * n
    tdir = tdir * (1.0 / sqrt_rn(torch.clamp(dot3(tdir, tdir), min=1e-38))[:, None])
    r0 = float(np.float32(0.25 / 6.25))
    c1 = 1.0 - torch.where(into, -ddn, dot3(tdir, n))
    re = r0 + (1.0 - r0) * c1 * c1 * c1 * c1 * c1
    p = 0.25 + 0.5 * re
    u, s0, s1 = mwc_draw(s0, s1, is_refr & ~tir, dtype)
    pick = u < p
    refr_refl = is_refr & (tir | pick)
    refr_trans = is_refr & ~tir & ~pick

    thr_new = torch.where(
        (is_diff | is_spec | (is_refr & tir))[:, None], thr_c,
        torch.where((is_refr & ~tir & pick)[:, None], (re / p)[:, None] * thr * c,
                    torch.where(refr_trans[:, None], ((1.0 - re) / (1.0 - p))[:, None] * thr * c,
                                thr)))
    d_new = torch.where(is_diff[:, None], nd_diff,
                        torch.where((is_spec | refr_refl)[:, None], refl_dir,
                                    torch.where(refr_trans[:, None], tdir, d)))
    o = torch.where(live[:, None], hp, o)
    spec_b = torch.where(is_diff, False, torch.where(is_spec | is_refr, True, spec_b))
    alive = live & ~is_diff if direct_only else live
    d = torch.where(live[:, None], d_new, d)
    thr = torch.where(live[:, None], thr_new, thr)
    return o, d, rad, thr, alive, spec_b, s0, s1


def radiance(scene: Scene, o, d, s0, s1, max_depth: int, direct_only: bool, dtype,
             on_sweep: Hook = None):
    """[R, 3] radiance of a batch of rays and the advanced RNG words.
    ``on_sweep(o, d, mask, max_t)`` sees every sweep: each bounce's nearest
    sweep over the lanes alive at its start (``max_t`` None) and each shadow
    sweep over the lanes that shoot a shadow ray."""
    r = o.shape[0]
    rad = torch.zeros((r, 3), dtype=dtype, device=o.device)
    thr = torch.ones((r, 3), dtype=dtype, device=o.device)
    alive = torch.ones((r,), dtype=torch.bool, device=o.device)
    spec_b = torch.ones((r,), dtype=torch.bool, device=o.device)
    for _ in range(max_depth):
        o, d, rad, thr, alive, spec_b, s0, s1 = _bounce(scene, direct_only, o, d, rad, thr, alive,
                                                        spec_b, s0, s1, dtype, on_sweep)
    return rad, s0, s1


class Frame(NamedTuple):
    """What a render is: the frame, its samples and the integrator's
    settings."""
    width: int
    height: int
    spp: int
    max_depth: int = 7
    direct_only: bool = False


def one_pass(scene: Scene, basis: Basis, frame: Frame, pix: torch.Tensor, s0, s1, dtype,
             on_sweep: Hook = None):
    """One sample of each pixel of ``pix`` from the RNG words (s0, s1):
    (radiance [P, 3], s0, s1)."""
    o, d, s0, s1 = camera_rays(basis, s0, s1, frame.width, frame.height, pix, dtype)
    return radiance(scene, o, d, s0, s1, frame.max_depth, frame.direct_only, dtype, on_sweep)


def accumulate(acc, rad, k: int, mean: str):
    """The running mean after pass ``k``. "reciprocal", as the kernels keep
    it: ``(acc * k + r) * fl(1 / (k + 1))``; "divide", as the
    differentiable render does: ``(acc * k + r) / (k + 1)``."""
    if mean == "reciprocal":
        return (acc * float(k) + rad) * float(np.float32(1.0) / np.float32(k + 1))
    return (acc * float(k) + rad) / (float(k) + 1.0)


def pixel_words(words: Tuple[np.ndarray, np.ndarray], pix: torch.Tensor):
    """The int64 RNG words of ``pix`` on its device."""
    idx = pix.cpu().numpy()
    return tuple(torch.from_numpy(w[idx].astype(np.int64)).to(pix.device) for w in words)


def render_pixels(scene: Scene, basis: Basis, frame: Frame, seed: int, pixels: torch.Tensor,
                  dtype=torch.float32, mean: str = "reciprocal", block: int = 1 << 16,
                  on_sweep: Hook = None, seed_words: Optional[Tuple[np.ndarray, np.ndarray]] = None
                  ) -> torch.Tensor:
    """[P, 3] values of the row-major ``pixels`` (int64, on the device) of a
    frame rendered with ``seed``, ``frame.spp`` passes and the running mean
    ``mean`` (``accumulate``), in blocks of ``block`` pixels."""
    words = seeds(seed, frame.width * frame.height) if seed_words is None else seed_words
    out = []
    for a in range(0, pixels.shape[0], block):
        pix = pixels[a:a + block]
        s0, s1 = pixel_words(words, pix)
        acc = torch.zeros((pix.shape[0], 3), dtype=dtype, device=pix.device)
        for k in range(frame.spp):
            rad, s0, s1 = one_pass(scene, basis, frame, pix, s0, s1, dtype, on_sweep)
            acc = accumulate(acc, rad, k, mean)
        out.append(acc)
    return torch.cat(out)


def all_pixels(frame: Frame, device) -> torch.Tensor:
    return torch.arange(frame.width * frame.height, dtype=torch.int64, device=device)


def sample_pixels(frame: Frame, count: int, rng: np.random.Generator, device) -> torch.Tensor:
    """``count`` distinct pixels of the frame, ascending, drawn by ``rng``."""
    n = frame.width * frame.height
    pick = np.sort(rng.choice(n, size=min(count, n), replace=False))
    return torch.from_numpy(pick.astype(np.int64)).to(device)


def image_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """sum |got - want| / sum |want|, in float64: the share of the
    reference's light that the rendered pixels misplace."""
    got, want = got.to(torch.float64), want.to(torch.float64)
    den = float(want.abs().sum())
    num = float((got - want).abs().sum())
    if not np.isfinite(num):
        return float("inf")
    return num / den if den > 0.0 else (0.0 if num == 0.0 else float("inf"))


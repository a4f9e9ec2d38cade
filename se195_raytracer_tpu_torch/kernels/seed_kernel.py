"""The per-render seed init of K1/K2's lane state on the card, bitwise numpy.

The JAX package draws a render's seeds on the host (twin of
se195_raytracer_tpu/core/rng.py:63-72 ``init_mwc_state`` and :94-107
``init_counter_state``) and lays them out in lane order
(``render_pallas``, kernels/pt_kernel.py:897-906). There is no Pallas kernel
behind it. ``seed_lanes`` does the same on a CUDA device with
``csrc/seed_kernel.cu`` and gives the same bits, without the host draw and
its copy to the card.

The MWC seeds are ``Generator(PCG64(seed)).integers(2, 2**31 - 1,
size=(2, n), dtype=uint32)``: draw ``k`` of that flat stream (s0 of pixel p
is draw p, s1 draw n + p) is PCG64's 64-bit outputs split into 32-bit words,
low word first, each word ``u`` mapped by Lemire's multiply ``m = u * R``
(R = 2**31 - 3) to ``(m >> 32) + 2``, and a word whose low product word is
below ``(2**32 - R) % R`` = 6 rejected: it yields no draw and every later
draw moves one word on. So a draw is found by jump-ahead, given where the
rejections lie. Two passes:

1. *scan*: every word in [0, 2n + capacity) is checked and the indices of
   the rejected ones are listed (at most ``capacity``; the count is exact).
   The list covers every word a draw can need as long as the count is at
   most ``capacity``; a longer list raises (about 1.4e-9 per word, so
   never at real sizes, but never silently).
2. *draw*: lane l's draw k comes from word w, the least fixed point of
   ``w = k + #(listed rejections <= w)``, PCG64's output ``w >> 1`` reached
   by jump-ahead (numpy's ``pcg_advance_lcg_128``, square and multiply with
   the LCG multiplier), its XSL-RR output taken after the step, as numpy's
   ``pcg64_random_r`` takes it.

The counter keys are the hash of ``init_counter_state`` of the lane's
absolute pixel id, the counter 0. Either way lane l holds pixel ``pix[l]``
(K2's blocked layout) or ``lane_offset + l`` (K1's identity layout, and a
shard of either), and a lane whose pixel is ``n`` or beyond is a pad lane:
2 in both words, as ``render_pallas`` pads.

``seed_lanes_reference`` is the plain PyTorch version of both passes (the
128-bit LCG in 16-bit limbs on int64 tensors); the tests and
``chip_smoke.py`` hold the kernel and numpy against it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

PCG_MULT = 0x2360ED051FC65DA44385DF649FCCF645
_M128 = (1 << 128) - 1
_M32 = 0xFFFFFFFF
# integers(2, 2**31 - 1): Lemire over R = 2**31 - 3 values, offset 2; a word
# is rejected when its low product word is below (2**32 - R) % R = 6.
LOW = 2
RANGE = 2**31 - 3
REJECT_BELOW = (2**32 - RANGE) % RANGE
# The rejection list's length: words past 2n that the scan checks too.
CAPACITY = 64
PAD = 2


@functools.lru_cache(maxsize=64)
def pcg64_state(seed: int) -> Tuple[int, int]:
    """(state, inc) of ``np.random.PCG64(seed)``: its SeedSequence seeding,
    kept in numpy (tens of us, once per seed)."""
    st = np.random.PCG64(seed).state["state"]
    return int(st["state"]), int(st["inc"])


def counter_seed_word(seed: int) -> int:
    return (seed * 0x85EBCA6B + 0x165667B1) & _M32


def _lane_pixels(lanes: int, pix: Optional[torch.Tensor], lane_offset: int,
                 device) -> torch.Tensor:
    if pix is not None:
        return pix.to(torch.int64)
    return torch.arange(lane_offset, lane_offset + lanes, dtype=torch.int64, device=device)


def _jump_bits(n: int, capacity: int) -> int:
    """Bits of the largest jump a draw or the scan takes: to output
    (2n + capacity) // 2 + 1."""
    return ((2 * n + capacity) // 2 + 1).bit_length()


def seed_lanes(rng: str, seed: int, n: int, lanes: Optional[int] = None, *,
               pix: Optional[torch.Tensor] = None, lane_offset: int = 0,
               device=None, capacity: int = CAPACITY) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fresh RNG state (two uint32 [lanes] tensors on ``device``) of a
    frame of ``n`` pixels, seeded with ``seed``: lane l holds pixel
    ``pix[l]`` (int32 on ``device``; then ``lanes`` may be None) or
    ``lane_offset + l``; a pixel at or past ``n`` is a pad lane (2, 2).
    ``rng`` "mwc": (s0, s1) of ``init_mwc_state((n,), seed)`` at those
    pixels; "counter": (key, counter) of ``init_counter_state``.

    On a CUDA device this launches ``csrc/seed_kernel.cu`` (or raises) and
    reads one word back, the scan's rejection count, to raise past
    ``capacity``; ``seed_lanes.launches`` counts these calls. On the CPU it
    takes numpy's draw (``core/rng.init_state``, the JAX package's own, and
    bitwise the kernel's) and gathers the lanes: ``seed_lanes_reference``
    gives the same bits at a far higher cost."""
    dev = torch.device(device if device is not None else "cuda")
    if rng not in ("mwc", "counter"):
        raise ValueError(f"unknown rng kind {rng!r}")
    if pix is not None:
        if (pix.dtype != torch.int32 or pix.dim() != 1 or pix.device.type != dev.type
                or dev.index is not None and pix.device != dev):
            raise ValueError(f"pix: need int32 [lanes] on {dev}, got {pix.dtype} "
                             f"{tuple(pix.shape)} on {pix.device}")
        if lane_offset:
            raise ValueError("pix holds absolute pixel ids: pass lane_offset=0 with it")
        dev, lanes = pix.device, pix.shape[0]
    if lanes is None:
        raise ValueError("seed_lanes: pass lanes or pix")
    if dev.type == "cpu":
        return _seed_lanes_host(rng, seed, n, lanes, pix, lane_offset)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    # Under a torch.func transform (the pixel-gradient check's jvp through
    # the plain recompute) a fresh tensor is a wrapper with no storage to
    # hand the kernel; the seeds carry no tangent, so they are made outside
    # it.
    with torch._C._DisableFuncTorch():
        s0, s1, count = _launch(rng, seed, n, lanes, pix, lane_offset, dev, capacity)
        rejected = 0 if count is None else int(count.item())
    if rejected > capacity:
        raise RuntimeError(f"seed {seed}: {rejected} rejected words in the first "
                           f"{2 * n + capacity} of PCG64's stream, more than the list "
                           f"holds ({capacity})")
    return s0, s1


def _launch(rng, seed, n, lanes, pix, lane_offset, dev, capacity):
    """The kernels of one seeding on ``dev``'s current stream: (s0, s1,
    the rejection count on the card, None for the counter keys), the count
    not read. Counts the launch in ``seed_lanes.launches``."""
    s0 = torch.empty((lanes,), dtype=torch.uint32, device=dev)
    s1 = torch.empty_like(s0)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if pix is not None:
        pix = pix.contiguous()
    pix_ptr = pix.data_ptr() if pix is not None else None
    if rng == "counter":
        err = lib.seed_counter_lanes_cuda(counter_seed_word(seed), n, pix_ptr, lane_offset,
                                          lanes, s0.data_ptr(), s1.data_ptr(), stream)
        _check(err, "seed_counter_lanes_cuda")
        seed_lanes.launches += 1
        return s0, s1, None
    state, inc = pcg64_state(seed)
    count = torch.empty((1,), dtype=torch.int32, device=dev)
    listed = torch.empty((max(capacity, 1),), dtype=torch.int64, device=dev)
    err = lib.seed_mwc_lanes_cuda(
        state >> 64, state & (2**64 - 1), inc >> 64, inc & (2**64 - 1), n,
        _jump_bits(n, capacity), pix_ptr, lane_offset, lanes,
        count.data_ptr(), listed.data_ptr(), capacity, s0.data_ptr(), s1.data_ptr(), stream)
    _check(err, "seed_mwc_lanes_cuda")
    seed_lanes.launches += 1
    return s0, s1, count


seed_lanes.launches = 0


def _check(err: int, entry: str) -> None:
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")


def _seed_lanes_host(rng, seed, n, lanes, pix, lane_offset):
    from se195_raytracer_tpu_torch.core.rng import init_state

    s0, s1 = init_state(rng, (n,), seed, device="cpu")
    p = _lane_pixels(lanes, pix, lane_offset, "cpu")
    pad = torch.full((1,), PAD, dtype=torch.uint32)
    s0, s1 = torch.cat([s0, pad]), torch.cat([s1, pad])
    p = torch.where((p >= 0) & (p < n), p, n)
    return s0[p], s1[p]


def _lib() -> ctypes.CDLL:
    from se195_raytracer_tpu_torch.kernels._build import load

    lib = load("seed_kernel")
    if lib.seed_mwc_lanes_cuda.argtypes is None:
        p, i, i64, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint64
        lib.seed_mwc_lanes_cuda.argtypes = [u64, u64, u64, u64, i64, i, p, i64, i64,
                                            p, p, i, p, p, p]
        lib.seed_counter_lanes_cuda.argtypes = [ctypes.c_uint32, i64, p, i64, i64, p, p, p]
        lib.seed_mwc_lanes_cuda.restype = lib.seed_counter_lanes_cuda.restype = ctypes.c_int
    return lib


# ---- the plain PyTorch version ---------------------------------------------
# A 128-bit value is [8, N] int64: 16-bit limbs, least significant first, so
# that a limb product (< 2**32) and a column of eight of them fit in int64.
# The scan jumps to _SCAN_STARTS outputs and steps on from each; the draws
# go _DRAW_CHUNK lanes at a time, which bounds the [8, 8, N] products' memory.
_SCAN_STARTS = 4096
_DRAW_CHUNK = 1 << 16

def _limbs(x: int) -> list:
    return [(x >> (16 * k)) & 0xFFFF for k in range(8)]


def _const(x: int, n: int, device) -> torch.Tensor:
    return torch.tensor(_limbs(x), dtype=torch.int64, device=device)[:, None].expand(8, n)


def _mul_add(a: torch.Tensor, mult: int, plus: int) -> torch.Tensor:
    """(a * mult + plus) mod 2**128, ``mult`` and ``plus`` Python ints: the
    schoolbook product's columns (each a sum of at most eight 32-bit limb
    products) as one matrix product, then the carries limb by limb."""
    ml = _limbs(mult)
    toeplitz = torch.tensor([[ml[k - i] if i <= k else 0 for i in range(8)] for k in range(8)],
                            dtype=torch.float64, device=a.device)
    # Exact in float64: every product and column sum is an integer below 2**35.
    cols = (toeplitz @ a.to(torch.float64)).to(torch.int64)
    out, carry = [], 0
    for k, p in enumerate(_limbs(plus)):
        v = cols[k] + (carry + p)
        out.append(v & 0xFFFF)
        carry = v >> 16
    return torch.stack(out)


def _advance(state: torch.Tensor, inc: int, delta: torch.Tensor) -> torch.Tensor:
    """Each column of ``state`` moved on by its ``delta`` LCG steps: numpy's
    ``pcg_advance_lcg_128``, applied straight to the state (the maps are
    powers of one affine map, so they commute)."""
    mult, plus = PCG_MULT, inc
    for bit in range(int(delta.max()).bit_length() if delta.numel() else 0):
        take = ((delta >> bit) & 1).bool()
        state = torch.where(take, _mul_add(state, mult, plus), state)
        plus = ((mult + 1) * plus) & _M128
        mult = (mult * mult) & _M128
    return state


def _xsl_rr(state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """PCG64's output of each state column, as its (low, high) 32-bit
    words: rotr64(hi ^ lo, state >> 122)."""
    x = state[:4] ^ state[4:]
    lo, hi = x[0] | (x[1] << 16), x[2] | (x[3] << 16)
    rot = state[7] >> 10
    big = rot >= 32
    lo, hi = torch.where(big, hi, lo), torch.where(big, lo, hi)
    r = rot & 31
    return (((lo >> r) | (hi << (32 - r))) & _M32, ((hi >> r) | (lo << (32 - r))) & _M32)


def _lemire(u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(value, rejected) of each 32-bit word."""
    m = u * RANGE
    return (m >> 32) + LOW, (m & _M32) < REJECT_BELOW


def scan_rejections_reference(seed: int, n: int, capacity: int = CAPACITY,
                              device="cpu") -> torch.Tensor:
    """Pass 1: the sorted indices of the rejected words in [0, 2n +
    capacity) of ``seed``'s stream (int64), as the kernel's scan finds
    them: ``_SCAN_STARTS`` jumps, then steps through consecutive outputs
    from each. Raises when there are more than ``capacity``."""
    state0, inc = pcg64_state(seed)
    limit = 2 * n + capacity
    outputs = (limit + 1) // 2
    chunk = -(-outputs // _SCAN_STARTS)
    j0 = torch.arange(0, outputs, chunk, dtype=torch.int64, device=device)
    state = _advance(_const(state0, j0.numel(), device), inc, j0)
    hits = []
    for i in range(chunk):
        state = _mul_add(state, PCG_MULT, inc)
        hits.append(torch.stack([_lemire(u)[1] for u in _xsl_rr(state)]))
    w = 2 * (j0[None, None, :] + torch.arange(chunk, device=device)[:, None, None]) + torch.arange(
        2, device=device)[None, :, None]  # [chunk, 2, starts] word index
    rejected = torch.sort(w[torch.stack(hits) & (w < limit)]).values
    if rejected.numel() > capacity:
        raise RuntimeError(f"seed {seed}: {rejected.numel()} rejected words in the first "
                           f"{limit} of PCG64's stream, more than the list holds ({capacity})")
    return rejected


def mwc_draws_reference(seed: int, k: torch.Tensor, rejected: torch.Tensor) -> torch.Tensor:
    """Pass 2: draw ``k`` (int64) of ``seed``'s flat stream, int64 in
    [2, 2**31 - 2], given the rejection list of pass 1."""
    state0, inc = pcg64_state(seed)
    w = k
    while True:  # the least fixed point of w = k + #(rejected <= w)
        nxt = k + (rejected[None, :] <= w[:, None]).sum(dim=1)
        if bool((nxt == w).all()):
            break
        w = nxt
    state = _advance(_const(state0, k.numel(), k.device), inc, (w >> 1) + 1)
    lo, hi = _xsl_rr(state)
    return _lemire(torch.where((w & 1).bool(), hi, lo))[0]


def seed_lanes_reference(rng: str, seed: int, n: int, lanes: Optional[int] = None, *,
                         pix: Optional[torch.Tensor] = None, lane_offset: int = 0,
                         device="cpu",
                         capacity: int = CAPACITY) -> Tuple[torch.Tensor, torch.Tensor]:
    """``seed_lanes`` in plain PyTorch on ``device``, both passes as the
    kernel runs them, the draws ``_DRAW_CHUNK`` lanes at a time."""
    chunk = _DRAW_CHUNK
    if pix is not None:
        lanes = pix.shape[0]
    p = _lane_pixels(lanes, pix, lane_offset, device)
    real = (p >= 0) & (p < n)
    if rng == "counter":
        key = (p * 0x9E3779B1) & _M32 ^ counter_seed_word(seed)
        key = key ^ (key >> 16)
        key = (key * 0x7FEB352D) & _M32
        key = key ^ (key >> 15)
        s0, s1 = key, torch.zeros_like(key)
    elif rng == "mwc":
        rejected = scan_rejections_reference(seed, n, capacity, device)
        k = torch.where(real, p, 0)
        s0 = torch.cat([mwc_draws_reference(seed, k[a:a + chunk], rejected)
                        for a in range(0, lanes, chunk)] or [k])
        s1 = torch.cat([mwc_draws_reference(seed, n + k[a:a + chunk], rejected)
                        for a in range(0, lanes, chunk)] or [k])
    else:
        raise ValueError(f"unknown rng kind {rng!r}")
    s0, s1 = torch.where(real, s0, PAD), torch.where(real, s1, PAD)
    return s0.to(torch.uint32), s1.to(torch.uint32)

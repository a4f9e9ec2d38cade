"""The per-render seed init of K1/K2's lane state on the card, bitwise numpy.

The JAX package draws a render's seeds on the host (twin of
se195_raytracer_tpu/core/rng.py:63-72 ``init_mwc_state`` and :94-107
``init_counter_state``) and lays them out in lane order
(``render_pallas``, kernels/pt_kernel.py:897-906). There is no Pallas kernel
behind it. ``seed_lanes`` does the same on a CUDA device with
``csrc/seed_kernel.cu`` and gives the same bits, without the host draw and
its copy to the card, and without reading anything back.

The MWC seeds are ``Generator(PCG64(seed)).integers(2, 2**31 - 1,
size=(2, n), dtype=uint32)``: draw ``d`` of that flat stream (s0 of pixel p
is draw p, s1 draw n + p) is PCG64's 64-bit outputs split into 32-bit words,
low word first, each word ``u`` mapped by Lemire's multiply ``m = u * R``
(R = 2**31 - 3) to ``(m >> 32) + 2``, and a word whose low product word is
below ``(2**32 - R) % R`` = 6 rejected: it yields no draw and every later
draw moves one word on. So accepted word w is draw ``w - R(w)``, R(w) the
rejected words before it. One pass finds the draws [0, D) that the lanes
need:

1. *runs*: the words [0, D + slack) are cut into runs of ``RUN`` outputs;
   each run jumps once to its start (numpy's ``pcg_advance_lcg_128``, by
   the 2^i-step tables of ``jump_tables``, made here and handed to the
   kernel) and steps one output at a time, XSL-RR taken after the step, as
   numpy's ``pcg64_random_r`` takes it;
2. *counts and prefix*: each run counts its rejected words; the exclusive
   prefix of the counts (the kernel's block scan and look-back across
   blocks of ``THREADS`` runs) gives R before each word, so each accepted
   word lands at its draw;
3. *tail*: when more than ``slack`` words of the pass are rejected (about
   1.4e-9 per word), the end of the stream steps on until D draws are
   found. Every seed is exact; nothing is read back to the host.

The counter keys are the hash of ``init_counter_state`` of the lane's
absolute pixel id, the counter 0. Either way lane l holds pixel ``pix[l]``
(K2's blocked layout) or ``lane_offset + l`` (K1's identity layout, and a
shard of either), and a lane whose pixel is ``n`` or beyond is a pad lane:
2 in both words, as ``render_pallas`` pads.

``seed_lanes_reference`` is the plain PyTorch version of the same runs,
counts, prefix and tail (the 128-bit LCG in 16-bit limbs on int64
tensors); the tests and ``chip_smoke.py`` hold the kernel and numpy against
it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

PCG_MULT = 0x2360ED051FC65DA44385DF649FCCF645
_M128 = (1 << 128) - 1
_M64 = (1 << 64) - 1
_M32 = 0xFFFFFFFF
# integers(2, 2**31 - 1): Lemire over R = 2**31 - 3 values, offset 2; a word
# is rejected when its low product word is below (2**32 - R) % R = 6.
LOW = 2
RANGE = 2**31 - 3
REJECT_BELOW = (2**32 - RANGE) % RANGE
# Words past the last draw that the pass scans; more rejections than this
# in the pass send the rest to the tail.
SLACK = 64
PAD = 2
# The kernel's run (kRun outputs a thread), block (kThreads runs) and the
# words a block covers.
RUN = 8
THREADS = 256
BLOCK_WORDS = 2 * RUN * THREADS
# Jump table entries (kMaxBits); the pass's words and counts are 32-bit.
MAX_JUMP_BITS = 48
MAX_WORDS = 2**32
# The look-back's status words carry a 30-bit epoch.
EPOCH_LIMIT = 2**30


@functools.lru_cache(maxsize=64)
def pcg64_state(seed: int) -> Tuple[int, int]:
    """(state, inc) of ``np.random.PCG64(seed)``: its SeedSequence seeding,
    kept in numpy (tens of us, once per seed)."""
    st = np.random.PCG64(seed).state["state"]
    return int(st["state"]), int(st["inc"])


def counter_seed_word(seed: int) -> int:
    return (seed * 0x85EBCA6B + 0x165667B1) & _M32


@functools.lru_cache(maxsize=1)
def _mult_table() -> Tuple[int, ...]:
    """PCG64's multiplier for 2^i steps, i < MAX_JUMP_BITS: seed-free."""
    out, m = [], PCG_MULT
    for _ in range(MAX_JUMP_BITS):
        out.append(m)
        m = (m * m) & _M128
    return tuple(out)


@functools.lru_cache(maxsize=64)
def jump_tables(inc: int) -> Tuple[Tuple[int, int], ...]:
    """(mult, plus) for 2^i steps of the LCG with increment ``inc``:
    state -> state * mult + plus, i < MAX_JUMP_BITS (numpy's
    ``pcg_advance_lcg_128``, one square of the map a bit)."""
    out, p = [], inc
    for m in _mult_table():
        out.append((m, p))
        p = ((m + 1) * p) & _M128
    return tuple(out)


@functools.lru_cache(maxsize=64)
def _tables_arg(inc: int) -> ctypes.Array:
    """``jump_tables`` as the kernel entry takes them: [MAX_JUMP_BITS][4]
    uint64, mult hi, lo, plus hi, lo."""
    words = [x for m, p in jump_tables(inc) for x in (m >> 64, m & _M64, p >> 64, p & _M64)]
    return (ctypes.c_uint64 * len(words))(*words)


def _lane_pixels(lanes: int, pix: Optional[torch.Tensor], lane_offset: int,
                 device) -> torch.Tensor:
    if pix is not None:
        return pix.to(torch.int64)
    return torch.arange(lane_offset, lane_offset + lanes, dtype=torch.int64, device=device)


def draws_needed(n: int, lanes: int, pixels_given: bool, lane_offset: int) -> int:
    """The prefix [0, D) of the flat draws that the lanes need: every draw
    for a ``pix`` layout (2n), else up to s1 of the range's last real pixel
    (0 when the range holds none)."""
    if pixels_given:
        return 2 * n
    lo = min(max(lane_offset, 0), n)
    hi = min(max(lane_offset + lanes, 0), n)
    return n + hi if hi > lo else 0


def seed_lanes(rng: str, seed: int, n: int, lanes: Optional[int] = None, *,
               pix: Optional[torch.Tensor] = None, lane_offset: int = 0,
               device=None, slack: int = SLACK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fresh RNG state (two uint32 [lanes] tensors on ``device``) of a
    frame of ``n`` pixels, seeded with ``seed``: lane l holds pixel
    ``pix[l]`` (int32 on ``device``; then ``lanes`` may be None) or
    ``lane_offset + l``; a pixel at or past ``n`` is a pad lane (2, 2).
    ``rng`` "mwc": (s0, s1) of ``init_mwc_state((n,), seed)`` at those
    pixels; "counter": (key, counter) of ``init_counter_state``.

    On a CUDA device this launches ``csrc/seed_kernel.cu`` (or raises) on
    the current stream and returns without synchronising it: nothing is
    read back, and every seed is exact (``slack``: words past the last
    draw that the one pass scans, the rest found by its tail).
    ``seed_lanes.launches`` counts these calls. On the CPU it takes numpy's
    draw (``core/rng.init_state``, the JAX package's own, and bitwise the
    kernel's) and gathers the lanes: ``seed_lanes_reference`` gives the
    same bits at a far higher cost."""
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
    if slack < 0 or 2 * n + slack >= MAX_WORDS:
        raise ValueError(f"n {n}, slack {slack}: the pass's 2n + slack words must be "
                         f"in [0, {MAX_WORDS})")
    if dev.type == "cpu":
        return _seed_lanes_host(rng, seed, n, lanes, pix, lane_offset)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    # Under a torch.func transform (the pixel-gradient check's jvp through
    # the plain recompute) a fresh tensor is a wrapper with no storage to
    # hand the kernel; the seeds carry no tangent, so they are made outside
    # it.
    with torch._C._DisableFuncTorch():
        return _launch(rng, seed, n, lanes, pix, lane_offset, dev, slack)


_STATUS: Dict[Tuple[int, int], torch.Tensor] = {}
_EPOCH = [0]


def _status(dev: torch.device, stream: int, blocks: int) -> Tuple[torch.Tensor, int]:
    """The look-back's status words for ``stream`` (at least ``blocks``;
    one buffer a stream, so launches that share one run in order) and a
    fresh epoch for the launch. The words are tagged with their launch's
    epoch, so the buffer is zeroed only when made, and again when the
    epochs wrap."""
    _EPOCH[0] += 1
    if _EPOCH[0] >= EPOCH_LIMIT:
        _STATUS.clear()
        _EPOCH[0] = 1
    key = (dev.index if dev.index is not None else torch.cuda.current_device(), stream)
    buf = _STATUS.get(key)
    if buf is None or buf.numel() < blocks:
        if len(_STATUS) >= 16:
            _STATUS.pop(next(iter(_STATUS)))
        size = max(blocks, 256, 0 if buf is None else 2 * buf.numel())
        buf = _STATUS[key] = torch.zeros((size,), dtype=torch.int64, device=dev)
    return buf, _EPOCH[0]


def _launch(rng, seed, n, lanes, pix, lane_offset, dev, slack):
    """The kernels of one seeding on ``dev``'s current stream: (s0, s1).
    Counts the seeding in ``seed_lanes.launches``."""
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
        return s0, s1
    state, inc = pcg64_state(seed)
    draws = draws_needed(n, lanes, pix is not None, lane_offset)
    blocks = -(-(draws + slack) // BLOCK_WORDS) if draws else 0
    status, epoch = _status(dev, stream, blocks)
    flat = torch.empty((draws,), dtype=torch.uint32, device=dev) if pix is not None else None
    err = lib.seed_mwc_lanes_cuda(
        _tables_arg(inc), state >> 64, state & _M64, inc >> 64, inc & _M64, n, draws, slack,
        pix_ptr, lane_offset, lanes,
        None if flat is None else flat.data_ptr(), status.data_ptr(), status.numel(), epoch,
        s0.data_ptr(), s1.data_ptr(), stream)
    _check(err, "seed_mwc_lanes_cuda")
    seed_lanes.launches += 1
    return s0, s1


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
        p, i64, u64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64
        lib.seed_mwc_lanes_cuda.argtypes = [p, u64, u64, u64, u64, i64, i64, i64, p, i64, i64,
                                            p, p, i64, u64, p, p, p]
        lib.seed_counter_lanes_cuda.argtypes = [ctypes.c_uint32, i64, p, i64, i64, p, p, p]
        lib.seed_mwc_lanes_cuda.restype = lib.seed_counter_lanes_cuda.restype = ctypes.c_int
    return lib


# ---- the plain PyTorch version ---------------------------------------------
# A 128-bit value is [8, N] int64: 16-bit limbs, least significant first, so
# that a limb product (< 2**32) and a column of eight of them fit in int64.

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
    """Each column of ``state`` moved on by its ``delta`` outputs, one
    table entry of ``jump_tables`` per set bit (the maps are powers of one
    affine map, so they commute)."""
    bits = int(delta.max()).bit_length() if delta.numel() else 0
    for bit, (mult, plus) in enumerate(jump_tables(inc)[:bits]):
        take = ((delta >> bit) & 1).bool()
        state = torch.where(take, _mul_add(state, mult, plus), state)
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


def mwc_words_reference(seed: int, words: int, run: int = RUN,
                        device="cpu") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The words [0, words) of ``seed``'s stream as the pass makes them:
    runs of ``run`` outputs, each a jump to its start and ``run`` steps.
    Returns (word index, value, rejected), int64, int64 and bool [runs, 2
    run]; a word at or past ``words`` is never rejected."""
    state0, inc = pcg64_state(seed)
    runs = -(-((words + 1) // 2) // run)
    j0 = torch.arange(runs, dtype=torch.int64, device=device) * run
    state = _advance(_const(state0, runs, device), inc, j0)
    halves = []
    for _ in range(run):
        state = _mul_add(state, PCG_MULT, inc)
        halves.extend(_xsl_rr(state))
    u = torch.stack(halves, dim=1)  # [runs, 2 run]: word k of run t is 2 (j0 + k // 2) + k % 2
    w = 2 * j0[:, None] + torch.arange(2 * run, device=device)[None, :]
    value, rejected = _lemire(u)
    return w, value, rejected & (w < words)


def _tail_reference(seed: int, w: int, need: int, device) -> torch.Tensor:
    """The next ``need`` draws of ``seed``'s stream from word ``w`` on,
    stepping one output at a time (the kernel's tail)."""
    state0, inc = pcg64_state(seed)
    state = _advance(_const(state0, 1, device), inc,
                     torch.tensor([w // 2], dtype=torch.int64, device=device))
    out, cur = [], None
    if w & 1:
        state = _mul_add(state, PCG_MULT, inc)
        cur = _xsl_rr(state)
    while len(out) < need:
        if not w & 1:
            state = _mul_add(state, PCG_MULT, inc)
            cur = _xsl_rr(state)
        value, rejected = _lemire(cur[w & 1])
        if not bool(rejected):
            out.append(value)
        w += 1
    return torch.cat(out)


def mwc_draws_reference(seed: int, draws: int, slack: int = SLACK, run: int = RUN,
                        block_runs: int = THREADS, device="cpu") -> torch.Tensor:
    """Draws [0, draws) of ``seed``'s flat stream (int64 in [2, 2**31 -
    2]) as the kernel finds them: the pass over words [0, draws + slack) in
    runs of ``run`` outputs, each run's count of rejected words, the
    exclusive prefix of the counts by blocks of ``block_runs`` runs (the
    blocks' own prefix, then the runs' inside each block), each accepted
    word at its draw, and the tail past the pass."""
    words = draws + slack
    out = torch.empty((draws,), dtype=torch.int64, device=device)
    if draws == 0:
        return out
    w, value, rejected = mwc_words_reference(seed, words, run, device)
    runs = w.shape[0]
    blocks = -(-runs // block_runs)
    count = torch.zeros((blocks * block_runs,), dtype=torch.int64, device=device)
    count[:runs] = rejected.sum(dim=1)
    count = count.reshape(blocks, block_runs)
    total = count.sum(dim=1)
    block_prefix = torch.cumsum(total, 0) - total  # the look-back
    run_prefix = (block_prefix[:, None] + torch.cumsum(count, 1) - count).reshape(-1)[:runs]
    d = w - run_prefix[:, None] - (torch.cumsum(rejected.to(torch.int64), 1) - rejected.to(
        torch.int64))
    keep = (w < words) & ~rejected & (d < draws)
    out[d[keep]] = value[keep]
    found = words - int(total.sum())
    if found < draws:
        out[found:] = _tail_reference(seed, words, draws - found, device)
    return out


def seed_lanes_reference(rng: str, seed: int, n: int, lanes: Optional[int] = None, *,
                         pix: Optional[torch.Tensor] = None, lane_offset: int = 0,
                         device="cpu", slack: int = SLACK, run: int = RUN,
                         block_runs: int = THREADS) -> Tuple[torch.Tensor, torch.Tensor]:
    """``seed_lanes`` in plain PyTorch on ``device``: the kernel's pass,
    counts, prefix and tail (``mwc_draws_reference``; ``run`` and
    ``block_runs`` default to the kernel's) over the draws the lanes need,
    then each lane's two."""
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
        draws = mwc_draws_reference(seed, draws_needed(n, lanes, pix is not None, lane_offset),
                                    slack, run, block_runs, device)
        k = torch.where(real, p, 0)
        s0 = draws[k] if draws.numel() else k
        s1 = draws[n + k] if draws.numel() else k
    else:
        raise ValueError(f"unknown rng kind {rng!r}")
    s0, s1 = torch.where(real, s0, PAD), torch.where(real, s1, PAD)
    return s0.to(torch.uint32), s1.to(torch.uint32)

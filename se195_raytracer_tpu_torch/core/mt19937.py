"""MT19937, the raytracer5 quality RNG (twister.{h,cpp}); twin of
se195_raytracer_tpu/core/mt19937.py.

The reference's ``Twister`` (raytracer5/trunk/twister.cpp:22-64) is a
standard MT19937 generator (624-word state, M=397 twist, the classic
u/s/t/l tempering) with a NON-standard seed expansion: a 69069
multiplicative LCG fill (twister.cpp:24-25) followed by an XOR whitening
sweep with the (5531, 81547) LCG + xorshift stream seeded at 373737
(twister.cpp:26-32). No render path draws from it (the integrators use the
MWC and counter generators of core/rng.py); it is carried, bit-exactly, as
the JAX package carries it.

The numpy part (seeding, the twist, tempering, scalar draws) is a copy of
the JAX module's, which is numpy-only but cannot be imported without the
JAX package. ``twist_torch`` and ``temper_torch`` regenerate and temper a
whole 624-word block on any device, in int64 tensors holding values in
[0, 2**32) (torch has few uint32 operations; the port's rule, core/rng.py).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

N = 624
M = 397
MATRIX_A = np.uint32(0x9908B0DF)
UPPER_MASK = np.uint32(0x80000000)
LOWER_MASK = np.uint32(0x7FFFFFFF)
DEFAULT_SEED = 0xF2710812  # Twister::Twister() (twister.h:14-17)
# float scale, (float)y * 2.3283064370807974e-10f (twister.cpp:63)
FLOAT_SCALE = np.float32(2.3283064370807974e-10)


class MTState(NamedTuple):
    mt: np.ndarray  # [624] uint32
    mti: int


def seed_ref(seed: int = DEFAULT_SEED) -> MTState:
    """Twister::Seed (twister.cpp:22-33): 69069-LCG fill + XOR whitening.

    A zero constructor argument falls back to 0xf2710812 (twister.h:14)."""
    if seed == 0:
        seed = DEFAULT_SEED
    mt = np.empty(N, np.uint64)
    mt[0] = seed & 0xFFFFFFFF
    for i in range(1, N):
        mt[i] = (69069 * mt[i - 1]) & 0xFFFFFFFF
    s = 373737
    for i in range(1, N):
        mt[i] ^= s
        s = (s * 5531 + 81547) & 0xFFFFFFFF
        s = (s ^ (s >> 9) ^ ((s << 19) & 0xFFFFFFFF)) & 0xFFFFFFFF
    # mti = N after seeding: the first draw triggers a full twist
    # (twister.cpp:27 leaves mti == mtRand_N).
    return MTState(mt.astype(np.uint32), N)


def _twist_np(mt: np.ndarray) -> np.ndarray:
    """One full 624-word regeneration (twister.cpp:39-55), vectorized.

    The reference's loop reads mt[kk+M] where kk+M wraps: for kk < N-M it
    reads PRE-twist words; for kk >= N-M it reads words the same loop already
    REGENERATED. Concatenating [new_low, old_high] reproduces that read
    pattern without sequential scalar code."""
    y = (mt & UPPER_MASK) | (np.roll(mt, -1) & LOWER_MASK)
    mag = np.where((y & np.uint32(1)).astype(bool), MATRIX_A, np.uint32(0))
    shifted = (y >> np.uint32(1)) ^ mag
    out = np.empty_like(mt)
    # kk in [0, N-M): mt[kk+M] is pre-twist.
    out[: N - M] = mt[M:] ^ shifted[: N - M]
    # kk in [N-M, N): mt[kk+M-N] = out[kk-(N-M)], already written this pass.
    for kk in range(N - M, N):
        out[kk] = out[kk + M - N] ^ shifted[kk]
    # The reference twists IN PLACE (twister.cpp:53-54), so the final word's
    # y reads mt[0] AFTER iteration 0 overwrote it: redo word N-1 with the
    # regenerated mt[0].
    y_last = (mt[N - 1] & UPPER_MASK) | (out[0] & LOWER_MASK)
    mag_last = MATRIX_A if (y_last & np.uint32(1)) else np.uint32(0)
    out[N - 1] = out[M - 1] ^ (y_last >> np.uint32(1)) ^ mag_last
    return out


def temper(y: np.ndarray) -> np.ndarray:
    """The u/s/t/l tempering chain (twister.cpp:57-61)."""
    y = y ^ (y >> np.uint32(11))
    y = y ^ ((y << np.uint32(7)) & np.uint32(0x9D2C5680))
    y = y ^ ((y << np.uint32(15)) & np.uint32(0xEFC60000))
    y = y ^ (y >> np.uint32(18))
    return y


def rand_u32(state: MTState, n: int = 1) -> Tuple[np.ndarray, MTState]:
    """``n`` draws of Twister::RandL (twister.cpp:66-92)."""
    mt, mti = np.array(state.mt, np.uint32), state.mti
    out = np.empty(n, np.uint32)
    for i in range(n):
        if mti >= N:
            mt = _twist_np(mt)
            mti = 0
        out[i] = temper(mt[mti])
        mti += 1
    return out, MTState(mt, mti)


def rand_float(state: MTState, n: int = 1) -> Tuple[np.ndarray, MTState]:
    """``n`` draws of Twister::Rand (twister.cpp:36-64): uint32 draw scaled
    by 2.3283064370807974e-10f in float32."""
    u, state = rand_u32(state, n)
    return (u.astype(np.float32) * FLOAT_SCALE).astype(np.float32), state


def twist_torch(mt: torch.Tensor) -> torch.Tensor:
    """``_twist_np`` on ``mt``'s device: one regeneration of the [624] state.

    Takes any integer tensor whose low 32 bits are the words; returns int64
    words in [0, 2**32). The region whose reads wrap (kk >= N-M) is a chain
    that steps down by N-M = 227, so it resolves in ceil(N / (N-M)) = 3
    passes of the same vector update, as ``twist_jnp`` does it; then word
    N-1 is redone for the in-place read of the regenerated mt[0]."""
    upper, lower, matrix_a = int(UPPER_MASK), int(LOWER_MASK), int(MATRIX_A)
    mt = mt.to(torch.int64) & 0xFFFFFFFF
    y = (mt & upper) | (torch.roll(mt, -1) & lower)
    shifted = (y >> 1) ^ ((y & 1) * matrix_a)
    out = torch.roll(mt, -M) ^ shifted  # mt[kk+M] pre-twist everywhere
    wraps = torch.arange(N, device=mt.device) >= N - M
    for _ in range(3):
        out = torch.where(wraps, torch.roll(out, N - M) ^ shifted, out)
    y_last = (mt[N - 1] & upper) | (out[0] & lower)
    last = out[M - 1] ^ (y_last >> 1) ^ ((y_last & 1) * matrix_a)
    return torch.cat([out[: N - 1], last.reshape(1)])


def temper_torch(y: torch.Tensor) -> torch.Tensor:
    """``temper`` on any integer tensor whose low 32 bits are the words;
    returns int64 in [0, 2**32)."""
    y = y.to(torch.int64) & 0xFFFFFFFF
    y = y ^ (y >> 11)
    y = y ^ ((y << 7) & 0x9D2C5680)
    y = y ^ ((y << 15) & 0xEFC60000)
    return y ^ (y >> 18)

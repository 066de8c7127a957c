"""Seed-compatible RNG for the `sample` and `genseed` verbs.

Copy of coati_tpu/rng.py: the fragmites::random Lehmer64 PRNG + SeedSeq256
seeding scheme (reference contrib/random/random.hpp:80-136, 328-440, 519-540)
so that `coati sample -s 42` produces bit-identical draws to the reference.
The sampler on the card draws from a torch.Generator seeded from this
generator's u64(); this generator drives the native host sampler.
"""

from __future__ import annotations

MASK64 = (1 << 64) - 1
MASK128 = (1 << 128) - 1
_MCG_MULT = 0xDA942042E4DD58B5


class Lehmer64:
    """128-bit-state Lehmer-style PRNG (O'Neill's lehmer64_fast)."""

    def __init__(self, state: int = 0x9F57C403D06C42FC):
        self.state = (state | 1) & MASK128

    def seed_state(self, state: int) -> None:
        self.state = (state | 1) & MASK128

    def seed_u32x4(self, words) -> None:
        """Seed from 4 little-endian uint32 words (engine seed_type)."""
        state = 0
        for i, w in enumerate(words):
            state |= (int(w) & 0xFFFFFFFF) << (32 * i)
        self.seed_state(state)

    def get_seed_u32x4(self) -> list[int]:
        return [(self.state >> (32 * i)) & 0xFFFFFFFF for i in range(4)]

    def bits(self) -> int:
        """Advance and return the top 64 bits of the state."""
        self.state = (self.state * _MCG_MULT) & MASK128
        return self.state >> 64

    def u64(self) -> int:
        return self.bits()

    def f24(self) -> float:
        """Uniform [0,1) with 24-bit resolution (random.hpp:213-216)."""
        return float(self.bits() >> 40) / 16777216.0

    def f53(self) -> float:
        return float(self.bits() >> 11) / 9007199254740992.0


def _multilinear_hash(inputs, count: int, init: int) -> list[int]:
    """Multilinear hash over a Weyl sequence (random.hpp:334-358)."""
    inc = 0x9E3779B97F4A7C15
    out = []
    w = init
    for _ in range(count):
        w = (w + inc) & MASK64
        s = w
        for u in inputs:
            w = (w + inc) & MASK64
            s = (s + w * (int(u) & 0xFFFFFFFF)) & MASK64
        w = (w + inc) & MASK64
        s = (s + w) & MASK64
        out.append(s >> 32)
    return out


class SeedSeq256:
    """Finite-entropy 8x32-bit seed sequence (random.hpp:366-401)."""

    _INIT_A = 0x3423DA0B87484307
    _INIT_B = 0xDF8B06C40FA44478

    def __init__(self, seeds):
        self.state = _multilinear_hash(list(seeds), 8, self._INIT_A)

    def generate(self, count: int) -> list[int]:
        return _multilinear_hash(self.state, count, self._INIT_B)


def str_crushto32(s: str) -> int:
    """FNV-1 hash of a string to 32 bits (random.hpp:465-472).

    Matches the C++ which feeds (signed) char values into the xor."""
    h = 2166136261
    for ch in s.encode("latin-1", errors="replace"):
        v = ch if ch < 128 else ch - 256  # signed char semantics
        h = ((h * 16777619) ^ (v & 0xFFFFFFFF)) & 0xFFFFFFFF
    return h


def string_seed_seq(args) -> SeedSeq256:
    """Build a seed sequence from CLI strings (random.hpp:522-540).

    Strings that parse fully as 32-bit signed decimal ints are used as ints;
    everything else is FNV-hashed.
    """
    import re

    seeds = []
    for a in args:
        # std::from_chars accepts an optional '-' then digits, no '+', and we
        # require the whole string to be consumed and the value to fit int32.
        if re.fullmatch(r"-?[0-9]+", a):
            v = int(a, 10)
            if -(2**31) <= v < 2**31:
                seeds.append(v & 0xFFFFFFFF)
                continue
        seeds.append(str_crushto32(a))
    return SeedSeq256(seeds)


def auto_seed_seq() -> SeedSeq256:
    """Entropy-based seed sequence (simplified; parity not required here)."""
    import os
    import time

    entropy = [
        int.from_bytes(os.urandom(4), "little"),
        int(time.time_ns()) & 0xFFFFFFFF,
        (int(time.time_ns()) >> 32) & 0xFFFFFFFF,
        os.getpid() & 0xFFFFFFFF,
    ]
    return SeedSeq256(entropy)


def seed_random(rng: Lehmer64, ss: SeedSeq256) -> None:
    rng.seed_u32x4(ss.generate(4))


_BASE58 = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"


def base58_encode_u32(u: int) -> str:
    buf = [_BASE58[0]] * 6
    u = int(u) & 0xFFFFFFFF
    for i in range(6):
        if u == 0:
            break
        buf[5 - i] = _BASE58[u % 58]
        u //= 58
    return "".join(buf)


def encode_seed(words) -> str:
    return "-".join(base58_encode_u32(w) for w in words)

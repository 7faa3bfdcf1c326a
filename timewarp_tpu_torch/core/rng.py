"""Counter-based RNG: elementwise Threefry-2x32 (port of
``timewarp_tpu/core/rng.py``).

Every draw is keyed by what it is for — ``(node, time)`` for a firing,
``(src, dst, time, slot)`` for a link sample — so the port derives the
reference's streams word for word.

uint32 words ride in int64 tensors holding ``[0, 2**32)`` (torch's
``uint32`` has no add, shift or remainder on the CPU): every add is
masked with ``0xFFFFFFFF``, and rotations shift at most 29 bits, so no
intermediate leaves int64. The same functions accept Python ints
(``seed_words`` runs host-side on them), and a fleet's seed words and
link parameters as ``[B, 1]`` tensors that broadcast over its ``[B, N]``
or ``[B, S]`` operands, word for word the reference's per-world draw.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..ops.numeric import MASK32, as_u32

__all__ = ["threefry2x32", "seed_words", "fire_bits", "msg_bits",
           "split_bits", "uniform_int", "bernoulli", "normal_f32"]

_PARITY = 0x1BD11BDA  # threefry key-schedule parity constant
_GOLD = 0x9E3779B9    # golden ratio — domain separation for seeding

# Domain tags: distinct streams for fires vs link samples.
_FIRE_TAG = 0xF14EF14E
_MSG_TAG = 0x4D534721

_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)


def _u32(x):
    """A word as uint32-in-int64 (tensor) or a masked Python int."""
    return as_u32(x) if isinstance(x, torch.Tensor) else int(x) & MASK32


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, c0, c1) -> Tuple:
    """Standard 20-round Threefry-2x32: key (k0, k1), counter (c0, c1)
    -> two uint32 words (int64 carriers). All arguments broadcast."""
    k0, k1 = _u32(k0), _u32(k1)
    x0 = (_u32(c0) + k0) & MASK32
    x1 = (_u32(c1) + k1) & MASK32
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    for g in range(5):
        rots = _ROT_A if g % 2 == 0 else _ROT_B
        for r in rots:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & MASK32
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & MASK32
    return x0, x1


def seed_words(seed: int) -> Tuple[int, int]:
    """Host-side: expand a Python int seed into two uint32 words."""
    a, b = threefry2x32(seed & MASK32, ((seed >> 32) & MASK32) ^ _GOLD,
                        0, 1)
    return int(a), int(b)


def _t_words(t: torch.Tensor):
    t = t.to(torch.int64)
    return t & MASK32, (t >> 32) & MASK32


def fire_bits(s0, s1, node, t) -> Tuple:
    """Entropy for one node's firing at virtual time ``t``."""
    tlo, thi = _t_words(t)
    a0, a1 = threefry2x32(s0 ^ _FIRE_TAG, s1, node, tlo)
    return threefry2x32(a0, a1, thi, 0)


def msg_bits(s0, s1, src, dst, t, slot) -> Tuple:
    """Entropy for the link sample of one message ``src -> dst`` emitted
    at time ``t`` from outbox slot ``slot``."""
    tlo, thi = _t_words(t)
    a0, a1 = threefry2x32(s0 ^ _MSG_TAG, s1, src, dst)
    b0, b1 = threefry2x32(a0, a1, tlo, thi)
    return threefry2x32(b0, b1, slot, 0)


def split_bits(b0, b1, tag: int) -> Tuple:
    """An independent substream of an entropy pair; ``tag`` is a static
    int."""
    return threefry2x32(b0, b1, tag, 1)


def uniform_int(bits: torch.Tensor, lo, hi) -> torch.Tensor:
    """Uniform integer in [lo, hi] from one uint32 word (modulo scheme,
    identical to the reference), int64."""
    span = (hi - lo + 1) & MASK32
    return lo + torch.remainder(bits, span)


def bernoulli(bits: torch.Tensor, p: float) -> torch.Tensor:
    """True with (static) probability ``p`` from one uint32 word —
    integer threshold compare, bit-exact on every backend."""
    if p <= 0.0:
        return torch.zeros_like(bits, dtype=torch.bool)
    thr = int(p * 4294967296.0)
    if thr >= 1 << 32:
        return torch.ones_like(bits, dtype=torch.bool)
    return bits < thr


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def normal_f32(b0: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """Standard normal via Box-Muller from two uint32 words (float32).
    Every constant is the reference's float32 value (``2π`` is the double
    product cast once); torch's and XLA's float32 ``log``/``cos`` may
    still differ by an ulp on some draws."""
    u1 = (b0 >> 8).to(torch.float32) * _f32(2.0 ** -24, b0) \
        + _f32(2.0 ** -25, b0)
    u2 = (b1 >> 8).to(torch.float32) * _f32(2.0 ** -24, b1)
    r = torch.sqrt(_f32(-2.0, b0) * torch.log(u1))
    return r * torch.cos(_f32(2.0 * math.pi, b1) * u2)

"""Threefry-2x32 streams keyed by what each draw is for.

uint32 words are carried in int64 tensors in ``[0, 2**32)``; every add is
masked and every rotation shifts at most 29 bits, so nothing leaves
int64. ``rounds`` is 20, the stream every configuration states; the
lower-precision control (``control.py``) asks for fewer.
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_GOLD = 0x9E3779B9
_FIRE_TAG = 0xF14EF14E
_MSG_TAG = 0x4D534721
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _word(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    return int(x) & MASK32


def threefry2x32(k0, k1, c0, c1, rounds: int = 20):
    """Threefry-2x32 of counter ``(c0, c1)`` under key ``(k0, k1)``: a
    key injection after every group of four rounds. Tensors broadcast;
    Python ints give Python ints."""
    k0, k1 = _word(k0), _word(k1)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (_word(c0) + k0) & MASK32
    x1 = (_word(c1) + k1) & MASK32
    for r in range(rounds):
        rot = _ROTATIONS[(r // 4) % 2][r % 4]
        x0 = (x0 + x1) & MASK32
        x1 = (((x1 << rot) | (x1 >> (32 - rot))) & MASK32) ^ x0
        if r % 4 == 3:
            g = r // 4
            x0 = (x0 + ks[(g + 1) % 3]) & MASK32
            x1 = (x1 + ks[(g + 2) % 3] + g + 1) & MASK32
    return x0, x1


def seed_words(seed: int):
    """The two key words of a run's seed (any Python int)."""
    return threefry2x32(seed & MASK32, ((seed >> 32) & MASK32) ^ _GOLD, 0, 1)


def _time_words(t: torch.Tensor):
    t = t.to(torch.int64)
    return t & MASK32, (t >> 32) & MASK32


def fire_bits(s0, s1, node, t, rounds: int = 20):
    """The entropy of one node's firing at virtual time ``t``."""
    lo, hi = _time_words(t)
    a0, a1 = threefry2x32(s0 ^ _FIRE_TAG, s1, node, lo, rounds)
    return threefry2x32(a0, a1, hi, 0, rounds)


def msg_bits(s0, s1, src, dst, t, slot, rounds: int = 20):
    """The entropy of the link draw of message ``src -> dst`` sent at
    ``t`` from outbox slot ``slot``."""
    lo, hi = _time_words(t)
    a0, a1 = threefry2x32(s0 ^ _MSG_TAG, s1, src, dst, rounds)
    b0, b1 = threefry2x32(a0, a1, lo, hi, rounds)
    return threefry2x32(b0, b1, slot, 0, rounds)


def uniform_int(bits: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """``lo + bits mod (hi - lo + 1)``, int64."""
    return lo + torch.remainder(bits, (hi - lo + 1) & MASK32)


def normal(b0: torch.Tensor, b1: torch.Tensor,
           dtype=torch.float32) -> torch.Tensor:
    """A standard normal by Box-Muller from two words: 24-bit uniforms,
    ``sqrt(-2 log u1) cos(2 pi u2)``, every constant cast once to
    ``dtype`` and every operation one elementwise op in ``dtype``."""
    def c(x):
        return torch.tensor(x, dtype=dtype, device=b0.device)
    u1 = (b0 >> 8).to(dtype) * c(2.0 ** -24) + c(2.0 ** -25)
    u2 = (b1 >> 8).to(dtype) * c(2.0 ** -24)
    r = torch.sqrt(c(-2.0) * torch.log(u1))
    return r * torch.cos(c(2.0 * math.pi) * u2)

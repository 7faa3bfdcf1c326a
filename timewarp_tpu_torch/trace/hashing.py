"""Order-independent 32-bit trace hashing (port of
``timewarp_tpu/trace/hashing.py``, device flavor).

Each record is mixed FNV/murmur-style into 32 bits, then records are
combined by wrapping uint32 addition (``ops.numeric.u32sum``). Words
ride in int64 carriers; every input is taken mod ``2**32`` first, so a
negative int32 maps to its two's-complement word.
"""

from __future__ import annotations

import torch

from ..ops.numeric import MASK32, as_u32

__all__ = ["mix32", "FIRED", "RECV", "SENT"]

_M1 = 0x9E3779B1  # golden-ratio odd constant
_M2 = 0x85EBCA77  # murmur3 finalizer constant
_SEED = 0x811C9DC5  # FNV offset basis

# Record kind tags.
FIRED, RECV, SENT = 1, 2, 3


def _mul32(x, c: int):
    """``x * c mod 2**32`` for words ``x`` and a constant ``c`` without
    leaving int64: split ``c`` into 16-bit halves (each partial product
    stays below ``2**48``)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def mix32(*xs) -> torch.Tensor:
    """Mix integer tensors (or ints, broadcasting; at least one tensor)
    into one uint32 word per element, int64 carrier. Leading int
    arguments fold on the host: no number is copied to the device, which
    would wait for the device's queue to drain."""
    h = _SEED
    for x in xs:
        x = as_u32(x) if isinstance(x, torch.Tensor) else int(x) & MASK32
        h = h ^ _mul32(x, _M1)
        h = _mul32(h, _M2)
        h = h ^ (h >> 16)
    return h

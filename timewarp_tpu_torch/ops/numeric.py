"""Engine-generic integer primitives (port of ``timewarp_tpu/ops/numeric.py``).

uint32 words are carried as int64 tensors holding values in
``[0, 2**32)``: torch's ``uint32`` lacks add, shift, compare and
remainder on the CPU, and every op here must run on both devices.
"""

from __future__ import annotations

import torch

__all__ = ["I32MAX", "MASK32", "group_rank", "u32sum", "tlo", "thi",
           "as_u32"]

I32MAX = 2**31 - 1
MASK32 = 0xFFFFFFFF


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor as its uint32 word in an int64 carrier:
    negative int32 values map to their two's-complement word."""
    return x.to(torch.int64) & MASK32


def group_rank(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its run of equal keys (keys sorted
    ascending): ``iota - cummax(run-start indices)``, int32."""
    S = sorted_keys.shape[0]
    iota = torch.arange(S, dtype=torch.int64, device=sorted_keys.device)
    boundary = torch.ones(S, dtype=torch.bool, device=sorted_keys.device)
    boundary[1:] = sorted_keys[1:] != sorted_keys[:-1]
    first = torch.cummax(torch.where(boundary, iota, 0), dim=0).values
    return (iota - first).to(torch.int32)


def u32sum(x: torch.Tensor, dim=None) -> torch.Tensor:
    """Wrapping uint32 sum (the order-independent digest reduction), as
    int64 in ``[0, 2**32)``: over every element, or over ``dim`` (an int
    or a tuple, e.g. each world's row of a fleet). Exact while a sum
    covers fewer than ``2**31`` words (the int64 partial sum cannot
    wrap)."""
    w = as_u32(x)
    return (w.sum() if dim is None else w.sum(dim=dim)) & MASK32


def tlo(t: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an int64 µs timestamp (digest word)."""
    return t & MASK32


def thi(t: torch.Tensor) -> torch.Tensor:
    """High 32 bits of an int64 µs timestamp (digest word)."""
    return (t >> 32) & MASK32

"""Shared pseudo-random peer sampling for the epidemic models (port of
``timewarp_tpu/models/peers.py``), batched over the node axis.

One in-state int32 LCG per node, advanced once per draw; every draw
picks a peer in ``[0, n)`` excluding self. The LCG wraps as int32 does in
the reference; the arithmetic runs in int64 and is wrapped explicitly,
so no step relies on signed overflow.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

__all__ = ["LCG_A", "LCG_C", "lcg_peers", "distinct_mask"]

LCG_A = 1103515245
LCG_C = 12345
_I32MIN = -2**31


def _wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value it wraps to (two's complement)."""
    return ((v - _I32MIN) & 0xFFFFFFFF) + _I32MIN


def lcg_peers(lcg: torch.Tensor, i: torch.Tensor, n: int, k: int
              ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Draw ``k`` chained peers per node: ``lcg`` and ``i`` int32 ``[N]``.
    Returns ``(lcg_k, [dst_1 … dst_k])`` (int32 ``[N]`` each), each
    destination ``(i + 1 + |lcg_j| % (n-1)) % n``. ``|INT32_MIN|`` stays
    ``INT32_MIN`` as under int32 ``abs``, and ``%`` is floor-mod, as in
    the reference."""
    dsts = []
    lc = lcg.to(torch.int64)
    i64 = i.to(torch.int64)
    for _ in range(k):
        lc = _wrap_i32(lc * LCG_A + LCG_C)
        mag = torch.where(lc == _I32MIN, lc, lc.abs())
        dsts.append(torch.remainder(
            i64 + 1 + torch.remainder(mag, n - 1), n).to(torch.int32))
    return lc.to(torch.int32), dsts


def distinct_mask(dsts: List[torch.Tensor]) -> torch.Tensor:
    """First-occurrence mask over a burst's peer draws, bool ``[k, N]``:
    lane a is True iff ``dsts[a]`` did not appear in an earlier lane."""
    uniq = [torch.ones_like(dsts[0], dtype=torch.bool)]
    for a in range(1, len(dsts)):
        dup = dsts[a] == dsts[0]
        for b in range(1, a):
            dup = dup | (dsts[a] == dsts[b])
        uniq.append(~dup)
    return torch.stack(uniq)

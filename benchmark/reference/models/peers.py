"""Peer draws of the epidemic families: one int32 LCG a node, advanced
once a draw, each peer ``(i + 1 + |lcg| mod (n - 1)) mod n`` (never the
node itself; ``|INT32_MIN|`` stays ``INT32_MIN``; floor modulo)."""

from __future__ import annotations

import torch

LCG_A = 1103515245
LCG_C = 12345


def _as_int32(v: torch.Tensor) -> torch.Tensor:
    """The int32 value an int64 wraps to, kept in int64."""
    return ((v + 2**31) & 0xFFFFFFFF) - 2**31


def draw_peers(lcg: torch.Tensor, ids: torch.Tensor, n: int, k: int):
    """``k`` chained peer draws a node: the advanced LCG (int32) and a
    ``[k, N]`` int32 tensor of destinations."""
    x = lcg.to(torch.int64)
    i = ids.to(torch.int64)
    out = []
    for _ in range(k):
        x = _as_int32(x * LCG_A + LCG_C)
        mag = torch.where(x == -2**31, x, x.abs())
        out.append(torch.remainder(i + 1 + torch.remainder(mag, n - 1), n))
    return x.to(torch.int32), torch.stack(out).to(torch.int32)


def first_seen(dsts: torch.Tensor) -> torch.Tensor:
    """``[k, N]`` bool: lane a is True unless an earlier lane drew the
    same peer."""
    k = dsts.shape[0]
    seen = torch.zeros_like(dsts, dtype=torch.bool)
    for a in range(1, k):
        seen[a] = (dsts[:a] == dsts[a]).any(dim=0)
    return ~seen


def lcg_init(ids: torch.Tensor) -> torch.Tensor:
    """Each node's first LCG word: ``(i * 2654435761) mod (2^31 - 1) + 1``."""
    return ((ids.to(torch.int64) * 2654435761) % (2**31 - 1) + 1) \
        .to(torch.int32)

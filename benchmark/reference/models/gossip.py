"""Push-rumor gossip: node 0 starts infected; a node first hearing the
rumor (the least hop count in its inbox) relays it after ``think_us``:
``fanout`` sends one a ``gossip_interval`` (paced), all at once
(``burst``), or one a ``gossip_interval`` until ``end_us`` (``steady``,
rumor mongering). Payload ``[hop]``; the inbox is commutative."""

from __future__ import annotations

import torch

from ..engine import NEVER, Model
from .peers import draw_peers, first_seen, lcg_init

I32MAX = 2**31 - 1


def build(n: int, *, fanout: int = 8, think_us: int = 5_000,
          gossip_interval: int = 2_000, bootstrap_us: int = 1_000,
          end_us: int = 60_000_000, steady: bool = False,
          burst: bool = False, mailbox_cap: int = 16) -> Model:
    if burst and steady:
        raise ValueError("burst and steady exclude each other")
    M = fanout if burst else 1

    def init(device):
        ids = torch.arange(n, dtype=torch.int32, device=device)
        first = ids == 0
        wake = torch.where(first, torch.tensor(bootstrap_us, device=device),
                           torch.tensor(NEVER, device=device))
        return {"hop": torch.where(first, 0, -1).to(torch.int32),
                "lcg": lcg_init(ids),
                "left": torch.where(first, fanout, 0).to(torch.int32),
                "next": wake.clone()}, wake

    def step(s, valid, payload, now, ids, bits):
        heard = torch.where(valid, payload[:, 0, :], I32MAX).amin(dim=0)
        fresh = (s["hop"] < 0) & (heard < I32MAX)
        hop = torch.where(fresh, heard, s["hop"])
        alive = now < end_us
        arm = fresh & alive
        left = torch.where(arm, 1 if burst else fanout, s["left"])
        nxt = torch.where(arm, now + think_us, s["next"])
        due = (left > 0) & (nxt <= now) & alive
        lcg, dsts = draw_peers(s["lcg"], ids, n, M)
        lcg = torch.where(due, lcg, s["lcg"])
        valid_out = due[None, :] & (first_seen(dsts) if burst else True)
        pay = (hop + 1)[None, None, :].expand(M, 1, -1)
        if burst:
            left = torch.where(due, 0, left)
            nxt = torch.where(due, NEVER, nxt)
        elif steady:
            nxt = torch.where(due, now + gossip_interval, nxt)
        else:
            left = left - due.to(torch.int32)
            nxt = torch.where(due, torch.where(left > 0,
                                               now + gossip_interval,
                                               NEVER), nxt)
        wake = torch.where((left > 0) & alive, nxt, NEVER)
        return ({"hop": hop, "lcg": lcg, "left": left, "next": nxt},
                valid_out.expand(M, -1), dsts, pay, wake)

    return Model(n=n, M=M, P=1, K=mailbox_cap, needs_key=False,
                 init=init, step=step)

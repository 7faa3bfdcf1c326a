"""Ouroboros-Praos slot leadership: every ``slot_us`` each node leads
with probability ``leader_prob`` (its firing entropy's first word under
the threshold ``leader_prob * 2^32``), extends its best chain and
diffuses the tip to ``fanout`` peers, all at once (``burst``) or one a
``relay_interval``; nodes adopt the longest tip heard and relay it.
Payload ``[chain length, relayer]``; the inbox is commutative. Equal
stake: the configuration gives no stake vector."""

from __future__ import annotations

import torch

from ..engine import NEVER, Model
from .peers import draw_peers, first_seen, lcg_init


def build(n: int, *, slot_us: int = 1_000_000, n_slots: int = 20,
          leader_prob: float = 0.05, fanout: int = 8,
          relay_interval: int = 2_000, burst: bool = False,
          mailbox_cap: int = 16) -> Model:
    threshold = min(int(leader_prob * 4294967296.0), 2**32 - 1)
    M = fanout if burst else 1

    def init(device):
        ids = torch.arange(n, dtype=torch.int32, device=device)
        wake = torch.full((n,), slot_us, dtype=torch.int64, device=device)
        s = {"best": torch.zeros(n, dtype=torch.int32, device=device),
             "lcg": lcg_init(ids),
             "slot": torch.zeros(n, dtype=torch.int32, device=device),
             "nslot": wake.clone(),
             "thr": torch.full((n,), threshold, dtype=torch.int64,
                               device=device)}
        if not burst:
            s["left"] = torch.zeros(n, dtype=torch.int32, device=device)
            s["nrelay"] = torch.full((n,), NEVER, dtype=torch.int64,
                                     device=device)
        return s, wake

    def step(s, valid, payload, now, ids, bits):
        tip = torch.where(valid, payload[:, 0, :], -1).amax(dim=0)
        adopt = tip > s["best"]
        best = torch.where(adopt, tip, s["best"])
        boundary = (s["slot"] < n_slots) & (s["nslot"] <= now)
        lead = boundary & (bits[0] < s["thr"])
        best = best + lead.to(torch.int32)
        slot = s["slot"] + boundary.to(torch.int32)
        nslot = torch.where(boundary, s["nslot"] + slot_us, s["nslot"])
        slot_wake = torch.where(slot < n_slots, nslot, NEVER)
        fresh = adopt | lead
        out = {"best": best, "slot": slot, "nslot": nslot, "thr": s["thr"]}
        if burst:
            lcg, dsts = draw_peers(s["lcg"], ids, n, M)
            out["lcg"] = torch.where(fresh, lcg, s["lcg"])
            valid_out = fresh[None, :] & first_seen(dsts)
            wake = slot_wake
        else:
            left = torch.where(fresh, fanout, s["left"])
            nrelay = torch.where(fresh, now + relay_interval, s["nrelay"])
            due = (left > 0) & (nrelay <= now)
            lcg, dsts = draw_peers(s["lcg"], ids, n, 1)
            out["lcg"] = torch.where(due, lcg, s["lcg"])
            valid_out = due[None, :]
            out["left"] = left - due.to(torch.int32)
            out["nrelay"] = torch.where(due, now + relay_interval, nrelay)
            wake = torch.minimum(slot_wake, torch.where(
                out["left"] > 0, out["nrelay"], NEVER))
        pay = torch.stack([best, ids.to(torch.int32)])[None].expand(M, 2, -1)
        return out, valid_out, dsts, pay, wake

    return Model(n=n, M=M, P=2, K=mailbox_cap, needs_key=True,
                 init=init, step=step)

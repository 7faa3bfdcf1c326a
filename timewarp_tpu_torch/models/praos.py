"""Ouroboros-Praos slot-leader consensus (port of
``timewarp_tpu/models/praos.py``), batched over the node axis.

Time is divided into fixed slots; in every slot each stake node wins
leadership with a stake-weighted probability from its private firing
entropy (``fire_bits``, the scenario ``needs_key``); a leader extends its
best chain by one block and diffuses the new tip to ``fanout``
pseudo-random peers; nodes adopt the longest tip they hear and relay it
onward. The inbox reduces commutatively (max over tip length) and never
reads the sender.

Payload layout: ``[chain_len, relayer]`` — slot 1 carries the id of the
node that relayed this tip, re-stamped at every hop.

The leadership threshold ``thr`` is a uint32 state leaf in the
reference, compared against the entropy word ``b0``. The port carries it
as an int64 word in ``[0, 2**32)``, like every uint32 word of the port
(``Scenario.u32_states``; state_io.py maps it at the boundary).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.scenario import NEVER, Inbox, Outbox, Scenario
from ..core.time import Microsecond, ms, sec
from .peers import distinct_mask, lcg_peers

__all__ = ["praos"]


def praos(n: int, *,
          slot_us: Microsecond = sec(1),
          n_slots: int = 20,
          leader_prob: float = 0.05,
          stake=None,
          fanout: int = 8,
          relay_interval: Microsecond = ms(2),
          burst: bool = False,
          mailbox_cap: int = 16) -> Scenario:
    """Build the Praos scenario (the reference's arguments). It quiesces
    after ``n_slots`` slots once the last relays drain. ``stake``
    (optional non-negative int array ``[n]``) weights each node's
    leadership linearly; None is equal stake 1. ``burst=True`` pushes a
    fresh tip to all ``fanout`` peers in one firing; ``burst=False`` is
    the paced model, one relay send per ``relay_interval``."""
    if n < 2:
        raise ValueError(f"praos needs n >= 2 nodes, got {n} "
                         "(peer draw divides by n - 1)")
    # the threshold in numpy exactly as the reference builds it
    if stake is None:
        thr_arr = np.full(
            n, min(int(leader_prob * 4294967296.0), 2**32 - 1), np.uint32)
    else:
        stake = np.asarray(stake)
        if stake.shape != (n,) or (stake < 0).any():
            raise ValueError("stake must be a non-negative int array [n]")
        thr_arr = np.minimum(
            stake.astype(np.float64) * leader_prob * 4294967296.0,
            2**32 - 1).astype(np.uint32)
    thr_words = torch.from_numpy(thr_arr.astype(np.int64))

    def adopt_and_lead(state, inbox: Inbox, now, key):
        """Adopt the longest incoming tip, then the slot boundary's
        leadership draw: ``(best2, slot1, nslot1, fresh)``."""
        best, slot, nslot = state["best"], state["slot"], state["nslot"]
        tin = torch.where(inbox.valid, inbox.payload[:, 0, :], -1) \
            .amax(dim=0)
        adopt = tin > best
        best1 = torch.where(adopt, tin, best)
        due_slot = (slot < n_slots) & (nslot <= now)
        b0, _ = key
        leader = due_slot & (b0 < state["thr"])
        best2 = best1 + leader.to(torch.int32)
        slot1 = slot + due_slot.to(torch.int32)
        nslot1 = torch.where(due_slot, nslot + slot_us, nslot)
        return best2, slot1, nslot1, adopt | leader

    def slot_wake(slot1, nslot1):
        return torch.where(slot1 < n_slots, nslot1, NEVER)

    def step_burst(state, inbox: Inbox, now, i, key):
        best2, slot1, nslot1, fresh = adopt_and_lead(state, inbox, now, key)
        # a fresh tip floods all peers at once: fanout chained LCG draws,
        # committed only when fresh; duplicate draws are masked
        lc, dsts = lcg_peers(state["lcg"], i, n, fanout)
        lcg1 = torch.where(fresh, lc, state["lcg"])
        pay = torch.stack([best2, i])                           # [2, N]
        out = Outbox(valid=fresh[None, :] & distinct_mask(dsts),
                     dst=torch.stack(dsts),
                     payload=pay[None].expand(fanout, 2, -1))
        return {"best": best2, "lcg": lcg1, "slot": slot1, "nslot": nslot1,
                "thr": state["thr"]}, out, slot_wake(slot1, nslot1)

    def step(state, inbox: Inbox, now, i, key):
        best2, slot1, nslot1, fresh = adopt_and_lead(state, inbox, now, key)
        # a new tip re-arms the relay burst
        left1 = torch.where(fresh, fanout, state["left"])
        nrelay1 = torch.where(fresh, now + relay_interval, state["nrelay"])
        due_relay = (left1 > 0) & (nrelay1 <= now)
        lc, (dst,) = lcg_peers(state["lcg"], i, n, 1)
        lcg1 = torch.where(due_relay, lc, state["lcg"])
        out = Outbox(valid=due_relay[None, :], dst=dst[None, :],
                     payload=torch.stack([best2, i])[None])
        left2 = left1 - due_relay.to(torch.int32)
        nrelay2 = torch.where(due_relay, now + relay_interval, nrelay1)
        relay_wake = torch.where(left2 > 0, nrelay2, NEVER)
        wake = torch.minimum(slot_wake(slot1, nslot1), relay_wake)
        return {"best": best2, "lcg": lcg1, "left": left2,
                "nrelay": nrelay2, "slot": slot1, "nslot": nslot1,
                "thr": state["thr"]}, out, wake

    def init(i: int):
        def scalar(v, dtype):
            return torch.tensor(v, dtype=dtype)
        st = {"best": scalar(0, torch.int32),
              "lcg": scalar((i * 2654435761) % (2**31 - 1) + 1, torch.int32),
              "slot": scalar(0, torch.int32),
              "nslot": scalar(slot_us, torch.int64),
              "thr": thr_words[i].clone()}
        if not burst:
            st["left"] = scalar(0, torch.int32)
            st["nrelay"] = scalar(NEVER, torch.int64)
        return st, slot_us

    def init_batched(nn: int, device):
        ids = torch.arange(nn, dtype=torch.int32, device=device)
        wake = torch.full((nn,), slot_us, dtype=torch.int64, device=device)
        states = {
            "best": torch.zeros(nn, dtype=torch.int32, device=device),
            "lcg": ((ids.to(torch.int64) * 2654435761) % (2**31 - 1)
                    + 1).to(torch.int32),
            "slot": torch.zeros(nn, dtype=torch.int32, device=device),
            "nslot": wake.clone(),
            "thr": thr_words.to(device),
        }
        if not burst:
            states["left"] = torch.zeros(nn, dtype=torch.int32,
                                         device=device)
            states["nrelay"] = torch.full((nn,), NEVER, dtype=torch.int64,
                                          device=device)
        return states, wake

    return Scenario(
        name=f"praos-{n}",
        n_nodes=n,
        step=step_burst if burst else step,
        init=init,
        init_batched=init_batched,
        payload_width=2,
        max_out=fanout if burst else 1,
        mailbox_cap=mailbox_cap,
        needs_key=True,
        commutative_inbox=True,
        inbox_src=False,
        u32_states=("thr",),
        meta={"slot_us": slot_us, "n_slots": n_slots,
              "leader_prob": leader_prob, "fanout": fanout,
              "burst": burst},
    )

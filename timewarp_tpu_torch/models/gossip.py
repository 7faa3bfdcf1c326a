"""Gossip broadcast (port of ``timewarp_tpu/models/gossip.py``), batched
over the node axis.

A push-rumor epidemic: node 0 originates a rumor; every node, on first
hearing it, relays it to ``fanout`` pseudo-random peers after a
``think_us`` incubation — one send per ``gossip_interval`` (paced), or
all ``fanout`` in one firing (``burst=True``). The inbox reduces
commutatively (min over hop counts) and never reads the sender.

Payload layout: ``[hop]`` — the relay depth at which the rumor travels.
``steady=True`` is the rumor-mongering variant: an infected node keeps
relaying to one random peer every ``gossip_interval`` until ``end_us``.
"""

from __future__ import annotations

import torch

from ..core.scenario import NEVER, Inbox, Outbox, Scenario
from ..core.time import Microsecond, ms, sec
from ..net.delays import LinkModel, LogNormalDelay
from .peers import distinct_mask, lcg_peers

__all__ = ["gossip", "gossip_links"]

_I32MAX = 2**31 - 1


def gossip(n: int, *,
           fanout: int = 8,
           think_us: Microsecond = ms(5),
           gossip_interval: Microsecond = ms(2),
           bootstrap_us: Microsecond = ms(1),
           end_us: Microsecond = sec(60),
           steady: bool = False,
           burst: bool = False,
           mailbox_cap: int = 16) -> Scenario:
    """Build the gossip scenario (the reference's arguments). Node 0
    starts infected; the run quiesces when every node has relayed (wave)
    or at ``end_us`` (``steady``)."""
    if n < 2:
        raise ValueError(f"gossip needs n >= 2 nodes, got {n} "
                         "(peer draw divides by n - 1)")
    if burst and steady:
        raise ValueError("burst applies to the broadcast wave only; "
                         "steady mode is round-paced by definition")

    def adopt(state, inbox: Inbox, now):
        """Adopt the minimum incoming relay depth (commutative)."""
        hin = torch.where(inbox.valid, inbox.payload[:, 0, :],
                          _I32MAX).amin(dim=0)
        got_new = (state["hop"] < 0) & (hin < _I32MAX)
        hop1 = torch.where(got_new, hin, state["hop"])
        alive = now < end_us
        return hop1, got_new & alive, alive

    def step_burst(state, inbox: Inbox, now, i, key):
        lcg, left, nxt = state["lcg"], state["left"], state["next"]
        hop1, arm, alive = adopt(state, inbox, now)
        left1 = torch.where(arm, 1, left)
        nxt1 = torch.where(arm, now + think_us, nxt)
        # one firing floods all fanout peers; duplicate draws are masked
        due = (left1 > 0) & (nxt1 <= now) & alive
        lc, dsts = lcg_peers(lcg, i, n, fanout)
        lcg1 = torch.where(due, lc, lcg)
        out = Outbox(
            valid=due[None, :] & distinct_mask(dsts),
            dst=torch.stack(dsts),
            payload=(hop1 + 1)[None, None, :].expand(fanout, 1, -1))
        left2 = torch.where(due, 0, left1)
        nxt2 = torch.where(due, NEVER, nxt1)
        wake = torch.where((left2 > 0) & alive, nxt2, NEVER)
        return {"hop": hop1, "lcg": lcg1, "left": left2,
                "next": nxt2}, out, wake

    def step(state, inbox: Inbox, now, i, key):
        lcg, left, nxt = state["lcg"], state["left"], state["next"]
        hop1, arm, alive = adopt(state, inbox, now)
        # first infection: arm the relay burst after the incubation
        left1 = torch.where(arm, fanout, left)
        nxt1 = torch.where(arm, now + think_us, nxt)
        due = (left1 > 0) & (nxt1 <= now) & alive
        lc, (dst,) = lcg_peers(lcg, i, n, 1)
        lcg1 = torch.where(due, lc, lcg)
        out = Outbox(valid=due[None, :], dst=dst[None, :],
                     payload=(hop1 + 1)[None, None, :])
        if steady:
            left2 = left1                     # mongering never exhausts
            nxt2 = torch.where(due, now + gossip_interval, nxt1)
        else:
            left2 = left1 - due.to(torch.int32)
            nxt2 = torch.where(
                due, torch.where(left2 > 0, now + gossip_interval, NEVER),
                nxt1)
        wake = torch.where((left2 > 0) & alive, nxt2, NEVER)
        return {"hop": hop1, "lcg": lcg1, "left": left2,
                "next": nxt2}, out, wake

    def init_batched(nn: int, device):
        ids = torch.arange(nn, dtype=torch.int32, device=device)
        seeded = ids == 0
        wake = torch.where(seeded, bootstrap_us, NEVER)
        states = {
            "hop": torch.where(seeded, 0, -1).to(torch.int32),
            "lcg": ((ids.to(torch.int64) * 2654435761) % (2**31 - 1)
                    + 1).to(torch.int32),
            "left": torch.where(seeded, fanout, 0).to(torch.int32),
            "next": wake,
        }
        return states, wake

    return Scenario(
        name=f"gossip-{n}",
        n_nodes=n,
        step=step_burst if burst else step,
        init_batched=init_batched,
        payload_width=1,
        max_out=fanout if burst else 1,
        mailbox_cap=mailbox_cap,
        commutative_inbox=True,
        inbox_src=False,
        meta={"fanout": fanout, "end_us": end_us, "burst": burst},
    )


def gossip_links(*, median_us: int = ms(50), sigma: float = 0.6,
                 cap_us: int = sec(10), floor_us: int = 1) -> LinkModel:
    """The baseline config's lognormal latency model; ``floor_us`` is
    the propagation floor that licenses windowed supersteps."""
    return LogNormalDelay(median_us, sigma, cap_us, floor_us)

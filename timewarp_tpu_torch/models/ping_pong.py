"""Ping-pong scenario (port of ``timewarp_tpu/models/ping_pong.py``),
batched over the node axis.

Two nodes: node 0 sends ``Ping``, node 1 answers ``Pong``, for a
configurable number of rounds. An ordered inbox that reads the sender,
one outbox slot. Payload layout: ``[seq, kind]``.
"""

from __future__ import annotations

import torch

from ..core.scenario import NEVER, Inbox, Outbox, Scenario
from ..core.time import Microsecond

__all__ = ["ping_pong", "PING", "PONG"]

PING, PONG = 0, 1


def ping_pong(*, rounds: int = 10, start_us: Microsecond = 0,
              mailbox_cap: int = 4) -> Scenario:
    """Two nodes; node 0 drives ``rounds`` ping/pong exchanges."""

    def step(state, inbox: Inbox, now, i, key):
        rem, seq = state["rem"], state["seq"]
        kind = inbox.payload[:, 1, :]
        vin = inbox.payload[:, 0, :]
        pong_in = inbox.valid & (kind == PONG)
        ping_in = inbox.valid & (kind == PING)
        is_pinger = i == 0

        # node 0: send the first ping at start, then one per pong
        kick = is_pinger & (now == start_us) & (seq == 0)
        got_pong = pong_in.any(dim=0)
        send_ping = is_pinger & (kick | (got_pong & (rem > 1)))
        rem1 = torch.where(is_pinger & got_pong, rem - 1, rem)
        seq1 = torch.where(send_ping, seq + 1, seq)

        # node 1: echo every ping back
        ping_v = torch.where(ping_in, vin, 0).amax(dim=0)
        send_pong = ~is_pinger & ping_in.any(dim=0)

        out = Outbox(
            valid=(send_ping | send_pong)[None, :],
            dst=torch.where(is_pinger, 1, 0).to(torch.int32)[None, :],
            payload=torch.stack([
                torch.where(is_pinger, seq1, ping_v),
                torch.where(is_pinger, PING, PONG).to(torch.int32)])[None])
        wake = torch.full_like(now, NEVER)
        return {"rem": rem1, "seq": seq1}, out, wake

    def init(i: int):
        state = {"rem": torch.tensor(rounds, dtype=torch.int32),
                 "seq": torch.tensor(0, dtype=torch.int32)}
        return state, start_us if i == 0 else NEVER

    def init_batched(n: int, device):
        ids = torch.arange(n, dtype=torch.int32, device=device)
        states = {"rem": torch.full((n,), rounds, dtype=torch.int32,
                                    device=device),
                  "seq": torch.zeros(n, dtype=torch.int32, device=device)}
        wake = torch.where(ids == 0, start_us, NEVER)
        return states, wake

    return Scenario(
        name="ping-pong",
        n_nodes=2,
        step=step,
        init=init,
        init_batched=init_batched,
        payload_width=2,
        max_out=1,
        mailbox_cap=mailbox_cap,
        meta={"rounds": rounds},
    )

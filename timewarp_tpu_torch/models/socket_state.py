"""Socket-state (port of ``timewarp_tpu/models/socket_state.py``), batched
over the node axis.

A server (node 0) counts requests per client connection; each client
``cid`` (nodes 1..C) sends ``Ping cid`` once per interval, as many times
as its seeded roulette allows, drawn host-side at build time with
Python's ``random`` exactly as the reference draws it. Deliveries count
on the server only while ``now < server_life_us``; later ones still fire
it. A commutative inbox without the sender; payload layout ``[cid]``.
"""

from __future__ import annotations

import random as _random

import torch

from ..core.scenario import NEVER, Inbox, Outbox, Scenario
from ..core.time import Microsecond

__all__ = ["socket_state", "roulette_sends"]


def roulette_sends(n_clients: int, seed: int):
    """Per-client send counts from the seeded roulette (``while
    rng.randrange(3) > 0``), the reference's exact draw."""
    sends = []
    for cid in range(1, n_clients + 1):
        rng = _random.Random((seed << 8) | cid)
        k = 0
        while rng.randrange(3) > 0:
            k += 1
        sends.append(k)
    return sends


def socket_state(n_clients: int = 3, *,
                 send_interval_us: Microsecond = 50_000,
                 server_life_us: Microsecond = 600_000,
                 seed: int = 0,
                 mailbox_cap: int = 8) -> Scenario:
    """Build the batched socket-state scenario (the reference's
    arguments; ``seed`` keys the roulette)."""
    if n_clients < 1:
        raise ValueError("socket_state needs at least one client")
    n = n_clients + 1
    C = n_clients
    sends = roulette_sends(n_clients, seed)

    def step(state, inbox: Inbox, now, i, key):
        cnt, left, nxt = state["cnt"], state["left"], state["next"]
        is_server = i == 0
        listening = now < server_life_us

        # each delivered ping on its client's counter. The reference
        # scatters at payload - 1 with jnp's "drop" mode, which first
        # wraps an index in [-C, 0) to index + C and then drops what is
        # out of range; here every slot that adds nothing goes to a spare
        # column C, cut off after (no negative index reaches torch)
        cid = inbox.payload[:, 0, :] - 1                         # [K, N]
        cid = torch.where(cid < 0, cid + C, cid)
        cid = torch.where(inbox.valid & (cid >= 0) & (cid < C), cid, C)
        inc = torch.zeros((cnt.shape[0], C + 1), dtype=torch.int32,
                          device=cnt.device).scatter_add_(
            1, cid.T.long(), inbox.valid.T.to(torch.int32))[:, :C]
        cnt1 = torch.where((is_server & listening)[:, None], cnt + inc, cnt)

        # one ping per interval while the roulette allows
        due = (left > 0) & (nxt <= now) & ~is_server
        out = Outbox(valid=due[None, :],
                     dst=torch.zeros_like(i)[None, :],
                     payload=i.to(torch.int32)[None, None, :])
        left1 = left - due.to(torch.int32)
        nxt1 = torch.where(due, nxt + send_interval_us, nxt)
        wake = torch.where(left1 > 0, nxt1, NEVER)
        return {"cnt": cnt1, "left": left1, "next": nxt1}, out, wake

    def init(i: int):
        left = 0 if i == 0 else sends[i - 1]
        first = send_interval_us if left > 0 else NEVER
        return {"cnt": torch.zeros(C, dtype=torch.int32),
                "left": torch.tensor(left, dtype=torch.int32),
                "next": torch.tensor(first, dtype=torch.int64)}, first

    def init_batched(nn: int, device):
        left = torch.tensor([0] + sends, dtype=torch.int32, device=device)
        first = torch.where(left > 0, send_interval_us, NEVER)
        states = {"cnt": torch.zeros((nn, C), dtype=torch.int32,
                                     device=device),
                  "left": left, "next": first}
        return states, first

    return Scenario(
        name=f"socket-state-{n}",
        n_nodes=n,
        step=step,
        init=init,
        init_batched=init_batched,
        payload_width=1,
        max_out=1,
        mailbox_cap=mailbox_cap,
        commutative_inbox=True,
        inbox_src=False,
        meta={"sends": sends, "send_interval_us": send_interval_us,
              "server_life_us": server_life_us},
    )

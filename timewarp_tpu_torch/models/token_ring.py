"""Token-ring scenario (port of ``timewarp_tpu/models/token_ring.py``),
batched over the node axis.

N ring nodes pass an incrementing token; on receipt a node notifies the
observer (node ``n_ring``, 0-latency link) and, after a think time,
forwards ``v+1`` to its successor; the observer checks values arrive
monotonically *in inbox order* — the ordered-inbox scenario (``max_out=2``,
``payload_width=2``, not commutative). Payload layout: ``[value, kind]``.

Without the observer (``with_observer=False``) the ring is lean: one
outbox slot to the fixed successor, declared as ``static_dst``, and a
commutative inbox — the dense-ring regime of the edge and fused-ring
engines.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.scenario import NEVER, Inbox, Outbox, Scenario
from ..core.time import Microsecond, ms, sec
from ..net.delays import FnDelay, LinkModel, UniformDelay

__all__ = ["token_ring", "token_ring_links", "TOKEN", "NOTE"]

TOKEN, NOTE = 0, 1


def token_ring(n_ring: int, *,
               n_tokens: int = 1,
               think_us: Microsecond = sec(3),
               bootstrap_us: Microsecond = sec(1),
               end_us: Microsecond = sec(20),
               with_observer: bool = True,
               mailbox_cap: int = 8) -> Scenario:
    """Build the token-ring scenario (the reference's arguments). Node
    ids ``0..n_ring-1`` form the ring; id ``n_ring`` is the observer."""
    if n_tokens > n_ring:
        raise ValueError(f"n_tokens={n_tokens} exceeds n_ring={n_ring}")
    n_nodes = n_ring + (1 if with_observer else 0)
    obs_id = n_ring

    def step(state, inbox: Inbox, now, i, key):
        cnt, val, send_at = state["cnt"], state["val"], state["send_at"]
        kind = inbox.payload[:, 1, :]
        vin = inbox.payload[:, 0, :]
        tok_in = inbox.valid & (kind == TOKEN)

        # --- ring-node half ---
        got = tok_in.any(dim=0)
        cnt1 = cnt + tok_in.sum(dim=0, dtype=torch.int32)
        vmax = torch.where(tok_in, vin, -2**31).amax(dim=0)
        val1 = torch.maximum(val, torch.where(got, vmax, val))
        send_at1 = torch.where(got & (send_at >= NEVER),
                               now + think_us, send_at)
        alive = now < end_us
        due = (send_at1 <= now) & (cnt1 > 0) & alive
        succ = torch.remainder(i + 1, n_ring).to(torch.int32)
        cnt2 = torch.where(alive, cnt1 - due.to(torch.int32), 0)
        send_at2 = torch.where(
            due, torch.where(cnt2 > 0, now + think_us, NEVER),
            torch.where(alive, send_at1, NEVER))
        tok_payload = torch.stack([val1 + 1, torch.full_like(val1, TOKEN)])

        if not with_observer:
            out = Outbox(valid=due[None, :], dst=succ[None, :],
                         payload=tok_payload[None])
            return {"cnt": cnt2, "val": val1, "send_at": send_at2}, \
                out, send_at2

        prev, errs = state["prev"], state["errs"]
        note_in = inbox.valid & (kind == NOTE)
        is_obs = i == obs_id

        # --- observer half: monotone check in inbox order ---
        p, e = prev, errs
        for j in range(inbox.valid.shape[0]):
            ok = note_in[j]
            e = e + (ok & (vin[j] != p + 1)).to(torch.int32)
            p = torch.where(ok, vin[j], p)

        # --- outbox: slot 0 = token to successor, slot 1 = note ---
        out = Outbox(
            valid=torch.stack([due & ~is_obs, got & ~is_obs & alive]),
            dst=torch.stack([succ, torch.full_like(succ, obs_id)]),
            payload=torch.stack([
                tok_payload,
                torch.stack([vmax, torch.full_like(vmax, NOTE)])]))
        new_state = {
            "cnt": torch.where(is_obs, cnt, cnt2),
            "val": torch.where(is_obs, val, val1),
            "send_at": torch.where(is_obs, NEVER, send_at2),
            "prev": torch.where(is_obs, p, prev),
            "errs": torch.where(is_obs, e, errs),
        }
        wake = torch.where(is_obs, NEVER, send_at2)
        return new_state, out, wake

    def init(i: int):
        holds = i < n_ring and i < n_tokens
        send_at = bootstrap_us if holds else NEVER
        st = {"cnt": torch.tensor(int(holds), dtype=torch.int32),
              "val": torch.tensor(0, dtype=torch.int32),
              "send_at": torch.tensor(send_at, dtype=torch.int64)}
        if with_observer:
            st["prev"] = torch.tensor(0, dtype=torch.int32)
            st["errs"] = torch.tensor(0, dtype=torch.int32)
        return st, send_at

    def init_batched(n: int, device):
        ids = torch.arange(n, dtype=torch.int32, device=device)
        holds = (ids < n_ring) & (ids < n_tokens)
        send_at = torch.where(holds, bootstrap_us, NEVER)
        states = {
            "cnt": holds.to(torch.int32),
            "val": torch.zeros(n, dtype=torch.int32, device=device),
            "send_at": send_at,
        }
        if with_observer:
            states["prev"] = torch.zeros(n, dtype=torch.int32, device=device)
            states["errs"] = torch.zeros(n, dtype=torch.int32, device=device)
        return states, send_at

    # the lean ring only ever sends to its successor: a static topology
    # (the edge engine's); the observer's hub has in-degree N
    static_dst = None if with_observer else (
        (np.arange(n_ring, dtype=np.int32) + 1) % n_ring).reshape(n_ring, 1)

    return Scenario(
        name=f"token-ring-{n_ring}",
        n_nodes=n_nodes,
        step=step,
        init=init,
        init_batched=init_batched,
        payload_width=2,
        max_out=2 if with_observer else 1,
        mailbox_cap=mailbox_cap,
        static_dst=static_dst,
        commutative_inbox=not with_observer,
        meta={"n_ring": n_ring, "obs_id": obs_id if with_observer else None,
              "think_us": think_us, "end_us": end_us},
    )


def token_ring_links(n_ring: int, *, lo_us: int = ms(1), hi_us: int = ms(5),
                     with_observer: bool = True) -> LinkModel:
    """The reference's ``Delays``: observer-bound messages connect in 0
    (clamped to the 1 µs floor), everything else uniform 1–5 ms."""
    uni = UniformDelay(lo_us, hi_us)
    if not with_observer:
        return uni
    obs_id = n_ring

    def fn(src, dst, t, key):
        d, drop = uni.sample(src, dst, t, key)
        return torch.where(dst == obs_id, 0, d), drop

    return FnDelay(fn)

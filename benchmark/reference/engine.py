"""The superstep of the emulation, in plain PyTorch over a world axis.

A state is a dict of tensors, every leaf with a leading world axis ``B``:
``states.<leaf>`` ``[B, N]``, ``wake`` int64 ``[B, N]`` (``NEVER`` when no
timer is armed), the mailbox ``mb_rel`` int32 ``[B, K, N]`` (deliver time
relative to the epoch ``time``; ``I32MAX`` marks a free slot), ``mb_src``
int32 ``[B, K, N]`` and ``mb_payload`` int32 ``[B, K, P, N]``, and the
counters ``overflow``, ``bad_dst``, ``bad_delay``, ``short_delay``,
``route_drop``, ``fault_dropped`` (int32 ``[B]``), ``delivered``,
``steps``, ``time`` (int64 ``[B]``).

One superstep of a world whose next event lies at ``t``:

1. ``t`` is the least of every node's timer and earliest pending
   delivery; a world with none is quiesced and left as it is;
2. every node whose next event lies in ``[t, t + W)`` fires at its own
   instant ``now``;
3. it receives every message in its mailbox due by ``now`` (the inbox
   is commutative: the step reduces it without regard to order);
4. the scenario's step gives its new state, timer and outbox;
5. delivered messages free their slots and the mailbox is rebased to
   the epoch ``t``;
6. each message ``src -> dst`` sent at ``now`` from outbox slot ``m``
   draws its delay from the link under the entropy of ``(seed, src,
   dst, now, m)``, flies at least 1 µs, and lands ``now - t + flight``
   after the new epoch; the messages to one node take its free slots in
   slot order, ordered by ``(now - t, src * M + m)``; those that find no
   free slot are counted in ``overflow``.

Worlds differ only by their seed. ``rounds`` and ``float_dtype`` are the
stream's and the float link's precision, lowered only by the control.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from . import links
from .rng import fire_bits, msg_bits, seed_words

NEVER = (1 << 62) - 1
I32MAX = 2**31 - 1
COUNTERS32 = ("overflow", "bad_dst", "bad_delay", "short_delay",
              "route_drop", "fault_dropped")
COUNTERS64 = ("delivered", "steps", "time")


@dataclass(frozen=True)
class Model:
    """A scenario family at one size: ``init(device) -> (states, wake)``
    over ``[N]``; ``step(states, valid [K, N'], payload [K, P, N'], now
    [N'], ids [N'], bits) -> (states, out_valid [M, N'], out_dst [M, N'],
    out_payload [M, P, N'], wake [N'])``, elementwise over any number of
    nodes ``N'``."""
    n: int
    M: int
    P: int
    K: int
    needs_key: bool
    init: Callable
    step: Callable


class RefEngine:
    def __init__(self, model: Model, link: dict, window, seeds, device,
                 rounds: int = 20, float_dtype=torch.float32) -> None:
        self.m, self.link = model, link
        floor = links.floor(link)
        self.W = floor if window == "auto" else int(window)
        if self.W > 1 and self.W > floor:
            raise ValueError(f"window {self.W} exceeds the link's floor "
                             f"{floor}")
        self.device = torch.device(device)
        self.rounds, self.float_dtype = rounds, float_dtype
        words = [seed_words(int(s)) for s in seeds]
        self.s0 = torch.tensor([w[0] for w in words], dtype=torch.int64,
                               device=self.device)[:, None]
        self.s1 = torch.tensor([w[1] for w in words], dtype=torch.int64,
                               device=self.device)[:, None]
        self.B = len(words)
        self.ids = torch.arange(model.n, dtype=torch.int32,
                                device=self.device)

    def init_state(self) -> dict:
        m, B, dev = self.m, self.B, self.device
        states, wake = m.init(dev)
        st = {f"states.{k}": v[None].repeat((B,) + (1,) * v.dim())
              for k, v in states.items()}
        st["wake"] = wake.to(torch.int64)[None].repeat(B, 1)
        st["mb_rel"] = torch.full((B, m.K, m.n), I32MAX, dtype=torch.int32,
                                  device=dev)
        st["mb_src"] = torch.zeros((B, m.K, m.n), dtype=torch.int32,
                                   device=dev)
        st["mb_payload"] = torch.zeros((B, m.K, m.P, m.n), dtype=torch.int32,
                                       device=dev)
        for k in COUNTERS32:
            st[k] = torch.zeros(B, dtype=torch.int32, device=dev)
        for k in COUNTERS64:
            st[k] = torch.zeros(B, dtype=torch.int64, device=dev)
        return st

    def run(self, st: dict, supersteps: int) -> dict:
        """``supersteps`` supersteps of every world (a quiesced world
        stays as it is)."""
        for _ in range(supersteps):
            st = self.superstep(st)
        return st

    def superstep(self, st: dict) -> dict:
        m, B, n, M = self.m, self.B, self.m.n, self.m.M
        base, rel = st["time"], st["mb_rel"]
        live = rel < I32MAX
        due_at = torch.where(live, base[:, None, None] + rel.long(), NEVER) \
            .amin(dim=1)
        node_next = torch.minimum(st["wake"], due_at)            # [B, N]
        t = node_next.amin(dim=1)                                 # [B]
        active = t < NEVER
        fire = (node_next < NEVER) & (node_next - t[:, None] < self.W)
        now = torch.where(fire, node_next, t[:, None])
        now_rel = torch.clamp(now - base[:, None], max=I32MAX - 1)
        deliver = live & fire[:, None, :] & (rel.long() <= now_rel[:, None])

        # the step, every world's nodes side by side
        def flat(x):          # [B, R..., N] -> [R..., B*N]
            return x.movedim(0, -2).reshape(*x.shape[1:-1], B * n)

        def unflat(x):        # [R..., B*N] -> [B, R..., N]
            return x.reshape(*x.shape[:-1], B, n).movedim(-2, 0)
        names = [k for k in st if k.startswith("states.")]
        flat_states = {k[7:]: st[k].reshape(B * n) for k in names}
        ids = self.ids.repeat(B)
        bits = None
        if m.needs_key:
            b0, b1 = fire_bits(self.s0, self.s1, self.ids[None, :], now,
                               self.rounds)
            bits = (b0.reshape(B * n), b1.reshape(B * n))
        new, o_valid, o_dst, o_pay, o_wake = m.step(
            flat_states, flat(deliver), flat(st["mb_payload"]),
            now.reshape(B * n), ids, bits)
        out = {}
        for k in names:
            out[k] = torch.where(fire, new[k[7:]].reshape(B, n), st[k])
        o_wake = o_wake.reshape(B, n)
        o_wake = torch.where(o_wake >= NEVER, NEVER,
                             torch.maximum(o_wake, now + 1))
        out["wake"] = torch.where(fire, o_wake, st["wake"])
        o_valid = unflat(o_valid) & fire[:, None, :]              # [B, M, N]
        o_dst, o_pay = unflat(o_dst), unflat(o_pay)        # [B, M(, P), N]

        # free the delivered slots, rebase to the epoch t
        shift = torch.clamp(t - base, max=I32MAX - 1).to(torch.int32)
        keep = live & ~deliver
        mb_rel = torch.where(keep, rel - shift[:, None, None], I32MAX)

        # the messages: draw, order, land
        dst = o_dst.long()
        in_range = (dst >= 0) & (dst < n)
        ok = o_valid & in_range
        bad_dst = (o_valid & ~in_range).sum(dim=(1, 2), dtype=torch.int32)
        src = self.ids.long()[None, None, :].expand(B, M, n)
        slot = torch.arange(M, device=self.device)[None, :, None] \
            .expand(B, M, n)
        tmsg = now[:, None, :].expand(B, M, n)
        mb0, mb1 = msg_bits(self.s0[:, :, None], self.s1[:, :, None], src,
                            torch.where(ok, dst, 0), tmsg, slot, self.rounds)
        flight = torch.clamp(links.draw(self.link, mb0, mb1,
                                        self.float_dtype), min=1)
        woff = tmsg - t[:, None, None]
        land = woff + flight
        bad_delay = (ok & (land > I32MAX - 1)).sum(dim=(1, 2),
                                                   dtype=torch.int32)
        short = (ok & (flight < self.W)).sum(dim=(1, 2), dtype=torch.int32) \
            if self.W > 1 else torch.zeros(B, dtype=torch.int32,
                                           device=self.device)
        land = torch.clamp(land, max=I32MAX - 1)
        mb_rel, mb_payload, overflow = self._land(
            mb_rel, st["mb_payload"], ok, dst, woff, src * M + slot, land,
            o_pay)

        for k, v in (("overflow", overflow), ("bad_dst", bad_dst),
                     ("bad_delay", bad_delay), ("short_delay", short)):
            out[k] = st[k] + v
        out["route_drop"] = st["route_drop"]
        out["fault_dropped"] = st["fault_dropped"]
        out["delivered"] = st["delivered"] + deliver.sum(dim=(1, 2))
        out["steps"] = st["steps"] + 1
        out["time"] = t
        out["mb_rel"], out["mb_src"] = mb_rel, st["mb_src"]
        out["mb_payload"] = mb_payload
        # a quiesced world stays as it was
        return {k: torch.where(active.view((B,) + (1,) * (v.dim() - 1)),
                               v, st[k]) for k, v in out.items()}

    def _land(self, mb_rel, mb_payload, ok, dst, woff, rank, land, pay):
        """Each world's messages into the free slots of their
        destinations: per destination in ``(woff, rank)`` order, the r-th
        message into the r-th free slot. Returns the new ``mb_rel``,
        ``mb_payload`` and each world's overflow count."""
        B, K, n = mb_rel.shape
        P = pay.shape[2]
        S = ok.shape[1] * ok.shape[2]
        ok, dst, woff, rank, land = (x.reshape(B, S) for x in
                                     (ok, dst, woff, rank, land))
        pay = pay.movedim(2, 1).reshape(B, P, S)
        # one lexicographic key: destination (n past the messages that
        # land nowhere), then send offset, then sender-major rank
        key_dst = torch.where(ok, dst, n)
        order = torch.argsort(woff * (1 << 32) + rank, dim=1, stable=True)
        order = order.gather(1, torch.argsort(key_dst.gather(1, order),
                                              dim=1, stable=True))
        sdst = key_dst.gather(1, order)
        # each message's rank among those to the same destination
        pos = torch.arange(S, device=ok.device).expand(B, S)
        first = torch.ones_like(sdst, dtype=torch.bool)
        first[:, 1:] = sdst[:, 1:] != sdst[:, :-1]
        r = pos - torch.cummax(torch.where(first, pos, 0), dim=1).values
        # the free slots of each node, in slot order
        free = mb_rel == I32MAX                                   # [B, K, N]
        nfree = free.sum(dim=1)                                   # [B, N]
        free_rank = torch.cumsum(free, dim=1) - 1                 # [B, K, N]
        real = sdst < n
        dn = torch.where(real, sdst, 0)
        fits = real & (r < nfree.gather(1, dn))
        overflow = (real & ~fits).sum(dim=1, dtype=torch.int32)
        # the slot of node d that is its r-th free one: each free slot
        # written under the cell (d, its rank among d's free slots)
        holder = torch.full((B, n * K + 1), -1, dtype=torch.int64,
                            device=ok.device)
        cells = torch.where(free, torch.arange(n, device=ok.device)
                            [None, None, :] * K + free_rank, n * K)
        slots = torch.arange(K, device=ok.device)[None, :, None] \
            .expand(B, K, n)
        holder.scatter_(1, cells.reshape(B, K * n), slots.reshape(B, K * n))
        target = torch.where(fits, dn * K + r, n * K)
        k_of = holder.gather(1, target)                           # [B, S]
        flat = torch.where(fits, k_of * n + dn, K * n)
        rel_flat = torch.cat([mb_rel.reshape(B, K * n),
                              mb_rel.new_zeros(B, 1)], dim=1)
        rel_flat.scatter_(1, flat, land.gather(1, order).to(torch.int32))
        pay_flat = torch.cat([mb_payload.movedim(2, 1).reshape(B, P, K * n),
                              mb_payload.new_zeros(B, P, 1)], dim=2)
        pay_flat.scatter_(2, flat[:, None, :].expand(B, P, S),
                          pay.gather(2, order[:, None, :].expand(B, P, S)))
        return (rel_flat[:, :K * n].reshape(B, K, n),
                pay_flat[:, :, :K * n].reshape(B, P, K, n).movedim(1, 2),
                overflow)

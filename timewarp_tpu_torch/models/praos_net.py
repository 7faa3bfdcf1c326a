"""Praos slot-leader consensus over the full network stack — the
generator-program twin of :func:`timewarp_tpu_torch.models.praos.praos`
(``burst=True``), one thread per stake node, one-way tip dialogs.

Cross-world alignment (tests/test_cross_world_more.py): the batched
world's "VRF" is the framework's counter RNG keyed by (node, slot
instant) — ``fire_bits(s0, s1, i, t)`` — which is a pure host-callable
function, so this world draws the SAME leadership schedule from the
same seed with no RNG stream to thread. Tips flood in the same firing
that creates them (leader mint or adoption — the burst model's
semantics), peers come from the exact host replica of the batched
LCG (models/gossip_net.py), and link delays come from one
(dst, t)-keyed seeded model — so the whole diffusion timeline and the
final chain lengths match the batched twin µs-for-µs.

Tie caveat (≙ gossip_net's): if two events land on one node at the
same µs instant (two tip arrivals, or an arrival exactly on a slot
boundary), the batched world folds them into one firing while this
world handles them in socket order — the test asserts the chosen
parameters produce no such ties rather than pretending the worlds
agree under them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..core.effects import (GetTime, Program, Wait, fork_, invoke,
                            modify_log_name)
from ..core.rng import fire_bits, seed_words
from ..core.time import at, till
from ..net.backend import NetBackend
from ..net.dialog import Dialog, Listener
from ..net.message import message
from ..net.transfer import AtPort, Transport, localhost
from .gossip_net import host_distinct, host_lcg_peers, lcg_init

__all__ = ["Tip", "praos_net", "praos_net_ports", "leader_schedule"]

PRAOS_PORT0 = 7800


def praos_net_ports(n: int) -> Dict[str, int]:
    """Endpoint name -> batched node index (for
    ``EmulatedBackend(endpoint_ids=...)``)."""
    return {f"127.0.0.1:{PRAOS_PORT0 + i}": i for i in range(n)}


def leader_schedule(seed: int, n: int, n_slots: int, slot_us: int,
                    leader_prob: float) -> Dict[int, List[int]]:
    """slot instant -> leader node ids, drawn EXACTLY as the batched
    engines do (fire_bits keyed by (node, instant); equal stake)."""
    s0, s1 = seed_words(seed)
    thr = min(int(leader_prob * 4294967296.0), 2**32 - 1)
    out: Dict[int, List[int]] = {}
    for k in range(1, n_slots + 1):
        t = k * slot_us
        b0, _ = fire_bits(s0, s1, torch.arange(n, dtype=torch.int64), t)
        out[t] = torch.nonzero(b0 < thr).flatten().tolist()
    return out


@message
class Tip:
    """A chain tip on the wire: ``[chain_len, relayer]`` ≙ the batched
    payload layout (models/praos.py)."""
    length: int
    relayer: int


def praos_net(backend: NetBackend, n: int, *,
              seed: int = 0,
              slot_us: int = 200_000,
              n_slots: int = 4,
              leader_prob: float = 0.1,
              fanout: int = 3,
              receipts: Optional[List[Tuple[int, int, int]]] = None):
    """Build the scenario main program. ``receipts`` collects every
    delivered tip as ``(time, node, length)``. Returns the final
    per-node chain lengths, for comparison against the batched
    state's ``best`` leaf."""
    duration = (n_slots + 1) * slot_us
    sched = leader_schedule(seed, n, n_slots, slot_us, leader_prob)

    def main() -> Program:
        transports: List[Transport] = []
        stops: List = []
        best: Dict[int, int] = {i: 0 for i in range(n)}
        lcgs: Dict[int, int] = {i: lcg_init(i) for i in range(n)}

        def launch_node(i: int) -> Program:
            tr = Transport(backend, host=localhost)
            transports.append(tr)
            d = Dialog(tr)

            def flood() -> Program:
                # a fresh tip floods all (distinct) fanout peers in
                # the same firing — burst semantics; the LCG commits
                lcgs[i], dsts = host_lcg_peers(lcgs[i], i, n, fanout)
                for j in host_distinct(dsts):
                    yield from d.send((localhost, PRAOS_PORT0 + j),
                                      Tip(best[i], i))

            def on_tip(msg: Tip, ctx) -> Program:
                t = yield GetTime()
                if receipts is not None:
                    receipts.append((t, i, msg.length))
                if msg.length > best[i]:
                    best[i] = msg.length
                    yield from flood()

            def slot_check(t: int) -> Program:
                # ≙ the batched leadership draw at the slot boundary
                if i in sched[t]:
                    best[i] += 1
                    yield from flood()
                return
                yield  # pragma: no cover — generator form

            stop = yield from d.listen(AtPort(PRAOS_PORT0 + i),
                                       [Listener(Tip, on_tip)])
            stops.append(stop)
            # persistent connections to every peer: the connect
            # handshake never sits on the diffusion timing path
            for j in range(n):
                if j != i:
                    yield from tr.user_state(
                        (localhost, PRAOS_PORT0 + j))
            for t in sorted(sched):
                yield from invoke(at(int(t)),
                                  lambda t=t: slot_check(t))

        for i in range(n):
            yield from fork_(
                lambda i=i: modify_log_name(f"node{i}",
                                            lambda: launch_node(i)))
        yield Wait(till(int(duration)))
        for tr in transports:
            yield from tr.close_all()
        for stop in stops:
            yield from stop()
        return dict(best)

    return main

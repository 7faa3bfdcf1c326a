"""Gossip broadcast over the full network stack — the generator-program
twin of :func:`timewarp_tpu_torch.models.gossip.gossip` (``burst=True``),
built the way the reference would have written it (one thread per
node, a typed one-way dialog per rumor — the ``Delays``-style emulated
network of examples/token-ring/Main.hs:73-85, but push-epidemic).

Cross-world alignment (tests/test_cross_world_more.py): this model
exchanges NO acks — every chunk on the wire is a rumor — and a node's
relay burst fires exactly ``think_us`` after its first infection, so
the batched twin needs NO think-time translation at all. Peers come
from the SAME wrapping-int32 LCG the batched scenario uses
(models/peers.py), replicated here in exact host arithmetic, and both
worlds draw link delays from one ``(dst, t)``-keyed seeded model
(net/delays.py ``SeededHashUniform`` + ``EmulatedBackend``
``endpoint_ids``), so the entire diffusion timeline matches µs-for-µs.

One documented divergence: when two rumors reach a NOT-yet-infected
node at the same instant, the batched world adopts the minimum hop
count while this world adopts whichever the socket delivered first —
the adopted *hop value* can differ, the timeline cannot (infection
time, relay instants, and destinations never depend on hop). The
cross-world law therefore covers the (time, node) delivery stream,
not payload hops.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..core.effects import (GetTime, Program, Wait, fork_, invoke,
                            modify_log_name)
from ..core.time import after, at, till
from ..net.backend import NetBackend
from ..net.dialog import Dialog, Listener
from ..net.message import message
from ..net.transfer import AtPort, Transport, localhost
from .peers import LCG_A, LCG_C

__all__ = ["Rumor", "gossip_net", "gossip_net_ports", "host_lcg_peers"]

GOSSIP_PORT0 = 7000


def gossip_net_ports(n: int):
    """Endpoint name -> batched node index (for
    ``EmulatedBackend(endpoint_ids=...)``)."""
    return {f"127.0.0.1:{GOSSIP_PORT0 + i}": i for i in range(n)}


def _lcg_wrap(x: int) -> int:
    """Exact int32 wrap of a host integer (the batched twin's int32 arithmetic)."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


def host_lcg_peers(lcg: int, i: int, n: int, k: int
                   ) -> Tuple[int, List[int]]:
    """Host replica of :func:`timewarp_tpu_torch.models.peers.lcg_peers`,
    bit-exact including the int32 wrap and int32 ``abs`` of int32-min
    (itself)."""
    dsts = []
    for _ in range(k):
        lcg = _lcg_wrap(lcg * LCG_A + LCG_C)
        a = lcg if lcg >= 0 else _lcg_wrap(-lcg)  # int32 abs semantics
        dsts.append((i + 1 + a % (n - 1)) % n)
    return lcg, dsts


def lcg_init(i: int) -> int:
    """The batched scenario's per-node LCG seed (gossip.py init)."""
    return (i * 2654435761) % (2**31 - 1) + 1


def host_distinct(dsts):
    """First-occurrence peer dedup — the host replica of
    :func:`timewarp_tpu_torch.models.peers.distinct_mask` (one push per
    peer connection per tip). One implementation for all net twins
    so they cannot drift from each other or the batched mask."""
    return list(dict.fromkeys(dsts))


@message
class Rumor:
    """One push-relay hop; ``hop`` is the relay depth."""
    hop: int


def gossip_net(backend: NetBackend, n: int, *,
               fanout: int = 4,
               think_us: int = 700,
               bootstrap_us: int = 100_000,
               duration_us: int = 1_000_000,
               prewarm: bool = True,
               receipts: Optional[List[Tuple[int, int]]] = None):
    """Build the scenario main program. ``receipts`` collects EVERY
    delivered rumor as ``(time, node)`` — the stream the cross-world
    law compares. Node 0 floods its ``fanout`` LCG peers at the
    absolute instant ``bootstrap_us``; every other node floods once,
    ``think_us`` after its first infection. The run tears down at
    ``duration_us``."""

    def main() -> Program:
        transports: List[Transport] = []
        stops: List = []

        def launch_node(i: int) -> Program:
            tr = Transport(backend, host=localhost)
            transports.append(tr)
            d = Dialog(tr)
            infected = [i == 0]
            # precompute this node's burst destinations (deterministic
            # from the shared LCG; duplicate draws skipped, ≙ the
            # batched twin's masked lanes — one push per peer), so
            # connections can be prewarmed
            _, dsts = host_lcg_peers(lcg_init(i), i, n, fanout)
            addrs = [(localhost, GOSSIP_PORT0 + j)
                     for j in host_distinct(dsts)]

            def flood() -> Program:
                for a in addrs:
                    yield from d.send(a, Rumor(1))

            def on_rumor(msg: Rumor, ctx) -> Program:
                t = yield GetTime()
                if receipts is not None:
                    receipts.append((t, i))
                if not infected[0]:
                    infected[0] = True
                    if t + think_us < duration_us:
                        yield from invoke(after(int(think_us)), flood)

            stop = yield from d.listen(AtPort(GOSSIP_PORT0 + i),
                                       [Listener(Rumor, on_rumor)])
            stops.append(stop)
            if prewarm:
                # persistent connections: the connect handshake stays
                # off the diffusion timing path (≙ token_ring_net)
                for a in addrs:
                    yield from tr.user_state(a)
            if i == 0:
                yield from invoke(at(int(bootstrap_us)), flood)

        for i in range(n):
            no = i
            yield from fork_(
                lambda no=no: modify_log_name(f"node{no}",
                                              lambda: launch_node(no)))
        # quiesce: bounded horizon, then teardown
        yield Wait(till(int(duration_us)))
        for tr in transports:
            yield from tr.close_all()
        for stop in stops:
            yield from stop()
        return receipts

    return main

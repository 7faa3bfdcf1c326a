"""Ping-pong over the full network stack — the reference's first
example (time-warp's `examples/ping-pong/Main.hs`) as ONE program
text that runs under the pure emulator (with the emulated fabric) and
under real asyncio (with either backend).

Two nodes: "pong" listens at one port and answers every ``Ping`` with a
``Pong`` (Main.hs:69-77); "ping" sends ``Ping`` after a beat and listens
for the ``Pong`` (Main.hs:57-67). Returns the µs virtual times at which
each side heard its message.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..core.effects import (GetTime, Program, Wait, fork_,
                            modify_log_name)
from ..manage.sync import Flag
from ..net.backend import NetBackend
from ..net.dialog import Dialog, Listener
from ..net.message import message
from ..net.transfer import AtPort, Transport, localhost

__all__ = ["Ping", "Pong", "ping_pong_net"]


@message
class Ping:
    """≙ ``data Ping`` (ping-pong Main.hs:42-43)."""


@message
class Pong:
    """≙ ``data Pong`` (ping-pong Main.hs:45-46)."""


def ping_pong_net(backend: NetBackend, *,
                  ping_port: int = 4444, pong_port: int = 5555,
                  pong_host: str = "pong-host",
                  warmup_us: int = 100_000,
                  rounds: int = 1,
                  send_at: bool = False,
                  prewarm: bool = False,
                  events_out: Optional[List[Tuple[str, int]]] = None):
    """Build the scenario's main program; run it under any interpreter.
    Returns µs times when the ping node got its Pong(s) and the pong
    node got its Ping(s). ``pong_host`` defaults to a fabric-only name;
    pass a resolvable host (e.g. ``localhost``) for the real TCP
    backend.

    ``rounds`` > 1 drives the reference shape repeatedly: every Pong
    triggers the next Ping *at the same virtual instant* (no think
    time — the reference's pinger answers immediately, Main.hs:57-67),
    which is also exactly the batched twin's timing
    (models/ping_pong.py), so the two worlds need NO translation.
    ``send_at=True`` anchors the first Ping at the absolute instant
    ``warmup_us`` (≙ token_ring_net's ``bootstrap_at``) — the
    cross-world alignment precondition. ``events_out``, when given,
    collects every ``(tag, t)`` event in order (the returned dict
    keeps only the last per tag — fine for one round)."""
    events: List[Tuple[str, int]] = events_out \
        if events_out is not None else []
    done = Flag()

    def main() -> Program:
        ping_tr = Transport(backend, host=localhost)
        pong_tr = Transport(backend, host=pong_host)
        ping_addr = (localhost, ping_port)
        pong_addr = (pong_host, pong_port)
        ping_d, pong_d = Dialog(ping_tr), Dialog(pong_tr)
        stops = []

        def pong_node() -> Program:
            # ≙ the "pong" node (Main.hs:69-77)
            def on_ping(msg: Ping, ctx) -> Program:
                t = yield GetTime()
                events.append(("pong-got-ping", t))
                yield from pong_d.send(ping_addr, Pong())

            stop = yield from pong_d.listen(AtPort(pong_port),
                                            [Listener(Ping, on_ping)])
            stops.append(stop)
            if prewarm:
                # the reply connection opens now, keeping the connect
                # handshake off the timing path (cross-world alignment)
                yield from pong_tr.user_state(ping_addr)

        def ping_node() -> Program:
            # ≙ the "ping" node (Main.hs:57-67)
            remaining = [rounds]

            def on_pong(msg: Pong, ctx) -> Program:
                t = yield GetTime()
                events.append(("ping-got-pong", t))
                remaining[0] -= 1
                if remaining[0] > 0:
                    # next round at the SAME instant — mirrors the
                    # batched twin's zero-think reply
                    yield from ping_d.send(pong_addr, Ping())
                else:
                    yield from done.set()

            stop = yield from ping_d.listen(AtPort(ping_port),
                                            [Listener(Pong, on_pong)])
            stops.append(stop)
            if prewarm:
                yield from ping_tr.user_state(pong_addr)
            if send_at:
                from ..core.time import till
                yield Wait(till(warmup_us))  # absolute anchor
            else:
                yield Wait(warmup_us)  # ≙ wait (for 2 sec), scaled
            yield from ping_d.send(pong_addr, Ping())

        yield from fork_(lambda: modify_log_name("pong", pong_node))
        yield from fork_(lambda: modify_log_name("ping", ping_node))
        yield from done.wait()
        # teardown so the scenario quiesces cleanly
        yield from ping_tr.close(pong_addr)
        yield from pong_tr.close(ping_addr)
        for stop in stops:
            yield from stop()
        return dict(events)

    return main

"""Bench sender — ≙ time-warp's `bench/Network/Sender/Main.hs`:
spread message ids over ``threads`` concurrent workers, listen
``AtConnTo`` each recipient for ``Pong`` replies (logging
PongReceived), rate-limit sends, stop at the duration deadline, give
replies one extra second, close connections (Main.hs:34-64). Options
mirror SenderOptions.hs:20-99.
"""

from __future__ import annotations

import logging
import random
from typing import Optional, Sequence

from ..core.effects import Program, Wait, fork_, start_timer
from ..manage.sync import Flag
from ..net.backend import NetBackend, NetworkAddress
from ..net.dialog import Dialog, Listener
from ..net.transfer import AtConnTo, Transport, localhost
from .commons import MeasureEvent, Ping, Pong, log_measure, payload_of

__all__ = ["sender"]


def sender(backend: NetBackend, peers: Sequence[NetworkAddress], *,
           threads: int = 5,
           msg_num: int = 1000,
           msg_rate: Optional[int] = None,
           duration_us: int = 10_000_000,
           payload_bound: int = 0,
           drain_us: int = 1_000_000,
           host: str = localhost,
           seed: int = 0,
           logger: logging.Logger = None):
    """Build the sender program. ``msg_rate`` is messages/sec/thread
    (None = unthrottled, ≙ ``sendDelay = 0``); payload sizes are drawn
    uniformly in [0, payload_bound] from a seeded RNG."""
    log = logger or logging.getLogger("bench.sender")
    send_delay = 0 if not msg_rate else 1_000_000 // msg_rate

    def main() -> Program:
        tr = Transport(backend, host=host)
        d = Dialog(tr)
        rng = random.Random(seed)
        done = [Flag() for _ in range(threads)]

        def on_pong(msg: Pong, ctx) -> Program:
            yield from log_measure(log, MeasureEvent.PONG_RECEIVED,
                                   msg.mid, len(msg.payload))

        stops = []
        for addr in peers:
            stop = yield from d.listen(AtConnTo(addr),
                                       [Listener(Pong, on_pong)])
            stops.append(stop)

        def worker(tid: int) -> Program:
            # ids tid, tid+threads, ... ≙ tasksIds (Main.hs:40)
            work_timer = yield from start_timer()
            for mid in range(tid, msg_num + 1, threads):
                if send_delay:
                    yield Wait(send_delay)
                elapsed = yield from work_timer()
                if elapsed > duration_us:  # ≙ the duration mzero cutoff
                    break
                for no, addr in enumerate(peers):
                    smid = no * msg_num + mid
                    payload = payload_of(rng.randint(0, payload_bound))
                    yield from log_measure(
                        log, MeasureEvent.PING_SENT, smid, len(payload))
                    yield from d.send(addr, Ping(smid, payload))
            yield from done[tid - 1].set()

        for tid in range(1, threads + 1):
            yield from fork_(lambda t=tid: worker(t))
        for f in done:
            yield from f.wait()
        yield Wait(drain_us)  # ≙ wait (for 1 sec) for responses
        for stop in stops:
            yield from stop()
        for addr in peers:
            yield from tr.close(addr)

    return main

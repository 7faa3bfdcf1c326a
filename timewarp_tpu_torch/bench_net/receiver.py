"""Bench receiver — ≙ time-warp's `bench/Network/Receiver/Main.hs`:
listen at a port; on every ``Ping`` log PingReceived and (unless
``no_pong``) log PongSent and reply ``Pong`` on the inbound connection
(Main.hs:32-41); stop after ``duration_us``.
"""

from __future__ import annotations

import logging

from ..core.effects import Program, Wait
from ..net.backend import NetBackend
from ..net.dialog import Dialog, Listener
from ..net.transfer import AtPort, Transport, localhost
from .commons import MeasureEvent, Ping, Pong, log_measure

__all__ = ["receiver"]


def receiver(backend: NetBackend, *,
             port: int = 3456,
             host: str = localhost,
             duration_us: int = 10_000_000,
             no_pong: bool = False,
             ready=None,
             logger: logging.Logger = None):
    """Build the receiver program (run under any interpreter).
    ``ready`` (an optional :class:`~timewarp_tpu_torch.manage.sync.Flag`) is
    set once the listener is bound — the launcher starts the sender
    after it, like launch.sh starting the receiver first (launch.sh:3-5)."""
    log = logger or logging.getLogger("bench.receiver")

    def main() -> Program:
        tr = Transport(backend, host=host)
        d = Dialog(tr)

        def on_ping(msg: Ping, ctx) -> Program:
            yield from log_measure(log, MeasureEvent.PING_RECEIVED,
                                   msg.mid, len(msg.payload))
            if not no_pong:
                yield from log_measure(log, MeasureEvent.PONG_SENT,
                                       msg.mid, len(msg.payload))
                yield from ctx.reply(Pong(msg.mid, msg.payload))

        stop = yield from d.listen(AtPort(port), [Listener(Ping, on_ping)])
        if ready is not None:
            yield from ready.set()
        yield Wait(duration_us)  # ≙ wait (for duration sec)
        yield from stop()

    return main

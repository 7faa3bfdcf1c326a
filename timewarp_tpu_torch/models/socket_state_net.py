"""Socket-state over the full network stack — the reference's
per-socket user-state example (time-warp's `examples/socket-state/
Main.hs`) as ONE program text that runs under the pure emulator (with
the emulated fabric, including delay/drop nastiness — BASELINE config
3) and under real asyncio TCP.

A server counts requests *from each client separately* via the
transport's per-socket user state (≙ ``userStateR`` incrementing a
``TVar Int``, Main.hs:91-93, 99-103); three clients send ``Ping cid``
once per interval, each continuing with probability 2/3 per round
(≙ ``ruskaRuletka``, Main.hs:105-106, drawn here from the scenario's
seeded RNG so emulated runs are deterministic), then ``close`` their
connection (Main.hs:88); the server's listener is stopped at a
deadline (≙ ``invoke (after 10 sec) stop``, Main.hs:78).
"""

from __future__ import annotations

import random
from typing import Dict, List

from ..core.effects import (GetTime, Program, Wait, fork_,
                            modify_log_name, schedule, after)
from ..manage.sync import Flag
from ..net.backend import NetBackend
from ..net.dialog import Dialog, Listener
from ..net.message import message
from ..net.transfer import AtPort, Transport, localhost

__all__ = ["Ping", "socket_state_net"]


@message(name="SocketStatePing")
class Ping:
    """≙ ``data Ping = Ping Int`` (socket-state Main.hs:51-55). Wire
    name is namespaced: the ping-pong example already owns ``"Ping"``."""
    cid: int


def socket_state_net(backend: NetBackend, *,
                     server_port: int = 4444,
                     server_host: str = localhost,
                     n_clients: int = 3,
                     send_interval_us: int = 50_000,
                     server_life_us: int = 600_000,
                     seed: int = 0):
    """Build the scenario's main program; run it under any interpreter.
    Returns ``{"per_socket": [per-connection final counters],
    "client_sends": {cid: sends}, "log": [(reqno, cid, µs), ...]}``."""
    log: List[tuple] = []
    counters: List[List[int]] = []   # every socket's [count] box
    client_sends: Dict[int, int] = {}
    done_flags = [Flag() for _ in range(n_clients)]
    server_done = Flag()

    def main() -> Program:
        def mk_counter() -> List[int]:
            box = [0]
            counters.append(box)
            return box

        server_tr = Transport(backend, host=server_host,
                              user_state_factory=mk_counter)
        server_d = Dialog(server_tr)
        addr = (server_host, server_port)

        def server() -> Program:
            # ≙ the server node (Main.hs:63-78)
            def on_ping(msg: Ping, ctx) -> Program:
                # increment THIS socket's counter (≙ counterTic via
                # userStateR, Main.hs:91-93, 99-103)
                ctx.user_state[0] += 1
                t = yield GetTime()
                log.append((ctx.user_state[0], msg.cid, t))

            stop = yield from server_d.listen(AtPort(server_port),
                                              [Listener(Ping, on_ping)])

            def stop_and_signal() -> Program:
                yield from stop()
                yield from server_done.set()

            # ≙ invoke (after 10 sec) stop — scaled down
            yield from schedule(after(server_life_us), stop_and_signal)

        def client(cid: int) -> Program:
            # ≙ one client node (Main.hs:80-88)
            tr = Transport(backend, host=f"client{cid}")
            d = Dialog(tr)
            rng = random.Random((seed << 8) | cid)
            sends = 0
            # whileM ruskaRuletka: continue with probability 2/3
            while rng.randrange(3) > 0:
                yield Wait(send_interval_us)
                yield from d.send(addr, Ping(cid))
                sends += 1
            client_sends[cid] = sends
            yield from tr.close(addr)
            yield from done_flags[cid - 1].set()

        yield from fork_(lambda: modify_log_name("server", server))
        for cid in range(1, n_clients + 1):
            yield from fork_(lambda c=cid: modify_log_name(
                f"client{c}", lambda: client(c)))
        for f in done_flags:
            yield from f.wait()
        # let in-flight pings drain, and outlive the server's scheduled
        # stop so teardown is orderly (≙ threadDelay (sec 12) in main,
        # Main.hs:89)
        yield from server_done.wait()
        return {
            "per_socket": sorted(box[0] for box in counters),
            "client_sends": dict(client_sends),
            "log": list(log),
        }

    return main

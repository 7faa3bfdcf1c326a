"""Token-ring over the full network stack — the reference's north-star
example re-expressed in its own shape
(time-warp's `examples/token-ring/Main.hs:104-208`): N nodes pass an
incrementing token via RPC ``call``; each node runs a *worker* thread
signalled through ``throw_to`` and a *server* created with ``serve``;
an observer node receives ``noteToken`` calls, checks monotonic
progress, and flags stalls. One program text runs under the pure
emulator (seeded, deterministic — ≙ ``runPureRpc gen delays``,
Main.hs:82-85) and under real asyncio (≙ ``runMsgPackRpc``).

The delays spec reproduces Main.hs:73-77: observer-bound messages are
(near-)instant, everything else takes uniform-random latency.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

from ..core.effects import (GetTime, Program, ThrowTo, Wait, fork,
                            fork_, invoke, modify_log_name, schedule,
                            sleep_forever, kill_thread)
from ..core.rng import uniform_int
from ..core.time import after, at, sec
from ..net.backend import NetBackend, endpoint_id
from ..net.delays import FnDelay, LinkModel
from ..net.dialog import Dialog
from ..net.message import message
from ..net.rpc import Method, Rpc, request
from ..net.transfer import Transport, localhost

__all__ = ["token_ring_net", "token_ring_delays", "PassToken",
           "NoteToken", "Ack"]


@message
class Ack:
    """Unit response for both calls."""


@message
class PassToken:
    """≙ ``call "token"`` (Main.hs:149-150)."""
    value: int


@message
class NoteToken:
    """≙ ``call "noteToken"`` (Main.hs:210-211)."""
    value: int


request(response=Ack)(PassToken)
request(response=Ack)(NoteToken)


class ValueReceived(Exception):
    """≙ ``SignalException(ValueReceived)`` (Main.hs:156-159) — thrown
    at the worker thread by the server method."""

    def __init__(self, value: int) -> None:
        super().__init__(value)
        self.value = value


OBSERVER_PORT = 5000  # ≙ observerPort (Main.hs:163)


def _node_port(no: int) -> int:
    """≙ ``nodePort`` iso (Main.hs:87-88)."""
    return no + 2000


def token_ring_delays(*, lo_us: int = 1000, hi_us: int = 5000,
                      observer_host: str = localhost,
                      observer_port: int = OBSERVER_PORT) -> LinkModel:
    """≙ the example's ``Delays`` (Main.hs:73-77): observer-bound
    messages connect in ~0 (1 µs — the engine minimum), every other
    link takes uniform 1–5 ms."""
    obs_id = endpoint_id(f"{observer_host}:{observer_port}")

    def fn(src, dst, t, key):
        b0, _ = key
        d = uniform_int(b0, lo_us, hi_us)
        d = torch.where((dst & 0xFFFFFFFF) == obs_id,
                        torch.ones_like(d), d)
        return d, torch.zeros_like(d, dtype=torch.bool)

    return FnDelay(fn)


def token_ring_net(backend: NetBackend, n_nodes: int = 3, *,
                   duration_us: int = sec(20),
                   passing_delay_us: int = sec(3),
                   bootstrap_us: int = sec(1),
                   check_period_us: int = sec(1),
                   allowed_progress_delay_us: int = sec(5),
                   prewarm: bool = False,
                   bootstrap_at: bool = False,
                   receipts: Optional[List[Tuple[int, int, int]]] = None):
    """Build the scenario main program (defaults = the reference's
    launch parameters, Main.hs:36-52). Returns
    ``(observer_notes, errors)``: the ``(time, value)`` list the
    observer recorded, and any wrong-value/stall errors it flagged.

    Cross-world-parity knobs (tests/test_cross_world.py — aligning this
    generator-program world with the batched Scenario world µs-for-µs):

    - ``prewarm``: each node opens its successor/observer connections at
      launch (persistent connections, as real deployments keep), so the
      connect handshake is off the steady-state timing path;
    - ``bootstrap_at``: anchor the first token at absolute virtual time
      ``bootstrap_us`` (``at``) instead of the reference's relative
      ``after`` (Main.hs:131-135), removing the few-µs fork-setup skew;
    - ``receipts``: optional sink recording ``(time, node, value)`` at
      each worker's token receipt.
    """
    notes: List[Tuple[int, int]] = []
    errors: List[str] = []
    cleanups: List[Any] = []

    def launch_node(no: int) -> Program:
        # ≙ launchNode (Main.hs:104-154)
        tr = Transport(backend, host=localhost)
        rpc = Rpc(Dialog(tr))
        successor = no % n_nodes + 1
        successor_addr = (localhost, _node_port(successor))
        observer_addr = (localhost, OBSERVER_PORT)

        def on_value_received(v: int) -> Program:
            # ≙ onValueReceived (Main.hs:137-141)
            if receipts is not None:
                t = yield GetTime()
                receipts.append((t, no, v))
            yield from rpc.call(observer_addr, NoteToken(v))
            yield Wait(int(passing_delay_us))
            yield from rpc.call(successor_addr, PassToken(v + 1))

        def worker() -> Program:
            # ≙ forever (catch sleepForever onValueReceived)
            # (Main.hs:110-112)
            while True:
                try:
                    yield from sleep_forever()
                except ValueReceived as e:
                    yield from on_value_received(e.value)

        wtid = yield from modify_log_name(
            "worker", lambda: fork(worker))

        def accept_token(req: PassToken, ctx) -> Program:
            # ≙ acceptToken: signal the worker (Main.hs:152-154)
            yield ThrowTo(wtid, ValueReceived(req.value))
            return Ack()

        stop_server = yield from rpc.serve(
            _node_port(no), [Method(PassToken, accept_token)])
        cleanups.append((tr, stop_server))

        # ≙ the killer (Main.hs:125-127); the server stops in cleanup
        yield from schedule(at(int(duration_us)),
                            lambda: kill_thread(wtid))

        if prewarm:
            # open the persistent connections and attach the response
            # listeners now, so neither the connect handshake nor the
            # listener-attach forks sit on the steady-state timing path
            yield from rpc.prepare(successor_addr)
            yield from rpc.prepare(observer_addr)

        if no == 1:
            # ≙ bootstrap (Main.hs:131-147)
            def create_token() -> Program:
                yield from rpc.call(successor_addr, PassToken(1))
            spec = (at(int(bootstrap_us)) if bootstrap_at
                    else after(int(bootstrap_us)))
            yield from invoke(spec, create_token)

    def launch_observer() -> Program:
        # ≙ launchObserver (Main.hs:167-208)
        tr = Transport(backend, host=localhost)
        rpc = Rpc(Dialog(tr))
        last_progress = [0, 0]  # (time, value) ≙ the TVar

        def note_token(req: NoteToken, ctx) -> Program:
            # ≙ noteTokenMethod (Main.hs:195-208)
            t = yield GetTime()
            was = last_progress[1]
            last_progress[0], last_progress[1] = t, req.value
            notes.append((t, req.value))
            if req.value != was + 1:
                errors.append(f"wrong token value: expected {was + 1} "
                              f"but got {req.value}")
            return Ack()

        stop_server = yield from rpc.serve(
            OBSERVER_PORT, [Method(NoteToken, note_token)])
        cleanups.append((tr, stop_server))

        def checker() -> Program:
            # ≙ the progress checker (Main.hs:179-187)
            while True:
                yield Wait(int(check_period_us))
                t = yield GetTime()
                if t - last_progress[0] > allowed_progress_delay_us:
                    errors.append(
                        f"token value ({last_progress[1]}) hasn't "
                        f"changed since {last_progress[0]} (now {t})")

        ctid = yield from modify_log_name(
            "checker", lambda: fork(checker))
        yield from schedule(at(int(duration_us)),
                            lambda: kill_thread(ctid))

    def main() -> Program:
        # ≙ scenario (Main.hs:63-72)
        for no in range(1, n_nodes + 1):
            yield from fork_(lambda no=no: modify_log_name(
                f"node.{no}", lambda: launch_node(no)))
        yield from fork_(lambda: modify_log_name(
            "observer.progress", launch_observer))
        # run to the end, then tear the network down so the scenario
        # quiesces cleanly (the reference leans on process exit)
        yield Wait(at(int(duration_us) + 1))
        for tr, stop_server in cleanups:
            yield from tr.close_all()
            yield from stop_server()
        return notes, errors

    return main

"""L3 transport — lively sockets over any :class:`NetBackend`
(the port's copy of ``timewarp_tpu/net/transfer.py``).

TPU-native re-design of the reference's raw byte-stream transport
(`time-warp/src/Control/TimeWarp/Rpc/MonadTransfer.hs:114-172`
interface; `time-warp/src/Control/TimeWarp/Rpc/Transfer.hs` TCP
implementation). Everything here is a *program* over the timed effect
API, so one transport implementation runs under the deterministic
emulator (with :class:`~timewarp_tpu_torch.net.backend.EmulatedBackend`) and
under real asyncio (with either backend) — restoring the emulable
network the reference lost in v1.1.1.1 (Transfer.hs:406-414 bottoms out
in concrete ``TimedIO``; SURVEY.md "critical historical note").

Lively-socket semantics preserved (file:line = reference):

- Per-peer bounded in/out queues bridged to the socket by worker
  threads — ``SocketFrame`` (Transfer.hs:231-253).
- ``send`` enqueues and blocks until the bytes reach the socket (or the
  frame closes) — ``sfSend`` (Transfer.hs:258-288), with full/closed
  queue warnings.
- Single listener per connection — ``AlreadyListeningOutbound``
  (Transfer.hs:297-298).
- Transparent reconnect for outbound connections under
  ``Settings.reconnect_policy`` with a fails-in-row counter —
  ``withRecovery`` (Transfer.hs:585-603); default <3 fails → retry in
  3 s (Transfer.hs:206-211).
- Peer-close detection: recv EOF ⇒ ``PeerClosedConnection``
  (Transfer.hs:393-396).
- Per-socket user state, created on demand — ``userState``
  (MonadTransfer.hs:149-152).
- Graceful teardown through nested :class:`JobCurator`\\ s with
  ``WithTimeout`` escalation (Transfer.hs:124-129, 301-305).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from ..core.effects import Fork, ForkSlave, Program, ThrowTo, Wait
from ..core.errors import (AlreadyListening, PeerClosedConnection,
                           ThreadKilled)
from ..core.time import Microsecond, sec
from ..manage.jobs import JobCurator, Plain, WithTimeout
from ..manage.sync import CLOSED, Channel, Flag, wait_until
from .backend import NetBackend, NetworkAddress, RawSocket

__all__ = [
    "AtPort", "AtConnTo", "Settings", "ResponseCtx", "Transport",
    "NetworkAddress", "localhost",
]

#: ≙ ``localhost`` (MonadTransfer.hs:87-88).
localhost = "127.0.0.1"

#: the ``comm`` sublogger namespacing transport noise
#: (≙ ``commLoggerName``, MonadTransfer.hs:93-100)
_log = logging.getLogger("timewarp.comm")


@dataclass(frozen=True)
class AtPort:
    """Listen at a local port (≙ ``AtPort``, MonadTransfer.hs:105-108)."""
    port: int


@dataclass(frozen=True)
class AtConnTo:
    """Listen on an outbound connection established earlier
    (≙ ``AtConnTo``, MonadTransfer.hs:105-108)."""
    addr: NetworkAddress


def _default_reconnect_policy(fails_in_row: int) -> Optional[Microsecond]:
    """<3 consecutive fails → retry in 3 s, else give up
    (≙ the ``Default Settings`` instance, Transfer.hs:206-211)."""
    return sec(3) if fails_in_row < 3 else None


@dataclass(frozen=True)
class Settings:
    """≙ ``Settings`` (Transfer.hs:199-211)."""
    queue_size: int = 100
    reconnect_policy: Callable[[int], Optional[Microsecond]] = \
        _default_reconnect_policy


@dataclass(frozen=True)
class ResponseCtx:
    """Peer-scoped context handed to listeners (≙ ``ResponseContext``,
    MonadTransfer.hs:176-182): ``send``/``close`` are program
    factories."""
    send: Callable[[bytes], Program]
    close: Callable[[], Program]
    peer_addr: str
    user_state: Any


class SocketFrame:
    """One lively socket (≙ ``SocketFrame``, Transfer.hs:231-253)."""

    def __init__(self, settings: Settings, peer_addr: str,
                 user_state: Any) -> None:
        self.peer_addr = peer_addr
        self.in_busy = False
        self.in_chan: Channel = Channel(settings.queue_size)
        self.out_chan: Channel = Channel(settings.queue_size)
        self.curator = JobCurator()
        self.user_state = user_state

    # -- send (≙ sfSend, Transfer.hs:258-288) ----------------------------

    def send(self, data: bytes) -> Program:
        if self.out_chan.full:
            _log.warning("send channel for %s is full", self.peer_addr)
        if self.out_chan.closed:
            _log.warning("send channel for %s is closed, message "
                         "wouldn't be sent", self.peer_addr)
        sent = Flag()
        ok = yield from self.out_chan.put((data, sent))
        if not ok:
            return
        # Block until the socket consumed the bytes, or the frame closed
        # (≙ the STM "notifier ∨ closed" wait, Transfer.hs:266-271).
        yield from wait_until(
            lambda: sent.is_set or self.curator.is_closed,
            sent, self.curator)

    # -- receive (≙ sfReceive, Transfer.hs:293-307) ----------------------

    def receive(self, sink: Callable[[Channel, ResponseCtx], Program]
                ) -> Program:
        """Attach the (single) listener: runs ``sink(in_chan, ctx)`` in a
        thread hung off a nested curator; a listener still running 3 s
        after interruption is Force-cleared (Transfer.hs:301-305)."""
        if self.in_busy:
            raise AlreadyListening(self.peer_addr)
        self.in_busy = True
        li = JobCurator()
        yield from self.curator.add_manager_as_job(
            li, WithTimeout(sec(3), self._log_interrupt_timeout))

        def run_listener() -> Program:
            try:
                yield from sink(self.in_chan, self.response_ctx())
                _log.debug("listening on socket to %s happily stopped",
                           self.peer_addr)
            except ThreadKilled:
                raise
            except GeneratorExit:   # teardown must unwind
                raise
            except BaseException as e:  # noqa: BLE001 ≙ logOnErr handleAll
                if not self.curator.is_interrupted:
                    _log.warning("server error on %s: %r",
                                 self.peer_addr, e)
                    yield from self.curator.interrupt_all_jobs(Plain)

        yield from li.add_thread_job(run_listener)

    def _log_interrupt_timeout(self) -> Program:
        _log.debug("while closing socket to %s listener worked for too "
                   "long, closing with no regard to it", self.peer_addr)
        return
        yield  # pragma: no cover

    # -- close (≙ sfClose, Transfer.hs:322-330) --------------------------

    def close_frame(self) -> Program:
        yield from self.curator.interrupt_all_jobs(Plain)
        yield from self.in_chan.close()
        yield from self.out_chan.close()
        self.in_chan.drain()

    def response_ctx(self) -> ResponseCtx:
        """≙ ``sfMkResponseCtx`` (Transfer.hs:342-349)."""
        return ResponseCtx(send=self.send, close=self.close_frame,
                           peer_addr=self.peer_addr,
                           user_state=self.user_state)

    # -- socket workers (≙ sfProcessSocket, Transfer.hs:353-401) ---------

    def process_socket(self, sock: RawSocket) -> Program:
        """Bridge the frame's queues to ``sock`` with three threads:
        send-worker, recv-worker, close-watcher. Returns when the frame
        is closed; re-raises the first worker error (feeding the
        reconnect loop)."""
        events: Channel = Channel(8)

        def reporting(worker: Callable[[], Program],
                      desc: str) -> Callable[[], Program]:
            def run() -> Program:
                try:
                    yield from worker()
                except GeneratorExit:   # teardown must unwind
                    raise
                except BaseException as e:  # noqa: BLE001 ≙ reportErrors
                    _log.debug("caught error on %s %s: %r",
                               desc, self.peer_addr, e)
                    yield from events.put(("error", e))
            return run

        def forever_send() -> Program:
            # ≙ foreverSend (Transfer.hs:383-391): pop, write to socket,
            # push back on failure so the chunk survives a reconnect.
            while True:
                item = yield from self.out_chan.get()
                if item is CLOSED:
                    return
                data, sent = item
                try:
                    yield from sock.send(data)
                except BaseException:
                    yield from self.out_chan.unget(item)
                    raise
                yield from sent.set()

        def forever_rec() -> Program:
            # ≙ foreverRec (Transfer.hs:393-396).
            while True:
                data = yield from sock.recv()
                if data == b"":
                    if not self.curator.is_interrupted:
                        raise PeerClosedConnection(self.peer_addr)
                    return
                ok = yield from self.in_chan.put(data)
                if not ok:
                    return

        # slave forks (≙ the slave-thread semantics forkSlave binds,
        # TimedIO.hs:78): if the thread running process_socket is killed
        # while blocked on the event channel below, the workers die with
        # it instead of leaking until curator teardown
        stid = yield ForkSlave(reporting(forever_send, "foreverSend"))
        rtid = yield ForkSlave(reporting(forever_rec, "foreverRec"))
        _log.debug("start processing of socket to %s", self.peer_addr)

        def watcher() -> Program:
            yield from wait_until(lambda: self.curator.is_closed,
                                  self.curator)
            yield from events.put(("closed", None))
            for tid in (stid, rtid):
                yield ThrowTo(tid, ThreadKilled())

        ctid = yield ForkSlave(watcher)
        kind, err = yield from events.get()
        _log.debug("stop processing socket to %s", self.peer_addr)
        if kind == "error":
            for tid in (stid, rtid, ctid):
                yield ThrowTo(tid, ThreadKilled())
            raise err


class Transport:
    """≙ the ``Transfer`` monad's operations as an object
    (Transfer.hs:612-627): ``send_raw``, ``listen_raw``, ``close``,
    ``user_state`` — every method a program.

    ``host`` is this node's identity for binding and for the emulated
    fabric's RNG; ``user_state_factory`` creates the per-socket state on
    demand (≙ the ``IO s`` reader, Transfer.hs:409).
    """

    def __init__(self, backend: NetBackend, *,
                 host: str = localhost,
                 settings: Settings = Settings(),
                 user_state_factory: Callable[[], Any] = lambda: None
                 ) -> None:
        self._backend = backend
        self._host = host
        self._settings = settings
        self._mk_user_state = user_state_factory
        self._pool: Dict[NetworkAddress, SocketFrame] = {}

    # -- public: MonadTransfer surface -----------------------------------

    def send_raw(self, addr: NetworkAddress, data: bytes) -> Program:
        """≙ ``sendRaw`` (MonadTransfer.hs:119-121): reuses the pooled
        connection; the byte sequence is transmitted as a whole."""
        sf = yield from self._get_out_conn(addr)
        yield from sf.send(data)

    def listen_raw(self, binding: Any,
                   sink: Callable[[Channel, ResponseCtx], Program]
                   ) -> Program:
        """≙ ``listenRaw`` (MonadTransfer.hs:132-134). Returns a stopper
        program factory which blocks until the server actually stopped."""
        if isinstance(binding, AtPort):
            return (yield from self._listen_inbound(binding.port, sink))
        if isinstance(binding, AtConnTo):
            sf = yield from self._get_out_conn(binding.addr)
            yield from sf.receive(sink)

            def stopper() -> Program:
                yield from sf.curator.stop_all_jobs(Plain)
            return stopper
        raise TypeError(f"unknown binding: {binding!r}")

    def close(self, addr: NetworkAddress) -> Program:
        """Asynchronous close of the outbound connection, if any
        (≙ Transfer.hs:620-624)."""
        sf = self._pool.get(addr)
        if sf is not None:
            yield from sf.curator.interrupt_all_jobs(Plain)

    def user_state(self, addr: NetworkAddress) -> Program:
        """≙ ``userState`` (MonadTransfer.hs:149-152): creates the
        connection on demand."""
        sf = yield from self._get_out_conn(addr)
        return sf.user_state

    def pooled(self, addr: NetworkAddress) -> Optional[SocketFrame]:
        """The live pooled outbound connection, or None — lets layers
        above detect that a connection was torn down and re-created
        (the RPC client re-attaches its response listener then)."""
        return self._pool.get(addr)

    def close_all(self) -> Program:
        """Close every pooled outbound connection — the teardown the
        reference leaves as debt (TW-67, Transfer.hs:31: "close all
        connections upon quiting")."""
        for addr in list(self._pool):
            yield from self.close(addr)

    # -- server side (≙ listenInbound, Transfer.hs:467-527) --------------

    def _listen_inbound(self, port: int,
                        sink: Callable[[Channel, ResponseCtx], Program]
                        ) -> Program:
        server_curator = JobCurator()
        lst = yield from self._backend.bind(self._host, port)

        def handle_conn(sock: RawSocket, peer: str) -> Program:
            sf = SocketFrame(self._settings, peer, self._mk_user_state())
            yield from server_curator.add_manager_as_job(sf.curator)
            _log.debug("new input connection: %d <- %s", port, peer)
            try:
                yield from sf.receive(sink)
                if not server_curator.is_interrupted:
                    try:
                        yield from sf.process_socket(sock)
                        _log.info("happily closing input connection "
                                  "%d <- %s", port, peer)
                    except ThreadKilled:
                        raise
                    except GeneratorExit:   # teardown must unwind
                        raise
                    except PeerClosedConnection:
                        # a client hanging up cleanly is the ordinary
                        # end of a connection, not an error
                        _log.info("happily closing input connection "
                                  "%d <- %s (peer closed)", port, peer)
                    except BaseException as e:  # noqa: BLE001
                        lvl = (logging.DEBUG if sf.curator.is_closed
                               else logging.WARNING)
                        _log.log(lvl, "error in server socket %d "
                                 "connected with %s: %r", port, peer, e)
            finally:
                yield from sf.close_frame()
                yield from sock.close()

        def serve_loop() -> Program:
            # ≙ the accept loop (Transfer.hs:485-496); killed via the
            # curator, the finally closes the listening socket
            # (Transfer.hs:476).
            try:
                while True:
                    item = yield from lst.accept()
                    if item is CLOSED:
                        return
                    sock, peer = item
                    yield Fork(lambda s=sock, p=peer: handle_conn(s, p))
            except ThreadKilled:
                raise
            except GeneratorExit:   # teardown must unwind
                raise
            except BaseException as e:  # noqa: BLE001
                lvl = (logging.DEBUG if server_curator.is_closed
                       else logging.ERROR)
                _log.log(lvl, "server at port %d stopped with error %r",
                         port, e)
            finally:
                yield from lst.close()

        yield from server_curator.add_thread_job(serve_loop)

        def stopper() -> Program:
            _log.debug("stopping server at %d", port)
            yield from server_curator.stop_all_jobs(Plain)
            _log.debug("server at %d fully stopped", port)

        return stopper

    # -- client side (≙ getOutConnOrOpen, Transfer.hs:542-609) -----------

    def _get_out_conn(self, addr: NetworkAddress) -> Program:
        sf = self._pool.get(addr)
        if sf is not None:
            return sf
        sf = SocketFrame(self._settings, f"{addr[0]}:{addr[1]}",
                         self._mk_user_state())
        # No yields since the pool check: insertion is atomic under both
        # interpreters, so the reference's double-checked insert
        # (Transfer.hs:554-570) reduces to this.
        self._pool[addr] = sf

        def worker() -> Program:
            try:
                yield from self._start_worker(sf, addr)
            finally:
                yield from self._release_conn(sf, addr)

        yield from sf.curator.add_safe_thread_job(worker)
        return sf

    def _start_worker(self, sf: SocketFrame,
                      addr: NetworkAddress) -> Program:
        """Connect-process-reconnect loop (≙ ``startWorker`` +
        ``withRecovery``, Transfer.hs:572-603)."""
        fails_in_row = 0
        _log.debug("lively socket to %s created, processing", sf.peer_addr)
        while True:
            try:
                sock = yield from self._backend.connect(self._host, addr)
                try:
                    fails_in_row = 0
                    _log.debug("established connection to %s",
                               sf.peer_addr)
                    yield from sf.process_socket(sock)
                finally:
                    yield from sock.close()
                return  # frame closed ⇒ done
            except ThreadKilled:
                raise
            except GeneratorExit:   # teardown must unwind
                raise
            except BaseException as e:  # noqa: BLE001 ≙ catchAll
                if sf.curator.is_interrupted:
                    return
                _log.warning("error while working with socket to %s: %r",
                             sf.peer_addr, e)
                fails_in_row += 1
                delay = self._settings.reconnect_policy(fails_in_row)
                if delay is None:
                    _log.warning("can't connect to %s, closing connection",
                                 sf.peer_addr)
                    return
                _log.warning("reconnect to %s in %d us", sf.peer_addr,
                             delay)
                yield Wait(int(delay))

    def _release_conn(self, sf: SocketFrame,
                      addr: NetworkAddress) -> Program:
        """≙ ``releaseConn`` (Transfer.hs:605-609)."""
        yield from sf.curator.interrupt_all_jobs(Plain)
        yield from sf.close_frame()
        if self._pool.get(addr) is sf:
            self._pool.pop(addr, None)
        _log.debug("socket to %s closed", sf.peer_addr)

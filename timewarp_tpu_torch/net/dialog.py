"""L4 dialog — whole-message send/receive with named-listener dispatch
(the port's copy of ``timewarp_tpu/net/dialog.py``).

TPU-native re-design of the reference's ``MonadDialog``
(`time-warp/src/Control/TimeWarp/Rpc/MonadDialog.hs`): an add-on
over the L3 transport that sends/receives *typed messages* with a
pluggable packing strategy and dispatches inbound messages to listeners
keyed by message name.

Semantics preserved (file:line = reference):

- Send family ``send``/``send_h``/``send_r`` — plain, with-header, and
  raw-with-header (MonadDialog.hs:149-166); the reply family mirrors it
  on the peer context (:172-192).
- ``listen`` pipeline: unpack stream → (header, raw) → name lookup —
  unknown name ⇒ warning + raw listener only (:241-245); known ⇒ raw
  listener gate, then typed parse, then handler (:247-256).
- Per-message ``ForkStrategy``: how each handler runs — the default
  forks a thread per message (:114-117, 317); listener and parse errors
  are logged, never fatal to the connection loop (:258-269).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Type

from ..core.effects import Fork, Program
from ..core.errors import ThreadKilled
from ..manage.sync import CLOSED, Channel
from .message import (BinaryPacking, MessageName, PackingType, ParseError,
                      message_name)
from .transfer import ResponseCtx, Transport

__all__ = [
    "Dialog", "DialogCtx", "Listener", "ForkStrategy",
    "fork_each_message", "run_inline",
]

_log = logging.getLogger("timewarp.comm")

#: ``ForkStrategy`` ≙ MonadDialog.hs:114-117 — decides how to run one
#: message's handler given its name: a function
#: ``(name, program_fn) -> Program``.
ForkStrategy = Callable[[MessageName, Callable[[], Program]], Program]


def fork_each_message(name: MessageName,
                      handler: Callable[[], Program]) -> Program:
    """Default strategy: every handler in a fresh thread
    (≙ ``ForkStrategy $ const fork_``, MonadDialog.hs:317)."""
    yield Fork(handler)


def run_inline(name: MessageName,
               handler: Callable[[], Program]) -> Program:
    """Inline strategy: run the handler on the listener thread —
    serializes handling per connection (≙ the playground's
    ``pendingForkStrategy`` choosing inline for some names,
    examples/playground/Main.hs:345-376)."""
    yield from handler()


@dataclass(frozen=True)
class Listener:
    """A typed listener (≙ ``Listener``/``ListenerH``,
    MonadDialog.hs:276-287): handles messages of ``msg_type``. The
    handler receives ``(msg, ctx)`` — or ``((header, msg), ctx)`` when
    ``with_header`` — and is a program."""
    msg_type: Type
    handler: Callable[..., Program]
    with_header: bool = False

    @property
    def name(self) -> MessageName:
        """≙ ``getListenerName`` (MonadDialog.hs:290-301)."""
        return message_name(self.msg_type)


class DialogCtx:
    """Peer context handed to listeners — the reply surface
    (≙ ``MonadResponse`` ops in ``ResponseT``, MonadTransfer.hs:159-172,
    reached through reply/replyH/replyR, MonadDialog.hs:172-192)."""

    def __init__(self, dialog: "Dialog", resp: ResponseCtx) -> None:
        self._dialog = dialog
        self._resp = resp
        self.peer_addr = resp.peer_addr
        self.user_state = resp.user_state

    def reply(self, msg: Any) -> Program:
        yield from self._resp.send(self._dialog._packing.pack(None, msg))

    def reply_h(self, header: Any, msg: Any) -> Program:
        yield from self._resp.send(self._dialog._packing.pack(header, msg))

    def reply_r(self, header: Any, raw: bytes) -> Program:
        yield from self._resp.send(
            self._dialog._packing.pack_raw(header, raw))

    def close(self) -> Program:
        """≙ ``closeR``."""
        yield from self._resp.close()


class Dialog:
    """≙ the ``Dialog`` monad as an object (MonadDialog.hs:309-317):
    holds the transport, the packing type and the default fork
    strategy."""

    def __init__(self, transport: Transport, *,
                 packing: Optional[PackingType] = None,
                 fork_strategy: ForkStrategy = fork_each_message) -> None:
        self.transport = transport
        self._packing = packing if packing is not None else BinaryPacking()
        self._fork_strategy = fork_strategy

    @property
    def packing(self) -> PackingType:
        return self._packing

    # -- send family (≙ MonadDialog.hs:149-166) --------------------------

    def send(self, addr, msg: Any) -> Program:
        """Send a plain message (header ``None``)."""
        yield from self.transport.send_raw(addr,
                                           self._packing.pack(None, msg))

    def send_h(self, addr, header: Any, msg: Any) -> Program:
        yield from self.transport.send_raw(addr,
                                           self._packing.pack(header, msg))

    def send_r(self, addr, header: Any, raw: bytes) -> Program:
        yield from self.transport.send_raw(
            addr, self._packing.pack_raw(header, raw))

    # -- listen family (≙ listen/listenH/listenR, MonadDialog.hs:204-271)

    def listen(self, binding, listeners: List[Listener],
               raw_listener: Optional[Callable[..., Program]] = None,
               *, fork_strategy: Optional[ForkStrategy] = None) -> Program:
        """Start listening at ``binding`` with the given typed listeners
        and optional raw listener; returns the stopper program factory.

        The raw listener receives ``((header, raw), ctx)`` and returns
        whether to continue with typed dispatch (≙ ``ListenerR``,
        MonadDialog.hs:286-287). Messages with no typed listener warn
        and run the raw listener only (:241-245).
        """
        table: Dict[MessageName, Listener] = {}
        for li in listeners:
            if li.name in table:
                raise ValueError(f"duplicate listener for {li.name!r}")
            table[li.name] = li
        strategy = (fork_strategy if fork_strategy is not None
                    else self._fork_strategy)
        packing = self._packing

        def sink(chan: Channel, resp: ResponseCtx) -> Program:
            ctx = DialogCtx(self, resp)
            parser = packing.parser()
            while True:
                data = yield from chan.get()
                if data is CLOSED:
                    return
                try:
                    packets = parser.feed(data)
                except ParseError as e:
                    # ≙ handleE: log and stop this connection's
                    # listening (MonadDialog.hs:258-259) — and CLOSE the
                    # frame: a desynced byte stream cannot recover, and
                    # closing pops the connection from the pool so the
                    # next send/call re-creates it with a fresh parser
                    # (the reference notes this as open debt, TW-59,
                    # Transfer.hs:57-59 — "socket gets closed; need to
                    # make it reconnect"; eviction does exactly that).
                    _log.warning("error parsing message from %s: %r",
                                 resp.peer_addr, e)
                    yield from ctx.close()
                    return
                for packet in packets:
                    yield from self._process_packet(
                        packet, table, raw_listener, strategy, ctx)

        return (yield from self.transport.listen_raw(binding, sink))

    def _process_packet(self, packet: bytes, table: Dict[str, Listener],
                        raw_listener: Optional[Callable[..., Program]],
                        strategy: ForkStrategy, ctx: DialogCtx) -> Program:
        """One packet through the processContent pipeline
        (MonadDialog.hs:237-256)."""
        packing = self._packing
        try:
            header, raw = packing.split(packet)
            name = packing.extract_name(raw)
        except ParseError as e:
            _log.warning("error parsing message from %s: %r",
                         ctx.peer_addr, e)
            return
        li = table.get(name)
        if li is None:
            # ≙ unknown-name warning + raw-listener-only path
            # (MonadDialog.hs:241-245). With an *empty* typed table the
            # caller is deliberately raw-listening (transferScenario
            # style / the RPC response listener) — no misconfiguration
            # to warn about.
            if table:
                _log.warning("no listener with name %s defined", name)
            if raw_listener is not None:
                def raw_only() -> Program:
                    yield from self._invoke_raw(raw_listener, header,
                                                raw, ctx)
                yield from strategy(name, raw_only)
            return

        def dispatch() -> Program:
            # raw-listener gate before the typed parse
            # (MonadDialog.hs:247-256)
            cont = True
            if raw_listener is not None:
                cont = yield from self._invoke_raw(raw_listener, header,
                                                   raw, ctx)
            if not cont:
                return
            try:
                msg = packing.extract_content(raw)
            except ParseError as e:
                _log.warning("error parsing message from %s: %r",
                             ctx.peer_addr, e)
                return
            _log.debug("got message from %s: %r", ctx.peer_addr, msg)
            arg = (header, msg) if li.with_header else msg
            try:
                yield from li.handler(arg, ctx)
            except ThreadKilled:
                raise
            except GeneratorExit:   # teardown must unwind
                raise
            except BaseException as e:  # noqa: BLE001 ≙ invokeListenerSafe
                _log.error("uncaught error in listener %r: %r", name, e)

        yield from strategy(name, dispatch)

    def _invoke_raw(self, raw_listener: Callable[..., Program],
                    header: Any, raw: bytes, ctx: DialogCtx) -> Program:
        """≙ ``invokeRawListenerSafe`` (MonadDialog.hs:264-266): errors
        logged, treated as "don't continue"."""
        try:
            return bool((yield from raw_listener((header, raw), ctx)))
        except ThreadKilled:
            raise
        except GeneratorExit:   # teardown must unwind
            raise
        except BaseException as e:  # noqa: BLE001
            _log.error("uncaught error in raw listener: %r", e)
            return False

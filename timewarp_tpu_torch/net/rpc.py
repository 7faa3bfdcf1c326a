"""L5 RPC — ``call``/``serve`` sugar over the dialog layer
(the port's copy of ``timewarp_tpu/net/rpc.py``).

Revives the reference's removed RPC surface, as SURVEY.md mandates
(`time-warp/src/Control/TimeWarp/Rpc/MonadRpc.hs.unused:48-72`;
TH instance generator `TH.hs.unused:28-43`; the token-ring example is
written against it, examples/token-ring/Main.hs:116-154):

- A *request* is a registered message declaring its response and
  expected-error types (≙ the ``Request`` class with ``Response`` /
  ``ExpectedError`` type families, MonadRpc.hs.unused:58-66; the
  :func:`request` decorator ≙ ``mkRequest``).
- :meth:`Rpc.serve` starts a server from :class:`Method` handlers
  (≙ ``serve``/``Method``, MonadRpc.hs.unused:52-53, 71-72).
- :meth:`Rpc.call` performs the remote call and returns the typed
  response, re-raising the method's *expected* error remotely raised,
  or :class:`RpcError` for unexpected failures (≙ ``call``,
  MonadRpc.hs.unused:50-51).

Wire protocol (over dialog headers): requests travel with header
``("q", call_id)``; responses come back on the same connection with
``("s", call_id)`` (success — content is the response message),
``("e", call_id)`` (expected error — content is the error message), or
``("x", call_id)`` (unexpected failure — content is
:class:`RpcFailure`).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Type

from ..core.errors import NetworkError, ThreadKilled
from ..core.effects import Program
from ..manage.sync import Flag, MVar
from .dialog import Dialog, DialogCtx, Listener
from .message import ParseError, message, message_name
from .transfer import AtConnTo, AtPort, NetworkAddress

__all__ = ["request", "Method", "Rpc", "RpcError", "RpcFailure"]

_log = logging.getLogger("timewarp.comm")


class RpcError(NetworkError):
    """Unexpected remote failure surfaced to the caller (≙ the
    ``RpcError`` surface referenced by MonadRpc.hs.unused:31)."""


@message
class RpcFailure:
    """Wire form of an unexpected server-side failure."""
    text: str


def request(response: Type, error: Optional[Type] = None):
    """Class decorator declaring a message as an RPC request
    (≙ ``$(mkRequest ''Req ''Resp ''Err)``, TH.hs.unused:28-43).

    ``response`` must be a registered message type; ``error`` (optional)
    a registered message type that is also an ``Exception`` — raised by
    the handler remotely, re-raised at the caller.
    """
    def apply(cls: Type) -> Type:
        message_name(cls)       # must already be a registered message
        message_name(response)
        if error is not None:
            message_name(error)
            if not issubclass(error, BaseException):
                raise TypeError(f"expected error {error!r} must be an "
                                "Exception")
        cls.__rpc_response__ = response
        cls.__rpc_error__ = error
        return cls
    return apply


@dataclass(frozen=True)
class Method:
    """An RPC method: handles requests of ``request_type`` with
    ``handler(req, ctx) -> Program[response]`` (≙ ``Method``,
    MonadRpc.hs.unused:71-72). The handler may raise the request's
    expected error."""
    request_type: Type
    handler: Callable[..., Program]


class Rpc:
    """``call``/``serve`` over a :class:`Dialog`."""

    def __init__(self, dialog: Dialog) -> None:
        self.dialog = dialog
        self._pending: Dict[int, MVar] = {}
        self._call_counter = 0
        #: addr -> SocketFrame we attached the response listener to
        self._listened: Dict[NetworkAddress, Any] = {}

    # -- server ----------------------------------------------------------

    def serve(self, port: int, methods: List[Method]) -> Program:
        """Start serving; returns the stopper program factory
        (≙ ``serve``, MonadRpc.hs.unused:52-53)."""
        listeners = [self._method_listener(m) for m in methods]
        return (yield from self.dialog.listen(AtPort(port), listeners))

    def _method_listener(self, m: Method) -> Listener:
        resp_type = getattr(m.request_type, "__rpc_response__", None)
        if resp_type is None:
            raise TypeError(f"{m.request_type!r} is not declared with "
                            "@request(response=...)")
        err_type = m.request_type.__rpc_error__

        def on_request(arg: Tuple[Any, Any], ctx: DialogCtx) -> Program:
            header, req = arg
            if (not isinstance(header, tuple) or len(header) != 2
                    or header[0] != "q"):
                _log.warning("malformed rpc header from %s: %r",
                             ctx.peer_addr, header)
                return
            cid = header[1]
            try:
                result = yield from m.handler(req, ctx)
            except ThreadKilled:
                raise
            except GeneratorExit:   # teardown must unwind
                raise
            except BaseException as e:  # noqa: BLE001 — RPC boundary
                if err_type is not None and isinstance(e, err_type):
                    # expected error: travels typed (≙ ExpectedError)
                    yield from ctx.reply_h(("e", cid), e)
                else:
                    _log.error("unexpected error in rpc method %r: %r",
                               message_name(m.request_type), e)
                    yield from ctx.reply_h(("x", cid), RpcFailure(repr(e)))
                return
            if not isinstance(result, resp_type):
                _log.error("rpc method %r returned %r, declared %r",
                           message_name(m.request_type), type(result),
                           resp_type)
                yield from ctx.reply_h(
                    ("x", cid), RpcFailure("bad response type"))
                return
            yield from ctx.reply_h(("s", cid), result)

        return Listener(m.request_type, on_request, with_header=True)

    # -- client ----------------------------------------------------------

    def call(self, addr: NetworkAddress, req: Any) -> Program:
        """Remote call: send ``req``, block until the typed response
        arrives on the same connection (≙ ``call``,
        MonadRpc.hs.unused:50-51). Raises the request's expected error
        if the handler raised it, :class:`RpcError` on unexpected
        failures.

        Delivery contract (same as the reference's): the transport
        re-sends the *request* through reconnects, but a *reply* whose
        inbound connection reset is lost — a call can then block
        forever. Compose with
        :func:`timewarp_tpu_torch.core.effects.timeout` and retry for
        at-least-once semantics over lossy links
        (tests/test_rpc.py::test_calls_survive_connection_resets)."""
        if getattr(type(req), "__rpc_response__", None) is None:
            raise TypeError(f"{type(req)!r} is not declared with "
                            "@request(response=...)")
        yield from self._ensure_response_listener(addr)
        cid = self._call_counter
        self._call_counter += 1
        box = MVar()
        self._pending[cid] = box
        try:
            yield from self.dialog.send_h(addr, ("q", cid), req)
            kind, payload = yield from box.take()
        finally:
            self._pending.pop(cid, None)
        if kind == "s":
            return payload
        if kind == "e":
            raise payload
        raise RpcError(payload.text)

    def prepare(self, addr: NetworkAddress) -> Program:
        """Persistent-connection warm-up: eagerly open the pooled
        connection to ``addr`` and attach the response listener. After
        this, a ``call``'s request chunk leaves the socket at the same
        virtual-time instant the call is issued — neither the connect
        handshake nor the listener-attach forks sit on the timing path
        (load-bearing for cross-world trace alignment,
        tests/test_cross_world.py)."""
        yield from self._ensure_response_listener(addr)

    def _ensure_response_listener(self, addr: NetworkAddress) -> Program:
        """Attach (once per live connection) a raw listener on the
        outbound connection that routes ``s``/``e``/``x`` responses to
        pending calls. Re-attaches transparently if the pooled
        connection was closed and re-created — the lively-socket
        analogue of the reference's per-connection listener. Concurrent
        first calls race here: the intent is recorded synchronously
        (pre-yield) so exactly one attaches, the rest wait on its flag
        (single-listener rule)."""
        while True:
            st = self._listened.get(addr)
            if st is not None and st["attaching"]:
                # someone is attaching right now: wait, then RE-CHECK —
                # the state we wake to may itself be mid-attach again,
                # and falling through here would double-attach and trip
                # the single-listener rule
                yield from st["flag"].wait()
                continue
            current = self.dialog.transport.pooled(addr)
            if (st is not None and st["frame"] is not None
                    and st["frame"] is current):
                return
            break

        def on_response(hr: Tuple[Any, bytes], ctx: DialogCtx) -> Program:
            header, raw = hr
            if (not isinstance(header, tuple) or len(header) != 2
                    or header[0] not in ("s", "e", "x")):
                return True  # not an rpc response; let typed dispatch try
            kind, cid = header
            box = self._pending.get(cid)
            if box is None:
                _log.warning("rpc response for unknown call id %r from %s",
                             cid, ctx.peer_addr)
                return False
            try:
                payload = self.dialog.packing.extract_content(raw)
            except ParseError as e:
                kind, payload = "x", RpcFailure(f"undecodable response: {e}")
            yield from box.put((kind, payload))
            return False

        st = {"attaching": True, "flag": Flag(), "frame": None}
        self._listened[addr] = st  # synchronous: no yield since the check
        try:
            yield from self.dialog.listen(AtConnTo(addr), [], on_response)
            st["frame"] = self.dialog.transport.pooled(addr)
        finally:
            st["attaching"] = False
            yield from st["flag"].set()

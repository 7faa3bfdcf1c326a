"""The network stack: link models, raw socket backends, L3 lively-socket
transport, L4 typed dialog, L5 RPC (the port's copy of
``timewarp_tpu/net/__init__.py``; ``links.py`` and ``delays.py`` are the
port's torch link models, the rest is host code)."""

from .backend import (AioBackend, EmulatedBackend, NetBackend,
                      NetworkAddress, endpoint_id)
from .delays import (FixedDelay, FnDelay, LinkModel, LogNormalDelay,
                     UniformDelay, WithDrop)
from .dialog import (Dialog, DialogCtx, ForkStrategy, Listener,
                     fork_each_message, run_inline)
from .message import (BinaryPacking, FrameParser, MessageName,
                      PackingType, ParseError, decode, encode, message,
                      message_name)
from .rpc import Method, Rpc, RpcError, RpcFailure, request
from .transfer import (AtConnTo, AtPort, ResponseCtx, Settings,
                       SocketFrame, Transport, localhost)

__all__ = [
    "AioBackend", "EmulatedBackend", "NetBackend", "NetworkAddress",
    "endpoint_id",
    "FixedDelay", "FnDelay", "LinkModel", "LogNormalDelay",
    "UniformDelay", "WithDrop",
    "Dialog", "DialogCtx", "ForkStrategy", "Listener",
    "fork_each_message", "run_inline",
    "BinaryPacking", "FrameParser", "MessageName", "PackingType",
    "ParseError", "decode", "encode", "message", "message_name",
    "Method", "Rpc", "RpcError", "RpcFailure", "request",
    "AtConnTo", "AtPort", "ResponseCtx", "Settings", "SocketFrame",
    "Transport", "localhost",
]

"""L4 serialization — message naming and the 2-phase pack/unpack scheme
(the port's copy of ``timewarp_tpu/net/message.py``).

TPU-native re-design of the reference's message layer
(`time-warp/src/Control/TimeWarp/Rpc/Message.hs`):

- A *message* is a registered dataclass with a unique wire name
  (≙ ``Message``/``messageName``, Message.hs:77-87; the default name is
  the class name, like the reference's ``Data``-derived default).
- A *packing type* abstracts the serialization strategy
  (≙ ``PackingType``/``Packable``/``Unpackable``, Message.hs:133-148).
  Deserialization is two-phase: byte stream → intermediate form
  ``(header, raw)``; then raw → name, raw → typed content on demand —
  so a router can forward a message it cannot parse (≙ the proxy
  scenario, examples/playground/Main.hs:238-287).
- :class:`BinaryPacking` is the concrete strategy (≙ ``BinaryP``,
  Message.hs:158-202): wire format ``[length-prefixed packet]`` where
  packet = ``enc(header) ++ enc(raw)`` and raw = ``enc(name) ++
  enc(fields)``; content extraction requires all input consumed
  (Message.hs:199-202).

The codec is a deterministic, self-describing binary encoding written
for this framework (the reference leans on Haskell's ``binary``); it is
byte-stable across platforms, which the trace-parity law relies on.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, fields, is_dataclass
from typing import Any, Dict, Optional, Tuple, Type

from ..core.errors import NetworkError

__all__ = [
    "MessageName", "message", "message_name", "ParseError",
    "PackingType", "BinaryPacking", "encode", "decode",
    "FrameParser", "frame",
]

MessageName = str


class ParseError(NetworkError):
    """Malformed wire data (≙ ``ParseError`` surfaced by
    ``runGetOrThrow``, Message.hs:119-123)."""


# ----------------------------------------------------------------------
# Message registry (≙ the Message class + messageName, Message.hs:77-87)
# ----------------------------------------------------------------------

_REGISTRY: Dict[MessageName, Type] = {}


def message(cls: Optional[Type] = None, *, name: Optional[str] = None):
    """Class decorator registering a dataclass as a wire message.

    ``@message`` uses the class name (≙ the reference's default
    ``messageName`` from the ``Data`` type name, Message.hs:80-87);
    ``@message(name="...")`` overrides it.
    """
    def apply(c: Type) -> Type:
        if not is_dataclass(c):
            c = dataclass(frozen=True)(c)
        wire = name if name is not None else c.__name__
        prev = _REGISTRY.get(wire)
        if prev is not None and (
                (prev.__module__, prev.__qualname__)
                != (c.__module__, c.__qualname__)):
            # identity must be module-qualified: two distinct classes
            # both named "Ping" silently replacing each other corrupts
            # every decode of that wire name
            raise ValueError(
                f"message name {wire!r} already registered by {prev!r} "
                f"(from {prev.__module__}); pass @message(name=...) to "
                "disambiguate")
        _REGISTRY[wire] = c
        c.__message_name__ = wire
        return c
    return apply(cls) if cls is not None else apply


def message_name(msg_or_cls: Any) -> MessageName:
    """≙ ``messageName'`` (Message.hs:112-116)."""
    cls = msg_or_cls if isinstance(msg_or_cls, type) else type(msg_or_cls)
    try:
        return cls.__message_name__
    except AttributeError:
        raise NetworkError(f"{cls!r} is not a registered message; "
                           "decorate it with @message") from None


def lookup_message(name: MessageName) -> Optional[Type]:
    return _REGISTRY.get(name)


# ----------------------------------------------------------------------
# Deterministic binary codec
# ----------------------------------------------------------------------

_I64 = struct.Struct(">q")
_F64 = struct.Struct(">d")


def _enc_varint(n: int, out: bytearray) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _dec_varint(buf: bytes, i: int) -> Tuple[int, int]:
    n = shift = 0
    while True:
        if i >= len(buf):
            raise ParseError("truncated varint")
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7
        if shift > 70:
            raise ParseError("varint too long")


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63) if -(1 << 63) <= n < (1 << 63) else _big(n)


def _big(n: int) -> int:
    raise ParseError(f"integer out of int64 range: {n}")


def _enc(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0x00)
    elif obj is True:
        out.append(0x01)
    elif obj is False:
        out.append(0x02)
    elif type(obj) is int:
        out.append(0x03)
        _enc_varint(_zigzag(obj), out)
    elif type(obj) is float:
        out.append(0x04)
        out += _F64.pack(obj)
    elif type(obj) is bytes:
        out.append(0x05)
        _enc_varint(len(obj), out)
        out += obj
    elif type(obj) is str:
        b = obj.encode()
        out.append(0x06)
        _enc_varint(len(b), out)
        out += b
    elif type(obj) is list:
        out.append(0x07)
        _enc_varint(len(obj), out)
        for x in obj:
            _enc(x, out)
    elif type(obj) is tuple:
        out.append(0x08)
        _enc_varint(len(obj), out)
        for x in obj:
            _enc(x, out)
    elif type(obj) is dict:
        out.append(0x09)
        _enc_varint(len(obj), out)
        # deterministic: sorted by encoded key
        items = sorted((encode(k), v) for k, v in obj.items())
        for kb, v in items:
            _enc_varint(len(kb), out)
            out += kb
            _enc(v, out)
    elif is_dataclass(obj) and hasattr(type(obj), "__message_name__"):
        out.append(0x0A)
        _enc(type(obj).__message_name__, out)
        vals = [getattr(obj, f.name) for f in fields(obj)]
        _enc_varint(len(vals), out)
        for v in vals:
            _enc(v, out)
    else:
        raise NetworkError(f"cannot encode {type(obj)!r} on the wire")


def _dec(buf: bytes, i: int) -> Tuple[Any, int]:
    if i >= len(buf):
        raise ParseError("truncated value")
    tag = buf[i]
    i += 1
    if tag == 0x00:
        return None, i
    if tag == 0x01:
        return True, i
    if tag == 0x02:
        return False, i
    if tag == 0x03:
        z, i = _dec_varint(buf, i)
        return (z >> 1) ^ -(z & 1), i
    if tag == 0x04:
        if i + 8 > len(buf):
            raise ParseError("truncated float")
        return _F64.unpack_from(buf, i)[0], i + 8
    if tag in (0x05, 0x06):
        n, i = _dec_varint(buf, i)
        if i + n > len(buf):
            raise ParseError("truncated bytes")
        raw = bytes(buf[i:i + n])
        return (raw if tag == 0x05 else raw.decode()), i + n
    if tag in (0x07, 0x08):
        n, i = _dec_varint(buf, i)
        xs = []
        for _ in range(n):
            x, i = _dec(buf, i)
            xs.append(x)
        return (xs if tag == 0x07 else tuple(xs)), i
    if tag == 0x09:
        n, i = _dec_varint(buf, i)
        d = {}
        for _ in range(n):
            klen, i = _dec_varint(buf, i)
            k, used = _dec(buf[i:i + klen], 0)
            if used != klen:
                # canonical-encoding contract: the key must fill its
                # declared length exactly (≙ checkAllConsumed)
                raise ParseError(f"dict key: {klen - used} stray bytes")
            i += klen
            v, i = _dec(buf, i)
            d[k] = v
        return d, i
    if tag == 0x0A:
        name, i = _dec(buf, i)
        cls = lookup_message(name)
        if cls is None:
            raise ParseError(f"unknown message name {name!r}")
        n, i = _dec_varint(buf, i)
        flds = fields(cls)
        if n != len(flds):
            raise ParseError(f"{name}: field count {n} != {len(flds)}")
        vals = []
        for _ in range(n):
            v, i = _dec(buf, i)
            vals.append(v)
        return cls(*vals), i
    raise ParseError(f"unknown tag 0x{tag:02x}")


def encode(obj: Any) -> bytes:
    out = bytearray()
    _enc(obj, out)
    return bytes(out)


def decode(buf: bytes) -> Any:
    obj, i = _dec(buf, 0)
    if i != len(buf):
        # ≙ the checkAllConsumed contract (Message.hs:199-202)
        raise ParseError(f"unconsumed input: {len(buf) - i} bytes")
    return obj


# ----------------------------------------------------------------------
# Framing (the stream → packet phase)
# ----------------------------------------------------------------------

def frame(packet: bytes) -> bytes:
    """Length-prefix one packet for the wire."""
    out = bytearray()
    _enc_varint(len(packet), out)
    return bytes(out) + packet


class FrameParser:
    """Incremental packet framer: feed arbitrary chunk boundaries (TCP
    re-chunks), iterate complete packets (≙ the ``conduitGet`` incremental
    parse, Message.hs:163-165)."""

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, chunk: bytes) -> list:
        self._buf += chunk
        packets = []
        while True:
            n = shift = i = 0
            ok = False
            while i < len(self._buf):
                b = self._buf[i]
                i += 1
                n |= (b & 0x7F) << shift
                if not b & 0x80:
                    ok = True
                    break
                shift += 7
                if shift > 70:
                    raise ParseError("frame length varint too long")
            if not ok or len(self._buf) < i + n:
                return packets
            packets.append(bytes(self._buf[i:i + n]))
            del self._buf[:i + n]


# ----------------------------------------------------------------------
# Packing types (≙ PackingType/Packable/Unpackable, Message.hs:133-148)
# ----------------------------------------------------------------------

class PackingType:
    """Serialization strategy. Two-phase unpack: ``parser()`` yields an
    incremental stream → ``(header, raw)`` splitter; ``extract_name`` /
    ``extract_content`` pull typed parts from ``raw`` on demand."""

    def pack(self, header: Any, msg: Any) -> bytes:
        raise NotImplementedError

    def pack_raw(self, header: Any, raw: bytes) -> bytes:
        raise NotImplementedError

    def parser(self) -> "FrameParser":
        raise NotImplementedError

    def split(self, packet: bytes) -> Tuple[Any, bytes]:
        """packet → (header, raw)."""
        raise NotImplementedError

    def extract_name(self, raw: bytes) -> MessageName:
        raise NotImplementedError

    def extract_content(self, raw: bytes) -> Any:
        raise NotImplementedError


class BinaryPacking(PackingType):
    """≙ ``BinaryP`` (Message.hs:158-202). Wire format per packet:
    ``varint-length [enc(header) enc(raw)]`` with
    ``raw = enc(name) ++ enc(fields-tuple)``."""

    def pack(self, header: Any, msg: Any) -> bytes:
        name = message_name(msg)
        raw = encode(name) + encode(
            tuple(getattr(msg, f.name) for f in fields(msg)))
        return self.pack_raw(header, raw)

    def pack_raw(self, header: Any, raw: bytes) -> bytes:
        return frame(encode(header) + encode(raw))

    def parser(self) -> FrameParser:
        return FrameParser()

    def split(self, packet: bytes) -> Tuple[Any, bytes]:
        header, i = _dec(packet, 0)
        raw, i = _dec(packet, i)
        if not isinstance(raw, bytes):
            raise ParseError("packet raw part is not bytes")
        if i != len(packet):
            raise ParseError("trailing bytes after packet")
        return header, raw

    def extract_name(self, raw: bytes) -> MessageName:
        name, _ = _dec(raw, 0)
        if not isinstance(name, str):
            raise ParseError("message name is not a string")
        return name

    def extract_content(self, raw: bytes) -> Any:
        name, i = _dec(raw, 0)
        cls = lookup_message(name)
        if cls is None:
            raise ParseError(f"unknown message name {name!r}")
        vals, i = _dec(raw, i)
        if i != len(raw):
            # ≙ checkAllConsumed (Message.hs:199-202)
            raise ParseError(f"unconsumed input: {len(raw) - i} bytes")
        if not isinstance(vals, tuple) or len(vals) != len(fields(cls)):
            raise ParseError(f"{name}: malformed content")
        return cls(*vals)

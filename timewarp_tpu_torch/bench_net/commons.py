"""Bench message types and the measure-event stream.

≙ time-warp's `bench/Network/Common/Bench/Network/Commons.hs`:
``Ping``/``Pong`` carry a message id and a filler payload (the payload
serializes as N bytes of 0x2A — Commons.hs:68-70); ``logMeasure``
writes one line per event through the logger with a µs timestamp
(Commons.hs:80-83), using the reference's exact glyphs
(Commons.hs:128-132), recovered later by :func:`parse_measure_line`
(≙ the attoparsec parsers, Commons.hs:134-186).
"""

from __future__ import annotations

import enum
import logging
import re
from typing import Optional, Tuple

from ..core.effects import GetTime, Program
from ..net.message import message

__all__ = ["Ping", "Pong", "MeasureEvent", "log_measure",
           "parse_measure_line", "payload_of"]


def payload_of(n: int) -> bytes:
    """``Payload l`` serializes as l filler bytes (Commons.hs:68-70)."""
    return b"\x2a" * n


@message(name="BenchPing")
class Ping:
    """≙ ``Ping MsgId Payload`` (Commons.hs:56-63). Wire name is
    namespaced: the ping-pong example already owns ``"Ping"``."""
    mid: int
    payload: bytes


@message(name="BenchPong")
class Pong:
    """≙ ``Pong MsgId Payload`` (Commons.hs:56-63)."""
    mid: int
    payload: bytes


class MeasureEvent(enum.Enum):
    """≙ ``MeasureEvent`` with the reference's glyph forms
    (Commons.hs:121-132)."""
    PING_SENT = "• → "      # "• → "
    PING_RECEIVED = " → •"  # " → •"
    PONG_SENT = " ← •"      # " ← •"
    PONG_RECEIVED = "• ← "  # "• ← "


#: measure line: ``#<mid> <glyph> (<payload-len>) <µs>``
_LINE = re.compile(
    r"#(?P<mid>\d+)\s+(?P<glyph>• → | → •"
    r"| ← •|• ← )\s+\((?P<plen>\d+)\)\s+(?P<t>\d+)")

_BY_GLYPH = {e.value: e for e in MeasureEvent}


def log_measure(logger: logging.Logger, event: MeasureEvent, mid: int,
                payload_len: int) -> Program:
    """Emit one measure line with the current virtual µs timestamp
    (≙ ``logMeasure``, Commons.hs:80-83)."""
    t = yield GetTime()
    logger.info("#%d %s (%d) %d", mid, event.value, payload_len, t)


def parse_measure_line(line: str
                       ) -> Optional[Tuple[MeasureEvent, int, int, int]]:
    """Recover ``(event, mid, payload_len, µs)`` from a log line, or
    None for non-measure lines (the parsers skip unrelated logging —
    Commons.hs:173-186)."""
    m = _LINE.search(line)
    if not m:
        return None
    return (_BY_GLYPH[m.group("glyph")], int(m.group("mid")),
            int(m.group("plen")), int(m.group("t")))

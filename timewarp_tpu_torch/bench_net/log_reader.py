"""Bench log reader — ≙ time-warp's `bench/Network/LogReader/
Main.hs:61-119`: parse sender and receiver logs, join the four
timestamps of each message id, emit aligned ``measures.csv`` rows
``MsgId,PingSent,PingReceived,PongSent,PongReceived`` (missing points
left empty, like the reference's sparse LogEntry merge).
"""

from __future__ import annotations

import csv
from typing import Dict, Iterable, List

from .commons import MeasureEvent, parse_measure_line

__all__ = ["join_measures", "write_csv", "read_log_lines", "summarize"]

_COLS = [MeasureEvent.PING_SENT, MeasureEvent.PING_RECEIVED,
         MeasureEvent.PONG_SENT, MeasureEvent.PONG_RECEIVED]


def read_log_lines(path: str) -> List[str]:
    with open(path, encoding="utf-8") as f:
        return f.readlines()


def join_measures(*line_sources: Iterable[str]) -> Dict[int, dict]:
    """Merge measure lines from any number of logs into
    ``{mid: {event: µs, "payload": len}}`` (≙ ``analyze`` building the
    per-id map, LogReader/Main.hs:76-96). A duplicate event for one id
    keeps the first occurrence and counts the duplicate."""
    table: Dict[int, dict] = {}
    dups = 0
    for lines in line_sources:
        for line in lines:
            parsed = parse_measure_line(line)
            if parsed is None:
                continue
            ev, mid, plen, t = parsed
            row = table.setdefault(mid, {"payload": plen})
            if ev in row:
                dups += 1
                continue
            row[ev] = t
    if dups:
        table["__duplicates__"] = dups  # surfaced, never silent
    return table


def write_csv(table: Dict[int, dict], path: str) -> int:
    """Write aligned rows sorted by message id (≙ the printed table,
    LogReader/Main.hs:97-119); returns the row count. The
    ``__duplicates__`` sentinel (if any) is left untouched in the
    table — the int-key filter below skips it."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["MsgId", "PayloadBytes"] + [c.name for c in _COLS])
        n = 0
        for mid in sorted(k for k in table if isinstance(k, int)):
            row = table[mid]
            w.writerow([mid, row.get("payload", "")] +
                       [row.get(c, "") for c in _COLS])
            n += 1
    return n


def summarize(table: Dict[int, dict]) -> dict:
    """Aggregate the joined 4-point timelines: message counts, RTT
    (PingSent -> PongReceived) percentiles, one-way (PingSent ->
    PingReceived) percentiles, and throughput over the sending window —
    the numbers the reference computed by hand in its spreadsheet
    (bench/calc-template.ods)."""
    rows = [v for k, v in table.items() if isinstance(k, int)]
    complete = [r for r in rows
                if MeasureEvent.PING_SENT in r
                and MeasureEvent.PONG_RECEIVED in r]
    one_way = [r for r in rows
               if MeasureEvent.PING_SENT in r
               and MeasureEvent.PING_RECEIVED in r]

    def pct(xs, q):
        if not xs:
            return None
        xs = sorted(xs)
        # nearest-rank percentile: ceil(q*n)-1, not int(q*n) (which
        # selects one rank high and degenerates at small n)
        import math
        return xs[max(0, min(len(xs) - 1, math.ceil(q * len(xs)) - 1))]

    rtts = [r[MeasureEvent.PONG_RECEIVED] - r[MeasureEvent.PING_SENT]
            for r in complete]
    ows = [r[MeasureEvent.PING_RECEIVED] - r[MeasureEvent.PING_SENT]
           for r in one_way]
    sends = [r[MeasureEvent.PING_SENT] for r in rows
             if MeasureEvent.PING_SENT in r]
    window_us = (max(sends) - min(sends)) if len(sends) > 1 else 0
    return {
        "messages": len(rows),
        "complete_timelines": len(complete),
        "send_window_us": window_us,
        "send_rate_msg_s": (round(len(sends) / (window_us / 1e6), 1)
                            if window_us else None),
        "rtt_us": {"p50": pct(rtts, 0.50), "p90": pct(rtts, 0.90),
                   "p99": pct(rtts, 0.99), "max": max(rtts, default=None)},
        "one_way_us": {"p50": pct(ows, 0.50), "p90": pct(ows, 0.90),
                       "p99": pct(ows, 0.99)},
    }

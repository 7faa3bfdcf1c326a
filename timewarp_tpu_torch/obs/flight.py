"""The causal flight recorder: per-message provenance on the device (the
port of ``timewarp_tpu/obs/flight.py``).

A :class:`RecordRow` is the fixed-shape, bounded per-superstep event
plane an engine builds when ``record != "off"``, from values the
superstep already computes (the deliver mask, the routed batch, the
fault masks), so states, traces and checkpoints are bit-identical in
every mode; with ``record="off"`` no code of this module runs.

Modes:

- ``"deliveries"`` — one event per delivered message: ``(src, dst,
  deliver_t)`` (``send_t`` is unknown at delivery and recorded -1;
  ``full`` mode's send events carry it).
- ``"full"`` — adds send events ``(src, dst, send_t, deliver_t)`` and
  fault-action events: ``defer`` (a crash window slid a node's pending
  event to ``t_up``), ``cut`` (a partition killed a send), ``down`` (a
  delivery landed inside the destination's down window), ``purge`` (a
  reset restart dropped pre-crash mailbox entries), ``restart`` (the
  injected reboot firing itself).

The plane is a bounded ring: ``record_cap`` events per superstep and
world (default 256). Events beyond capacity are dropped while ``n_ev``
keeps counting — ``n_ev`` exceeding the stored count IS the overflow
evidence, never silent. Within a superstep the event order is the
reference's: deliveries (node-major, slot order), then the fault and
send captures in superstep order (defer, restart, purge, cut, sends).

Device builders here take a leading world axis B on every mask (1 for a
solo engine); columns broadcast against the mask. The compaction is the
reference's: an inclusive cumsum over the mask, each buffer lane's event
found by ``searchsorted``, then a gather — no host sync. Rows stay on
the device and come to the host once per ``run`` call, as numpy arrays
``[T, B, ...]`` (``[T, ...]`` solo), which :func:`decode_flight` turns
into a :class:`FlightLog` per world. :class:`FlightWriter` drains logs
into a schema'd JSONL event log — METRICS_SCHEMA ``event`` lines with
``name="flight"``, validated by ``python -m
timewarp_tpu_torch.obs.metrics validate``; the lines equal the
reference's for the same events.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import numpy as np

__all__ = ["RECORD_MODES", "RecordRow", "FlightLog", "FlightWriter",
           "FlightRecorderMixin", "validate_record", "empty_row",
           "record_masked", "record_compacted", "compact",
           "record_deliveries",
           "decode_flight", "concat_flight", "load_flight_jsonl",
           "EV_DELIVER", "EV_SEND", "EV_FAULT", "TAG_DEFER",
           "TAG_CUT", "TAG_DOWN", "TAG_PURGE", "TAG_RESTART",
           "KIND_NAMES", "ACTION_NAMES"]

#: the engine knob's legal values, in increasing cost order
RECORD_MODES = ("off", "deliveries", "full")

#: event kinds (RecordRow.kind; 0 = empty slot)
EV_DELIVER, EV_SEND, EV_FAULT = 1, 2, 3
KIND_NAMES = {EV_DELIVER: "deliver", EV_SEND: "send", EV_FAULT: "fault"}

#: fault-action tags (RecordRow.tag for EV_FAULT events; a SEND whose
#: delivery lands in the destination's down window is recorded as an
#: EV_FAULT with TAG_DOWN — the send's fate rides its tag)
TAG_DEFER, TAG_CUT, TAG_DOWN, TAG_PURGE, TAG_RESTART = 1, 2, 3, 4, 5
ACTION_NAMES = {TAG_DEFER: "defer", TAG_CUT: "cut", TAG_DOWN: "down",
                TAG_PURGE: "purge", TAG_RESTART: "restart"}


def validate_record(mode: str, who: str = "engine") -> str:
    """Loud knob validation — a typo'd mode must not silently run
    unrecorded (mirrors obs.telemetry.validate_mode)."""
    if mode not in RECORD_MODES:
        raise ValueError(
            f"{who}: record must be one of {RECORD_MODES}, got "
            f"{mode!r} ('off' = zero overhead, 'deliveries' = one "
            "event per delivered message, 'full' = + sends and fault "
            "actions — docs/observability.md)")
    return mode


class RecordRow(NamedTuple):
    """One superstep's bounded event plane (tensors ``[B]`` and ``[B,
    R]``, R the capacity). ``n_ev`` counts every event the superstep
    produced — past ``R`` they are dropped but still counted. Empty
    slots carry kind 0. The deliveries-mode row is slim: ``kind``,
    ``send_t`` and ``tag`` are None (every event an EV_DELIVER with
    unknown send instant, filling slots ``[0, min(n_ev, R))``)."""
    n_ev: Any     # int32[B] — events produced (stored + dropped)
    kind: Any     # int32[B, R] — EV_* (0 = empty slot); None when slim
    src: Any      # int32[B, R]
    dst: Any      # int32[B, R]
    send_t: Any   # int64[B, R] — send instant (-1 = unknown); None slim
    t: Any        # int64[B, R] — deliver / action instant
    tag: Any      # int32[B, R] — TAG_* for EV_FAULT rows; None when slim


# ---------------------------------------------------------------------------
# device-side builders (called inside the engines' superstep)
# ---------------------------------------------------------------------------

def empty_row(cap: int, B: int, device) -> RecordRow:
    import torch
    z32 = torch.zeros((B, cap), dtype=torch.int32, device=device)
    z64 = torch.zeros((B, cap), dtype=torch.int64, device=device)
    return RecordRow(n_ev=torch.zeros((B,), dtype=torch.int32,
                                      device=device),
                     kind=z32, src=z32, dst=z32, send_t=z64, t=z64,
                     tag=z32)


def _lanes(mask, base, cap: int):
    """The compaction's plan for a world-axis ``mask`` ``[B, ...]``: each
    world's new-event count, and for each of the ``cap`` buffer lanes
    whether it takes an event (``pick``) and that event's flat index
    into the mask (``idx``). Lane ``l`` holds event ``l - base`` of the
    mask's flat order (``base`` ``[B]``, the events already in the
    buffer)."""
    import torch
    B = mask.shape[0]
    m = mask.reshape(B, -1)
    M = m.shape[1]
    lane = torch.arange(cap, dtype=torch.int32, device=mask.device)
    rel = lane[None, :] - base[:, None]
    if M == 0:
        zero = torch.zeros((B,), dtype=torch.int32, device=mask.device)
        return zero, torch.zeros_like(rel, dtype=torch.bool), \
            torch.zeros_like(rel, dtype=torch.int64)
    # one scan over every world's flattened mask (a device-wide scan; a
    # scan along each row of [B, M] is many times slower on the card):
    # world b's running count is the global one minus ``before[b]``, the
    # live elements of the worlds ahead of it
    wide = torch.int64 if B * M >= 2**31 else torch.int32
    cs = torch.cumsum(m.reshape(-1), 0, dtype=wide).view(B, M)
    before = torch.zeros((B,), dtype=wide, device=mask.device)
    if B > 1:
        before[1:] = cs[:-1, -1]
    n_new = (cs[:, -1] - before).to(torch.int32)
    pick = (rel >= 0) & (rel < n_new[:, None])
    want = (rel + 1).to(wide) + before[:, None]
    idx = torch.clamp(torch.searchsorted(cs, want, side="left"), 0, M - 1)
    return n_new, pick, idx


def _column(v, shape, idx, dtype, off=None):
    """Column ``v`` (a number, a 0-d tensor, or a tensor broadcasting to
    the mask's ``shape`` ``[B, ...]``) at the lanes' flat indices ``idx``
    ``[B, R]``; ``off`` (``[B]``) is added after widening, so a caller can
    pass an int32 relative plane."""
    import torch
    if not isinstance(v, torch.Tensor):
        # a fill on the device: a number moved there would be a copy from
        # the host, which waits for the device's queue to drain
        g = torch.full(idx.shape, v, dtype=dtype, device=idx.device)
    elif v.dim() == 0:
        g = v.to(dtype).expand(idx.shape)
    else:
        lead = v.shape[0] if v.dim() == len(shape) else 1
        if lead == 1:
            # shared by every world: one flat plane, indexed per world
            flat = torch.broadcast_to(v, (1,) + tuple(shape[1:])) \
                .reshape(-1)
            g = flat[idx]
        else:
            g = torch.broadcast_to(v, shape).reshape(shape[0], -1) \
                .gather(1, idx)
        g = g.to(dtype)
    if off is not None:
        g = off[:, None] + g
    return g


def record_masked(row: RecordRow, kind, mask, src, dst, send_t, t,
                  tag=0, t_off=None) -> RecordRow:
    """Append the masked events to ``row`` in the mask's flat order (the
    pinned within-superstep order): lanes past the row's ``n_ev`` take
    the mask's live elements in turn, each gathered at its flat index.
    Capacity drops are counted in ``n_ev``, never silent. Columns
    broadcast against ``mask``'s shape; ``t_off`` (``[B]``) is added to
    the gathered ``t``, so callers pass the int32 relative plane."""
    import torch
    cap = row.kind.shape[1]
    shape = tuple(mask.shape)
    n_new, pick, idx = _lanes(mask, row.n_ev, cap)

    def put(buf, v, dtype, off=None):
        return torch.where(pick, _column(v, shape, idx, dtype, off), buf)
    return RecordRow(
        n_ev=row.n_ev + n_new,
        kind=put(row.kind, kind, torch.int32),
        src=put(row.src, src, torch.int32),
        dst=put(row.dst, dst, torch.int32),
        send_t=put(row.send_t, send_t, torch.int64),
        t=put(row.t, t, torch.int64, t_off),
        tag=put(row.tag, tag, torch.int32))


def _fresh(cap: int, mask, cols, t_off):
    """The compaction of ``mask`` into an empty ``[B, cap]`` buffer: each
    world's event count, and each column (``(value, dtype)``, the last one
    ``t`` with ``t_off``) gathered where a lane takes an event, else 0."""
    import torch
    shape = tuple(mask.shape)
    zero = torch.zeros((shape[0],), dtype=torch.int32, device=mask.device)
    n_new, pick, idx = _lanes(mask, zero, cap)
    last = len(cols) - 1
    return n_new, [torch.where(pick, _column(v, shape, idx, dtype,
                                             t_off if i == last else None), 0)
                   for i, (v, dtype) in enumerate(cols)]


def record_deliveries(cap: int, mask, src, dst, t,
                      t_off=None) -> RecordRow:
    """The deliveries-mode fast path: one slim row straight from the
    deliver mask — :func:`record_masked`'s compaction from an empty
    buffer, with ``None`` for the three constant planes."""
    import torch
    n_new, (src, dst, t) = _fresh(cap, mask, ((src, torch.int32),
                                              (dst, torch.int32),
                                              (t, torch.int64)), t_off)
    return RecordRow(n_ev=n_new, kind=None, src=src, dst=dst, send_t=None,
                     t=t, tag=None)


def compact(cap: int, kind, mask, src, dst, send_t, t,
            tag=0, t_off=None) -> RecordRow:
    """Compact one masked event source into a standalone ``[B, cap]``
    buffer (what :func:`record_masked` appends to an empty row); merge it
    with :func:`record_compacted`."""
    import torch
    n_new, (kind, src, dst, send_t, tag, t) = _fresh(
        cap, mask, ((kind, torch.int32), (src, torch.int32),
                    (dst, torch.int32), (send_t, torch.int64),
                    (tag, torch.int32), (t, torch.int64)), t_off)
    return RecordRow(n_ev=n_new, kind=kind, src=src, dst=dst, send_t=send_t,
                     t=t, tag=tag)


def record_compacted(row: RecordRow, comp: RecordRow) -> RecordRow:
    """Append a pre-compacted buffer (:func:`compact`) onto ``row`` at
    offset ``n_ev``. ``comp.n_ev`` carries events ``comp`` itself dropped
    at capacity; they stay counted (the two caps are the same)."""
    import torch
    cap = row.kind.shape[1]
    lane = torch.arange(cap, dtype=torch.int32, device=row.n_ev.device)
    rel = lane[None, :] - row.n_ev[:, None]
    pick = (rel >= 0) & (rel < torch.clamp(comp.n_ev, max=cap)[:, None])
    idx = torch.clamp(rel, 0, cap - 1).long()

    def put(buf, v):
        return torch.where(pick, v.gather(1, idx), buf)
    return RecordRow(
        n_ev=row.n_ev + comp.n_ev,
        kind=put(row.kind, comp.kind), src=put(row.src, comp.src),
        dst=put(row.dst, comp.dst),
        send_t=put(row.send_t, comp.send_t), t=put(row.t, comp.t),
        tag=put(row.tag, comp.tag))


# ---------------------------------------------------------------------------
# host-side decode
# ---------------------------------------------------------------------------

_COLS = ("superstep", "t_sup", "kind", "src", "dst", "send_t", "t",
         "tag")


@dataclass
class FlightLog:
    """Host-side decode of one run's recorded events: one row per
    stored event, with the (run-global) superstep index and the
    superstep instant attached. ``dropped`` counts events past the
    per-superstep capacity (``n_ev`` overflow) — a complete log has
    ``dropped == 0``."""
    superstep: np.ndarray   # int64[M]
    t_sup: np.ndarray       # int64[M] — the superstep's instant
    kind: np.ndarray        # int32[M] — EV_*
    src: np.ndarray         # int32[M]
    dst: np.ndarray         # int32[M]
    send_t: np.ndarray      # int64[M] (-1 = unknown)
    t: np.ndarray           # int64[M]
    tag: np.ndarray         # int32[M]
    dropped: int = 0

    def __len__(self) -> int:
        return len(self.kind)

    def event(self, i: int) -> dict:
        """One event as the schema'd record body (the JSONL line's
        payload fields — FlightWriter adds the envelope)."""
        k = int(self.kind[i])
        rec = {"ev": KIND_NAMES.get(k, str(k)),
               "superstep": int(self.superstep[i]),
               "t_sup_us": int(self.t_sup[i]),
               "src": int(self.src[i]), "dst": int(self.dst[i]),
               "send_t_us": int(self.send_t[i]),
               "t_us": int(self.t[i]), "tag": int(self.tag[i])}
        if k == EV_FAULT:
            rec["action"] = ACTION_NAMES.get(int(self.tag[i]),
                                             str(int(self.tag[i])))
        return rec

    def keyset(self):
        """The event identity tuples — what the bisection's event
        delta diffs (superstep index deliberately excluded: two runs
        may chunk differently yet carry the same events)."""
        return {(int(self.kind[i]), int(self.src[i]),
                 int(self.dst[i]), int(self.send_t[i]),
                 int(self.t[i]), int(self.tag[i]))
                for i in range(len(self))}


def _empty_log() -> FlightLog:
    return FlightLog(*(np.zeros(0, np.int64) if c in
                       ("superstep", "t_sup", "send_t", "t")
                       else np.zeros(0, np.int32) for c in _COLS))


def decode_flight(rec, valid, t_us, offset=0,
                  n_worlds: Optional[int] = None):
    """Decode the scan's stacked record rows ([T, R] leaves; [T, B, R]
    batched) into a :class:`FlightLog` (solo) or one per world,
    masked to the supersteps that actually fired. ``offset`` (the
    engine state's superstep count at chunk entry; [B] batched) makes
    the indices run-global, so chunked drivers concatenate without
    bookkeeping."""
    valid = np.asarray(valid)
    t_us = np.asarray(t_us)
    offset = np.asarray(offset, np.int64)

    def one(world: Optional[int]) -> FlightLog:
        m = valid if world is None else valid[:, world]

        def col(x):
            a = np.asarray(x)
            return a[m] if world is None else a[m, world]
        n_ev = col(rec.n_ev).astype(np.int64)            # [S]
        src = col(rec.src)                               # [S, R]
        ts = col(t_us)
        S, R = src.shape
        if rec.kind is None:
            # slim deliveries-mode row (RecordRow docstring): the
            # live slots are exactly [0, min(n_ev, R)), every event
            # is an EV_DELIVER with unknown send instant
            lanes = np.arange(R, dtype=np.int64)
            live = lanes[None, :] < np.minimum(n_ev, R)[:, None]
            kind = np.where(live, np.int32(EV_DELIVER),
                            np.int32(0))
            send_t = np.full((S, R), -1, np.int64)
            tag = np.zeros((S, R), np.int32)
        else:
            kind = col(rec.kind)
            send_t = np.asarray(col(rec.send_t), np.int64)
            tag = col(rec.tag)
        off = int(offset if world is None else offset[world])
        sel = kind.reshape(-1) > 0
        sup = np.repeat(np.arange(S, dtype=np.int64) + off, R)[sel]
        tsup = np.repeat(ts, R)[sel]
        stored = (kind > 0).sum()
        return FlightLog(
            superstep=sup, t_sup=tsup.astype(np.int64),
            kind=kind.reshape(-1)[sel],
            src=src.reshape(-1)[sel],
            dst=col(rec.dst).reshape(-1)[sel],
            send_t=send_t.reshape(-1)[sel],
            t=col(rec.t).reshape(-1)[sel].astype(np.int64),
            tag=tag.reshape(-1)[sel],
            dropped=int(np.maximum(n_ev.sum() - stored, 0)))

    if n_worlds is None:
        return one(None)
    return [one(b) for b in range(n_worlds)]


def concat_flight(chunks):
    """Concatenate per-chunk :class:`FlightLog`\\ s (or per-world
    lists of them) into one run-level log — superstep indices are
    already run-global (decode's ``offset``), so this is a plain
    column concat."""
    chunks = [c for c in chunks if c is not None]
    if not chunks:
        return None
    if isinstance(chunks[0], list):
        B = len(chunks[0])
        return [concat_flight([c[b] for c in chunks])
                for b in range(B)]
    return FlightLog(
        *(np.concatenate([getattr(c, col) for c in chunks])
          for col in _COLS),
        dropped=sum(c.dropped for c in chunks))


# ---------------------------------------------------------------------------
# the JSONL event log (METRICS_SCHEMA `event` kind, name="flight")
# ---------------------------------------------------------------------------

class FlightWriter:
    """Append-only schema'd JSONL event log. Every line is a
    METRICS_SCHEMA ``event`` record with ``name="flight"`` — the
    stream re-validates with ``python -m timewarp_tpu_torch.obs.metrics
    validate`` (a malformed line refuses to be written at all). Safe
    for concurrent buckets: appends serialize under one lock.
    ``events`` counts recorded events (drop-marker lines excluded —
    the count agrees with per-world ``len(FlightLog)`` everywhere).
    ``truncate=True`` starts the file fresh — the solo CLI uses it so
    re-running a command does not silently merge two runs' events
    into one un-disambiguatable log (solo lines carry no ``run_id``,
    so :func:`load_flight_jsonl`'s multi-run refusal could not catch
    the merge); the sweep service keeps appending, its lines are
    ``run_id``-stamped."""

    def __init__(self, path: str, run: Optional[str] = None,
                 truncate: bool = False) -> None:
        self.path = path
        self.run = run
        self.events = 0
        self._fh = None
        self._mode = "w" if truncate else "a"
        self._lock = threading.Lock()

    def write(self, log: FlightLog, world: Optional[int] = None,
              run_id: Optional[str] = None) -> int:
        from .metrics import METRICS_SCHEMA, validate_line

        def envelope(rec):
            if self.run is not None:
                rec["run"] = self.run
            if world is not None:
                rec["world"] = int(world)
            if run_id is not None:
                rec["run_id"] = run_id
            validate_line(rec)
            return json.dumps(rec, sort_keys=True)
        lines = []
        for i in range(len(log)):
            lines.append(envelope(
                {"schema": METRICS_SCHEMA, "kind": "event",
                 "name": "flight", **log.event(i)}))
        if log.dropped:
            # the overflow evidence must cross the file boundary too:
            # without this line a reloaded log would look complete
            # (load_flight_jsonl sums these back into
            # FlightLog.dropped)
            lines.append(envelope(
                {"schema": METRICS_SCHEMA, "kind": "event",
                 "name": "flight_drops", "dropped": int(log.dropped)}))
        with self._lock:
            if self._fh is None:
                self._fh = open(self.path, self._mode)
                self._mode = "a"          # one truncation per writer
            for ln in lines:
                self._fh.write(ln + "\n")
            self._fh.flush()
            self.events += len(log)
        return len(log)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def load_flight_jsonl(path: str, run_id: Optional[str] = None,
                      world: Optional[int] = None) -> FlightLog:
    """Load a :class:`FlightWriter` event log back into a
    :class:`FlightLog` (the ``explain`` CLI's input). Non-flight
    metrics lines in the same file are skipped; ``run_id``/``world``
    filter a sweep's shared log down to one world. A log that still
    spans several runs or worlds after the given filters REFUSES to
    load — one merged FlightLog would let the causal join pair a send
    from one run with a delivery from another, a confidently wrong
    chain (the module's loud-failure convention)."""
    names = {v: k for k, v in KIND_NAMES.items()}
    cols: dict = {c: [] for c in _COLS}
    seen_runs: set = set()
    seen_worlds: set = set()
    n = dropped = 0
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            if rec.get("kind") != "event" \
                    or rec.get("name") not in ("flight",
                                               "flight_drops"):
                continue
            if run_id is not None and rec.get("run_id") != run_id:
                continue
            if world is not None and rec.get("world") != world:
                continue
            seen_runs.add(rec.get("run_id"))
            seen_worlds.add(rec.get("world"))
            if rec["name"] == "flight_drops":
                # the writer's overflow evidence (FlightWriter.write)
                dropped += int(rec.get("dropped", 0))
                continue
            n += 1
            cols["superstep"].append(rec["superstep"])
            cols["t_sup"].append(rec.get("t_sup_us", -1))
            cols["kind"].append(names.get(rec["ev"], 0))
            cols["src"].append(rec["src"])
            cols["dst"].append(rec["dst"])
            cols["send_t"].append(rec.get("send_t_us", -1))
            cols["t"].append(rec["t_us"])
            cols["tag"].append(rec.get("tag", 0))
    if n == 0:
        raise ValueError(
            f"{path!r} holds no flight events"
            + (f" for run_id {run_id!r}" if run_id is not None else "")
            + (f" world {world}" if world is not None else "")
            + " — record one with --record deliveries|full "
            "--record-out FILE (docs/observability.md)")
    if run_id is None and len(seen_runs) > 1:
        raise ValueError(
            f"{path!r} holds flight events from "
            f"{len(seen_runs)} runs ({sorted(map(str, seen_runs))}) "
            "— pick one with run_id=/--run-id; a merged log would "
            "join causal chains across unrelated runs")
    if world is None and len(seen_worlds) > 1:
        raise ValueError(
            f"{path!r} holds flight events from "
            f"{len(seen_worlds)} worlds "
            f"({sorted(map(str, seen_worlds))}) — pick one with "
            "world=/--world; a merged log would join causal chains "
            "across unrelated worlds")
    return FlightLog(
        *(np.asarray(cols[c],
                     np.int64 if c in ("superstep", "t_sup",
                                       "send_t", "t")
                     else np.int32) for c in _COLS),
        dropped=dropped)


# ---------------------------------------------------------------------------
# engine wiring
# ---------------------------------------------------------------------------

class FlightRecorderMixin:
    """``record=`` wiring + the host-side drain every torch engine shares.
    Host state only: with ``record="off"`` no capture site runs."""

    #: the engine's record mode ("off" | "deliveries" | "full")
    record = "off"
    #: per-superstep event capacity (overflow counted, never silent)
    record_cap = 256
    #: optional FlightWriter the traced drivers drain each chunk
    flight_out = None
    #: the last traced run's FlightLog (list per world, batched)
    last_run_flight = None
    #: the current superstep's compacted full-mode captures (None when
    #: nothing is captured: the capture sites test it before calling in)
    _rec_extra = None

    def _bind_record(self, record: str,
                     record_cap: Optional[int]) -> None:
        self.record = validate_record(record, type(self).__name__)
        if record_cap is not None:
            if record_cap < 1:
                raise ValueError(
                    f"record_cap must be >= 1, got {record_cap}")
            self.record_cap = int(record_cap)

    def _rec_cut(self, cutm, src, dst, tmsg) -> None:
        """Capture of partition-cut sends (full mode, world-axis masks),
        with the pre-cut destinations."""
        self._rec_extra.append(compact(
            self.record_cap, EV_FAULT, cutm, src, dst, tmsg, tmsg,
            TAG_CUT))

    def _rec_sends(self, ok, downm, src, dst, tmsg, dt_abs) -> None:
        """Capture of the sent batch (full mode): kind SEND, except a send
        whose delivery lands inside the destination's down window, which
        is recorded as EV_FAULT with TAG_DOWN."""
        import torch
        if downm is None:
            kind, tag = EV_SEND, 0
        else:
            kind = torch.where(downm, EV_FAULT, EV_SEND)
            tag = torch.where(downm, TAG_DOWN, 0)
        self._rec_extra.append(compact(self.record_cap, kind, ok, src, dst,
                                       tmsg, dt_abs, tag))

    def _rec_fault(self, tag, mask, src, dst, send_t, t, t_off=None):
        """Capture of one fault action (full mode): defer, restart, purge."""
        self._rec_extra.append(compact(self.record_cap, EV_FAULT, mask,
                                       src, dst, send_t, t, tag,
                                       t_off=t_off))

    def _record_row(self, deliver_nm, src_nm, dst_nm, rel_nm, base):
        """The superstep's event plane: the deliveries (masks node-major,
        ``[B, N, slots]``), then the captures in superstep order."""
        if self.record == "deliveries":
            return record_deliveries(self.record_cap, deliver_nm, src_nm,
                                     dst_nm, rel_nm, t_off=base)
        row = compact(self.record_cap, EV_DELIVER, deliver_nm, src_nm,
                      dst_nm, -1, rel_nm, 0, t_off=base)
        for comp in self._rec_extra:
            row = record_compacted(row, comp)
        return row

    def _capture_flight(self, rec, valid, t_us, steps_before) -> None:
        """Host-side decode of one traced run's record plane (numpy
        ``[T, B, ...]`` columns, or None) onto ``last_run_flight`` (+ a
        chunk drain to an attached FlightWriter) — a no-op in off mode."""
        self.last_run_flight = None
        if self.record == "off" or rec is None:
            return
        batch = getattr(self, "batch", None)
        self.last_run_flight = decode_flight(
            rec, valid, t_us, offset=np.asarray(steps_before, np.int64),
            n_worlds=None if batch is None else batch.B)
        if self.flight_out is not None:
            if isinstance(self.last_run_flight, list):
                for b, lg in enumerate(self.last_run_flight):
                    self.flight_out.write(lg, world=b)
            else:
                self.flight_out.write(self.last_run_flight)

"""Crash-safe sweep journal: append-only JSONL + atomic checkpoints
(the port's copy of ``timewarp_tpu/sweep/journal.py``).

One directory per sweep:

- ``pack.json`` — the pack, written atomically at first run; resume
  reloads it (and refuses a different pack by sha).
- ``journal.jsonl`` — append-only event log, fsync'd per append.
  Events: ``pack`` (sha, world count), ``bucket_start``, ``retry``,
  ``bucket_split``, ``world_done`` (the streamed per-world result),
  ``world_failed`` (terminal, loud), ``bucket_done``, ``sweep_done``.
- ``bucket-<id>.npz`` — per-bucket state snapshot via
  ``utils/checkpoint.save_state`` (atomic: temp + fsync + rename),
  whose meta carries the per-world digest chain, so a resumed bucket
  continues the digest exactly where the state is.

Crash model: every append is flushed and fsync'd before the action it
records is considered durable; a crash can tear at most the *last*
line, which :meth:`SweepJournal.scan` detects and drops with a
warning (the event it described simply re-happens on resume — the
done-set makes re-happening idempotent). A ``world_done`` seen twice
with *different* results is the one unforgivable state — it means two
result streams claimed the same world — and scan fails loudly rather
than pick one.

Multi-host mode (the serving layer, serve/ + docs/serving.md): with
``host="name"`` each cooperating process appends to its OWN
``journal-<name>.jsonl`` (never a shared file — concurrent appends
from two processes could interleave inside a line), with every record
stamped ``host``/``seq``/``ts`` (``ts`` monotone per journal handle).
:meth:`records` merges every journal file in the directory, sorted by
``(ts, host, seq)`` — per-host causal order is preserved, cross-host
order follows wall time — and applies the torn-final-line tolerance
*per file* (any host may have crashed mid-append). With ``host=None``
(the default) nothing changes: one ``journal.jsonl``, unstamped
records, byte-identical to the single-host service since r10.
"""

from __future__ import annotations

import glob as _glob
import json
import logging
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set

__all__ = ["SweepJournal", "JournalState", "SweepJournalError",
           "status_fields", "merge_key", "util_rollup"]


def merge_key(rec: Dict[str, Any]):
    """THE multi-host merge ordering — ``(ts, host, seq)`` — shared by
    :meth:`SweepJournal.records`, the live watch tail (obs/watch.py),
    and the serve frontend's result tail (serve/frontend.py), so the
    file-merge convention cannot drift between readers."""
    return (float(rec.get("ts", 0.0)), str(rec.get("host", "")),
            int(rec.get("seq", 0)))

_log = logging.getLogger("timewarp.sweep")


class SweepJournalError(RuntimeError):
    """The journal contradicts itself (double-journaled world, mixed
    packs, mid-file corruption) — never silently reconciled."""


@dataclass
class JournalState:
    """What a scan of the journal knows."""
    pack_sha: Optional[str] = None
    done: Dict[str, dict] = field(default_factory=dict)      # run_id -> result
    failed: Dict[str, dict] = field(default_factory=dict)    # run_id -> info
    bucket_done: Set[str] = field(default_factory=set)
    #: bucket_id -> [child_id, ...] in split order
    splits: Dict[str, List[str]] = field(default_factory=dict)
    retries: int = 0
    events: List[dict] = field(default_factory=list)
    #: bucket_id -> utilization record (obs: worlds-active occupancy,
    #: budget-mask efficiency, pow2 pad waste — sweep/runner.py)
    util: Dict[str, dict] = field(default_factory=dict)
    #: bucket_id -> ordered dispatch-controller decision records
    #: (dispatch/trace.py schema), journaled BEFORE each chunk runs —
    #: resume replays them so a pre-kill decision is never re-made
    #: differently (docs/dispatch.md)
    decisions: Dict[str, List[dict]] = field(default_factory=dict)
    #: run_id -> bucket_id that streamed its result (what --verify
    #: uses to assemble a controller world's decision chain)
    world_bucket: Dict[str, str] = field(default_factory=dict)
    #: integrity_violation events (integrity/, docs/integrity.md):
    #: each one a detected state corruption that was rolled back —
    #: surfaced in `sweep status` so an SDC-prone host is visible
    integrity: List[dict] = field(default_factory=list)
    #: spec_rollback events (speculate/, docs/speculation.md): each
    #: one a causality violation a speculative chunk detected and
    #: rolled back — surfaced in `sweep status` so the
    #: misspeculation rate is visible (observability only; resume
    #: re-derives rollbacks from the committed decision chain)
    spec_rollbacks: List[dict] = field(default_factory=list)
    #: run_id -> flight-recorder event count (flight_counts records,
    #: sweep/runner.py; summed across processes — a resumed sweep
    #: journals its own drain). Surfaced in `sweep status` next to
    #: utilization when the sweep ran with --record
    flight: Dict[str, int] = field(default_factory=dict)
    #: run_id -> the world's per-chunk digest trail ([[supersteps,
    #: chain_hex], ...], the world_done record's "chain" field) —
    #: what --verify's auto-bisect feeds
    #: obs.bisect.first_trail_divergence to name the first diverging
    #: chunk on a survival-law mismatch
    chains: Dict[str, list] = field(default_factory=dict)
    #: host name -> serving-fleet facts (serve/, docs/serving.md):
    #: leases held, last journaled heartbeat ts, stolen-bucket count,
    #: listen address — folded from serve_open / host_heartbeat /
    #: lease_* records, so `sweep status` and the live watch report
    #: the SAME hosts block from the same fold
    hosts: Dict[str, dict] = field(default_factory=dict)
    #: run_id -> admit record ({"bucket", "slot", "config"}) — the
    #: serving layer's admission ledger: curators rebuild open-bucket
    #: membership from exactly this (the journal IS the queue)
    admits: Dict[str, dict] = field(default_factory=dict)
    #: bucket_id -> bucket_open record (key sha, window, capacity) —
    #: the serving layer's open-bucket table
    serve_buckets: Dict[str, dict] = field(default_factory=dict)
    #: repack events (serve/worker.py): each one an under-occupied
    #: open bucket merged into a same-key peer between chunks
    repacks: List[dict] = field(default_factory=list)
    #: True once a serve_drain record landed: the frontend stopped
    #: admitting; curators exit when every admitted world settles
    draining: bool = False
    #: bucket_id -> the sweep plan's pack_decision record ({"members",
    #: "mode", "artifact_sha", ...}, timewarp_tpu_torch/pack/): journaled
    #: BEFORE any bucket starts when the plan is not a pure function
    #: of the pack alone (--pack predicted), so resume re-derives the
    #: identical bucket membership from the journal — never from a
    #: re-run of the predictor (docs/sweeps.md "Predictive packing").
    #: Insertion-ordered: the fold preserves plan order.
    pack_plan: Dict[str, dict] = field(default_factory=dict)
    #: every pack_decision record (sweep plan form + the serving
    #: layer's placement/repack choices) — the packing audit trail
    pack_decisions: List[dict] = field(default_factory=list)

    def apply(self, rec: Dict[str, Any]) -> None:
        """Fold ONE journal record into this state — the single fold
        both :meth:`SweepJournal.scan` and the live ``sweep watch``
        tail (obs/watch.py) run, so a watcher's aggregates and
        ``sweep status`` can never disagree about the same journal."""
        self.events.append(rec)
        ev = rec.get("ev")
        if ev == "pack":
            if self.pack_sha is not None and self.pack_sha != rec["sha"]:
                raise SweepJournalError(
                    "journal holds events for two different packs — "
                    "one journal dir per sweep")
            self.pack_sha = rec["sha"]
        elif ev == "world_done":
            rid = rec["result"]["run_id"]
            if rid in self.done:
                if self.done[rid] == rec["result"]:
                    # an interrupted attempt's straggler replayed
                    # an identical record — harmless, noted
                    _log.warning("sweep journal: duplicate "
                                 "world_done for %r (identical "
                                 "result)", rid)
                    return
                raise SweepJournalError(
                    f"world {rid!r} is double-journaled with "
                    f"DIFFERENT results — refusing to pick one:\n"
                    f"  first:  {self.done[rid]}\n"
                    f"  second: {rec['result']}")
            self.done[rid] = rec["result"]
            self.world_bucket[rid] = rec.get("bucket", "")
            self.chains[rid] = list(rec.get("chain", []))
        elif ev == "world_failed":
            self.failed[rec["run_id"]] = rec
        elif ev == "bucket_done":
            self.bucket_done.add(rec["bucket"])
        elif ev == "bucket_split":
            self.splits[rec["bucket"]] = list(rec["into"])
        elif ev == "bucket_util":
            # a resumed bucket re-journals its (process-local)
            # utilization; last record wins — wall facts are not
            # replayable, only results are
            self.util[rec["bucket"]] = {
                k: v for k, v in rec.items() if k != "ev"}
        elif ev == "retry":
            self.retries += 1
        elif ev == "integrity_violation":
            self.integrity.append(
                {k: v for k, v in rec.items() if k != "ev"})
        elif ev == "spec_rollback":
            self.spec_rollbacks.append(
                {k: v for k, v in rec.items() if k != "ev"})
        elif ev == "flight_counts":
            # per-world recorded-event counts (sweep/runner.py):
            # each process journals its own drain once per bucket
            # run, so summing across records totals the sweep
            for rid, n in rec.get("counts", {}).items():
                self.flight[rid] = self.flight.get(rid, 0) + int(n)
        elif ev == "serve_open":
            h = self._host(rec["host"])
            h["listen"] = rec.get("listen")
            h["last_heartbeat"] = rec.get("ts")
        elif ev == "host_heartbeat":
            self._host(rec["host"])["last_heartbeat"] = rec.get("ts")
        elif ev == "lease_acquire":
            h = self._host(rec["host"])
            h["leases"].add(rec["bucket"])
            h["last_heartbeat"] = rec.get("ts", h["last_heartbeat"])
            if rec.get("stolen_from"):
                h["stolen"] += 1
                h["stolen_buckets"].append(
                    {"bucket": rec["bucket"],
                     "from": rec["stolen_from"]})
            # a steal implicitly evicts the dead holder's lease row
            prev = self.hosts.get(rec.get("stolen_from") or "")
            if prev is not None:
                prev["leases"].discard(rec["bucket"])
        elif ev == "lease_release":
            self._host(rec["host"])["leases"].discard(rec["bucket"])
        elif ev == "bucket_open":
            self.serve_buckets[rec["bucket"]] = {
                k: v for k, v in rec.items() if k != "ev"}
        elif ev == "admit":
            rid = rec["run_id"]
            prev = self.admits.get(rid)
            if prev is not None \
                    and prev.get("config") != rec.get("config"):
                raise SweepJournalError(
                    f"world {rid!r} is double-admitted with "
                    f"DIFFERENT configs — refusing to pick one:\n"
                    f"  first:  {prev.get('config')}\n"
                    f"  second: {rec.get('config')}")
            # same config: either an idempotent client re-submit (a
            # retried lost reply — harmless by design) or a repack
            # re-point to the merged bucket. A re-point (marked
            # ``repacked_from``) beats an original REGARDLESS of
            # merge order — cross-host wall clocks order the merge,
            # and a skewed clock must not resurrect the donor bucket
            # (which closed at repack); among records of equal
            # authority, last wins
            if prev is None or "repacked_from" in rec \
                    or "repacked_from" not in prev:
                self.admits[rid] = {
                    k: v for k, v in rec.items() if k != "ev"}
        elif ev == "repack":
            self.repacks.append(
                {k: v for k, v in rec.items() if k != "ev"})
        elif ev == "serve_drain":
            self.draining = True
        elif ev == "pack_decision":
            d = {k: v for k, v in rec.items() if k != "ev"}
            self.pack_decisions.append(d)
            if "members" in d:
                # the sweep plan form: exactly one per bucket. A
                # duplicate with identical membership is a resumed
                # service re-journaling its replayed plan (harmless);
                # DIFFERENT membership for one bucket id is the
                # unforgivable state — a resumed sweep would load
                # checkpoints planned for other worlds
                prev = self.pack_plan.get(d["bucket"])
                if prev is not None:
                    knobs = ("members", "mode", "artifact_sha")
                    if any(prev.get(k) != d.get(k) for k in knobs):
                        raise SweepJournalError(
                            f"bucket {d['bucket']!r} is "
                            f"double-journaled with DIFFERENT pack "
                            f"decisions — refusing to pick one:\n"
                            f"  first:  {prev}\n  second: {d}")
                    _log.warning("sweep journal: duplicate pack "
                                 "decision for bucket %r (identical "
                                 "membership)", d["bucket"])
                else:
                    self.pack_plan[d["bucket"]] = d
        elif ev == "dispatch_decision":
            dl = self.decisions.setdefault(rec["bucket"], [])
            d = rec["decision"]
            dup = next((p for p in dl
                        if p["chunk"] == d["chunk"]), None)
            if dup is not None:
                knobs = ("window_us", "rung_pin", "chunk_len")
                if any(dup[k] != d[k] for k in knobs):
                    # the one unforgivable controller state: two
                    # different decisions claim the same chunk —
                    # a replayed resume would match neither run
                    raise SweepJournalError(
                        f"bucket {rec['bucket']!r} chunk "
                        f"{d['chunk']} is double-journaled with "
                        f"DIFFERENT dispatch decisions — "
                        f"refusing to pick one:\n  first:  {dup}"
                        f"\n  second: {d}")
                _log.warning("sweep journal: duplicate dispatch "
                             "decision for bucket %r chunk %d "
                             "(identical knobs)", rec["bucket"],
                             d["chunk"])
            else:
                dl.append(d)

    def event_counts(self) -> Dict[str, int]:
        """The journal's telemetry-event tallies in one block — the
        ``events`` field of ``sweep status --json`` AND the live
        ``sweep watch`` aggregates, computed from the same fold so
        the two surfaces report identical numbers by construction."""
        return {
            "dispatch_decision": sum(len(v)
                                     for v in self.decisions.values()),
            "spec_rollback": len(self.spec_rollbacks),
            "integrity_violation": len(self.integrity),
            "pack_decision": len(self.pack_decisions),
        }

    def decision_chain(self, bucket_id: str) -> List[dict]:
        """Every decision record governing ``bucket_id``'s worlds, in
        chunk order. A split child (``b3.0.1``) continued its parent's
        chunk numbering from the parent's checkpoint, so the chain is
        the ancestor prefixes (``b3``, ``b3.0``) plus the child's own
        records — the sequence a solo replay twin re-applies. Dedup by
        chunk index (ancestor first): a chunk the parent decided but
        never durably executed is reused, not re-decided, by the
        child (sweep/runner.py)."""
        parts = bucket_id.split(".")
        ids = [".".join(parts[:i + 1]) for i in range(len(parts))]
        out: List[dict] = []
        seen: Set[int] = set()
        for bid in ids:
            for d in self.decisions.get(bid, []):
                if d["chunk"] not in seen:
                    seen.add(d["chunk"])
                    out.append(d)
        return sorted(out, key=lambda d: d["chunk"])

    # -- the serving fleet's folded views (serve/, docs/serving.md) ------

    def _host(self, name: str) -> dict:
        return self.hosts.setdefault(name, {
            "leases": set(), "last_heartbeat": None, "stolen": 0,
            "stolen_buckets": [], "listen": None})

    def hosts_block(self) -> Dict[str, dict]:
        """The per-host lease table for ``sweep status --json`` and
        the live watch — one assembly over the one fold, so the two
        surfaces agree by construction. ``last_heartbeat`` is the
        journaled wall ts (deterministic from the fold); readers
        derive heartbeat *age* from it at render time."""
        return {name: {
            "leases": sorted(h["leases"]),
            "last_heartbeat": h["last_heartbeat"],
            "stolen": h["stolen"],
            "stolen_buckets": list(h["stolen_buckets"]),
            "listen": h["listen"],
        } for name, h in sorted(self.hosts.items())}

    def serve_block(self) -> Dict[str, Any]:
        """Admission/steal/repack rollup of a service journal — what
        the ledger ingests as the ``serve`` kind and ``sweep status``
        surfaces next to the hosts block."""
        return {
            "admitted": len(self.admits),
            "open_buckets": sorted(self.serve_buckets),
            "steals": sum(h["stolen"] for h in self.hosts.values()),
            "repacks": len(self.repacks),
            "draining": self.draining,
        }


class SweepJournal:
    def __init__(self, root: str, host: Optional[str] = None) -> None:
        self.root = root
        #: multi-host mode (module docstring): this process's own
        #: append file; merged reads see every host's file
        self.host = host
        self.path = os.path.join(
            root, f"journal-{host}.jsonl" if host else "journal.jsonl")
        self.pack_path = os.path.join(root, "pack.json")
        self._fh = None
        self._seq = 0
        self._last_ts = 0.0
        # one process may append from two threads sharing a handle
        # (the serve frontend's event loop + its embedded curator,
        # serve/frontend.py) — the lock keeps lines whole and seq
        # stamps unique; cross-PROCESS writers use per-host files
        import threading
        self._wlock = threading.Lock()
        #: optional observability hook: called as ``on_append(ev,
        #: wall_s)`` after every durable append — the sweep service
        #: wires it to the Perfetto timeline so fsync stalls are
        #: visible (obs/perfetto.py). Purely additive: the append's
        #: durability contract does not depend on it.
        self.on_append = None

    # -- writing -----------------------------------------------------------

    def ensure_dir(self) -> None:
        os.makedirs(self.root, exist_ok=True)

    def write_pack(self, pack) -> None:
        """Atomically persist the pack (resume's source of truth)."""
        from ..utils.checkpoint import atomic_write
        self.ensure_dir()

        def write(f):
            json.dump(pack.to_json(), f, indent=1, sort_keys=True)
            f.write("\n")
        atomic_write(self.pack_path, write, mode="w")

    def append(self, rec: Dict[str, Any]) -> None:
        """Durable append: the record is on disk (flushed + fsync'd)
        before this returns — the crash-safety contract every caller
        leans on."""
        import time as _time
        t0 = _time.perf_counter()
        with self._wlock:
            if self._fh is None:
                self.ensure_dir()
                self._fh = open(self.path, "a")
            if self.host is not None:
                # the multi-host merge stamp: per-host seq (causal
                # order within a file) + a ts kept monotone per handle
                # so the (ts, host, seq) merge sort can never invert
                # one host's own appends even across a wall-clock
                # step back
                self._seq += 1
                self._last_ts = max(self._last_ts, _time.time())
                rec = {**rec, "host": self.host, "seq": self._seq,
                       "ts": round(self._last_ts, 6)}
            self._fh.write(json.dumps(rec, sort_keys=True) + "\n")
            self._fh.flush()
            os.fsync(self._fh.fileno())
        if self.on_append is not None:
            self.on_append(rec.get("ev", "?"),
                           _time.perf_counter() - t0)

    def maybe_heartbeat(self, min_interval_s: float = 1.0) -> None:
        """Journal a throttled ``host_heartbeat`` (multi-host mode
        only) — the fold's ``last_heartbeat`` behind the hosts block's
        heartbeat-age view. The lease files carry the load-bearing
        liveness (lease.py); this is the observability mirror."""
        if self.host is None:
            return
        import time as _time
        now = _time.monotonic()
        if now - getattr(self, "_hb_mono", 0.0) >= min_interval_s:
            self._hb_mono = now
            self.append({"ev": "host_heartbeat", "host": self.host})

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def checkpoint_path(self, bucket_id: str) -> str:
        return os.path.join(self.root, f"bucket-{bucket_id}.npz")

    # -- reading -----------------------------------------------------------

    def journal_files(self) -> List[str]:
        """Every journal file in the directory: the single-host
        ``journal.jsonl`` (if present) plus every per-host
        ``journal-<name>.jsonl``, in sorted order."""
        out = []
        single = os.path.join(self.root, "journal.jsonl")
        if os.path.exists(single):
            out.append(single)
        out.extend(sorted(
            p for p in _glob.glob(os.path.join(self.root,
                                               "journal-*.jsonl"))
            if p != single))
        return out

    def exists(self) -> bool:
        return bool(self.journal_files())

    def _parse_file(self, path: str) -> List[dict]:
        with open(path) as f:
            lines = f.read().splitlines()
        out: List[dict] = []
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError as e:
                if i == len(lines) - 1:
                    _log.warning(
                        "sweep journal %s: dropping torn final line "
                        "(crash mid-append): %r", path, line[:80])
                    continue
                raise SweepJournalError(
                    f"sweep journal {path!r} line {i + 1} is "
                    f"corrupt mid-file ({e}); a crash can only tear "
                    "the last line — this journal has been damaged "
                    "externally") from None
        return out

    def records(self) -> List[dict]:
        """Parse the log(s). A torn *final* line (crash mid-append) is
        dropped with a warning — per file: in multi-host mode any host
        may have crashed mid-append; an unparsable line anywhere else
        is corruption and fails loudly. Multiple host files merge
        sorted by ``(ts, host, seq)`` (module docstring)."""
        files = self.journal_files()
        if not files:
            return []
        if len(files) == 1 and files[0] == os.path.join(
                self.root, "journal.jsonl"):
            # the single-host fast path: exactly the pre-serve reader
            return self._parse_file(files[0])
        recs = [r for p in files for r in self._parse_file(p)]
        return sorted(recs, key=merge_key)

    def scan(self) -> JournalState:
        st = JournalState()
        for rec in self.records():
            try:
                st.apply(rec)
            except SweepJournalError as e:
                # re-raise with the file named (apply is path-free so
                # the live watch tail can share it verbatim)
                raise SweepJournalError(
                    f"sweep journal {self.path!r}: {e}") from None
        return st


def util_rollup(util: Dict[str, dict]) -> Dict[str, float]:
    """Fleet-level packing efficiency from the per-bucket
    ``bucket_util`` records (sweep/runner.py, serve/worker.py): the
    work-weighted ``budget_efficiency`` (world supersteps over every
    slot-superstep the batched scans paid for) and ``pad_waste_frac``
    (pow2 scan-pad supersteps over scan supersteps), across all
    buckets. THE two numbers the predictive packer is gated on —
    surfaced on the sweep_hetero/serve_gossip bench lines and
    promoted to `ledger compare` metrics (obs/regress.py), so a
    packing regression is a gateable rate regression."""
    world = scan_total = pad = slot_total = 0.0
    for u in util.values():
        s = float(u.get("scan_supersteps", 0) or 0)
        world += float(u.get("world_supersteps", 0) or 0)
        scan_total += s
        slot_total += float(u.get("worlds", 0) or 0) * s
        pad += float(u.get("pad_waste_frac", 0.0) or 0.0) * s
    return {
        "budget_efficiency": round(world / slot_total, 4)
        if slot_total else 1.0,
        "pad_waste_frac": round(pad / scan_total, 4)
        if scan_total else 0.0,
    }


def status_fields(scan: JournalState,
                  total_worlds: Optional[int]) -> Dict[str, Any]:
    """The shared progress block behind ``sweep status --json`` and
    the final aggregates of ``sweep watch`` (obs/watch.py): ONE
    assembly over one fold, so the two surfaces are equal by
    construction. ``total_worlds`` is the pack's world count (None
    when a watcher attached before ``pack.json`` was written)."""
    done, failed = len(scan.done), len(scan.failed)
    out = {
        "worlds": total_worlds, "completed": done,
        "failed": sorted(scan.failed),
        "pending": (None if total_worlds is None
                    else total_worlds - done - failed),
        "retries": scan.retries,
        "splits": {k: v for k, v in scan.splits.items()},
        "buckets_done": sorted(scan.bucket_done),
        # per-bucket hardware utilization (sweep/runner.py): how well
        # the batched executables were used — worlds-active occupancy,
        # budget-mask efficiency, pow2 scan-pad waste
        "utilization": scan.util,
        # detected-and-rolled-back state corruptions (integrity/):
        # a nonzero count on real hardware means an SDC-prone host
        "integrity_violations": scan.integrity,
        # detected-and-rolled-back causality violations (speculate/):
        # the misspeculation ledger — each one a speculative window
        # probe the policy backed off from (docs/speculation.md)
        "spec_rollbacks": scan.spec_rollbacks,
        # the journal's event tallies in one block (event_counts):
        # dispatch decisions, speculation rollbacks, integrity
        # violations — the cross-run ledger ingests exactly this
        "events": scan.event_counts(),
        # per-world flight-recorder event counts (obs/flight.py) —
        # present when the sweep ran with --record; the events
        # themselves live in <journal>/events.jsonl (query with
        # `timewarp-tpu explain`)
        "flight_events": scan.flight,
        "pack_sha": scan.pack_sha}
    if scan.hosts or scan.admits or scan.serve_buckets:
        # the serving fleet's blocks (serve/, docs/serving.md) —
        # present ONLY when host/lease/admission events exist, so a
        # plain single-host sweep's status line stays byte-identical
        # to the pre-serve service
        out["hosts"] = scan.hosts_block()
        out["serve"] = scan.serve_block()
    return out

"""Live sweep watch: a read-only tail over a running sweep's journal
and metrics streams (the port's copy of ``timewarp_tpu/obs/watch.py``,
folded through the port's ``sweep/journal.py``).

``timewarp-tpu sweep status`` is a snapshot you poll by hand;
``timewarp-tpu sweep watch`` attaches to the journal directory and
renders refreshing aggregates while the sweep runs: buckets in
flight, worlds done (and done/sec), retry / speculation-rollback /
integrity-violation counts, utilization — the mission-control face
of the fleet.

Hard properties, by construction:

- **Read-only.** The watcher opens ``journal.jsonl`` /
  ``metrics.jsonl`` / ``pack.json`` for reading only — it can never
  perturb the sweep, its journal, or the survival law's compare
  surface (a post-run ``sweep resume --verify`` is oblivious to any
  number of attached watchers).
- **Torn-tail tolerant.** The journal's appends are whole fsync'd
  lines, but a watcher can catch one mid-write: :class:`TailReader`
  consumes only newline-complete lines and leaves a torn tail in
  place for the next poll — the same crash model
  :meth:`~timewarp_tpu_torch.sweep.journal.SweepJournal.records` applies
  to the final line, incrementalized.
- **Status-equal.** Records fold through
  :meth:`~timewarp_tpu_torch.sweep.journal.JournalState.apply` — the SAME
  fold ``sweep status`` scans with — and the snapshot's shared
  fields come from the same :func:`~timewarp_tpu_torch.sweep.journal.
  status_fields` assembly, so a watcher's final aggregates equal
  ``sweep status --json`` exactly (pinned in
  tests/test_zzzzzzzledger.py).

Output contract: plain append-only stdout lines, one per refresh in
which anything changed — no escape codes, no keybinds, no terminal
control — so ``sweep watch | tee`` and CI logs read identically to a
terminal (``--json`` swaps the text line for one JSON object per
refresh).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from ..sweep.journal import JournalState, status_fields

__all__ = ["TailReader", "SweepWatch"]


class TailReader:
    """Incremental, torn-tail-tolerant JSONL reader (read-only).

    Consumes bytes from a growing file in whole newline-terminated
    lines; an incomplete tail (a writer caught mid-append) stays
    unconsumed until its newline lands. A complete line that fails to
    parse is counted in ``parse_errors``, never raised — a watcher
    must keep watching."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._off = 0
        self.parse_errors = 0

    def poll(self) -> List[dict]:
        """Every newly completed record since the last poll."""
        if not os.path.exists(self.path):
            return []
        with open(self.path, "rb") as f:
            f.seek(self._off)
            buf = f.read()
        end = buf.rfind(b"\n")
        if end < 0:
            return []               # nothing complete yet
        chunk = buf[:end + 1]
        self._off += end + 1
        out: List[dict] = []
        for raw in chunk.splitlines():
            if not raw.strip():
                continue
            try:
                out.append(json.loads(raw))
            except json.JSONDecodeError:
                self.parse_errors += 1
        return out


class SweepWatch:
    """Fold a sweep directory's streams into refreshing aggregates."""

    def __init__(self, journal_dir: str) -> None:
        self.root = journal_dir
        #: journal tails, one per file — multi-host journals
        #: (journal-<host>.jsonl, serve/ + docs/serving.md) are
        #: discovered per poll so a host that joins mid-watch is
        #: picked up; single-host dirs tail journal.jsonl exactly as
        #: before
        self._journal_tails: Dict[str, TailReader] = {}
        self.metrics = TailReader(os.path.join(journal_dir,
                                               "metrics.jsonl"))
        self.state = JournalState()
        self.finished = False
        #: buckets started but not yet done/split — "in flight"
        self._open_buckets: set = set()
        self._total_worlds: Optional[int] = None
        #: metrics-stream aggregates (kind counts + superstep total)
        self.metric_kinds: Dict[str, int] = {}
        self.metric_supersteps = 0
        self._t0 = time.monotonic()
        self._done0: Optional[int] = None

    # -- folding -----------------------------------------------------------

    def _apply_journal(self, rec: Dict[str, Any]) -> None:
        self.state.apply(rec)       # the one shared fold (journal.py)
        ev = rec.get("ev")
        if ev == "bucket_start":
            self._open_buckets.add(rec.get("bucket"))
        elif ev in ("bucket_done", "bucket_split"):
            self._open_buckets.discard(rec.get("bucket"))
        elif ev in ("sweep_done", "serve_done"):
            self.finished = True

    def _apply_metrics(self, rec: Dict[str, Any]) -> None:
        k = rec.get("kind")
        if not isinstance(k, str):
            return
        self.metric_kinds[k] = self.metric_kinds.get(k, 0) + 1
        if k == "supersteps":
            s = rec.get("supersteps")
            if isinstance(s, int):
                self.metric_supersteps += s

    def _poll_journal(self) -> List[dict]:
        """New records across every journal file, merge-sorted by the
        same ``(ts, host, seq)`` key :meth:`SweepJournal.records`
        uses — so a watch over a finished multi-host journal folds in
        the exact order ``sweep status``'s scan does. (A LIVE
        multi-host watch can see cross-poll inversions — a slow
        host's old record arriving after a fast host's new one — but
        the fold is commutative on everything except the loud
        double-journal refusals, which compare content, not order.)"""
        from ..sweep.journal import SweepJournal, merge_key
        fresh: List[dict] = []
        for p in SweepJournal(self.root).journal_files():
            tail = self._journal_tails.get(p)
            if tail is None:
                tail = self._journal_tails[p] = TailReader(p)
            fresh.extend(tail.poll())
        fresh.sort(key=merge_key)
        return fresh

    @property
    def parse_errors_total(self) -> int:
        return (sum(t.parse_errors
                    for t in self._journal_tails.values())
                + self.metrics.parse_errors)

    def poll(self) -> Dict[str, Any]:
        """Consume everything new and return the current snapshot."""
        for rec in self._poll_journal():
            self._apply_journal(rec)
        for rec in self.metrics.poll():
            self._apply_metrics(rec)
        if self._total_worlds is None:
            pack = os.path.join(self.root, "pack.json")
            if os.path.exists(pack):
                try:
                    with open(pack) as f:
                        self._total_worlds = len(json.load(f))
                except (json.JSONDecodeError, OSError):
                    pass            # mid-atomic-write; next poll
        done = len(self.state.done)
        if self._done0 is None:
            # worlds completed before we attached don't count toward
            # the observed rate — only progress we actually saw
            self._done0 = done
        return self.snapshot()

    # -- snapshots ---------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The shared ``sweep status --json`` fields (identical by
        construction: same fold, same assembly) plus watch-only
        extras under keys status does not use."""
        total = self._total_worlds
        if total is None and self.state.admits:
            # a serve journal has no pack — the admission ledger is
            # the world count (exactly what `sweep status` uses)
            total = len(self.state.admits)
        snap = status_fields(self.state, total)
        elapsed = time.monotonic() - self._t0
        seen = len(self.state.done) - (self._done0 or 0)
        snap["watch"] = {
            "buckets_in_flight": sorted(
                b for b in self._open_buckets if b is not None),
            "elapsed_s": round(elapsed, 3),
            "worlds_done_per_s": round(seen / elapsed, 4)
            if elapsed > 0 else 0.0,
            "finished": self.finished,
            "metrics_kinds": dict(self.metric_kinds),
            "metrics_supersteps": self.metric_supersteps,
            "parse_errors": self.parse_errors_total,
        }
        return snap

    def render(self, snap: Dict[str, Any]) -> str:
        """One plain text line per refresh (module docstring output
        contract)."""
        w = snap["watch"]
        worlds = snap["worlds"] if snap["worlds"] is not None else "?"
        ev = snap["events"]
        util = snap["utilization"]
        parts = [
            f"worlds {snap['completed']}/{worlds} done"
            + (f", {len(snap['failed'])} failed" if snap["failed"]
               else ""),
            f"buckets {len(w['buckets_in_flight'])} in flight / "
            f"{len(snap['buckets_done'])} done",
            f"retries {snap['retries']}",
            "events "
            f"decision={ev['dispatch_decision']} "
            f"spec_rollback={ev['spec_rollback']} "
            f"integrity={ev['integrity_violation']}",
        ]
        if util:
            import statistics
            eff = statistics.mean(
                u.get("budget_efficiency", 1.0)
                for u in util.values())
            parts.append(f"util eff {eff:.2f}")
            builds = sum(u.get("engine_builds", 0)
                         for u in util.values())
            if builds:
                # the zero-recompile serving law's live face: builds
                # should track bucket count, never admission count
                parts.append(f"engine builds {builds}")
        if w["metrics_kinds"]:
            parts.append(
                f"metrics {sum(w['metrics_kinds'].values())} lines")
        hosts = snap.get("hosts")
        if hosts:
            # the serving fleet's per-host line: leases held,
            # heartbeat AGE (derived at render time from the folded
            # ts — the folded fields themselves stay deterministic),
            # stolen-bucket counts
            now = time.time()
            bits = []
            for name, h in hosts.items():
                hb = h.get("last_heartbeat")
                age = f"{now - hb:.1f}s" if hb is not None else "?"
                bits.append(f"{name}:{len(h['leases'])}lease"
                            f"/hb {age}"
                            + (f"/stole {h['stolen']}"
                               if h["stolen"] else ""))
            parts.append("hosts " + " ".join(bits))
        parts.append(f"{w['worlds_done_per_s']:g} worlds/s")
        status = "DONE" if w["finished"] else "live"
        return f"sweep {status} | " + " | ".join(parts)

"""Per-bucket execution: chunked, checkpointed, digest-chained
(the port's copy of ``timewarp_tpu/sweep/runner.py``).

A :class:`BucketRunner` owns one bucket's engine and drives it one
chunk at a time (``engine.run`` with per-world remaining budgets —
the vector-budget driver; the active/remaining bookkeeping is the
engine's own ``fleet_progress``, shared with ``run_stream`` so the
quiesce law cannot drift between drivers). Every chunk:

1. the injection hook fires (the deterministic chaos the CI smoke and
   tests use to provoke retries / OOM splits / mid-sweep kills);
2. worlds that have quiesced or exhausted their budget since the last
   chunk stream their result record to the journal — **as they
   finish**, not at bucket end;
3. the chunk runs; each world's digest chain and superstep count
   advance;
4. the bucket checkpoint is atomically rewritten, its meta carrying
   the digest chains — so a killed sweep resumes the digests exactly
   where the state is.

Methods here are *blocking* (they launch the bucket engine's
kernels and wait for their results); the service (service.py) calls
them through ``AwaitIO`` on an executor thread so its watchdogs stay
live. On the card every call launches on the thread's current stream —
the default stream, shared by an abandoned attempt's thread and its
retry — and every host read waits for what was queued before it; the
kernel wrappers allocate their outputs and scratch afresh each call, and
a retry reloads its state from the checkpoint into new tensors, so a
zombie attempt's launches never touch the retry's memory.

Zombie safety: a watchdog-abandoned attempt's thread may still be
inside a chunk when the retry starts. Attempts are therefore
*epoch-stamped*: the service passes each blocking call the epoch it
belongs to, the watchdog's :meth:`abandon` invalidates that epoch,
and every commit (journal append, checkpoint write, in-memory
state/digest update) happens under a lock only if the call's epoch is
still current — a stale thread raises :class:`StaleAttempt` and can
never corrupt the retry's digest chain or double-journal a world.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Dict, List, Optional, Set

import numpy as np

from .bucket import Bucket, build_bucket_engine
from .journal import SweepJournal
from .spec import DIGEST_ZERO, chain_digest, result_leaves, world_result

__all__ = ["BucketRunner", "StaleAttempt", "scan_pad"]


def scan_pad(max_steps: int) -> int:
    """The reference's scan length for a ``max_steps`` budget: the next
    power of two (its traced drivers round every budget up to one, and
    mask the tail). The port's driver runs no pad, so this is the
    utilization ledger's accounting only: ``bucket_util`` records the
    same ``scan_supersteps`` and ``pad_waste_frac`` as the reference's
    for the same pack, and the packing gates compare the same numbers."""
    if max_steps <= 0:
        return 0
    return 1 << (max_steps - 1).bit_length()


class StaleAttempt(RuntimeError):
    """A watchdog-abandoned thread outlived its attempt: every write
    path refuses it (raised on an executor thread whose future the
    supervisor already dropped — nobody observes it, by design)."""


class BucketRunner:
    def __init__(self, bucket: Bucket, journal: SweepJournal,
                 done: Dict[str, dict], *, lint: str = "warn",
                 chunk: int = 64, inject=None,
                 telemetry: str = "off", metrics=None,
                 prior_decisions=(), verify: str = "off",
                 record: str = "off", flight=None,
                 device=None) -> None:
        self.bucket = bucket
        #: the bucket engine's device (the card unless the caller asks
        #: for the CPU; resolved when the engine is built)
        self.device = device
        self.journal = journal
        #: shared run_id -> result map (journaled results land here
        #: too, so the service reports without rescanning the log)
        self.done = done
        self.lint = lint
        self.chunk = int(chunk)
        self.inject = inject
        #: online adaptive dispatch (dispatch/, docs/dispatch.md):
        #: controller buckets decide window/rung/chunk-length per
        #: chunk, journal each FRESH decision before its chunk runs
        #: (under the epoch lock — a zombie attempt can neither
        #: decide nor journal), and REPLAY `prior_decisions` (the
        #: journaled chain, resume/split) instead of re-deciding
        self.ctrl = None
        self.prior_decisions = list(prior_decisions)
        #: optimistic time-warp execution (speculate/,
        #: docs/speculation.md): speculate buckets run under a
        #: SpeculationPolicy — the same decide/replay surface as the
        #: controller, PLUS rollback. Two discipline differences:
        #: decisions journal at COMMIT (the policy is a pure function
        #: of its committed chain — no telemetry to lose in a crash,
        #: so re-deciding after a kill is bit-deterministic), and a
        #: SpeculationViolation from the chunk rolls just this chunk
        #: back (state uncommitted, decision replaced with the floor)
        #: instead of surfacing to the retry machinery.
        self._spec = bucket.speculate != "off"
        #: chunk indices whose decisions are durably journaled — the
        #: commit-time journaling ledger (prior_decisions arriving
        #: from a resume scan are journaled by definition; a split
        #: parent's in-flight unjournaled decision is filtered out in
        #: split_children)
        self._journaled = {d["chunk"] if isinstance(d, dict)
                           else d.chunk for d in self.prior_decisions}
        #: chunks durably executed (checkpoint meta "chunks") — the
        #: next decision's index
        self.chunks = 0
        #: engine telemetry mode + optional obs.metrics.MetricsRegistry
        #: (the engine chunk-flushes `supersteps` lines into it)
        self.telemetry = telemetry
        self.metrics = metrics
        #: causal flight recorder (obs/flight.py): bucket engines
        #: built with record= thread the event plane; each chunk's
        #: per-world logs drain into the shared ``flight`` writer
        #: (<journal>/events.jsonl) tagged with the world's run_id,
        #: and per-world event counts are journaled for `sweep
        #: status`. Retried chunks may re-drain — events.jsonl is an
        #: observability artifact, deliberately OUTSIDE the survival
        #: law's compare surface (duplicates are harmless; the
        #: superstep indices make them identifiable)
        self.record = record
        self.flight = flight
        self.flight_counts: Dict[str, int] = {}
        #: per-world [(supersteps, trace-digest chain), ...] trail —
        #: the prefix values of the row chain at each chunk boundary.
        #: Journaled on the world_done record (outside "result") and
        #: persisted in checkpoint meta, it is what --verify's
        #: auto-bisect compares against the solo twin to name the
        #: first diverging chunk (obs/bisect.first_trail_divergence)
        self.trails: Optional[List[list]] = None
        #: online state-integrity mode (integrity/, docs/integrity.md):
        #: "guard" builds the bucket engine with the on-device
        #: invariant plane; "digest" additionally keeps a per-world
        #: rolling state digest, verified at every chunk ENTRY and
        #: chained into the checkpoint meta — each checkpoint is a
        #: verified epoch, and detection raises IntegrityViolation
        #: (the service journals it and retries from that checkpoint:
        #: deterministic rollback of just this bucket)
        self.verify = verify
        #: per-world uint32 state digests at the last verified epoch
        self.vdigests = None
        #: per-world sha256 digest chain over the verified epochs
        self.vchain: Optional[List[str]] = None
        self.attempts = 0
        #: multi-host mode (serve/lease.py, docs/serving.md): the
        #: bucket lease this runner executes under — renewed at every
        #: chunk entry (the heartbeat) and CHECKED before every
        #: journal commit, so a host whose lease was reclaimed (it
        #: stalled past the TTL and a peer stole the bucket) abandons
        #: via LeaseLost instead of double-journaling. None in
        #: single-host mode: zero behavior change.
        self.lease = None
        self.lease_dir = None
        #: attempt generation (module docstring): bumped by
        #: begin_attempt and by abandon, so a zombie thread's stamped
        #: epoch can never match again
        self.epoch = 0
        self._lock = threading.Lock()
        self.engine = None
        self.state = None
        self.digests: Optional[List[str]] = None
        self.supersteps: Optional[List[int]] = None
        self.emitted: Optional[Set[str]] = None
        #: wall seconds this process has spent running the bucket's
        #: chunks (stamped onto world_done records — observability
        #: metadata OUTSIDE the result dict, so the sweep survival law
        #: and resume's replay-equality check never see it)
        self.wall_s = 0.0
        #: hardware-utilization accumulators (journaled as a
        #: `bucket_util` record when the bucket completes): how much
        #: of the batched engine's width and of the reference's
        #: pow2-padded scan length (:func:`scan_pad`) did real
        #: (unmasked, unpadded) supersteps use. ``compiles`` stays 0:
        #: the port compiles nothing per run (its kernels build once)
        self.util = {"chunks": 0, "world_supersteps": 0,
                     "scan_supersteps": 0, "pad_supersteps": 0,
                     "active_world_chunks": 0,
                     "engine_builds": 0, "compiles": 0}

    # -- attempt lifecycle (called from the event-loop thread) -----------

    def begin_attempt(self) -> int:
        """Start a new attempt generation; returns its epoch (stamped
        onto every blocking call of this attempt)."""
        with self._lock:
            self.epoch += 1
            return self.epoch

    def abandon(self, epoch: int) -> None:
        """Watchdog: invalidate ``epoch`` if it is still current —
        the abandoned thread's writes all fail their epoch check."""
        with self._lock:
            if self.epoch == epoch:
                self.epoch += 1

    def _check(self, epoch: Optional[int]) -> None:
        if epoch is not None and epoch != self.epoch:
            raise StaleAttempt(
                f"bucket {self.bucket.bucket_id!r}: attempt epoch "
                f"{epoch} was abandoned (current {self.epoch})")

    def _lease_renew(self) -> None:
        """Chunk-entry heartbeat (multi-host mode): raises LeaseLost
        when the bucket was reclaimed by a peer."""
        if self.lease is not None:
            self.lease_dir.renew(self.lease)
            self.journal.maybe_heartbeat()

    def _lease_check(self) -> None:
        """Pre-commit guard (multi-host mode): never journal for a
        bucket we no longer hold."""
        if self.lease is not None:
            self.lease_dir.check(self.lease)

    # -- blocking entry points (run on an executor thread) ---------------

    def prepare(self, epoch: Optional[int] = None) -> None:
        """Build the engine (once) and (re)load the bucket state from
        its checkpoint — every retry restarts exactly here, so a
        transient crash costs at most one chunk of progress."""
        self._check(epoch)
        engine = self.engine
        ctrl = self.ctrl
        if engine is None:
            if self.bucket.controller:
                from ..dispatch import DispatchController
                # the operator's --chunk stays the CEILING: it bounds
                # memory per executable and checkpoint granularity (a
                # crash loses at most one chunk) — the controller
                # adapts downward within it, never past it
                ctrl = DispatchController(
                    mode="auto", chunk=self.chunk,
                    chunk_min=min(8, self.chunk),
                    chunk_max=self.chunk,
                    replay=self.prior_decisions)
            elif self._spec:
                from ..speculate import parse_speculate
                from ..speculate.policy import SpeculationPolicy
                mode, w = parse_speculate(self.bucket.speculate)
                # the journaled chain replays as a PREFIX (mode stays
                # auto/fixed): committed chunks re-apply verbatim,
                # the in-flight chunk re-decides — identically, the
                # policy being a pure function of that chain
                ctrl = SpeculationPolicy(
                    mode=mode, fixed_w=w, chunk=self.chunk,
                    replay=self.prior_decisions or None)
            engine = build_bucket_engine(
                self.bucket, lint=self.lint, telemetry=self.telemetry,
                # a SpeculationPolicy is the runner's host-side
                # decision source, never an engine binding — the
                # engine's own speculate= knob (bucket.speculate,
                # build_bucket_engine) licenses the dynamic window
                controller=ctrl if self.bucket.controller else None,
                record=self.record,
                # digest mode includes the guard rung of the ladder
                # (the in-scan invariants); the digest itself is this
                # runner's chunk-boundary business
                verify="off" if self.verify == "off" else "guard",
                device=self.device)
            engine.metrics = self.metrics
        path = self.journal.checkpoint_path(self.bucket.bucket_id)
        B = self.bucket.B
        if os.path.exists(path):
            from ..utils.checkpoint import load_state
            st, meta = load_state(
                path, engine.init_state(),
                expect_meta={"bucket": self.bucket.bucket_id,
                             "run_ids": list(self.bucket.run_ids)},
                scenario=engine.scenario)
            digests = list(meta["digests"])
            supersteps = [int(s) for s in meta["supersteps"]]
            chunks = int(meta.get("chunks", 0))
            trails = [list(t) for t in meta["trail"]] \
                if "trail" in meta else [[] for _ in range(B)]
        else:
            st = engine.init_state()
            meta = None
            digests = [DIGEST_ZERO] * B
            supersteps = [0] * B
            chunks = 0
            trails = [[] for _ in range(B)]
        vdigests = vchain = None
        if self.verify == "digest":
            # a restored checkpoint must match the digests its meta
            # recorded (the verified-epoch contract): the per-leaf
            # sha in utils/checkpoint.py caught at-rest disk
            # corruption; this catches a chain that was broken before
            # the checkpoint was even written (and seeds the chain
            # the coming chunks extend). The recompute runs every
            # retry, so resuming onto corrupt state is impossible.
            from ..integrity.checks import IntegrityViolation
            from ..integrity.digest import (VERIFY_CHAIN_ZERO,
                                            first_digest_mismatch,
                                            host_digests)
            vdigests = host_digests(st, engine.batch,
                                    engine.scenario.u32_states)
            if meta is not None and "state_digests" in meta:
                hit = first_digest_mismatch(vdigests,
                                            meta["state_digests"])
                if hit is not None:
                    bad, got_h, want_h = hit
                    raise IntegrityViolation(
                        f"bucket {self.bucket.bucket_id!r} checkpoint "
                        f"{path!r} world {bad}: restored state digest "
                        f"{got_h} != recorded {want_h} "
                        "— the checkpoint is not the verified epoch "
                        "its meta claims (docs/integrity.md)")
                vchain = list(meta["verify_chain"])
            else:
                vchain = [VERIFY_CHAIN_ZERO] * B
        with self._lock:
            self._check(epoch)
            if self.engine is None:
                self.engine = engine
                self.util["engine_builds"] += 1
                self.ctrl = ctrl
                if ctrl is not None:
                    ctrl.begin(engine)
            self.state = st
            self.digests = digests
            self.supersteps = supersteps
            self.chunks = chunks
            self.trails = trails
            self.vdigests = vdigests
            self.vchain = vchain
            self.emitted = set(self.done)
            # a retry restarts from the checkpoint: the telemetry the
            # in-flight chunk produced is gone, which is exactly why
            # its journaled decision (if any) is REUSED, not re-made
            if self.engine is not None:
                self.engine.last_run_telemetry = None

    def fault_pad(self):
        """The engine's realized fault-table pad shape — what split
        children must pad to so the sliced ``restart_done`` state
        keeps its shape (bucket.py)."""
        from ..faults.schedule import FaultFleet
        if self.engine is None or not isinstance(self.engine.faults,
                                                 FaultFleet):
            return None
        return self.engine.faults._pad_shape()

    def step(self, epoch: Optional[int] = None) -> str:
        """One chunk (module docstring). Returns ``"running"`` or
        ``"done"`` (every world's result is journaled)."""
        self._check(epoch)
        self._lease_renew()
        if self.inject is not None:
            self.inject()
            # the flip: form corrupts the in-memory state between
            # chunks (integrity/inject.py) — exactly the window the
            # entry digest check below covers
            hook = getattr(self.inject, "flip_hook", None)
            if hook is not None:
                hook(self)
        eng = self.engine
        if self.verify == "digest" and self.vdigests is not None:
            # chunk-entry verification: the state arrays did not
            # legitimately change since the last verified epoch, so
            # any digest movement is corruption at rest — detected
            # BEFORE the corrupt state runs a superstep. The raise
            # unwinds to the service, which journals the
            # integrity_violation and retries from the last verified
            # checkpoint (deterministic rollback of this bucket only)
            from ..integrity.checks import IntegrityViolation
            from ..integrity.digest import (first_digest_mismatch,
                                            host_digests)
            ver_cm = (self.metrics.span(
                "verify", bucket=self.bucket.bucket_id)
                if self.metrics is not None
                else contextlib.nullcontext())
            with ver_cm:
                hit = first_digest_mismatch(
                    host_digests(self.state, eng.batch,
                                 eng.scenario.u32_states),
                    self.vdigests)
            if hit is not None:
                bad, got_h, want_h = hit
                raise IntegrityViolation(
                    f"bucket {self.bucket.bucket_id!r} chunk "
                    f"{self.chunks} world {bad}: state digest "
                    f"{got_h} != last verified {want_h} — state "
                    "corrupted between chunks; rolling back to the "
                    "last verified checkpoint (docs/integrity.md)")
        # snapshot the attempt's view; commits re-check the epoch
        st, digests = self.state, list(self.digests)
        supersteps = list(self.supersteps)
        trails = [list(t) for t in self.trails]
        B = self.bucket.B
        _, remaining, active = eng.fleet_progress(st,
                                                  self.bucket.budgets)
        host = None
        for b in np.nonzero(~active)[0]:
            cfg = self.bucket.configs[int(b)]
            if cfg.run_id in self.emitted:
                continue
            if host is None:
                # one device read for every world this chunk emits
                host = result_leaves(st)
            res = world_result(cfg, st, int(b), digests[int(b)],
                               supersteps[int(b)], host)
            with self._lock:
                self._check(epoch)
                self._lease_check()
                # wall_s / attempts are observability metadata on the
                # RECORD, deliberately outside "result": the sweep
                # survival law (and resume's replayed-record equality)
                # compare results, which must stay bit-deterministic
                # "chain" (the per-chunk digest trail) rides OUTSIDE
                # "result" like wall_s/attempts: --verify's
                # auto-bisect reads it, the survival law's compare
                # surface never sees it
                self.journal.append({"ev": "world_done",
                                     "bucket": self.bucket.bucket_id,
                                     "wall_s": round(self.wall_s, 6),
                                     "attempts": self.attempts,
                                     "chain": trails[int(b)],
                                     "result": res})
                self.done[cfg.run_id] = res
                self.emitted.add(cfg.run_id)
        if not active.any():
            self._finish_util(epoch)
            return "done"
        run_kw = {}
        chunk_len = self.chunk
        ci = self.chunks
        if self.ctrl is not None:
            # decide + journal atomically under the epoch lock: a
            # zombie attempt must neither mint a decision nor journal
            # one, and a FRESH decision is durable BEFORE its chunk
            # runs — so a kill mid-chunk resumes by replaying it,
            # never re-deciding from telemetry the crash destroyed
            t_now = int(st.time.min())
            with self._lock:
                self._check(epoch)
                self._lease_check()
                dec, fresh = self.ctrl.decide(
                    ci, eng.last_run_telemetry, t_now)
                if fresh and not self._spec:
                    # speculate buckets journal at COMMIT instead
                    # (below): a speculative decision may be replaced
                    # by its rollback's floor decision before it ever
                    # commits, and the policy re-derives an in-flight
                    # decision bit-identically from the journaled
                    # chain — so journaling early would only plant
                    # double-journal conflicts
                    self.journal.append(
                        {"ev": "dispatch_decision",
                         "bucket": self.bucket.bucket_id,
                         "decision": dec.to_json()})
                    if self.metrics is not None:
                        # the decision also streams as a metrics line
                        # (obs/metrics.py `decision` kind), same as
                        # run_controlled — the journal stays the
                        # replay truth, metrics the observability
                        self.metrics.emit(
                            "decision",
                            label=f"bucket:{self.bucket.bucket_id}",
                            chunk=dec.chunk,
                            window_us=dec.window_us,
                            rung_pin=dec.rung_pin,
                            chunk_len=dec.chunk_len)
            chunk_len = dec.chunk_len
            dyn = eng.dyn_values(dec)
            if dyn is not None:
                run_kw["_dyn"] = dyn
        vec = np.where(active, np.minimum(remaining, chunk_len), 0)
        import time as _time

        from torch.profiler import record_function
        _t0 = _time.perf_counter()
        # speculate buckets shield the metrics stream while the chunk
        # runs (the run_verified/run_speculative discipline): the
        # chunk is uncommitted until its causality plane decodes
        # clean, and eng.run flushes its `supersteps` lines BEFORE
        # the decode raises — a violating chunk would leave tainted
        # (then, after the floor re-run, duplicated) lines behind.
        # The committed chunk's lines flush below, at commit.
        if self._spec:
            eng.metrics = None
        try:
            with record_function(f"sweep bucket {self.bucket.bucket_id}"):
                new_state, traces = eng.run(vec, state=st, **run_kw)
        except Exception as e:  # noqa: BLE001 — re-raised unless spec
            from ..speculate import SpeculationViolation
            if not (self._spec
                    and isinstance(e, SpeculationViolation)):
                raise
            # optimistic rollback (speculate/, docs/speculation.md):
            # the chunk's causality plane flagged a straggler — the
            # chunk is DISCARDED (state/digests/trails untouched: the
            # in-memory view still holds the last committed chunk,
            # exactly what the checkpoint holds), its decision is
            # replaced with the conservative floor, and the next
            # step() call re-runs it. Journaled for observability
            # (resume needs nothing: the policy re-derives the floor
            # decision from the committed chain).
            hit = getattr(e, "hit", None) or {}
            if dec.window_us <= self.ctrl.floor:
                # the conservative floor itself violated: the link
                # model's declared min_delay_us lies about its
                # samples — surface to the retry machinery (terminal
                # failure, loud) instead of rolling back forever
                raise SpeculationViolation(
                    f"bucket {self.bucket.bucket_id!r} chunk {ci} "
                    f"violated causality at the conservative floor "
                    f"{self.ctrl.floor} µs — the link model's "
                    "declared min_delay_us is not a true lower bound "
                    "of its samples (docs/speculation.md)", hit) \
                    from e
            with self._lock:
                self._check(epoch)
                self.ctrl.rollback(ci, hit)
                eng.last_run_telemetry = None
                from ..speculate import hit_scalars
                self.journal.append({
                    "ev": "spec_rollback",
                    "bucket": self.bucket.bucket_id, "chunk": ci,
                    "window_us": dec.window_us, **hit_scalars(hit)})
                if self.metrics is not None:
                    self.metrics.emit(
                        "speculation",
                        label=f"bucket:{self.bucket.bucket_id}",
                        chunk=ci, window_us=dec.window_us,
                        outcome="rollback", **hit_scalars(hit))
            self.wall_s += _time.perf_counter() - _t0
            return "running"
        finally:
            if self._spec:
                eng.metrics = self.metrics
        chunk_wall = _time.perf_counter() - _t0
        if self._spec and self.metrics is not None \
                and eng.last_run_telemetry is not None:
            # the committed chunk's telemetry lines — exactly what
            # eng.run would have flushed had the stream not been
            # shielded above
            self.metrics.superstep_chunk(eng.metrics_label,
                                         eng.last_run_telemetry)
        for b in range(B):
            digests[b] = chain_digest(digests[b], traces[b])
            supersteps[b] += len(traces[b])
            if len(traces[b]):
                trails[b].append([supersteps[b], digests[b]])
        if self.record != "off" and self.flight is not None \
                and eng.last_run_flight is not None:
            # drain this chunk's per-world events into the shared
            # journal-dir event log, tagged by run_id (superstep
            # indices are run-global — the engine state's step count)
            for b, lg in enumerate(eng.last_run_flight):
                if len(lg) == 0 and lg.dropped == 0:
                    continue
                rid = self.bucket.configs[b].run_id
                self.flight.write(lg, world=b, run_id=rid)
                self.flight_counts[rid] = \
                    self.flight_counts.get(rid, 0) + len(lg)
        vdig2 = vchain2 = None
        if self.verify == "digest":
            # the new verified epoch: digest the post-chunk state and
            # extend the per-world sha256 chain — recorded in the
            # checkpoint meta below, so the checkpoint IS the epoch
            from ..integrity.digest import (chain_state_digest,
                                            host_digests)
            vdig2 = host_digests(new_state, eng.batch,
                                 eng.scenario.u32_states)
            vchain2 = [chain_state_digest(self.vchain[b], vdig2[b])
                       for b in range(B)]
        top = int(vec.max())
        with self._lock:
            self._check(epoch)
            self._lease_check()
            if self._spec and ci not in self._journaled:
                # the commit-time half of the speculation journaling
                # discipline (ctor comment): the decision that
                # actually committed — floor decisions a rollback
                # settled on included — becomes durable with its
                # chunk, so the solo twin's replay chain is exactly
                # the committed window sequence
                self.journal.append(
                    {"ev": "dispatch_decision",
                     "bucket": self.bucket.bucket_id,
                     "decision": dec.to_json()})
                self._journaled.add(ci)
                if self.metrics is not None:
                    self.metrics.emit(
                        "speculation",
                        label=f"bucket:{self.bucket.bucket_id}",
                        chunk=ci, window_us=dec.window_us,
                        outcome="committed")
            self.state = new_state
            self.digests = digests
            self.supersteps = supersteps
            self.trails = trails
            self.chunks = ci + 1
            self.wall_s += chunk_wall
            if vdig2 is not None:
                self.vdigests = vdig2
                self.vchain = vchain2
            # utilization bookkeeping: the fleet executed B ×
            # scan_pad(top) superstep bodies for Σ len(traces[b]) real
            # (unmasked) ones — the gap is pad waste + budget masking
            u = self.util
            u["chunks"] += 1
            u["world_supersteps"] += sum(len(traces[b])
                                         for b in range(B))
            u["scan_supersteps"] += scan_pad(top)
            u["pad_supersteps"] += scan_pad(top) - top
            u["active_world_chunks"] += int(active.sum())
            u["compiles"] += int((eng.last_run_stats or {}
                                  ).get("compiles", 0))
            from ..utils.checkpoint import save_state
            ckpt_cm = (self.metrics.span(
                "checkpoint", bucket=self.bucket.bucket_id)
                if self.metrics is not None
                else contextlib.nullcontext())
            meta = {"bucket": self.bucket.bucket_id,
                    "run_ids": list(self.bucket.run_ids),
                    "digests": list(digests),
                    "supersteps": [int(s) for s in supersteps],
                    "trail": [list(t) for t in trails],
                    "chunks": ci + 1}
            if vdig2 is not None:
                # the verified-epoch extension of the existing sha256
                # digest chain (docs/integrity.md): resume recomputes
                # state_digests from the restored arrays and refuses
                # a checkpoint that no longer matches its own record
                meta["state_digests"] = [int(d) for d in vdig2]
                meta["verify_chain"] = list(vchain2)
            with ckpt_cm:
                save_state(
                    self.journal.checkpoint_path(self.bucket.bucket_id),
                    new_state, meta=meta, scenario=eng.scenario)
        return "running"

    def utilization(self) -> dict:
        """The bucket's hardware-utilization record (module docstring
        step 4's ledger): budget-mask efficiency = real supersteps /
        (B × scan supersteps executed), pow2 pad waste, and mean
        worlds-active occupancy per chunk. A resumed bucket reports
        only the resumed process's chunks (wall-clock facts are not
        replayable — the *results* are what the survival law pins)."""
        u = self.util
        B = self.bucket.B
        scan_total = u["scan_supersteps"]
        return {
            "bucket": self.bucket.bucket_id,
            "worlds": B,
            "chunks": u["chunks"],
            "world_supersteps": u["world_supersteps"],
            "scan_supersteps": scan_total,
            "budget_efficiency": round(
                u["world_supersteps"] / (B * scan_total), 4)
            if scan_total else 1.0,
            "pad_waste_frac": round(
                u["pad_supersteps"] / scan_total, 4)
            if scan_total else 0.0,
            "worlds_active_mean": round(
                u["active_world_chunks"] / (u["chunks"] * B), 4)
            if u["chunks"] else 0.0,
            "engine_builds": u["engine_builds"],
            "compiles": u["compiles"],
            "wall_s": round(self.wall_s, 6),
        }

    def _finish_util(self, epoch: Optional[int]) -> None:
        """Journal the bucket's utilization record once, when every
        world's result has streamed — alongside (not inside) the
        results, so `sweep status` can report hardware efficiency per
        bucket without touching the survival law's compare surface."""
        if self.util.get("_journaled"):
            return
        rec = self.utilization()
        with self._lock:
            self._check(epoch)
            self._lease_check()
            self.journal.append({"ev": "bucket_util", **rec})
            if self.record != "off":
                # per-world flight-event counts (this process's) —
                # `sweep status` surfaces them next to utilization
                self.journal.append({
                    "ev": "flight_counts",
                    "bucket": self.bucket.bucket_id,
                    "record": self.record,
                    "counts": dict(self.flight_counts)})
            self.util["_journaled"] = True
        if self.metrics is not None:
            self.metrics.emit("utilization", **rec)

    def split_children(self) -> List["BucketRunner"]:
        """The OOM degradation path: halve the bucket, slice the last
        good checkpointed state per child (world slices are exact —
        the batch exactness law), persist each child's checkpoint, and
        hand back child runners. The caller journals the split event
        AFTER this returns, so a crash mid-split leaves the parent
        authoritative."""
        import dataclasses

        import torch

        from ..interp.torch_engine.batched import map_state
        pad = self.fault_pad()
        kids = self.bucket.split()
        if pad is not None:
            kids = tuple(dataclasses.replace(k, fault_pad=pad)
                         for k in kids)
        mid = kids[0].B
        parts = [(kids[0], list(range(mid))),
                 (kids[1], list(range(mid, self.bucket.B)))]
        # controller buckets: children continue the parent's chunk
        # numbering from its checkpoint and REPLAY the parent's
        # decision chain (prior + this process's) — the solo twin's
        # decision_chain (journal.py) reassembles the same sequence
        kid_decisions = [d.to_json() for d in self.ctrl.decisions] \
            if self.ctrl is not None else list(self.prior_decisions)
        if self._spec and self.ctrl is not None:
            # speculation decisions journal at commit: an in-flight
            # (unjournaled) decision must not ride to the children as
            # replay truth — they re-derive it bit-identically from
            # the committed chain (policy.py module docstring)
            kid_decisions = [d for d in kid_decisions
                             if d["chunk"] in self._journaled]
        runners = []
        for child, idxs in parts:
            r = BucketRunner(child, self.journal, self.done,
                             lint=self.lint, chunk=self.chunk,
                             inject=self.inject,
                             telemetry=self.telemetry,
                             metrics=self.metrics,
                             prior_decisions=kid_decisions,
                             verify=self.verify, record=self.record,
                             flight=self.flight, device=self.device)
            if self.state is not None:
                # world slices index the world axis of every leaf (a
                # copy: the children never alias the parent's tensors)
                idx = torch.as_tensor(idxs, device=self.engine.device)
                child_state = map_state(lambda x: x[idx], self.state)
                from ..utils.checkpoint import save_state
                meta = {"bucket": child.bucket_id,
                        "run_ids": list(child.run_ids),
                        "digests": [self.digests[i] for i in idxs],
                        "supersteps": [self.supersteps[i]
                                       for i in idxs],
                        "trail": [list(self.trails[i])
                                  for i in idxs]
                        if self.trails is not None
                        else [[] for _ in idxs],
                        "chunks": self.chunks}
                if self.vdigests is not None:
                    # world slices are exact (batch exactness law), so
                    # the per-world verified-epoch chain slices with
                    # them — the child checkpoint stays a verified
                    # epoch
                    meta["state_digests"] = [int(self.vdigests[i])
                                             for i in idxs]
                    meta["verify_chain"] = [self.vchain[i]
                                            for i in idxs]
                save_state(
                    self.journal.checkpoint_path(child.bucket_id),
                    child_state, meta=meta,
                    scenario=self.engine.scenario)
            runners.append(r)
        return runners

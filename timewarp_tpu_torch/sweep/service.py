"""The fault-tolerant sweep service: supervision, retry, split, resume
(the port's copy of ``timewarp_tpu/sweep/service.py``).

The scheduler the ROADMAP's "emulation-as-a-service" item asks for:
accept a heterogeneous pack, shape-bucket it (bucket.py), and execute
buckets under a supervision loop built on the manage/ layer's
:class:`~timewarp_tpu_torch.manage.jobs.JobCurator` running on the real
asyncio interpreter (interp/aio/timed.py) — each bucket attempt is a
curator thread job whose blocking chunk calls are offloaded through
``AwaitIO`` to an executor thread, so the supervisor (and its
watchdogs) stay live while the bucket's kernels run.

Failure policy, per bucket attempt:

- **watchdog timeout** (``bucket_timeout_us``): a per-attempt
  watchdog interrupts the attempt's child curator with
  ``WithTimeout(grace_us)`` — Plain-kill now, Force-clear any
  straggler at the grace deadline — and the attempt counts as a
  transient failure. The abandoned executor thread's attempt *epoch*
  is invalidated (runner.py), so it can never again commit state,
  journal a world, or overwrite a checkpoint — even if it races the
  retry. (A chunk wedged in a native call that never returns cannot
  be killed from Python at all: the service itself still terminates
  — chunks run on a dedicated executor shut down without joining —
  but process exit then waits on the wedged thread. That residue is
  a CPython limit, not a supervision gap.)
- **transient errors** retry with exponential backoff
  (``backoff_us * 2^(attempt-1)``) from the bucket's last checkpoint,
  at most ``max_retries`` times; exhaustion is a **loud terminal
  failure** — every unfinished world journals ``world_failed``, lands
  in the report's ``failed`` map, and the CLI exits nonzero. Other
  buckets still complete.
- **device OOM** (``torch.cuda.OutOfMemoryError``, any "out of
  memory" error, or the injected simulation) degrades gracefully: the
  bucket splits in half from its last checkpoint (exact — world
  slices, batch exactness law), down to solo buckets; a solo OOM is
  terminal for that world.
- :class:`SweepKilled` (the test/CI injection ``die:K``) aborts the
  whole process mid-sweep — the crash the journal's resume contract
  is tested against.

Everything observable streams to the journal as it happens
(journal.py), so ``SweepService.run`` on an existing journal dir IS
resume: completed worlds are never re-run, in-flight buckets restart
from their last checkpoint, and the per-world digest chains continue
to the same value an uninterrupted run produces (the sweep survival
law, docs/sweeps.md).

The port's differences, each refused loudly rather than run silently
without: ``lint`` is ``"off"`` only (no pre-flight analysis yet,
ROADMAP queue 1 item 10), and ``host=`` (multi-host leases,
serve/lease.py) waits for the serve slice. The bucket engines run on
``device`` — the card unless ``device="cpu"`` is passed — and on the
card :meth:`SweepService.run` builds the kernels before the
supervision loop starts, so a first-use ``nvcc`` never counts against
an attempt's watchdog.
"""

from __future__ import annotations

import dataclasses
import logging
import time as _time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..core.effects import AwaitIO, Fork, Program, Wait
from ..core.errors import ThreadKilled
from ..manage.jobs import JobCurator, Plain, WithTimeout
from ..manage.sync import Flag
from .bucket import Bucket, plan_buckets
from .journal import SweepJournal, SweepJournalError
from .runner import BucketRunner
from .spec import SweepPack, resolve_window

__all__ = ["SweepService", "SweepReport", "SweepKilled",
           "SimulatedTransient", "SimulatedOOM", "InjectPlan"]

_log = logging.getLogger("timewarp.sweep")


class SimulatedTransient(RuntimeError):
    """Injected transient failure (retried like a real one)."""


class SimulatedOOM(RuntimeError):
    """Injected device OOM (split like a real one)."""


class SweepKilled(RuntimeError):
    """Injected hard kill: aborts the sweep process mid-bucket —
    what `sweep resume` is tested against. Never retried."""


def _is_oom(e: BaseException) -> bool:
    import torch
    if isinstance(e, (SimulatedOOM, torch.cuda.OutOfMemoryError)):
        return True
    s = f"{type(e).__name__}: {e}"
    return "RESOURCE_EXHAUSTED" in s or "out of memory" in s.lower()


class InjectPlan:
    """Deterministic chaos for the service itself (the emulator's
    chaos is faults/; this injects failures into the *sweep
    machinery*). Grammar: ``fail:K | oom:K | die:K | hang:K:MS |
    flip:SEED[:K[:PLANE]]``, ';'-joined — trigger at the K-th
    chunk-executor call (1-based, counted across the whole sweep),
    once each. ``flip:`` (integrity/inject.py, round 14) is the
    state-corruption form the detection law is tested against: a
    seeded bit-flip written into the bucket's in-memory state between
    chunks — what the ``verify`` knob must catch and roll back."""

    GRAMMAR = ("fail:K | oom:K | die:K | hang:K:MS | "
               "flip:SEED[:K[:PLANE]]  "
               "(';'-joined; K = 1-based chunk call, fires once; "
               "flip = seeded bit-flip into a state plane — "
               "docs/integrity.md)")

    def __init__(self, spec: str) -> None:
        self.fail, self.oom, self.die = set(), set(), set()
        self.hang: Dict[int, int] = {}
        self.flip: Dict[int, object] = {}
        self.calls = 0
        self.fired: List[str] = []
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            bits = part.split(":")
            try:
                if bits[0] == "flip":
                    # full grammar (incl. INJECT_GRAMMAR naming on
                    # malformation) lives in integrity/inject.py
                    from ..integrity.inject import parse_flip
                    fs = parse_flip(part)
                    if fs.chunk in self.flip:
                        # two flips on one chunk call would silently
                        # overwrite each other — refuse like any
                        # other malformation
                        raise ValueError(
                            f"duplicate flip at chunk call "
                            f"{fs.chunk}")
                    self.flip[fs.chunk] = fs
                    continue
                kind, k = bits[0], int(bits[1])
                if kind == "fail" and len(bits) == 2:
                    self.fail.add(k)
                elif kind == "oom" and len(bits) == 2:
                    self.oom.add(k)
                elif kind == "die" and len(bits) == 2:
                    self.die.add(k)
                elif kind == "hang" and len(bits) == 3:
                    self.hang[k] = int(bits[2])
                else:
                    raise ValueError(part)
            except (IndexError, ValueError) as e:
                # a library-raised, catchable error (the CLI converts
                # it to a grammar-named exit; an embedding caller —
                # bench, notebook — must not have its process killed).
                # A flip malformation's own message (naming the
                # INJECT_GRAMMAR flip form) rides along verbatim.
                from .spec import SweepConfigError
                detail = f": {e}" if bits and bits[0] == "flip" else ""
                raise SweepConfigError(
                    f"malformed inject spec {part!r}; grammar: "
                    f"{self.GRAMMAR}{detail}") from None

    def __call__(self) -> None:
        self.calls += 1
        n = self.calls
        if n in self.hang:
            self.fired.append(f"hang:{n}")
            _time.sleep(self.hang[n] / 1000.0)
            raise SimulatedTransient(
                f"injected hang ({self.hang[n]} ms) at chunk call {n}")
        if n in self.fail:
            self.fired.append(f"fail:{n}")
            raise SimulatedTransient(f"injected transient failure at "
                                     f"chunk call {n}")
        if n in self.oom:
            self.fired.append(f"oom:{n}")
            raise SimulatedOOM(f"injected RESOURCE_EXHAUSTED at chunk "
                               f"call {n}")
        if n in self.die:
            self.fired.append(f"die:{n}")
            raise SweepKilled(f"injected sweep kill at chunk call {n}")

    def flip_hook(self, runner) -> None:
        """Corrupt the runner's in-memory state if a ``flip:`` spec
        is due at the current chunk call (the runner calls this right
        after ``__call__`` counted the call). Fires once — rollback
        re-runs the same chunk, and re-corrupting the recovered state
        would make recovery unfalsifiable."""
        n = self.calls
        fs = self.flip.get(n)
        tag = f"flip:{n}"
        if fs is None or tag in self.fired or runner.state is None:
            return
        from ..integrity.inject import apply_flip
        self.fired.append(tag)
        runner.state, desc = apply_flip(
            runner.state, fs.seed, fs.plane,
            runner.engine.scenario.u32_states)
        _log.warning("sweep: injected state corruption at chunk call "
                     "%d — %s", n, desc)


@dataclass
class SweepReport:
    total: int
    done: Dict[str, dict]
    failed: Dict[str, dict]
    retries: int = 0
    splits: int = 0
    buckets: int = 0

    @property
    def ok(self) -> bool:
        return not self.failed and len(self.done) == self.total

    def to_json(self) -> dict:
        return {"worlds": self.total, "completed": len(self.done),
                "failed": sorted(self.failed), "retries": self.retries,
                "splits": self.splits, "buckets": self.buckets,
                "ok": self.ok}


@dataclass
class _Attempt:
    """Outcome box one bucket attempt fills in."""
    ok: bool = False
    error: Optional[BaseException] = None
    timed_out: bool = False
    box: dict = field(default_factory=dict)


class SweepService:
    def __init__(self, pack: SweepPack, journal_dir: str, *,
                 chunk: int = 64, max_retries: int = 2,
                 backoff_us: int = 50_000,
                 bucket_timeout_us: Optional[int] = None,
                 grace_us: int = 500_000, max_bucket: int = 64,
                 lint: str = "off", inject=None,
                 telemetry: str = "off",
                 trace_out: Optional[str] = None,
                 verify: str = "off",
                 record: str = "off",
                 post_verify: bool = False,
                 host: Optional[str] = None,
                 pack_mode: str = "first-fit",
                 pack_artifact: Optional[str] = None,
                 device=None) -> None:
        from ..interp.torch_engine.engine import resolve_device
        from .spec import check_lint
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        # online state-integrity checking per bucket (integrity/,
        # docs/integrity.md): "guard" threads the on-device invariant
        # plane through every bucket engine's scans; "digest" adds
        # the per-chunk rolling state digest — verified at every
        # chunk entry and chained through the checkpoints, so each
        # checkpoint marks a verified epoch. Detection journals an
        # `integrity_violation` event and ROLLS BACK just the
        # affected bucket: the existing retry machinery restores the
        # last verified checkpoint and replays the journaled
        # dispatch-decision chain — bit-identical recovery by the
        # replay law. "shadow" (sampled re-execution) is the solo
        # driver's mode (run_verified); refused here rather than
        # silently downgraded.
        from ..integrity.checks import validate_verify
        self.verify = validate_verify(verify, type(self).__name__)
        if self.verify == "shadow":
            raise ValueError(
                "the sweep service verifies buckets with "
                "verify='guard'|'digest'; shadow re-execution is the "
                "solo chunked driver's mode "
                "(engine.run_verified, docs/integrity.md)")
        self.pack = pack
        # multi-host mode (--hosts, docs/serving.md "Multi-host
        # sweeps") claims buckets through per-bucket leases
        # (serve/lease.py), which the port has not yet
        if host is not None:
            raise NotImplementedError(
                f"SweepService(host={host!r}): multi-host sweeps run "
                "on the serving layer's bucket leases (serve/lease.py), "
                "which the torch port does not have yet (ROADMAP queue "
                "1 item 8, the serve slice); run one host (host=None)")
        self.journal = SweepJournal(journal_dir)
        #: the bucket engines' device (the card unless the caller
        #: passes device="cpu"; no CUDA and no device= raises here)
        self.device = resolve_device(device, type(self).__name__)
        self.chunk = chunk
        self.max_retries = max_retries
        self.backoff_us = int(backoff_us)
        self.bucket_timeout_us = bucket_timeout_us
        self.grace_us = int(grace_us)
        self.max_bucket = max_bucket
        # predictive packing (timewarp_tpu_torch/pack/, docs/sweeps.md
        # "Predictive packing"): "predicted" reorders each shape
        # group best-fit-decreasing by forecast supersteps before
        # chunking, and journals one pack_decision per bucket BEFORE
        # any bucket starts — resume replays the journaled plan
        # bit-identically, artifact or not. "first-fit" is the
        # historical plan, a pure function of the pack (no journaling
        # needed). The artifact is the sha-stamped fitted predictor
        # (`timewarp-tpu pack fit`); without one, forecasts fall back
        # to each config's budget — honest, never fabricated.
        from ..pack.allocate import validate_pack_mode
        self.pack_mode = validate_pack_mode(pack_mode)
        self.pack_artifact = None
        if pack_artifact is not None:
            from ..pack.predict import load_artifact
            self.pack_artifact = load_artifact(pack_artifact)
        # fleet-scale pre-flight verification (analysis/plan_lint.py)
        # lints the whole pack before any bucket engine is built; the
        # port has no analysis package yet, so only "off" runs
        self.lint = check_lint(lint, type(self).__name__)
        self.inject = (InjectPlan(inject) if isinstance(inject, str)
                       else inject)
        if getattr(self.inject, "flip", None) \
                and self.verify != "digest" and not post_verify:
            # mirror of the solo CLI's guard: a flip without the
            # digest entry check would corrupt streamed results
            # SILENTLY (guard misses most planes by design) — the
            # detection-law test would test nothing. A promised
            # post-sweep --verify is the other legal arming: the
            # survival-law check catches the corrupted stream and
            # auto-bisects to the first diverging chunk
            # (obs/bisect.py, docs/observability.md)
            raise ValueError(
                "--inject flip: corrupts bucket state between "
                "chunks; it needs --state-verify digest (online "
                "detection + rollback) or --verify (post-sweep "
                "survival-law check, which auto-bisects the "
                "mismatch to its first diverging chunk) — "
                "anything less goes undetected into the journaled "
                "results (docs/integrity.md)")
        # observability (obs/, docs/observability.md): when telemetry
        # is on, the bucket engines thread counter planes through
        # their scans (bit-exact — the streamed results are
        # mode-independent), a MetricsRegistry streams
        # `<journal>/metrics.jsonl`, and a TraceBuilder records the
        # service's wall-clock spans (attempts, retries, backoffs,
        # checkpoints, journal fsyncs) for Perfetto
        import os as _os
        from ..obs.telemetry import validate_mode
        self.telemetry = validate_mode(telemetry, type(self).__name__)
        self.trace_out = trace_out
        self.trace_path = None
        self.metrics = None
        self.tracer = None
        if self.telemetry != "off":
            from ..obs.metrics import MetricsRegistry
            from ..obs.perfetto import TraceBuilder
            self.journal.ensure_dir()
            self.tracer = TraceBuilder(process="timewarp-tpu sweep")
            self.metrics = MetricsRegistry(
                path=_os.path.join(journal_dir, "metrics.jsonl"),
                run=f"sweep:{pack.sha()[:12]}", tracer=self.tracer)
            self.journal.on_append = (
                lambda ev, dt: self.tracer.complete(
                    f"journal fsync: {ev}", dur_us=dt * 1e6,
                    cat="journal"))
        # causal flight recorder per bucket (obs/flight.py,
        # docs/observability.md): bucket engines thread the event
        # plane (bit-exact — streamed results are mode-independent),
        # and every chunk's per-world events drain into
        # <journal>/events.jsonl tagged by run_id, queryable with
        # `timewarp-tpu explain EVENTS --run-id ID`
        from ..obs.flight import validate_record
        self.record = validate_record(record, type(self).__name__)
        self.flight = None
        if self.record != "off":
            from ..obs.flight import FlightWriter
            self.journal.ensure_dir()
            self.flight = FlightWriter(
                _os.path.join(journal_dir, "events.jsonl"),
                run=f"sweep:{pack.sha()[:12]}")
        self.done: Dict[str, dict] = {}
        self.failed: Dict[str, dict] = {}
        self._retries = 0
        self._splits = 0
        self._executor = None

    @classmethod
    def resume(cls, journal_dir: str, **kw) -> "SweepService":
        """Open an existing journal dir; the pack comes from the
        journaled copy."""
        j = SweepJournal(journal_dir)
        import os
        if not os.path.exists(j.pack_path):
            raise SweepJournalError(
                f"{journal_dir!r} holds no pack.json — nothing to "
                "resume (run `sweep run PACK --journal DIR` first)")
        return cls(SweepPack.load(j.pack_path), journal_dir, **kw)

    # -- planning ----------------------------------------------------------

    def _build_queue(self) -> deque:
        scan = self.journal.scan()
        if scan.pack_sha is not None and scan.pack_sha != self.pack.sha():
            raise SweepJournalError(
                f"journal {self.journal.path!r} was written for a "
                "different pack (sha mismatch) — one journal dir per "
                "pack; use a fresh --journal or the journaled pack")
        self.journal.write_pack(self.pack)
        if scan.pack_sha is None:
            self.journal.append({"ev": "pack", "sha": self.pack.sha(),
                                 "worlds": len(self.pack.configs)})
        self.done = dict(scan.done)
        self.failed = dict(scan.failed)
        self._retries = scan.retries

        def expand(bucket: Bucket) -> List[Bucket]:
            if bucket.bucket_id not in scan.splits:
                return [bucket]
            rec = next(e for e in scan.events
                       if e.get("ev") == "bucket_split"
                       and e["bucket"] == bucket.bucket_id)
            pad = rec.get("fault_pad")
            kids = bucket.split()
            if pad is not None:
                kids = tuple(dataclasses.replace(k, fault_pad=tuple(pad))
                             for k in kids)
            self._splits += 1
            return [g for k in kids for g in expand(k)]

        queue: deque = deque()
        settled = set(self.done) | set(self.failed)
        for base in self._base_plan(scan):
            for bucket in expand(base):
                if bucket.bucket_id in scan.bucket_done:
                    continue
                if all(r in settled for r in bucket.run_ids):
                    continue
                queue.append(BucketRunner(
                    bucket, self.journal, self.done, lint=self.lint,
                    chunk=self.chunk, inject=self.inject,
                    telemetry=self.telemetry, metrics=self.metrics,
                    verify=self.verify, record=self.record,
                    flight=self.flight, device=self.device,
                    # resume replays the journaled dispatch-decision
                    # chain (split-ancestor prefixes included) so a
                    # pre-kill decision is never re-made differently
                    prior_decisions=scan.decision_chain(
                        bucket.bucket_id)))
        self._planned = len(queue)
        return queue

    def _base_plan(self, scan) -> List[Bucket]:
        """The base bucket plan, BEFORE split expansion. Three-way:

        1. the journal already holds ``pack_decision`` plan records —
           replay them verbatim (membership and order), no artifact
           needed: the plan is journal state, so resume/steal rebuild
           the identical buckets even on a host without the predictor
           file;
        2. ``pack_mode="predicted"`` on a fresh journal — plan
           best-fit-decreasing by forecast supersteps
           (pack/allocate.py) and journal one ``pack_decision`` per
           bucket before ANY bucket starts;
        3. first-fit (the default) — the plan is a pure function of
           the pack (bucket.py docstring); nothing to journal.
        """
        if scan.pack_plan:
            by_id = {c.run_id: c for c in self.pack.configs}
            covered: set = set()
            planned: List[Bucket] = []
            for bid, d in scan.pack_plan.items():
                missing = [r for r in d["members"] if r not in by_id]
                if missing:
                    raise SweepJournalError(
                        f"journaled pack_decision for bucket {bid!r} "
                        f"names worlds absent from the pack "
                        f"({missing}) — the journal belongs to a "
                        "different pack")
                cfgs = tuple(by_id[r] for r in d["members"])
                planned.append(
                    Bucket(bid, cfgs, resolve_window(cfgs[0])))
                covered.update(d["members"])
            if covered != set(by_id):
                raise SweepJournalError(
                    "journaled pack_decision records cover "
                    f"{len(covered)} of {len(by_id)} pack worlds — "
                    "the plan journal is truncated; refusing to "
                    "invent placement for the rest")
            return planned
        if self.pack_mode == "predicted":
            if any(e.get("ev") == "bucket_start" for e in scan.events):
                raise SweepJournalError(
                    "this journal was planned first-fit (buckets "
                    "already started, no pack_decision records) — "
                    "re-bucketing in-flight worlds would resume them "
                    "from checkpoints planned for other buckets; "
                    "resume with --pack first-fit")
            from ..pack.predict import predict_supersteps
            art = self.pack_artifact

            def predict(c):
                return predict_supersteps(c, art)

            plan = plan_buckets(self.pack.configs, self.max_bucket,
                                pack_mode="predicted", predict=predict)
            for b in plan:
                self.journal.append({
                    "ev": "pack_decision", "bucket": b.bucket_id,
                    "members": list(b.run_ids), "mode": "predicted",
                    "artifact_sha": (art or {}).get("sha"),
                    "predicted": [predict(c) for c in b.configs]})
            return plan
        return plan_buckets(self.pack.configs, self.max_bucket)

    def decisions_for_world(self, run_id: str, scan=None):
        """The journaled dispatch-decision chain governing
        ``run_id``'s bucket (split ancestry included) — what the
        ``--verify`` solo twin replays for a controller config, and
        None for controller-off worlds. Pass a pre-computed
        ``journal.scan()`` when calling in a loop (the verify path
        does — re-scanning the whole append-only log per world would
        be O(worlds × journal)); without one the journal is read
        fresh, so it works after :meth:`run` returned (or was
        killed)."""
        if scan is None:
            scan = self.journal.scan()
        bid = scan.world_bucket.get(run_id)
        if not bid:
            return None
        chain = scan.decision_chain(bid)
        return chain or None

    # -- the supervision loop (runs under the asyncio interpreter) -------

    def _io(self, fn) -> Program:
        """Offload a blocking call to the sweep's own executor,
        awaited through AwaitIO so watchdogs stay live (and a
        ThreadKilled from one lands here, abandoning — not blocking
        on — the thread). A dedicated executor, NOT the loop default:
        asyncio.run joins the default executor at teardown, which
        would block the service's exit on a wedged abandoned chunk."""
        import asyncio
        if self._executor is None:
            from concurrent.futures import ThreadPoolExecutor
            self._executor = ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="tw-sweep")
        loop = asyncio.get_running_loop()
        return (yield AwaitIO(loop.run_in_executor(self._executor, fn)))

    def _bucket_body(self, runner: BucketRunner, epoch: int) -> Program:
        from functools import partial
        yield from self._io(partial(runner.prepare, epoch))
        while True:
            status = yield from self._io(partial(runner.step, epoch))
            if status == "done":
                return

    def _attempt(self, jc: JobCurator, runner: BucketRunner) -> Program:
        """One supervised attempt: the bucket body as a thread job in
        a per-attempt child curator (nested under the service curator,
        so the end-of-sweep stop reaches every straggler), with an
        optional watchdog that escalates through ``WithTimeout`` at
        the deadline."""
        out = _Attempt()
        flag = Flag()
        child = JobCurator()
        yield from jc.add_manager_as_job(child, Plain)
        epoch = runner.begin_attempt()
        runner.attempts += 1

        def body() -> Program:
            try:
                yield from self._bucket_body(runner, epoch)
                out.ok = True
            except ThreadKilled:
                raise
            except Exception as e:  # noqa: BLE001 — classified below
                out.error = e
            finally:
                yield from flag.set()

        yield from child.add_thread_job(body)

        if self.bucket_timeout_us is not None:
            deadline = int(self.bucket_timeout_us)

            def watchdog() -> Program:
                yield Wait(deadline)
                if not flag.is_set:
                    out.timed_out = True
                    # invalidate the attempt's epoch FIRST: the
                    # zombie thread loses every write path before we
                    # even deliver the kill (runner.py)
                    runner.abandon(epoch)
                    # Plain-kill the attempt now; Force-clear any
                    # straggler at the grace deadline (the
                    # manage/jobs.py WithTimeout watchdog)
                    yield from child.stop_all_jobs(
                        WithTimeout(self.grace_us, None))

            yield Fork(watchdog)

        yield from flag.wait()
        if not child.is_closed:
            # close the (now job-free) curator so nothing dangles
            yield from child.interrupt_all_jobs(Plain)
        return out

    def _terminal_failure(self, runner: BucketRunner, reason: str) -> None:
        """Loud terminal failure: journal + report + ERROR log for
        every world the bucket never finished. Never silent, never
        blocking the rest of the sweep."""
        for cfg in runner.bucket.configs:
            if cfg.run_id in self.done or cfg.run_id in self.failed:
                continue
            rec = {"ev": "world_failed", "run_id": cfg.run_id,
                   "bucket": runner.bucket.bucket_id,
                   "attempts": runner.attempts, "error": reason}
            self.journal.append(rec)
            self.failed[cfg.run_id] = rec
            if self.metrics is not None:
                self.metrics.event("world_failed", run_id=cfg.run_id,
                                   bucket=runner.bucket.bucket_id)
            _log.error("sweep: world %r TERMINALLY FAILED after %d "
                       "attempt(s): %s", cfg.run_id, runner.attempts,
                       reason)

    def _supervise(self, queue: deque) -> Program:
        jc = JobCurator()
        while queue:
            runner: BucketRunner = queue.popleft()
            self.journal.append({"ev": "bucket_start",
                                 "bucket": runner.bucket.bucket_id,
                                 "attempt": runner.attempts + 1})
            _t0 = _time.perf_counter()
            _ts = None if self.tracer is None else self.tracer.now_us()
            out = yield from self._attempt(jc, runner)
            if self.tracer is not None:
                self.tracer.complete(
                    f"attempt: bucket {runner.bucket.bucket_id}",
                    dur_us=(_time.perf_counter() - _t0) * 1e6,
                    ts_us=_ts, cat="attempt",
                    args={"attempt": runner.attempts,
                          "ok": out.ok,
                          "timed_out": out.timed_out})
            if out.ok:
                self.journal.append({"ev": "bucket_done",
                                     "bucket": runner.bucket.bucket_id})
                continue
            err = out.error
            if isinstance(err, SweepKilled):
                # the injected hard kill aborts the process mid-bucket
                raise err
            from ..integrity.checks import IntegrityViolation
            if isinstance(err, IntegrityViolation):
                # detected state corruption (or a real bug surfacing
                # through the exactness laws): journal it — never
                # silent — then fall through to the retry path, which
                # IS the deterministic rollback: the attempt restarts
                # from the bucket's last verified checkpoint and
                # replays the journaled dispatch-decision chain, so
                # the recovered bucket is bit-identical to an
                # uncorrupted run (docs/integrity.md; the detection
                # law, tests/test_zzzzintegrity.py)
                self.journal.append({
                    "ev": "integrity_violation",
                    "bucket": runner.bucket.bucket_id,
                    "attempt": runner.attempts,
                    "detail": str(err)[:500]})
                if self.metrics is not None:
                    self.metrics.event("integrity_violation",
                                       bucket=runner.bucket.bucket_id)
                _log.warning("sweep: bucket %s INTEGRITY VIOLATION "
                             "(%s) — rolling back to its last "
                             "verified checkpoint",
                             runner.bucket.bucket_id, err)
            if err is not None and _is_oom(err):
                if runner.bucket.B > 1:
                    if self.metrics is not None:
                        self.metrics.event(
                            "oom_split",
                            bucket=runner.bucket.bucket_id)
                    kids = yield from self._io(runner.split_children)
                    self.journal.append({
                        "ev": "bucket_split",
                        "bucket": runner.bucket.bucket_id,
                        "into": [k.bucket.bucket_id for k in kids],
                        "fault_pad": runner.fault_pad(),
                        "reason": str(err)})
                    self._splits += 1
                    _log.warning("sweep: bucket %s OOM (%s) — split "
                                 "into %s", runner.bucket.bucket_id, err,
                                 [k.bucket.bucket_id for k in kids])
                    queue.extendleft(reversed(kids))
                else:
                    self._terminal_failure(runner, f"device OOM on a "
                                           f"solo bucket: {err}")
                continue
            reason = ("bucket watchdog timeout "
                      f"({self.bucket_timeout_us} µs)" if out.timed_out
                      else f"{type(err).__name__}: {err}" if err
                      else "attempt ended without result")
            if runner.attempts <= self.max_retries:
                backoff = self.backoff_us * (
                    2 ** (runner.attempts - 1))
                self.journal.append({
                    "ev": "retry", "bucket": runner.bucket.bucket_id,
                    "attempt": runner.attempts, "backoff_us": backoff,
                    "reason": reason})
                self._retries += 1
                _log.warning("sweep: bucket %s attempt %d failed (%s) "
                             "— retrying after %d µs",
                             runner.bucket.bucket_id, runner.attempts,
                             reason, backoff)
                _bt = None if self.tracer is None \
                    else self.tracer.now_us()
                yield Wait(int(backoff))
                if self.tracer is not None:
                    self.tracer.complete(
                        f"backoff: bucket {runner.bucket.bucket_id}",
                        dur_us=self.tracer.now_us() - _bt, ts_us=_bt,
                        cat="retry",
                        args={"attempt": runner.attempts,
                              "reason": reason})
                queue.appendleft(runner)
            else:
                self._terminal_failure(
                    runner, f"{reason} (retries exhausted)")
        # end of sweep: Force-clear anything still straggling at the
        # grace deadline (a wedged executor thread's job) — the
        # service must terminate even when a chunk never returns
        yield from jc.stop_all_jobs(WithTimeout(self.grace_us, None))

    # -- entry point -------------------------------------------------------

    def _build_kernels(self) -> None:
        """On the card, build (at first use: ``nvcc``) and load the
        kernels every bucket engine launches, before the supervision
        loop starts — a build inside a bucket's first chunk would count
        against its attempt's watchdog. The CPU runs their plain
        versions and builds nothing."""
        if self.device.type != "cuda":
            return
        from ..utils.build import library
        for name in ("fire_compact", "mailbox_insert"):
            library(name)

    def run(self) -> SweepReport:
        """Run (or resume — same call) the sweep to completion.
        Raises :class:`SweepKilled` if an injected kill fires;
        otherwise always returns a report (terminal failures are in
        ``report.failed``, never raised)."""
        from ..interp.aio.timed import run_real_time
        queue = self._build_queue()
        try:
            if queue:
                self._build_kernels()
                run_real_time(lambda: self._supervise(queue))
            report = SweepReport(
                total=len(self.pack.configs), done=self.done,
                failed=self.failed, retries=self._retries,
                splits=self._splits, buckets=self._planned)
            self.journal.append({"ev": "sweep_done",
                                 **report.to_json()})
            return report
        finally:
            self.journal.close()
            if self.tracer is not None:
                # the Perfetto timeline survives kills too: written in
                # the finally, so a die:K abort still leaves the spans
                # up to the kill on disk. Best-effort: the sweep's
                # outcome (report, --verify, the killed path) must
                # never be masked by its own instrumentation failing
                # to write (a bad --trace-out dir, a full disk)
                import os as _os
                path = self.trace_out or _os.path.join(
                    self.journal.root, "trace.json")
                try:
                    self.tracer.save(path)
                    self.trace_path = path
                except OSError as e:
                    _log.warning("sweep: could not write Perfetto "
                                 "trace %r (%s) — results are "
                                 "unaffected", path, e)
            if self.metrics is not None:
                try:
                    self.metrics.close()
                except OSError as e:
                    _log.warning("sweep: metrics close failed: %s", e)
            if self.flight is not None:
                try:
                    self.flight.close()
                except OSError as e:
                    _log.warning("sweep: flight-event log close "
                                 "failed: %s", e)
            if self._executor is not None:
                # never join: an abandoned wedged chunk must not keep
                # a finished (or killed) sweep from returning
                self._executor.shutdown(wait=False)
                self._executor = None

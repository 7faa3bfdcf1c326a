"""Per-host serving curator: claim, execute, steal, repack
(the port's copy of ``timewarp_tpu/serve/curator.py``; every open
bucket it drives runs on ``device``, the card unless the caller passes
``device="cpu"``).

One :class:`ServeCurator` runs per host process (a frontend's process
embeds one; extra hosts run curator-only processes). The shared journal directory is the entire
coordination surface:

- the **admission queue** is the journal itself: ``bucket_open`` /
  ``admit`` records (written by the frontend) tell every curator
  which open buckets exist and which configs sit in which slots;
- **claims** go through per-bucket lease files (lease.py): a free
  bucket is acquired, a dead host's stale lease is *stolen* and the
  bucket continues from its shared-dir checkpoint (work-stealing);
- every lease transition and a throttled heartbeat are journaled, so
  ``sweep status`` / ``sweep watch`` render the per-host lease table
  from the same fold (journal.py ``hosts_block``).

Between chunks of a held bucket the curator: renews the lease, admits
any newly journaled configs for that bucket (worker.py — no state
splice needed, reserved slots are pristine by construction), and runs
the **re-packing pass**: if another same-key open bucket is
under-occupied (the journaled ``bucket_util`` arithmetic), its lease
is free, and its active worlds fit into this bucket's free slots, the
two merge and the donor closes — one executable where two
half-empty ones ran.

The curator exits when a ``serve_drain`` record exists and every
admitted world has settled. A hard kill (the CI scenario) simply
stops renewing; survivors steal after one lease TTL.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

from ..interp.torch_engine.engine import resolve_device
from ..sweep.journal import JournalState, SweepJournal
from ..sweep.spec import RunConfig, check_lint
from .lease import Lease, LeaseDir, LeaseLost
from .worker import OpenBucketRunner

__all__ = ["ServeCurator", "CuratorKilled"]

_log = logging.getLogger("timewarp.serve")


class CuratorKilled(RuntimeError):
    """Deterministic test/CI injection: abandon the curator loop
    mid-bucket WITHOUT releasing the lease — the death the steal
    protocol is pinned against (tests/test_zzzzzzzzzserve.py)."""


class ServeCurator:
    def __init__(self, journal_dir: str, host: str, *,
                 chunk: int = 64, lint: str = "off",
                 lease_ttl_s: float = 10.0, poll_s: float = 0.2,
                 heartbeat_s: float = 1.0, repack: bool = True,
                 repack_below: float = 0.5, max_attempts: int = 3,
                 die_after_chunks: Optional[int] = None,
                 journal: Optional[SweepJournal] = None,
                 pack_mode: str = "first-fit",
                 pack_artifact=None, device=None) -> None:
        #: every open bucket's device: the card unless the caller
        #: passes device="cpu" (no CUDA and no device= raises here)
        self.device = resolve_device(device, type(self).__name__)
        # the embedded curator shares the frontend's journal handle
        # (append is locked) so one host's seq stamps stay unique
        self.journal = journal if journal is not None \
            else SweepJournal(journal_dir, host=host)
        self.host = host
        self.chunk = int(chunk)
        self.lint = check_lint(lint, type(self).__name__)
        self.leases = LeaseDir(journal_dir, host, ttl_s=lease_ttl_s)
        self.poll_s = float(poll_s)
        self.heartbeat_s = float(heartbeat_s)
        self.repack = bool(repack)
        self.repack_below = float(repack_below)
        #: proactive repack policy (docs/serving.md "Predictive
        #: packing"): "predicted" ALSO triggers a merge when the
        #: donor's forecast remaining occupancy — predicted work left,
        #: not heads admitted — falls under ``repack_below``, so a
        #: bucket of nearly-quiesced worlds drains into a live one
        #: before its slots sit budget-masked
        from ..pack.allocate import validate_pack_mode
        self.pack_mode = validate_pack_mode(pack_mode)
        self.pack_artifact = None
        if pack_artifact is not None:
            if isinstance(pack_artifact, str):
                from ..pack.predict import load_artifact
                self.pack_artifact = load_artifact(pack_artifact)
            else:
                self.pack_artifact = dict(pack_artifact)
        #: chunk-executor call counter + the injected-death threshold
        #: (counted across the whole curator lifetime, 1-based like
        #: the sweep InjectPlan's K)
        self._calls = 0
        self.die_after_chunks = die_after_chunks
        #: buckets this host gave up on after max_attempts local
        #: failures (terminal world_failed journaled)
        self.max_attempts = int(max_attempts)
        self.stop = False
        #: run_id -> result, shared view filled from the merged scan
        self.done: Dict[str, dict] = {}
        self.stolen = 0
        #: incrementally-folded view of the merged journal: a
        #: long-lived service must not re-read its whole history per
        #: chunk (the journal only grows), so the curator tails every
        #: host file with the watch layer's torn-tail-tolerant
        #: TailReader and folds new records through the one shared
        #: JournalState.apply — the same fold a full scan() runs,
        #: incrementalized
        self._state = JournalState()
        self._tails: Dict[str, object] = {}

    # -- journal views -----------------------------------------------------

    def scan(self) -> JournalState:
        """The current merged-journal view (incremental — consumes
        only records appended since the last call)."""
        from ..obs.watch import TailReader
        from ..sweep.journal import merge_key
        batch = []
        for p in SweepJournal(self.journal.root).journal_files():
            tail = self._tails.get(p)
            if tail is None:
                tail = self._tails[p] = TailReader(p)
            batch.extend(tail.poll())
        batch.sort(key=merge_key)
        for rec in batch:
            self._state.apply(rec)
        return self._state

    @staticmethod
    def bucket_members(scan: JournalState,
                       bucket_id: str) -> Dict[int, RunConfig]:
        """slot -> RunConfig for every config admitted to the bucket
        (the journal IS the membership truth — frontends journal
        ``admit`` before acknowledging the client)."""
        out: Dict[int, RunConfig] = {}
        for rid, a in scan.admits.items():
            if a.get("bucket") == bucket_id:
                out[int(a["slot"])] = RunConfig.from_json(
                    dict(a["config"]), 0)
        return out

    @staticmethod
    def unfinished(scan: JournalState, bucket_id: str) -> bool:
        return any(a.get("bucket") == bucket_id
                   and rid not in scan.done
                   and rid not in scan.failed
                   for rid, a in scan.admits.items())

    def _heartbeat(self, lease: Lease) -> None:
        self.leases.renew(lease)
        self.journal.maybe_heartbeat(self.heartbeat_s)

    def _tick(self) -> None:
        self._calls += 1
        if self.die_after_chunks is not None \
                and self._calls >= self.die_after_chunks:
            raise CuratorKilled(
                f"injected curator death at chunk call {self._calls} "
                "(lease deliberately NOT released)")

    # -- one claimed bucket ------------------------------------------------

    def _restore_runner(self, bucket_id: str,
                        scan: JournalState,
                        lease: Lease) -> OpenBucketRunner:
        meta = scan.serve_buckets[bucket_id]
        self.done.update(scan.done)
        runner = OpenBucketRunner(
            bucket_id, self.journal, self.done,
            capacity=int(meta["capacity"]), window=meta["window"],
            chunk=self.chunk, lint=self.lint,
            precommit=lambda: self.leases.check(lease),
            device=self.device)
        for slot, cfg in self.bucket_members(scan, bucket_id).items():
            runner.admit(slot, cfg)
        runner.restore()
        return runner

    def _predicted_occupancy(self, bid: str, donor_active,
                             scan: JournalState,
                             capacity: int) -> Optional[float]:
        """Forecast remaining occupancy of a donor bucket: remaining
        work (forecast supersteps minus checkpointed progress, per
        active world) over the work the bucket's slots will PAY for
        (capacity x its longest remaining member — the pow2 scan runs
        every slot until the slowest world drains). Near 0.0 the
        bucket's slots are about to idle budget-masked even though
        heads still occupy them — the proactive trigger the observed
        head-count occupancy cannot see. None when nothing is active
        (the head-count trigger already fires there)."""
        from ..pack.predict import predict_supersteps
        from .worker import checkpoint_meta
        if not donor_active:
            return None
        done_ss: Dict[str, int] = {}
        meta = checkpoint_meta(self.journal.checkpoint_path(bid))
        if meta is not None:
            done_ss = dict(zip(meta.get("members", ()),
                               meta.get("supersteps", ())))
        rem = []
        for rid in donor_active:
            cfg = RunConfig.from_json(
                dict(scan.admits[rid]["config"]), 0)
            rem.append(max(0, predict_supersteps(
                cfg, self.pack_artifact) - int(done_ss.get(rid, 0))))
        longest = max(rem)
        if longest <= 0:
            return 0.0
        return sum(rem) / (capacity * longest)

    def _try_repack(self, runner: OpenBucketRunner, lease: Lease,
                    scan: JournalState) -> None:
        """The re-packing pass (module docstring): pull one
        under-occupied same-key open bucket into ``runner``."""
        if not runner.free_slots():
            return
        my_key = scan.serve_buckets[runner.bucket_id].get("key")
        for bid, meta in sorted(scan.serve_buckets.items()):
            if bid == runner.bucket_id or meta.get("key") != my_key \
                    or bid in scan.bucket_done:
                continue
            if not self.unfinished(scan, bid):
                continue
            donor_active = [
                rid for rid, a in scan.admits.items()
                if a.get("bucket") == bid and rid not in scan.done
                and rid not in scan.failed]
            occ = len(donor_active) / max(1, int(meta["capacity"]))
            pocc = None
            if self.pack_mode == "predicted":
                pocc = self._predicted_occupancy(
                    bid, donor_active, scan,
                    max(1, int(meta["capacity"])))
            under = occ <= self.repack_below or (
                pocc is not None and pocc <= self.repack_below)
            if not under \
                    or len(donor_active) > len(runner.free_slots()):
                continue
            dl = self.leases.try_acquire(bid)
            if dl is None:
                continue
            try:
                if self.pack_mode == "predicted":
                    # journaled BEFORE its effect (the merge + the
                    # repack/admit records below), so resume and
                    # sibling hosts see WHY the donor drained — and a
                    # replay needs only the record, never the artifact
                    self.journal.append({
                        "ev": "pack_decision", "kind": "repack",
                        "bucket": bid, "into": runner.bucket_id,
                        "mode": self.pack_mode,
                        "observed_occupancy": round(occ, 4),
                        "predicted_occupancy":
                            None if pocc is None else round(pocc, 4),
                        "artifact_sha":
                            (self.pack_artifact or {}).get("sha"),
                        "host": self.host})
                self.journal.append(
                    {"ev": "lease_acquire", "bucket": bid,
                     "host": self.host, "gen": dl.gen,
                     "stolen_from": dl.stolen_from})
                donor = self._restore_runner(bid, scan, dl)
                moved = runner.merge_from(donor)
                self.leases.check(lease)
                self.journal.append(
                    {"ev": "repack", "from": bid,
                     "into": runner.bucket_id, "moved": moved,
                     "host": self.host})
                for rid in moved:
                    a = dict(scan.admits[rid])
                    self.journal.append(
                        {"ev": "admit", "run_id": rid,
                         "bucket": runner.bucket_id,
                         "slot": runner.slot_of(rid),
                         "config": a["config"],
                         "repacked_from": bid})
                self.journal.append({"ev": "bucket_done",
                                     "bucket": bid})
            finally:
                self.journal.append({"ev": "lease_release",
                                     "bucket": bid,
                                     "host": self.host})
                self.leases.release(dl)
            return

    def _drive(self, bucket_id: str, lease: Lease) -> None:
        scan = self.scan()
        runner = self._restore_runner(bucket_id, scan, lease)
        self.journal.append({"ev": "bucket_start",
                             "bucket": bucket_id,
                             "attempt": 1 + sum(
                                 1 for e in scan.events
                                 if e.get("ev") == "bucket_start"
                                 and e.get("bucket") == bucket_id)})
        while not self.stop:
            self._heartbeat(lease)
            self._tick()
            status = runner.step()
            if status == "idle":
                # poll admissions once more — a config may have been
                # admitted to this bucket while the last chunk ran
                scan = self.scan()
                fresh = False
                for slot, cfg in self.bucket_members(
                        scan, bucket_id).items():
                    if runner.members[slot] is None:
                        runner.admit(slot, cfg)
                        fresh = True
                if fresh:
                    continue
                if scan.draining and not self.unfinished(scan,
                                                         bucket_id):
                    self.journal.append({"ev": "bucket_done",
                                         "bucket": bucket_id})
                return
            scan = self.scan()
            for slot, cfg in self.bucket_members(scan,
                                                 bucket_id).items():
                if runner.members[slot] is None:
                    runner.admit(slot, cfg)
            if self.repack:
                self._try_repack(runner, lease, scan)

    # -- the claim loop ----------------------------------------------------

    def run(self, max_seconds: Optional[float] = None) -> int:
        """Claim-and-execute until drained (or ``stop``/deadline).
        Returns the number of buckets this host completed or drove to
        idle."""
        deadline = None if max_seconds is None \
            else time.monotonic() + max_seconds
        served = 0
        while not self.stop:
            if deadline is not None and time.monotonic() >= deadline:
                break
            scan = self.scan()
            work = [bid for bid in sorted(scan.serve_buckets)
                    if bid not in scan.bucket_done
                    and self.unfinished(scan, bid)]
            claimed = None
            for bid in work:
                lease = self.leases.try_acquire(bid)
                if lease is not None:
                    claimed = (bid, lease)
                    break
            if claimed is None:
                if scan.draining and not work:
                    break
                time.sleep(self.poll_s)
                continue
            bid, lease = claimed
            if lease.stolen_from:
                self.stolen += 1
                _log.warning("serve[%s]: STOLE bucket %s from dead "
                             "host %s (stale lease reclaimed)",
                             self.host, bid, lease.stolen_from)
            self.journal.append(
                {"ev": "lease_acquire", "bucket": bid,
                 "host": self.host, "gen": lease.gen,
                 "stolen_from": lease.stolen_from})
            try:
                self._drive(bid, lease)
                served += 1
            except CuratorKilled:
                # the injected hard death: abandon WITHOUT releasing
                # the lease — exactly what a SIGKILL leaves behind,
                # and what the steal law is pinned against
                raise
            except LeaseLost as e:
                # stolen from US (we must have stalled past the TTL):
                # the thief owns the bucket — abandon, never commit
                _log.warning("serve[%s]: %s", self.host, e)
                continue
            except Exception as e:  # noqa: BLE001 — loud, never hung
                # an execution failure: transient ones (a device
                # hiccup, an OOM) get retried — releasing the lease
                # re-queues the bucket for ANY host to continue from
                # its checkpoint — while a deterministic failure
                # would crash-loop across every host that claims it,
                # so after max_attempts journaled starts the failure
                # turns terminal LOUDLY (awaiting clients get a
                # ServeRejected, drain can settle)
                scan = self.scan()
                attempts = sum(1 for ev in scan.events
                               if ev.get("ev") == "bucket_start"
                               and ev.get("bucket") == bid)
                if attempts < self.max_attempts:
                    _log.warning(
                        "serve[%s]: bucket %s attempt %d failed "
                        "(%s) — releasing for retry", self.host,
                        bid, attempts, e)
                else:
                    _log.error(
                        "serve[%s]: bucket %s FAILED after %d "
                        "attempt(s): %s", self.host, bid, attempts, e)
                    for rid, a in sorted(scan.admits.items()):
                        if a.get("bucket") == bid \
                                and rid not in scan.done \
                                and rid not in scan.failed:
                            self.journal.append(
                                {"ev": "world_failed", "run_id": rid,
                                 "bucket": bid, "attempts": attempts,
                                 "error":
                                     f"{type(e).__name__}: {e}"})
            self.journal.append({"ev": "lease_release",
                                 "bucket": bid, "host": self.host})
            self.leases.release(lease)
        return served

"""The streaming RunConfig frontend on the ``net/`` real-IO fabric
(the port's copy of ``timewarp_tpu/serve/frontend.py``; ``lint="warn"``
or ``"error"`` pre-flights each admission with analysis/plan_lint.py,
as the reference's does).

A serving process listening on ``HOST:PORT`` runs this: an
:class:`~timewarp_tpu_torch.net.rpc.Rpc` server (``Rpc.serve``/``Method``)
that accepts :class:`~timewarp_tpu_torch.sweep.spec.RunConfig`\\ s over the
wire *continuously*, admits each into an open bucket (worker.py —
between chunks, into reserved pow2-fleet slots), and streams each
``world_done`` back to the submitting client as its world quiesces.

Wire surface (all payloads ride as canonical JSON strings — the
result a client receives is byte-identical to the journaled record):

- ``ServeSubmit(config_json) -> ServeAccepted(run_id, bucket, slot)``
  — admission. **Idempotent by run_id**: re-submitting the same
  config (a client retrying a lost reply) returns the original
  placement; a different config under a taken run_id is
  ``ServeRejected``. The ``admit`` journal record is durable BEFORE
  the ack leaves, so an acked config survives a frontend kill.
- ``ServeAwait(run_id) -> ServeResult(record_json)`` — long-poll
  streaming: the handler suspends until the world's ``world_done``
  lands in the (merged, possibly another host's) journal, then
  returns the full record. Clients fork one await per submitted
  config and receive results in quiescence order.
- ``ServeStatus -> ServeStatusRep(status_json)`` — the same
  ``status_fields`` block ``sweep status --json`` prints.
- ``ServeDrain -> ServeDrained(admitted)`` — stop admitting; the
  frontend (and every curator, via the journaled ``serve_drain``)
  exits once all admitted worlds settle.

Results are discovered by tailing the journal directory with the
watch layer's torn-tail-tolerant :class:`TailReader` — so a result
computed by ANY host of the fleet streams back through this frontend.
"""

from __future__ import annotations

import hashlib
import json
import logging
from typing import Any, Dict, List, Optional, Tuple

from ..core.effects import Program, Wait
from ..manage.sync import Flag
from ..net.message import message
from ..net.rpc import Method, request
from ..sweep.journal import SweepJournal
from ..sweep.spec import (RunConfig, SweepConfigError, check_lint,
                          link_signature, resolve_window)

__all__ = ["ServeFrontend", "ServeSubmit", "ServeAccepted",
           "ServeRejected", "ServeAwait", "ServeResult",
           "ServeStatus", "ServeStatusRep", "ServeDrain",
           "ServeDrained", "bucket_key_sha"]

_log = logging.getLogger("timewarp.serve")


# -- wire messages ---------------------------------------------------------

@message
class ServeSubmit:
    config_json: str


@message
class ServeAccepted:
    run_id: str
    bucket: str
    slot: int


@message
class ServeRejected(Exception):
    reason: str

    def __post_init__(self):
        Exception.__init__(self, self.reason)


@message
class ServeAwait:
    run_id: str


@message
class ServeResult:
    record_json: str


@message
class ServeStatus:
    pass


@message
class ServeStatusRep:
    status_json: str


@message
class ServeDrain:
    pass


@message
class ServeDrained:
    admitted: int


request(response=ServeAccepted, error=ServeRejected)(ServeSubmit)
request(response=ServeResult, error=ServeRejected)(ServeAwait)
request(response=ServeStatusRep)(ServeStatus)
request(response=ServeDrained)(ServeDrain)


def bucket_key_sha(cfg: RunConfig) -> str:
    """The open-bucket identity: same family/params/link-structure/
    resolved-window/speculate configs share a batched executable —
    exactly the sweep bucketer's key (sweep/bucket.py), hashed so it
    can ride a journal record. The key is pure *shape* plus the
    per-bucket decision-source mode: per-world identity (seed, link
    values, fault tables) rides the executable as traced operands and
    never splits a bucket (docs/serving.md)."""
    key = (cfg.family, cfg.params, link_signature(cfg.parse_link()),
           resolve_window(cfg), cfg.speculate)
    return hashlib.sha256(repr(key).encode()).hexdigest()[:16]


class ServeFrontend:
    """Admission book + result streamer (module docstring). Journal
    appends happen on the event-loop thread and (from the embedded
    curator) a worker thread — the SweepJournal handle is shared and
    its append is locked, so per-host seq stamps stay unique."""

    def __init__(self, journal: SweepJournal, host: str,
                 listen: Tuple[str, int], *, slots: int = 4,
                 poll_us: int = 100_000, lint: str = "off",
                 pack_mode: str = "first-fit",
                 pack_artifact=None) -> None:
        if slots < 1:
            raise ValueError(f"--slots must be >= 1, got {slots}")
        check_lint(lint, type(self).__name__)
        from ..pack.allocate import validate_pack_mode
        #: slot placement policy (docs/serving.md "Predictive
        #: packing"): "first-fit" (the historical default — first
        #: same-key bucket with a free slot), or "predicted" — join
        #: the open bucket whose forecast remaining horizon best
        #: matches the admitted config's own forecast, journaled as a
        #: pack_decision record before the admit
        self.pack_mode = validate_pack_mode(pack_mode)
        self.pack_artifact = None
        if pack_artifact is not None:
            if isinstance(pack_artifact, str):
                from ..pack.predict import load_artifact
                self.pack_artifact = load_artifact(pack_artifact)
            else:
                self.pack_artifact = dict(pack_artifact)
        self.journal = journal
        self.host = host
        self.listen = listen
        self.slots = int(slots)
        self.poll_us = int(poll_us)
        #: admission-time pre-flight verification (analysis/plan_lint.py):
        #: "error" refuses a doomed config with its findings, "warn"
        #: logs them, "off" (the default) skips
        self.lint = lint
        #: key sha -> [bucket_id, ...] (newest last) — open buckets
        self._by_key: Dict[str, List[str]] = {}
        #: bucket_id -> {"capacity", "used": set(slot), "key"}
        self._buckets: Dict[str, dict] = {}
        self._admitted: Dict[str, dict] = {}     # run_id -> admit info
        self.results: Dict[str, dict] = {}       # run_id -> world_done rec
        self.failed: Dict[str, dict] = {}
        self._waiters: Dict[str, List[Flag]] = {}
        self._tails: Dict[str, Any] = {}
        self._next_bucket = 0
        self.draining = False
        self._seed_from_journal()
        self.journal.append({"ev": "serve_open", "host": host,
                             "listen": f"{listen[0]}:{listen[1]}",
                             "slots": self.slots})

    # -- state reconstruction (resume) ------------------------------------

    def _seed_from_journal(self) -> None:
        scan = SweepJournal(self.journal.root).scan()
        for bid, meta in scan.serve_buckets.items():
            self._buckets[bid] = {"capacity": int(meta["capacity"]),
                                  "used": set(), "key": meta["key"],
                                  "closed": bid in scan.bucket_done}
            self._by_key.setdefault(meta["key"], []).append(bid)
            n = int(bid[2:]) if bid.startswith("sb") \
                and bid[2:].isdigit() else -1
            self._next_bucket = max(self._next_bucket, n + 1)
        for rid, a in scan.admits.items():
            self._admitted[rid] = dict(a)
            b = self._buckets.get(a.get("bucket"))
            if b is not None:
                b["used"].add(int(a["slot"]))
        for rid, res in scan.done.items():
            # seed full records so pre-restart results stream again
            rec = next((e for e in scan.events
                        if e.get("ev") == "world_done"
                        and e["result"]["run_id"] == rid), None)
            if rec is not None:
                self.results[rid] = {
                    k: v for k, v in rec.items()
                    if k not in ("host", "seq", "ts")}
        self.failed.update(scan.failed)
        self.draining = scan.draining

    # -- admission ---------------------------------------------------------

    def admit(self, d: Any) -> Tuple[str, str, int]:
        if self.draining:
            raise ServeRejected(
                "service is draining — no new admissions "
                "(docs/serving.md)")
        if not isinstance(d, dict):
            raise ServeRejected(
                f"a submission is one JSON config object, got "
                f"{type(d).__name__}")
        if "id" not in d:
            raise ServeRejected(
                "a submitted config needs an explicit \"id\" — "
                "run_ids are the idempotence key for retried "
                "submissions (the submit client assigns w0..wN "
                "automatically)")
        try:
            cfg = RunConfig.from_json(d, 0)
        except SweepConfigError as e:
            raise ServeRejected(str(e)) from None
        if cfg.controller != "off":
            raise ServeRejected(
                f"config {cfg.run_id!r}: the serving layer admits "
                "static-dispatch and speculate configs; controller "
                "packs run through the sweep service — the "
                "telemetry controller's per-bucket decision source "
                "assumes a fixed fleet (docs/serving.md)")
        prev = self._admitted.get(cfg.run_id)
        if prev is not None:
            if prev.get("config") == cfg.to_json():
                return cfg.run_id, prev["bucket"], int(prev["slot"])
            raise ServeRejected(
                f"run_id {cfg.run_id!r} is already admitted with a "
                "different config — run_ids are unique per service")
        if self.lint != "off":
            # pre-flight verification at admission (plan_lint.py): every
            # refusal the curator would hit mid-bucket — window undercuts,
            # doomed speculation, the scenario sanitizer, fault-aware
            # capacity proofs — refused HERE, with the pinned findings in
            # the reply and nothing journaled
            from ..analysis import lint_run_config
            rep = lint_run_config(cfg)
            if self.lint == "error" and not rep.ok:
                raise ServeRejected(
                    f"config {cfg.run_id!r} failed pre-flight lint "
                    "(docs/serving.md 'Pre-flight verification'):\n"
                    + "\n".join(f.render() for f in rep.errors))
            for f in rep.errors:
                _log.warning("admission lint: %s", f.render())
            for f in rep.warnings:
                _log.info("admission lint: %s", f.render())
        try:
            key = bucket_key_sha(cfg)
        except SweepConfigError as e:
            raise ServeRejected(str(e)) from None
        bid = slot = None
        cands = [c for c in self._by_key.get(key, [])
                 if not self._buckets[c].get("closed")
                 and len(self._buckets[c]["used"])
                 < self._buckets[c]["capacity"]]
        if self.pack_mode == "predicted":
            # predictive placement (docs/serving.md "Predictive
            # packing"): join the open bucket whose forecast remaining
            # horizon is CLOSEST to this config's own forecast —
            # journaled BEFORE its effect (the admit / bucket_open
            # below), so resume and stealing curators replay the same
            # placement from the record, never the predictor
            from ..pack.allocate import best_horizon_bucket
            from ..pack.predict import predict_supersteps
            pred = predict_supersteps(cfg, self.pack_artifact)
            horizon = None
            if cands:
                pairs = [(c, self._predicted_horizon(c))
                         for c in cands]
                bid = best_horizon_bucket(pred, pairs)
                horizon = dict(pairs)[bid]
            self.journal.append({
                "ev": "pack_decision", "kind": "place",
                "run_id": cfg.run_id,
                "bucket": bid if bid is not None
                else f"sb{self._next_bucket}",
                "mode": self.pack_mode, "predicted": pred,
                "horizon": horizon,
                "artifact_sha":
                    (self.pack_artifact or {}).get("sha")})
        elif cands:
            bid = cands[0]
        if bid is not None:
            b = self._buckets[bid]
            slot = min(set(range(b["capacity"])) - b["used"])
        if bid is None:
            bid = f"sb{self._next_bucket}"
            self._next_bucket += 1
            self._buckets[bid] = {"capacity": self.slots,
                                  "used": set(), "key": key}
            self._by_key.setdefault(key, []).append(bid)
            self.journal.append({"ev": "bucket_open", "bucket": bid,
                                 "key": key, "capacity": self.slots,
                                 "window": resolve_window(cfg)})
            slot = 0
        # durable BEFORE the ack (module docstring): an acked config
        # survives a frontend kill — resume re-seeds from this record
        rec = {"ev": "admit", "run_id": cfg.run_id, "bucket": bid,
               "slot": slot, "config": cfg.to_json()}
        self.journal.append(rec)
        self._admitted[cfg.run_id] = {
            k: v for k, v in rec.items() if k != "ev"}
        self._buckets[bid]["used"].add(slot)
        return cfg.run_id, bid, slot

    def _predicted_horizon(self, bid: str) -> int:
        """Forecast remaining horizon of an open bucket: the max
        predicted supersteps over its active (admitted, unsettled)
        members — 0 when every member has settled, i.e. the bucket is
        about to quiesce and a short config should join IT rather
        than pin a long-running fleet's pow2 pad."""
        from ..pack.predict import predict_supersteps
        horizon = 0
        for rid, a in self._admitted.items():
            if a.get("bucket") != bid or rid in self.results \
                    or rid in self.failed:
                continue
            try:
                mcfg = RunConfig.from_json(dict(a["config"]), 0)
            except SweepConfigError:
                continue
            horizon = max(horizon, predict_supersteps(
                mcfg, self.pack_artifact))
        return horizon

    # -- result tailing ----------------------------------------------------

    def _poll_records(self) -> List[str]:
        """Consume new journal records from every host file (same
        file discovery as :meth:`SweepJournal.journal_files`, same
        merge order as its reader); returns the run_ids newly settled
        (done or failed). Beyond results, the tail also folds the
        records CURATORS write that move admission state — repack
        re-points and bucket closures — so the frontend can never
        assign a slot a repack just filled, or admit into a closed
        donor bucket."""
        from ..obs.watch import TailReader
        from ..sweep.journal import merge_key
        fresh: List[str] = []
        batch: List[dict] = []
        for p in SweepJournal(self.journal.root).journal_files():
            tail = self._tails.get(p)
            if tail is None:
                tail = self._tails[p] = TailReader(p)
            batch.extend(tail.poll())
        batch.sort(key=merge_key)
        for rec in batch:
            ev = rec.get("ev")
            if ev == "world_done":
                rid = rec["result"]["run_id"]
                if rid not in self.results:
                    self.results[rid] = {
                        k: v for k, v in rec.items()
                        if k not in ("host", "seq", "ts")}
                    fresh.append(rid)
            elif ev == "world_failed":
                rid = rec["run_id"]
                if rid not in self.failed:
                    self.failed[rid] = rec
                    fresh.append(rid)
            elif ev == "admit":
                # a curator's repack re-point (the frontend's own
                # admits are applied synchronously in admit()): track
                # the world's new home and mark the target slot used
                rid = rec["run_id"]
                prev = self._admitted.get(rid)
                if prev is None or "repacked_from" in rec \
                        or "repacked_from" not in prev:
                    self._admitted[rid] = {
                        k: v for k, v in rec.items() if k != "ev"}
                b = self._buckets.get(rec.get("bucket"))
                if b is not None:
                    b["used"].add(int(rec["slot"]))
            elif ev == "bucket_done":
                # a closed bucket (repack donor, or drained) never
                # takes another admission
                b = self._buckets.get(rec.get("bucket"))
                if b is not None:
                    b["closed"] = True
        return fresh

    def settled(self) -> bool:
        return all(rid in self.results or rid in self.failed
                   for rid in self._admitted)

    # -- rpc methods -------------------------------------------------------

    def methods(self) -> List[Method]:
        front = self

        def submit(req: ServeSubmit, ctx) -> Program:
            try:
                d = json.loads(req.config_json)
            except json.JSONDecodeError as e:
                raise ServeRejected(f"config is not JSON: {e}") \
                    from None
            rid, bid, slot = front.admit(d)
            _log.info("serve[%s]: admitted %r -> bucket %s slot %d",
                      front.host, rid, bid, slot)
            return ServeAccepted(rid, bid, slot)
            yield  # pragma: no cover — generator marker

        def await_(req: ServeAwait, ctx) -> Program:
            rid = req.run_id
            if rid not in front._admitted:
                raise ServeRejected(
                    f"unknown run_id {rid!r} — submit it first")
            while rid not in front.results:
                if rid in front.failed:
                    raise ServeRejected(
                        f"world {rid!r} FAILED: "
                        f"{front.failed[rid].get('error', '?')}")
                flag = Flag()
                front._waiters.setdefault(rid, []).append(flag)
                yield from flag.wait()
            return ServeResult(json.dumps(front.results[rid],
                                          sort_keys=True))

        def status(req: ServeStatus, ctx) -> Program:
            from ..sweep.journal import status_fields
            scan = SweepJournal(front.journal.root).scan()
            return ServeStatusRep(json.dumps(
                status_fields(scan, len(scan.admits))))
            yield  # pragma: no cover — generator marker

        def drain(req: ServeDrain, ctx) -> Program:
            if not front.draining:
                front.draining = True
                front.journal.append({"ev": "serve_drain",
                                      "host": front.host})
            return ServeDrained(len(front._admitted))
            yield  # pragma: no cover — generator marker

        return [Method(ServeSubmit, submit),
                Method(ServeAwait, await_),
                Method(ServeStatus, status),
                Method(ServeDrain, drain)]

    # -- the server program ------------------------------------------------

    def program(self, rpc, *,
                max_seconds: Optional[float] = None) -> Program:
        """The frontend's main program (run under ``run_real_time``):
        serve, tail results to waiters, exit once drained & settled."""
        stop = yield from rpc.serve(self.listen[1], self.methods())
        elapsed_us = 0
        budget_us = None if max_seconds is None \
            else int(max_seconds * 1e6)
        try:
            while True:
                yield Wait(self.poll_us)
                elapsed_us += self.poll_us
                for rid in self._poll_records():
                    for flag in self._waiters.pop(rid, []):
                        yield from flag.set()
                if self.draining and self.settled():
                    return
                if budget_us is not None and elapsed_us >= budget_us:
                    _log.warning("serve[%s]: --max-seconds reached "
                                 "with %d world(s) unsettled",
                                 self.host,
                                 sum(1 for r in self._admitted
                                     if r not in self.results
                                     and r not in self.failed))
                    return
        finally:
            self.journal.append({"ev": "serve_done",
                                 "host": self.host,
                                 "admitted": len(self._admitted),
                                 "completed": len(self.results)})
            yield from stop()

"""``timewarp-tpu-torch sweep run|resume|status|watch`` — the sweep CLI.

::

    timewarp-tpu-torch sweep run pack.json --journal DIR [--chunk N]
        [--retries K] [--backoff-us U] [--timeout-us T] [--inject S]
        [--max-bucket B] [--verify]
    timewarp-tpu-torch sweep resume --journal DIR [...same knobs] [--verify]
    timewarp-tpu-torch sweep status --journal DIR
    timewarp-tpu-torch sweep watch --journal DIR [--interval S] [--once]

``run`` on a fresh dir starts the sweep; on an existing dir it
resumes (same pack only — a different pack is refused loudly).
``resume`` needs no pack argument: the journaled copy is the truth.
``status`` prints one JSON line of progress without running anything;
its ``events`` block (dispatch decisions, speculation rollbacks,
integrity violations) comes from the same journal fold the live
``watch`` renders, so the two surfaces always agree. ``watch``
attaches a READ-ONLY refreshing tail to a running (or finished)
sweep — obs/watch.py, docs/observability.md "Fleet observability".
``--verify`` re-runs every completed world solo after the sweep and
asserts the streamed result is bit-identical — the sweep survival law
as an executable gate (CI runs it).

Exit codes: 0 = every world completed (and verified, if asked);
1 = terminal world failures or a verification mismatch; an injected
``die:K`` kill exits 1 with the kill message (resume then finishes
the pack).
"""

from __future__ import annotations

import argparse
import json
import sys

from .journal import SweepJournal
from .service import SweepKilled, SweepService
from .spec import SweepConfigError, SweepPack, solo_result

__all__ = ["sweep_main"]


def _loud(fn):
    """Library config errors (SweepConfigError, the service's
    construction-time ValueError guards — bad chunk/retries, an
    unarmed flip injection — and a ``--lint error`` pack refusal)
    become clean CLI exits, keeping the guard-named message without a
    traceback."""
    from ..analysis import LintError
    try:
        return fn()
    except LintError as e:
        # the pre-flight verifier refused the pack (plan_lint.py):
        # exit with the pinned findings, one per line — no engine was
        # built, nothing was journaled
        raise SystemExit(str(e)) from None
    except (SweepConfigError, ValueError) as e:
        raise SystemExit(str(e)) from None


def _service_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--journal", required=True,
                   help="journal directory (JSONL log + checkpoints)")
    p.add_argument("--chunk", type=int, default=64,
                   help="supersteps per chunk between checkpoints")
    p.add_argument("--retries", type=int, default=2,
                   help="max retries per bucket before loud terminal "
                        "failure")
    p.add_argument("--backoff-us", type=int, default=50_000,
                   help="retry backoff base (doubles per attempt)")
    p.add_argument("--timeout-us", type=int, default=None,
                   help="per-bucket-attempt watchdog deadline")
    p.add_argument("--grace-us", type=int, default=500_000,
                   help="Force-clear grace after a watchdog interrupt")
    p.add_argument("--max-bucket", type=int, default=64,
                   help="max worlds per batched bucket")
    p.add_argument("--lint", default="warn",
                   choices=["error", "warn", "off"],
                   help="pre-flight verification of the whole pack "
                        "before any bucket builds (plan lint + "
                        "per-world sanitizer + fault-aware capacity "
                        "proofs) AND per-engine construction lint: "
                        "'error' refuses with the findings, 'warn' "
                        "(default) logs them, 'off' skips "
                        "(docs/sweeps.md 'Pre-flight verification')")
    p.add_argument("--inject", default=None,
                   help="deterministic failure injection: fail:K | "
                        "oom:K | die:K | hang:K:MS | "
                        "flip:SEED[:K[:PLANE]] (';'-joined, K = "
                        "1-based chunk call) — CI/test chaos for the "
                        "sweep machinery itself; flip writes a seeded "
                        "bit-flip into a bucket's state between "
                        "chunks (docs/integrity.md)")
    p.add_argument("--state-verify", default="off",
                   choices=["off", "guard", "digest"],
                   help="online state-integrity checking per bucket "
                        "(integrity/, docs/integrity.md): guard = "
                        "on-device invariant checks in every chunk; "
                        "digest = + rolling per-world state digest "
                        "verified at each chunk entry and chained "
                        "through the checkpoints (verified epochs). "
                        "Detection journals integrity_violation and "
                        "rolls the bucket back to its last verified "
                        "checkpoint")
    p.add_argument("--verify", action="store_true",
                   help="after the sweep, re-run every completed "
                        "world solo and assert the streamed result is "
                        "bit-identical (the sweep survival law)")
    p.add_argument("--hosts", default=None,
                   help="multi-host mode (serve/, docs/serving.md): "
                        "NAME[,PEER...] — first entry is THIS "
                        "process's identity (HOST_GRAMMAR). N "
                        "processes sharing one --journal cooperate "
                        "through per-bucket leases; a dead host's "
                        "buckets are stolen after --lease-ttl-s and "
                        "continue from their shared checkpoints")
    p.add_argument("--lease-ttl-s", type=float, default=30.0,
                   help="lease staleness TTL for --hosts mode")
    p.add_argument("--telemetry", default="off",
                   choices=["off", "counters", "full"],
                   help="engine telemetry mode (obs/, "
                        "docs/observability.md): bucket engines "
                        "thread per-superstep counter planes (bit-"
                        "exact; results are mode-independent), the "
                        "journal dir gains metrics.jsonl + a Perfetto "
                        "trace.json of service spans")
    p.add_argument("--trace-out", default=None,
                   help="write the Perfetto trace here instead of "
                        "<journal>/trace.json (needs --telemetry)")
    p.add_argument("--record", default="off",
                   choices=["off", "deliveries", "full"],
                   help="causal flight recorder per bucket "
                        "(obs/flight.py, docs/observability.md): "
                        "bucket engines thread the bounded event "
                        "plane (bit-exact; results are mode-"
                        "independent) and every chunk's per-world "
                        "events drain into <journal>/events.jsonl "
                        "tagged by run_id — query with `timewarp-tpu-torch "
                        "explain <journal>/events.jsonl --run-id ID`; "
                        "`sweep status` surfaces per-world event "
                        "counts")
    p.add_argument("--pack", default="first-fit", dest="pack_mode",
                   help="bucket packing mode (first-fit | predicted; "
                        "docs/sweeps.md 'Predictive packing'): "
                        "predicted reorders each shape group best-fit-"
                        "decreasing by forecast supersteps and "
                        "journals the plan as pack_decision records "
                        "(streamed results are bit-identical either "
                        "way — the survival law holds per world)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the bucket engines' device (and the --verify "
                        "solo runs'): the CUDA device (default) or the "
                        "CPU")
    p.add_argument("--pack-artifact", default=None,
                   help="sha-stamped predictor artifact from "
                        "`timewarp-tpu-torch pack fit` (--pack predicted "
                        "falls back to each world's declared budget "
                        "without one)")


def _kw(args) -> dict:
    if args.trace_out and args.telemetry == "off":
        raise SystemExit("--trace-out needs --telemetry "
                         "counters|full (off records nothing)")
    host = None
    if args.hosts is not None:
        from ..serve.hosts import parse_hosts
        host = parse_hosts(args.hosts)[0].name
    from ..cli import require_device
    device = require_device(args.device)
    return dict(chunk=args.chunk, max_retries=args.retries,
                backoff_us=args.backoff_us,
                bucket_timeout_us=args.timeout_us,
                grace_us=args.grace_us, max_bucket=args.max_bucket,
                lint=args.lint, inject=args.inject,
                telemetry=args.telemetry, trace_out=args.trace_out,
                verify=args.state_verify, record=args.record,
                host=host, lease_ttl_s=args.lease_ttl_s,
                pack_mode=args.pack_mode,
                pack_artifact=args.pack_artifact,
                # a promised post-sweep --verify arms the flip guard's
                # other legal detection path (service.py)
                post_verify=args.verify, device=device)


def _auto_bisect(trail, trace) -> dict:
    """Localize one ``--verify`` mismatch (obs/bisect.py): fold the
    solo twin's trace rows (already computed by the verify run
    itself) chunk-for-chunk against the world's journaled digest
    trail (the ``world_done`` record's ``chain``) — the result names
    the first diverging chunk and its superstep span, or reports that
    every journaled chunk agrees (the divergence then lies outside
    the digested rows)."""
    if not trail:
        return {"first_divergence": None}
    from ..obs.bisect import first_trail_divergence
    return {"first_divergence": first_trail_divergence(trail, trace)}


def _finish(svc: SweepService, verify: bool) -> int:
    try:
        report = svc.run()
    except SweepKilled as e:
        print(json.dumps({"sweep": "killed", "error": str(e)}))
        return 1
    out = report.to_json()
    if svc.trace_path is not None:
        out["trace"] = svc.trace_path
        out["metrics"] = svc.metrics.path
    if svc.flight is not None:
        out["events"] = svc.flight.path
        out["flight_events"] = svc.flight.events
    if verify:
        mismatches = []
        scan = svc.journal.scan()
        for rid, res in sorted(report.done.items()):
            cfg = svc.pack.by_id(rid)
            # controller AND speculate worlds: the solo twin replays
            # the bucket's journaled decision chain (the replay law
            # carries the survival law — docs/dispatch.md; for
            # speculation the chain is the committed window sequence,
            # rollbacks already resolved to their floor decisions —
            # docs/speculation.md)
            decs = svc.decisions_for_world(rid, scan) \
                if cfg.controller == "auto" or cfg.speculate != "off" \
                else None
            want, solo_tr = solo_result(cfg, lint="off",
                                        decisions=decs,
                                        with_trace=True,
                                        device=svc.device)
            if want != res:
                mm = {"run_id": rid, "solo": want, "streamed": res}
                # auto-bisect the mismatch (obs/bisect.py): replay
                # the world's journaled per-chunk digest trail
                # against the solo twin's trace and name the first
                # diverging chunk — "which chunk broke", not just
                # "a digest differs"
                mm.update(_auto_bisect(scan.chains.get(rid, []),
                                       solo_tr))
                mismatches.append(mm)
        out["verified"] = len(report.done) - len(mismatches)
        if mismatches:
            out["verify_mismatches"] = mismatches
            print(json.dumps(out))
            for mm in mismatches:
                d = mm.get("first_divergence")
                sys.stderr.write(
                    f"sweep --verify: {mm['run_id']}: "
                    + (f"first diverging chunk {d['chunk']} "
                       f"(supersteps {d['supersteps'][0]}.."
                       f"{d['supersteps'][1]}): streamed "
                       f"{d['streamed'][:12]}.. != solo "
                       f"{str(d['solo'])[:12]}.."
                       if d else
                       "journaled chunk trail matches the solo "
                       "trace — the divergence is outside the "
                       "digested rows (counters/final state)")
                    + "\n")
            sys.stderr.write(
                "sweep survival law VIOLATED: streamed results "
                "diverge from solo runs\n")
            return 1
    print(json.dumps(out))
    return 0 if report.ok else 1


def _run(argv) -> int:
    p = argparse.ArgumentParser(
        prog="timewarp-tpu-torch sweep run",
        description="Run (or resume, on an existing journal) a pack.")
    p.add_argument("pack", help="pack file: JSON list (or JSONL) of "
                   "run configs — see docs/sweeps.md")
    p.add_argument("--speculate", default=None,
                   help="optimistic time-warp execution per bucket "
                        "(speculate/, docs/speculation.md): "
                        "auto | fixed:W — applied as the pack-level "
                        "default to every config that does not set "
                        "its own \"speculate\" (explicit per-config "
                        "values — including \"off\" — win; this flag "
                        "beats a pack-file-level \"speculate\" key; "
                        "the journaled pack carries the result, so "
                        "resume needs no flag). Committed window "
                        "choices journal as dispatch_decision events "
                        "and --verify replays them; rollbacks "
                        "surface in `sweep status` spec_rollbacks")
    _service_args(p)
    args = p.parse_args(argv)

    def build():
        if args.speculate:
            from ..speculate import parse_speculate
            parse_speculate(args.speculate, who="--speculate")
        # the default applies at the JSON layer (explicit per-config
        # values — including an explicit "off" opt-out — win) and
        # BEFORE the pack is journaled, so pack.sha / resume / bucket
        # planning all see the speculated configs exactly as if the
        # pack file said it
        pack = SweepPack.load(args.pack,
                              speculate_default=args.speculate)
        return SweepService(pack, args.journal, **_kw(args))
    svc = _loud(build)
    return _finish(svc, args.verify)


def _resume(argv) -> int:
    p = argparse.ArgumentParser(
        prog="timewarp-tpu-torch sweep resume",
        description="Resume a killed sweep from its journal dir.")
    _service_args(p)
    args = p.parse_args(argv)
    svc = _loud(lambda: SweepService.resume(args.journal, **_kw(args)))
    return _finish(svc, args.verify)


def _status(argv) -> int:
    p = argparse.ArgumentParser(
        prog="timewarp-tpu-torch sweep status",
        description="One JSON progress line from a sweep journal.")
    p.add_argument("--journal", required=True)
    args = p.parse_args(argv)
    j = SweepJournal(args.journal)
    import os

    from .journal import status_fields
    if os.path.exists(j.pack_path):
        total = len(SweepPack.load(j.pack_path).configs)
        scan = j.scan()
    elif j.exists():
        # a serve journal dir (docs/serving.md) has no pack — the
        # world count is the admission ledger's
        scan = j.scan()
        total = len(scan.admits)
    else:
        raise SystemExit(
            f"{args.journal!r} holds no sweep (no pack.json and no "
            "journal files)")
    # ONE shared fold + assembly (journal.py status_fields) behind
    # both this line and `sweep watch`'s aggregates — the two
    # surfaces report identical numbers from the same journal by
    # construction (docs/observability.md "Fleet observability")
    print(json.dumps(status_fields(scan, total)))
    return 0


def _watch(argv) -> int:
    p = argparse.ArgumentParser(
        prog="timewarp-tpu-torch sweep watch",
        description="READ-ONLY live tail of a sweep journal dir "
                    "(obs/watch.py): refreshing aggregates — worlds "
                    "done, buckets in flight, retries, event counts, "
                    "utilization. Plain append-only output (no "
                    "escape codes); one line per refresh in which "
                    "anything changed.")
    p.add_argument("--journal", required=True,
                   help="the sweep's journal directory")
    p.add_argument("--interval", type=float, default=2.0,
                   help="poll interval in seconds (default 2.0)")
    p.add_argument("--once", action="store_true",
                   help="render one snapshot and exit 0 — the CI "
                        "form against a finished journal")
    p.add_argument("--json", action="store_true",
                   help="one JSON object per refresh instead of the "
                        "text line (final snapshot's shared fields "
                        "equal `sweep status --json`)")
    p.add_argument("--max-seconds", type=float, default=None,
                   help="stop watching after this long even if the "
                        "sweep is still running (default: watch "
                        "until sweep_done or Ctrl-C)")
    args = p.parse_args(argv)
    if args.interval <= 0:
        raise SystemExit(
            f"--interval must be > 0, got {args.interval}")
    import time as _time

    from ..obs.watch import SweepWatch
    if args.once and not SweepJournal(args.journal).exists():
        raise SystemExit(
            f"{args.journal!r} holds no sweep journal to snapshot "
            "(no journal*.jsonl)")
    w = SweepWatch(args.journal)
    deadline = None if args.max_seconds is None \
        else _time.monotonic() + args.max_seconds
    last = None
    try:
        while True:
            snap = w.poll()
            out = json.dumps(snap) if args.json else w.render(snap)
            if out != last:
                print(out, flush=True)
                last = out
            if args.once or w.finished:
                return 0
            if deadline is not None and _time.monotonic() >= deadline:
                return 0
            _time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0        # watching is observational; detach quietly


def sweep_main(argv) -> int:
    if not argv or argv[0] not in ("run", "resume", "status",
                                   "watch"):
        raise SystemExit(
            "usage: timewarp-tpu-torch sweep run PACK --journal DIR | "
            "sweep resume --journal DIR | sweep status --journal DIR"
            " | sweep watch --journal DIR")
    cmd, rest = argv[0], argv[1:]
    if cmd == "run":
        return _run(rest)
    if cmd == "resume":
        return _resume(rest)
    if cmd == "watch":
        return _watch(rest)
    return _status(rest)

"""``timewarp-tpu-torch serve`` / ``timewarp-tpu-torch submit`` — the service CLI.

::

    timewarp-tpu-torch serve --journal DIR --hosts NAME[,...] \\
        [--listen HOST:PORT] [--slots W] [--chunk N] [--lease-ttl-s T]
        [--no-curator | --no-repack] [--max-seconds S]
    timewarp-tpu-torch submit CONFIGS --connect HOST:PORT \\
        [--timeout-s T] [--verify] [--drain] [--no-wait]

``serve`` with ``--listen`` runs the streaming frontend (RPC over
real TCP, frontend.py) plus — unless ``--no-curator`` — an embedded
execution curator; without ``--listen`` it joins the fleet as a
curator-only host, claiming and stealing buckets through the shared
journal directory's leases (curator.py). Any number of hosts share
one ``--journal`` dir; each needs a unique first ``--hosts`` name.

``submit`` loads a pack-shaped JSON/JSONL file (or one config
object), submits every config, and streams each ``world_done`` record
to stdout as its world quiesces (completion order). ``--verify``
re-runs every config solo afterwards and asserts the streamed result
is bit-identical — the extended survival law as an executable gate
(the CI serve-smoke job runs it). ``--drain`` tells the service to
stop admitting and exit once everything settles.

Exit codes: serve — 0 drained/deadline, 1 on an injected curator
death; submit — 0 all results streamed (and verified, if asked),
1 on failures/mismatches/timeouts.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
from typing import List, Optional

from ..sweep.journal import SweepJournal
from ..sweep.spec import SweepConfigError
from .curator import CuratorKilled, ServeCurator
from .hosts import parse_hosts, parse_listen

__all__ = ["serve_main", "submit_main"]


def _serve(argv) -> int:
    p = argparse.ArgumentParser(
        prog="timewarp-tpu-torch serve",
        description="Emulation as a service: streaming RunConfig "
                    "frontend + multi-host work-stealing curators "
                    "(docs/serving.md).")
    p.add_argument("--journal", required=True,
                   help="shared journal directory (per-host JSONL "
                        "logs, lease files, bucket checkpoints)")
    p.add_argument("--hosts", required=True,
                   help="NAME[@HOST:PORT][,PEER...] — first entry is "
                        "THIS host's identity (HOST_GRAMMAR)")
    p.add_argument("--listen", default=None,
                   help="HOST:PORT to serve the RPC frontend on; "
                        "omit to run a curator-only host")
    p.add_argument("--slots", type=int, default=4,
                   help="world slots per open bucket (reserved "
                        "capacity mid-bucket admissions fill)")
    p.add_argument("--chunk", type=int, default=64,
                   help="supersteps per chunk between checkpoints / "
                        "admission points")
    p.add_argument("--lint", default="off",
                   choices=["error", "warn", "off"],
                   help="pre-flight verification: 'error' refuses a "
                        "ServeSubmit whose config fails the plan "
                        "lint / scenario sanitizer / fault-aware "
                        "capacity proof — findings in the reply, "
                        "nothing journaled; also the curators' "
                        "engine-construction lint knob "
                        "(docs/serving.md 'Pre-flight verification')")
    p.add_argument("--lease-ttl-s", type=float, default=10.0,
                   help="lease staleness TTL: a host silent this long "
                        "has its buckets stolen")
    p.add_argument("--poll-s", type=float, default=0.2,
                   help="curator idle poll interval")
    p.add_argument("--heartbeat-s", type=float, default=1.0,
                   help="min interval between journaled heartbeats")
    p.add_argument("--no-curator", action="store_true",
                   help="frontend only: admit + stream, execute "
                        "nothing (other hosts run the curators)")
    p.add_argument("--no-repack", action="store_true",
                   help="disable the between-chunk merge of "
                        "under-occupied same-key open buckets")
    p.add_argument("--pack", default="first-fit", dest="pack_mode",
                   help="slot placement / repack policy (first-fit | "
                        "predicted; docs/serving.md 'Predictive "
                        "packing'): predicted places each admission "
                        "in the open bucket whose forecast remaining "
                        "horizon best matches it, and repacks when "
                        "PREDICTED occupancy falls under the floor — "
                        "every choice journaled as a pack_decision")
    p.add_argument("--pack-artifact", default=None,
                   help="sha-stamped predictor artifact from "
                        "`timewarp-tpu-torch pack fit` (predicted mode "
                        "falls back to declared budgets without one)")
    p.add_argument("--max-seconds", type=float, default=None,
                   help="hard deadline: exit even if not drained")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the curator's open buckets' device: the CUDA "
                        "device (default) or the CPU (a --no-curator "
                        "frontend builds no engine)")
    p.add_argument("--die-after-chunks", type=int, default=None,
                   help="TEST INJECTION: abandon the curator after "
                        "K chunk calls WITHOUT releasing its lease — "
                        "what the steal law is pinned against")
    args = p.parse_args(argv)
    fleet = parse_hosts(args.hosts)
    me = fleet[0]
    if args.no_curator and args.listen is None:
        raise SystemExit("--no-curator without --listen would serve "
                         "nothing and execute nothing")

    # validate the knob (and load + sha-check the artifact) ONCE,
    # loudly, before any journal record exists
    from ..pack.allocate import validate_pack_mode
    validate_pack_mode(args.pack_mode)
    artifact = None
    if args.pack_artifact is not None:
        from ..pack.predict import load_artifact
        artifact = load_artifact(args.pack_artifact)

    from ..cli import require_device
    device = None if args.no_curator else require_device(args.device)
    journal = SweepJournal(args.journal, host=me.name)
    cur: Optional[ServeCurator] = None
    if not args.no_curator:
        cur = ServeCurator(
            args.journal, me.name, chunk=args.chunk, lint=args.lint,
            lease_ttl_s=args.lease_ttl_s, poll_s=args.poll_s,
            heartbeat_s=args.heartbeat_s, repack=not args.no_repack,
            die_after_chunks=args.die_after_chunks, journal=journal,
            pack_mode=args.pack_mode, pack_artifact=artifact,
            device=device)

    if args.listen is None:
        # curator-only host: the claim loop IS the process
        try:
            served = cur.run(max_seconds=args.max_seconds)
        except CuratorKilled as e:
            print(json.dumps({"serve": "killed", "host": me.name,
                              "error": str(e)}))
            return 1
        finally:
            journal.close()
        print(json.dumps({"serve": "done", "host": me.name,
                          "buckets_served": served}))
        return 0

    listen = parse_listen(args.listen)
    from ..interp.aio.timed import run_real_time
    from ..net.backend import AioBackend
    from ..net.dialog import Dialog
    from ..net.rpc import Rpc
    from ..net.transfer import Transport
    from .frontend import ServeFrontend
    front = ServeFrontend(journal, me.name, listen, slots=args.slots,
                          lint=args.lint, pack_mode=args.pack_mode,
                          pack_artifact=artifact)
    worker = None
    killed: List[BaseException] = []
    if cur is not None:
        def _work():
            try:
                cur.run()
            except CuratorKilled as e:
                killed.append(e)
            except Exception as e:  # noqa: BLE001 — surfaced at exit
                killed.append(e)
        worker = threading.Thread(target=_work, name="tw-serve-cur",
                                  daemon=True)
        worker.start()
    rpc = Rpc(Dialog(Transport(AioBackend())))
    try:
        run_real_time(lambda: front.program(
            rpc, max_seconds=args.max_seconds))
    finally:
        if cur is not None:
            cur.stop = True
        if worker is not None:
            worker.join(timeout=10.0)
        journal.close()
    if killed:
        print(json.dumps({"serve": "killed", "host": me.name,
                          "error": str(killed[0])}))
        return 1
    print(json.dumps({"serve": "done", "host": me.name,
                      "listen": args.listen,
                      "admitted": len(front._admitted),
                      "completed": len(front.results),
                      "failed": sorted(front.failed)}))
    return 0 if not front.failed else 1


def _load_configs(path: str) -> List[dict]:
    with open(path) as f:
        text = f.read()
    try:
        data = json.loads(text)
    except json.JSONDecodeError:
        try:
            data = [json.loads(line) for line in text.splitlines()
                    if line.strip()]
        except json.JSONDecodeError as e:
            raise SystemExit(
                f"{path!r} is neither JSON nor JSONL ({e})") from None
    if isinstance(data, dict) and "worlds" in data:
        data = data["worlds"]
    if isinstance(data, dict):
        data = [data]
    if not isinstance(data, list) or not data:
        raise SystemExit(f"{path!r} holds no configs (expected a "
                         "JSON list, {'worlds': [...]}, or one "
                         "config object)")
    out = []
    for i, d in enumerate(data):
        if isinstance(d, dict) and "id" not in d:
            d = {**d, "id": f"w{i}"}
        out.append(d)
    return out


def _submit(argv) -> int:
    p = argparse.ArgumentParser(
        prog="timewarp-tpu-torch submit",
        description="Submit RunConfigs to a running service and "
                    "stream each world_done back as it quiesces "
                    "(docs/serving.md).")
    p.add_argument("configs", help="pack-shaped JSON/JSONL file (or "
                                   "one config object)")
    p.add_argument("--connect", required=True,
                   help="the service's HOST:PORT (HOST_GRAMMAR)")
    p.add_argument("--timeout-s", type=float, default=120.0,
                   help="overall deadline for submit + stream")
    p.add_argument("--call-timeout-s", type=float, default=10.0,
                   help="per-RPC timeout before an idempotent retry")
    p.add_argument("--verify", action="store_true",
                   help="after streaming, re-run every config solo "
                        "and assert each streamed result is "
                        "bit-identical (the extended survival law)")
    p.add_argument("--drain", action="store_true",
                   help="tell the service to stop admitting and exit "
                        "once everything settles")
    p.add_argument("--no-wait", action="store_true",
                   help="submit only; do not await results")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the --verify solo runs' device: the CUDA "
                        "device (default) or the CPU")
    args = p.parse_args(argv)
    if args.verify:
        from ..cli import require_device
        require_device(args.device)
    addr = parse_listen(args.connect, who="--connect")
    configs = _load_configs(args.configs)

    from ..core.effects import Program, fork_, timeout
    from ..core.errors import TimeoutExpired
    from ..interp.aio.timed import run_real_time
    from ..manage.sync import Flag
    from ..net.backend import AioBackend
    from ..net.dialog import Dialog
    from ..net.rpc import Rpc
    from ..net.transfer import Transport
    from .frontend import (ServeAwait, ServeDrain, ServeRejected,
                           ServeSubmit)

    rpc = Rpc(Dialog(Transport(AioBackend())))
    call_us = int(args.call_timeout_s * 1e6)
    deadline_us = int(args.timeout_s * 1e6)
    results = {}
    failures = {}

    def call_retry(req) -> Program:
        # replies on a reset connection are lost (net/rpc.py delivery
        # contract); submits are idempotent by run_id and awaits are
        # reads, so timeout + retry gives at-least-once safely
        spent = 0
        while spent < deadline_us:
            try:
                return (yield from timeout(
                    call_us, lambda: rpc.call(addr, req)))
            except TimeoutExpired:
                spent += call_us
        raise TimeoutExpired(
            f"service at {args.connect} did not answer within "
            f"--timeout-s {args.timeout_s}")

    def main() -> Program:
        acks = []
        for d in configs:
            try:
                ack = yield from call_retry(
                    ServeSubmit(json.dumps(d, sort_keys=True)))
            except ServeRejected as e:
                raise SystemExit(
                    f"submit rejected for {d.get('id')!r}: "
                    f"{e.reason}") from None
            acks.append(ack)
            print(json.dumps({"submitted": ack.run_id,
                              "bucket": ack.bucket,
                              "slot": ack.slot}), flush=True)
        if not args.no_wait:
            flags = []

            def awaiter(rid, flag):
                def prog() -> Program:
                    try:
                        r = yield from call_retry(ServeAwait(rid))
                        rec = json.loads(r.record_json)
                        results[rid] = rec
                        # the streamed record, one JSONL line per
                        # world, in quiescence order
                        print(json.dumps(rec, sort_keys=True),
                              flush=True)
                    except ServeRejected as e:
                        failures[rid] = e.reason
                        print(json.dumps({"failed": rid,
                                          "error": e.reason}),
                              flush=True)
                    finally:
                        yield from flag.set()
                return prog
            for ack in acks:
                flag = Flag()
                flags.append(flag)
                yield from fork_(awaiter(ack.run_id, flag))
            for flag in flags:
                yield from flag.wait()
        if args.drain:
            yield from call_retry(ServeDrain())
        yield from rpc.dialog.transport.close(addr)

    try:
        run_real_time(main)
    except TimeoutExpired as e:
        sys.stderr.write(f"submit: {e}\n")
        return 1
    out = {"submitted": len(configs), "streamed": len(results),
           "failed": sorted(failures)}
    if args.verify and not args.no_wait:
        from ..sweep.spec import RunConfig, solo_result
        mism = []
        for d in configs:
            rid = d["id"]
            if rid not in results:
                continue
            cfg = RunConfig.from_json(d, 0)
            want = solo_result(cfg, lint="off", device=args.device)
            got = results[rid]["result"]
            if want != got:
                mism.append({"run_id": rid, "solo": want,
                             "streamed": got})
        out["verified"] = len(results) - len(mism)
        if mism:
            out["verify_mismatches"] = mism
            print(json.dumps(out))
            sys.stderr.write(
                "serve survival law VIOLATED: streamed results "
                "diverge from solo runs\n")
            return 1
    print(json.dumps(out))
    return 0 if not failures else 1


def serve_main(argv) -> int:
    def run():
        return _serve(argv)
    try:
        return run()
    except SweepConfigError as e:
        raise SystemExit(str(e)) from None


def submit_main(argv) -> int:
    try:
        return _submit(argv)
    except SweepConfigError as e:
        raise SystemExit(str(e)) from None

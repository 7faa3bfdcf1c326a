"""Scenario runner CLI of the port (port of ``timewarp_tpu/cli.py``): the
same flags, subcommands and one-line JSON summary, on the torch engines.

Usage::

    python -m timewarp_tpu_torch token-ring --nodes 64 --engine edge \
        --steps 500 --link uniform:1000:5000 --trace-csv trace.csv
    python -m timewarp_tpu_torch gossip --nodes 1024 --engine general --steady
    python -m timewarp_tpu_torch praos --nodes 4096 --engine sharded --devices 2
    python -m timewarp_tpu_torch ping-pong --engine oracle --device cpu

(also installed as ``timewarp-tpu-torch``). Every run is on the CUDA
device unless ``--device cpu`` is passed; without a card and without that
flag the CLI exits with a message naming it, never falling back to the
CPU. Prints one JSON summary line (the reference's keys, plus ``device``);
``--trace-csv`` dumps the superstep trace; ``--save`` / ``--resume``
checkpoint through utils/checkpoint.py (the reference's ``.npz`` layout).

Subcommands: ``lint`` (the scenario sanitizer sweep; ``--jaxpr`` scans
every engine's superstep body, analysis/determinism.py), ``lint-pack``,
``sweep run|resume|status|watch`` (sweep/cli.py), ``ledger
add|import|list|show|compare|anomalies`` (obs/ledger.py), ``search
run|repro`` (search/cli.py), ``serve`` / ``submit`` (serve/cli.py),
``pack fit`` (pack/cli.py), ``profile FAMILY`` (a run under full
telemetry with a Perfetto trace), ``explain EVENTS.jsonl`` (a delivery's
causal chain from a flight log) and ``bisect FAMILY`` (the first
diverging chunk, superstep and field of two runs).

Where the port differs from the reference's CLI (each loud):

- ``--device cuda|cpu`` is new; its default is the card.
- ``--insert`` is refused: the port has one insertion stage (kernels K2
  then K1 on the card, their plain versions on the CPU). ``--insert-cap``
  stays (K2's batch width).
- ``--jax-profile`` is refused in favour of ``--torch-profile DIR``, a
  ``torch.profiler`` session (obs/profiler.py).
- ``--devices N`` with a sharded engine starts N ranks
  (parallel/launch.py ``spawn``); rank 0 prints the summary. The ranks
  are gloo processes (on the card they share it) unless ``--dist-backend
  nccl`` (new) asks for NCCL, one card a rank, the collectives on device
  tensors; ``nccl`` with ``--device cpu``, or with fewer cards than
  ``--devices``, exits naming the cause and never falls back to gloo.
  The reference's ``--devices N`` always means N devices of its
  platform. On the CPU ``--devices`` is required. A sharded
  ``--save`` writes the gathered state from rank 0, in the one-device
  layout and meta; ``--resume`` loads a checkpoint of either on every
  rank and keeps the rank's shard.
- The telemetry block's ``compiles`` is 0 (the port compiles nothing per
  run).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

__all__ = ["main"]

PROG = "timewarp-tpu-torch"


def _window_arg(s: str):
    """--window accepts a µs integer or "auto" (derive the widest
    exact window from the link model's declared minimum delay)."""
    return "auto" if s == "auto" else int(s)


def _seeds_arg(s: str):
    """--seeds takes a half-open world-seed range ``a:b`` (world k
    runs seed a+k; b-a worlds total)."""
    try:
        a, b = s.split(":")
        a, b = int(a), int(b)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--seeds takes a half-open integer range a:b, got {s!r}")
    if b <= a:
        raise argparse.ArgumentTypeError(
            f"--seeds range {s!r} is empty (need b > a)")
    return range(a, b)


def _device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the run goes: the CUDA device (default) "
                        "or the CPU, where every kernel runs its plain "
                        "PyTorch version")


def require_device(device: str) -> str:
    """``device``, after refusing ``cuda`` on a host without one: the CLI
    never moves a run to the CPU on its own."""
    if device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit(
                f"{PROG} runs on the CUDA device by default and none is "
                "available; pass --device cpu to run on the CPU (every "
                "kernel's plain PyTorch version)")
    return device


#: engines that carry the world axis (--batch / --seeds)
BATCH_ENGINES = ("general", "sharded-batched")
#: engines that start one rank per shard (--devices)
SHARDED_ENGINES = ("sharded", "sharded-edge", "sharded-fused",
                   "sharded-batched")


def build_batch(args):
    """The world-axis spec from --batch/--seeds, or None (solo)."""
    if args.batch is None and args.seeds is None:
        return None
    from .interp.torch_engine.batched import BatchSpec
    try:
        return BatchSpec.of(args.batch, args.seeds, base_seed=args.seed)
    except ValueError as e:
        raise SystemExit(str(e)) from None


# the --link grammar + parser live with the link models they build
# (net/links.py, one module for the CLI and the sweep pack loader)
from .net.links import LINK_GRAMMAR, parse_link  # noqa: F401,E402


def build_scenario(args):
    if args.scenario == "token-ring":
        from .models.token_ring import token_ring
        return token_ring(
            args.nodes, n_tokens=args.tokens or 1,
            think_us=args.think_us, end_us=args.end_us,
            with_observer=args.observer, mailbox_cap=args.mailbox_cap)
    if args.scenario == "gossip":
        from .models.gossip import gossip
        return gossip(args.nodes, fanout=args.fanout,
                      end_us=args.end_us, steady=args.steady,
                      burst=args.burst, mailbox_cap=args.mailbox_cap)
    if args.scenario == "praos":
        from .models.praos import praos
        return praos(args.nodes, n_slots=args.slots,
                     leader_prob=args.leader_prob, fanout=args.fanout,
                     burst=args.burst, mailbox_cap=args.mailbox_cap)
    if args.scenario == "ping-pong":
        from .models.ping_pong import ping_pong
        return ping_pong(rounds=args.tokens or 10)
    raise SystemExit(f"unknown scenario {args.scenario!r}")


#: engines that can run a fault schedule (faults/: scheduled chaos)
FAULT_ENGINES = ("oracle", "general", "edge", "sharded-batched")


def build_faults(args):
    """The fault schedule from --faults, or None. A batched run
    replicates the one schedule to every world (per-world schedules
    are the library FaultFleet API)."""
    if args.faults is None:
        return None
    from .faults.schedule import parse_faults
    return parse_faults(args.faults)


#: engines the dispatch controller drives (dispatch/) — the chunked ones
CONTROLLER_ENGINES = ("general", "edge", "fused-sparse",
                      "sharded-batched")

#: engines that speculate (speculate/) — the chunked engines that thread
#: the dynamic per-superstep window (edge runs classic W=1 supersteps;
#: kernel K3 bakes the window into its arithmetic)
SPECULATE_ENGINES = ("general", "sharded-batched")


def build_controller(args):
    """The dispatch controller from --controller, or None."""
    spec = getattr(args, "controller", None)
    if spec in (None, "off"):
        return None
    from .dispatch import parse_controller
    ctrl = parse_controller(spec)
    if ctrl is not None and ctrl.mode == "auto" \
            and getattr(args, "telemetry", "off") == "off":
        raise SystemExit(
            "--controller auto consumes per-chunk telemetry "
            "(engine.last_run_telemetry); pass --telemetry "
            "counters|full (replay:<trace> alone runs with "
            "telemetry off)")
    return ctrl


#: engines that carry the causal flight recorder (obs/flight.py) — the
#: engines whose events live in one process (the node-sharded engines
#: refuse: events would scatter across ranks)
RECORD_ENGINES = ("general", "edge", "fused-sparse", "sharded-batched")


def build_engine(args, sc, link, device, mesh=None):
    """The engine ``args`` name, on ``device``; the sharded engines over
    ``mesh`` (inside a rank)."""
    batch = build_batch(args)
    faults = build_faults(args)
    telemetry = getattr(args, "telemetry", "off")
    verify = getattr(args, "verify", "off")
    record = getattr(args, "record", "off")
    record_cap = getattr(args, "record_cap", None)
    if record != "off" and args.engine not in RECORD_ENGINES:
        raise SystemExit(
            f"--record threads the flight recorder's event plane "
            f"through the engines whose events live in one process "
            f"({', '.join(RECORD_ENGINES)}); {args.engine} "
            "cannot carry one (the oracle is host Python — already "
            "observable; node-sharded engines scatter events across "
            "ranks — record the 1-device twin, bit-identical by "
            "the sharding law)")
    controller = build_controller(args)
    if controller is not None \
            and args.engine not in CONTROLLER_ENGINES:
        raise SystemExit(
            f"--controller drives the chunked engines "
            f"({', '.join(CONTROLLER_ENGINES)}); {args.engine} has "
            "no chunked driver to adapt")
    speculate = getattr(args, "speculate", "off")
    if speculate != "off" and args.engine not in SPECULATE_ENGINES:
        raise SystemExit(
            f"--speculate threads the dynamic per-superstep window "
            f"through the general engines "
            f"({', '.join(SPECULATE_ENGINES)}); {args.engine} cannot "
            "(edge runs classic supersteps; kernel K3 bakes the "
            "window; the oracle is host Python)")
    if telemetry != "off" and args.engine == "oracle":
        raise SystemExit(
            "--telemetry threads on-device counter planes through the "
            "engines; the oracle is host Python — its whole "
            "execution is already observable (use --record-events, or "
            "run an engine: the traces are bit-identical)")
    if faults is not None and args.engine not in FAULT_ENGINES:
        raise SystemExit(
            f"--faults runs on {', '.join(FAULT_ENGINES)}; "
            f"{args.engine} has no fault masks wired into its "
            "superstep (the fused kernels bypass the mask points)")
    # never-silent: reject knobs an engine would ignore rather than
    # letting cross-engine comparisons diverge mysteriously
    if batch is not None and args.engine not in BATCH_ENGINES:
        raise SystemExit(
            f"--batch/--seeds add a world axis; only the general "
            f"engines carry one ({', '.join(BATCH_ENGINES)}) — "
            f"{args.engine} runs exactly one world (run it once per "
            "seed, or switch engines)")
    if batch is None and args.engine == "sharded-batched":
        raise SystemExit(
            "sharded-batched shards the world axis over the ranks; "
            "it needs --batch B or --seeds a:b (one sharded world "
            "is --engine sharded)")
    if batch is not None and args.record_events:
        raise SystemExit(
            "--record-events is a solo-run debug ring; record world "
            "b's events by running that seed solo (bit-identical by "
            "the batch exactness law, batched.py)")
    if args.engine not in ("general", "fused-sparse") \
            and args.record_events:
        raise SystemExit(
            f"--record-events is the general engine's device-side "
            f"ring; {args.engine} does not carry one (the oracle "
            "records host-side via SuperstepOracle(record_events=True))")
    if args.events_csv and not args.record_events:
        raise SystemExit("--events-csv needs --record-events")
    if args.engine in ("edge", "sharded-edge") and args.window != 1:
        raise SystemExit(
            f"--window applies to the general engines only; "
            f"{args.engine} runs classic supersteps")
    if (args.engine not in ("general", "sharded", "sharded-batched")
            and args.route_cap is not None):
        raise SystemExit(
            f"--route-cap applies to the general engines only; "
            f"{args.engine} has no routed insertion stage to bound "
            "(fused-sparse bounds its static batch with --max-batch; "
            "sharded-fused sizes per-rank exchange buckets via the "
            "API's bucket_cap)")
    if args.engine not in ("fused-sparse",) \
            and args.max_batch is not None:
        raise SystemExit(
            f"--max-batch sizes the fused-sparse engine's static "
            f"batch; {args.engine} does not hold one")
    if args.engine != "general" and args.insert_cap is not None:
        raise SystemExit(
            "--insert-cap sizes the general engine's fire-compacted "
            f"batch (kernel K2's width); {args.engine} does not hold "
            "one")
    common = dict(seed=args.seed, lint=args.lint, device=device)
    if args.engine == "oracle":
        from .interp.ref.superstep import SuperstepOracle
        return SuperstepOracle(sc, link, window=args.window,
                               faults=faults, **common)
    if args.engine == "general":
        from .interp.torch_engine.engine import TorchEngine
        try:
            return TorchEngine(sc, link, window=args.window,
                               route_cap=args.route_cap,
                               record_events=args.record_events,
                               batch=batch, faults=faults,
                               telemetry=telemetry,
                               insert_cap=args.insert_cap,
                               controller=controller, verify=verify,
                               record=record, record_cap=record_cap,
                               speculate=speculate, **common)
        except ValueError as e:
            # construction-time speculation guards (fixed:W under the
            # floor, conflicting decision sources) are grammar-class
            # errors for a CLI caller — clean exit, not a traceback
            if speculate != "off":
                raise SystemExit(str(e)) from None
            raise
    if args.engine == "fused-sparse":
        from .interp.torch_engine.fused_sparse import FusedSparseEngine
        kw = {} if args.max_batch is None else {
            "max_batch": args.max_batch}
        return FusedSparseEngine(sc, link, window=args.window,
                                 record_events=args.record_events,
                                 telemetry=telemetry,
                                 controller=controller, verify=verify,
                                 record=record, record_cap=record_cap,
                                 **common, **kw)
    if args.engine == "edge":
        from .interp.torch_engine.edge_engine import EdgeEngine
        return EdgeEngine(sc, link, cap=args.edge_cap, faults=faults,
                          telemetry=telemetry, controller=controller,
                          verify=verify, record=record,
                          record_cap=record_cap, **common)
    if args.engine in SHARDED_ENGINES:
        from .interp.torch_engine import sharded as sh
        try:
            if args.engine == "sharded-batched":
                return sh.ShardedBatchedEngine(
                    sc, link, mesh, batch=batch, window=args.window,
                    route_cap=args.route_cap, faults=faults,
                    telemetry=telemetry, controller=controller,
                    verify=verify, record=record, record_cap=record_cap,
                    speculate=speculate, **common)
            if args.engine == "sharded-edge":
                return sh.ShardedEdgeEngine(
                    sc, link, mesh, cap=args.edge_cap,
                    telemetry=telemetry, verify=verify, **common)
            if args.engine == "sharded-fused":
                return sh.ShardedFusedSparseEngine(
                    sc, link, mesh, window=args.window,
                    telemetry=telemetry, verify=verify, **common)
            return sh.ShardedEngine(sc, link, mesh, window=args.window,
                                    route_cap=args.route_cap,
                                    telemetry=telemetry, verify=verify,
                                    **common)
        except ValueError as e:
            # the sharded engines' refusals (a speculation
            # misconfiguration, an indivisible mesh) name the
            # unsupported knob: a clean exit
            raise SystemExit(str(e)) from None
    raise SystemExit(f"unknown engine {args.engine!r}")


def lint_targets(families=None, *, nodes: int = 64):
    """Every shipped model the ``lint`` subcommand sweeps: state-machine
    scenarios as builder thunks (so one bad build does not kill the
    sweep) and the effect-program ``_net`` twin modules. ``families``
    filters by scenario family name."""
    scenarios = {
        "token-ring": [
            lambda: _m("token_ring").token_ring(nodes),
            lambda: _m("token_ring").token_ring(nodes,
                                                with_observer=False),
        ],
        "gossip": [
            lambda: _m("gossip").gossip(nodes),
            lambda: _m("gossip").gossip(nodes, burst=True),
            lambda: _m("gossip").gossip(nodes, steady=True),
        ],
        "praos": [
            lambda: _m("praos").praos(nodes),
            lambda: _m("praos").praos(nodes, burst=True),
        ],
        "ping-pong": [lambda: _m("ping_pong").ping_pong()],
        "socket-state": [
            lambda: _m("socket_state").socket_state(min(nodes, 16))],
    }
    modules = {
        "token-ring": ["token_ring_net"],
        "gossip": ["gossip_net"],
        "praos": ["praos_net"],
        "ping-pong": ["ping_pong_net"],
        "socket-state": ["socket_state_net"],
    }
    if families:
        unknown = set(families) - set(scenarios)
        if unknown:
            raise SystemExit(
                f"unknown scenario families {sorted(unknown)}; "
                f"choose from {sorted(scenarios)}")
        scenarios = {k: v for k, v in scenarios.items() if k in families}
        modules = {k: v for k, v in modules.items() if k in families}
    return scenarios, modules


def _m(name):
    import importlib
    return importlib.import_module(f"timewarp_tpu_torch.models.{name}")


def lint_sweep(families=None, *, nodes: int = 64, probe: bool = True,
               seed: int = 0, faults=None, device=None):
    """The shared sanitizer sweep behind ``lint``: returns ``(subjects,
    LintReport)``. A subject that fails to build or import becomes a
    TW000 error finding — one broken model never kills the sweep.
    ``faults`` (a FaultSchedule) additionally runs the TW5xx fault lints
    against every swept scenario; the probe runs on ``device``."""
    from .analysis import (ERROR, Finding, LintReport,
                           lint_fault_schedule, lint_module_programs,
                           lint_scenario)
    scenarios, modules = lint_targets(families, nodes=nodes)
    report = LintReport()
    subjects = 0
    for fam, builders in scenarios.items():
        for build in builders:
            subjects += 1
            try:
                sc = build()
            except Exception as e:  # noqa: BLE001 — sweep must finish
                report.add(Finding(
                    "TW000", ERROR, fam,
                    f"scenario failed to build under lint: {e!r}"))
                continue
            report.extend(lint_scenario(sc, probe=probe, seed=seed,
                                        device=device))
            if faults is not None:
                report.extend(lint_fault_schedule(faults, sc))
    for fam, mods in modules.items():
        for mod in mods:
            subjects += 1
            try:
                report.extend(lint_module_programs(_m(mod)))
            except Exception as e:  # noqa: BLE001 — sweep must finish
                report.add(Finding(
                    "TW000", ERROR, fam,
                    f"program module {mod!r} failed to lint: {e!r}"))
    return subjects, report


def jaxpr_sweep(families=None, *, nodes: int = 8, device=None):
    """The ``lint --jaxpr`` sweep (analysis/determinism.py): build every
    shipped engine family x observability/execution mode with an
    integer-delay link on ``device``, scan each engine's superstep body
    (its aten graph) for TW7xx bit-exactness threats, and re-prove the
    off-mode neutrality pins (TW705) per family x engine. Returns
    ``(subjects, LintReport)``; a mode that fails to build becomes a
    TW000 error finding, never a crash. Small ``nodes`` by design — the
    scan is a fake-tensor trace, and the body's op inventory does not
    change with the width."""
    from .analysis import (ERROR, Finding, LintReport,
                           lint_engine_jaxpr, prove_mode_neutrality)
    from .net.delays import FixedDelay

    # integer µs delays: the heavy-tail samplers' float
    # transcendentals (TW702, deliberate + quantized) would otherwise
    # drown the sweep in known warnings
    link = FixedDelay(1000)
    modes = [
        ("baseline", {}),
        ("telemetry=counters", {"telemetry": "counters"}),
        ("telemetry=full", {"telemetry": "full"}),
        ("record=deliveries", {"record": "deliveries"}),
        ("record=full", {"record": "full"}),
        ("verify=guard", {"verify": "guard"}),
        ("speculate=fixed:2000", {"speculate": "fixed:2000"}),
    ]
    scenarios, _ = lint_targets(families, nodes=nodes)
    report = LintReport()
    subjects = 0

    def scan(subject, build):
        nonlocal subjects
        subjects += 1
        try:
            engine = build()
        except Exception as e:  # noqa: BLE001 — sweep must finish
            report.add(Finding(
                "TW000", ERROR, subject,
                f"engine failed to build under the jaxpr sweep: "
                f"{e!r}"))
            return
        report.extend(lint_engine_jaxpr(engine, subject))

    for fam, builders in scenarios.items():
        built = []
        for build in builders:
            try:
                built.append(build())
            except Exception as e:  # noqa: BLE001 — sweep must finish
                report.add(Finding(
                    "TW000", ERROR, fam,
                    f"scenario failed to build under the jaxpr "
                    f"sweep: {e!r}"))
        if not built:
            continue
        sc = built[0]

        def gen(**kw):
            from .interp.torch_engine.engine import TorchEngine
            return TorchEngine(sc, link, seed=0, lint="off",
                               device=device, **kw)

        for label, kw in modes:
            scan(f"{fam}/general/{label}", lambda kw=kw: gen(**kw))
        subjects += 1
        report.extend(prove_mode_neutrality(gen, f"{fam}/general"))

        # the edge engine demands a static topology — sweep the
        # family's first static variant, if it ships one
        sc_e = next((s for s in built if s.static_dst is not None),
                    None)
        if sc_e is not None:
            def edge(**kw):
                from .interp.torch_engine.edge_engine import EdgeEngine
                return EdgeEngine(sc_e, link, seed=0, lint="off",
                                  device=device, **kw)

            for label, kw in modes:
                if "speculate" in kw:
                    continue    # edge engine has no speculation plane
                scan(f"{fam}/edge/{label}", lambda kw=kw: edge(**kw))
            subjects += 1
            report.extend(prove_mode_neutrality(edge, f"{fam}/edge"))
    return subjects, report


def lint_main(argv) -> int:
    """``lint``: run the scenario sanitizer (step-graph contract lints +
    static capacity proofs + commutative-inbox permutation probes) over
    the shipped state-machine models, and the effect-program AST linter
    over their ``_net`` twins. Exits 1 on any error-severity finding."""
    p = argparse.ArgumentParser(
        prog=f"{PROG} lint",
        description="Static scenario sanitizer "
                    "(timewarp_tpu_torch.analysis). With no arguments, "
                    "sweeps every shipped model.")
    p.add_argument("families", nargs="*",
                   help="scenario families to lint (default: all): "
                        "token-ring gossip praos ping-pong socket-state")
    p.add_argument("--nodes", type=int, default=64,
                   help="node count the swept scenarios are built at")
    p.add_argument("--no-probe", action="store_true",
                   help="skip the commutative-inbox permutation probe "
                        "(the only check that executes the step)")
    p.add_argument("--seed", type=int, default=0,
                   help="probe permutation seed")
    p.add_argument("--json", action="store_true",
                   help="one JSON report line instead of findings text")
    p.add_argument("--faults", default=None,
                   help="also lint this fault schedule (the --faults "
                        "run grammar) against every swept scenario — "
                        "the TW5xx rules")
    p.add_argument("--jaxpr", action="store_true",
                   help="run the engine-level determinism sanitizer "
                        "instead: scan every shipped engine x mode's "
                        "superstep body (its aten graph) for "
                        "bit-exactness threats and re-prove the "
                        "off-mode neutrality pins (TW7xx)")
    _device_arg(p)
    args = p.parse_args(argv)

    if args.jaxpr:
        # default shrinks to 8: the body's op inventory does not change
        # with fleet width, only trace time does
        nodes = 8 if args.nodes == 64 else args.nodes
        subjects, report = jaxpr_sweep(
            args.families or None, nodes=nodes,
            device=require_device(args.device))
    else:
        faults = None
        if args.faults:
            from .faults.schedule import parse_faults
            faults = parse_faults(args.faults)
        # only the probe executes anything: --no-probe needs no device
        device = args.device if args.no_probe \
            else require_device(args.device)
        subjects, report = lint_sweep(args.families or None,
                                      nodes=args.nodes,
                                      probe=not args.no_probe,
                                      seed=args.seed, faults=faults,
                                      device=device)

    if args.json:
        print(json.dumps({"subjects": subjects, **report.to_json()}))
    else:
        print(report.render())
        print(f"({subjects} subjects linted)")
    return 0 if report.ok else 1


def lint_pack_main(argv) -> int:
    """``lint-pack PACK``: the fleet-scale pre-flight verifier
    (analysis/plan_lint.py). Statically predicts the pack's bucket plan,
    mirrors every construction-time refusal the runtime would raise
    mid-bucket, and runs the per-scenario sanitizer plus the fault-aware
    capacity proof over every world — all before any engine is built (so
    it needs no device). Exits 1 on any error-severity finding."""
    p = argparse.ArgumentParser(
        prog=f"{PROG} lint-pack",
        description="Static pre-flight verification of a sweep pack "
                    "(TW6xx + the per-world TW1xx-TW2xx/TW7xx rules).")
    p.add_argument("pack",
                   help="pack path: a JSON file ({\"worlds\": [...]} "
                        "or a bare config list) or JSONL, the same "
                        "grammar `sweep run` takes")
    p.add_argument("--json", action="store_true",
                   help="one JSON report line instead of findings text")
    p.add_argument("--max-bucket", type=int, default=64,
                   help="bucket width the plan is predicted at (must "
                        "match the sweep run's --max-bucket to "
                        "predict the same builds)")
    args = p.parse_args(argv)

    from .analysis import lint_pack_path
    configs, report = lint_pack_path(args.pack,
                                     max_bucket=args.max_bucket)
    if args.json:
        print(json.dumps({"configs": configs, **report.to_json()}))
    else:
        print(report.render())
        print(f"({configs} config(s) linted)")
    return 0 if report.ok else 1


#: subcommand -> "module:function" (imported when dispatched)
SUBCOMMANDS = {
    "lint-pack": "timewarp_tpu_torch.cli:lint_pack_main",
    "lint": "timewarp_tpu_torch.cli:lint_main",
    "sweep": "timewarp_tpu_torch.sweep.cli:sweep_main",
    "ledger": "timewarp_tpu_torch.obs.ledger:ledger_main",
    "search": "timewarp_tpu_torch.search.cli:search_main",
    "serve": "timewarp_tpu_torch.serve.cli:serve_main",
    "submit": "timewarp_tpu_torch.serve.cli:submit_main",
    "pack": "timewarp_tpu_torch.pack.cli:pack_main",
    "profile": "timewarp_tpu_torch.cli:profile_main",
    "explain": "timewarp_tpu_torch.cli:explain_main",
    "bisect": "timewarp_tpu_torch.cli:bisect_main",
}


def run_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=PROG,
        description="Run a distributed-system scenario under an "
                    "interchangeable interpreter, on the torch engines.")
    p.add_argument("scenario",
                   choices=["token-ring", "gossip", "praos", "ping-pong"])
    p.add_argument("--engine", default="general",
                   choices=["oracle", "general", "fused-sparse",
                            "edge", "sharded", "sharded-edge",
                            "sharded-fused", "sharded-batched"])
    _device_arg(p)
    p.add_argument("--nodes", type=int, default=64)
    p.add_argument("--steps", type=int, default=1000,
                   help="max supersteps to run")
    p.add_argument("--link", default="uniform:1000:5000",
                   help="fixed:D | uniform:LO:HI | lognormal:MED:SIGMA"
                        " | drop:P:<inner> | quantize:Q:<inner> | "
                        "never (stationary loss: drop:P wraps any "
                        "inner model with i.i.d. loss probability P; "
                        "never severs the link entirely)")
    p.add_argument("--faults", default=None,
                   help="deterministic fault schedule (faults/): "
                        "';'-separated events, e.g. "
                        "\"crash:3:5s:9s:reset; partition:0-3|4-7:2s:4s;"
                        " degrade:all:all:1s:2s:4.0:10ms; skew:2:250\"")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=None,
                   help="world count B: run B independent emulations "
                        "of this scenario in one batched engine "
                        "(seeds --seed .. --seed+B-1); general "
                        "engines only")
    p.add_argument("--seeds", type=_seeds_arg, default=None,
                   help="explicit world-seed range a:b (half-open) "
                        "for the batched world axis; implies the "
                        "world count")
    p.add_argument("--devices", type=int, default=None,
                   help="ranks for the sharded engines (one process "
                        "each; default: one per CUDA device, required "
                        "with --device cpu)")
    p.add_argument("--dist-backend", default="gloo",
                   choices=["gloo", "nccl"],
                   help="the sharded engines' ranks: gloo processes "
                        "(default; on the card they share it, every "
                        "collective through host buffers) or nccl (one "
                        "CUDA device a rank, the collectives on device "
                        "tensors)")
    p.add_argument("--mailbox-cap", type=int, default=8)
    p.add_argument("--edge-cap", type=int, default=2)
    p.add_argument("--tokens", type=int, default=None,
                   help="token-ring: initial tokens; ping-pong: rounds")
    p.add_argument("--think-us", type=int, default=3_000_000)
    p.add_argument("--end-us", type=int, default=20_000_000)
    p.add_argument("--observer", action="store_true")
    p.add_argument("--steady", action="store_true",
                   help="gossip: rumor-mongering steady state")
    p.add_argument("--burst", action="store_true",
                   help="gossip/praos: flood all fanout peers in one "
                        "firing (the windowed-superstep-friendly form)")
    p.add_argument("--window", type=_window_arg, default=1,
                   help="multi-instant superstep window in µs, or "
                        "'auto' to use the link model's declared "
                        "minimum delay (requires link min delay >= "
                        "window)")
    p.add_argument("--route-cap", type=int, default=None,
                   help="static active-message budget for the insertion "
                        "stage (clipped messages are counted)")
    p.add_argument("--max-batch", type=int, default=None,
                   help="fused-sparse: static message batch bound per "
                        "superstep (excess counted in route_drop, "
                        "never silent)")
    p.add_argument("--insert", default=None,
                   help="refused: the reference's insertion-strategy "
                        "selector; the port has one insertion stage")
    p.add_argument("--insert-cap", type=int, default=None,
                   help="general engine: fire-compacted batch bound in "
                        "messages per superstep (kernel K2's width; "
                        "default n_nodes*max_out = can never drop; "
                        "excess counted in route_drop, never silent)")
    p.add_argument("--fanout", type=int, default=8)
    p.add_argument("--slots", type=int, default=10)
    p.add_argument("--leader-prob", type=float, default=0.05)
    p.add_argument("--trace-csv", default=None)
    p.add_argument("--record-events", type=int, default=0,
                   help="general engine: device-side event ring "
                        "capacity (per-event records; dropped-beyond-"
                        "capacity is counted, never silent)")
    p.add_argument("--events-csv", default=None,
                   help="write the recorded events (needs "
                        "--record-events)")
    p.add_argument("--save", default=None,
                   help="write the final engine state to this .npz")
    p.add_argument("--resume", default=None,
                   help="resume from a checkpoint written by --save")
    p.add_argument("--log-config", default=None,
                   help="YAML severity tree (utils/logconfig.py)")
    p.add_argument("--lint", default="warn",
                   choices=["error", "warn", "off"],
                   help="construction-time scenario sanitizer "
                        "(analysis/): 'warn' logs findings (default), "
                        "'error' refuses to run a scenario with "
                        "error-severity findings, 'off' skips the "
                        "checks entirely")
    p.add_argument("--controller", default="off",
                   help="online adaptive dispatch (dispatch/): 'auto' "
                        "adapts window/chunk between chunks from "
                        "telemetry (needs --telemetry counters|full) "
                        "and records a decision trace; 'replay:TRACE' "
                        "re-applies a recorded trace bit-for-bit; "
                        "'off' (default) static dispatch")
    p.add_argument("--decisions-out", default=None,
                   help="write the controller's decision trace to "
                        "this JSONL file (needs --controller; the "
                        "file replays via --controller replay:FILE)")
    p.add_argument("--telemetry", default="off",
                   choices=["off", "counters", "full"],
                   help="on-device telemetry (obs/): per-superstep "
                        "counter planes — bit-exact, and 'off' runs "
                        "no code of the plane ('full' adds mailbox "
                        "occupancy)")
    p.add_argument("--metrics-out", default=None,
                   help="write the telemetry metrics stream to this "
                        "JSONL file (needs --telemetry)")
    p.add_argument("--trace-out", default=None,
                   help="write a Perfetto/Chrome trace of the run "
                        "(superstep counter tracks on virtual time; "
                        "needs --telemetry) — open at ui.perfetto.dev")
    p.add_argument("--torch-profile", default=None,
                   help="wrap the run in a torch.profiler session "
                        "writing DIR/trace.json (obs/profiler.py); "
                        "degrades to a warning when profiling is "
                        "unavailable")
    p.add_argument("--jax-profile", default=None,
                   help="refused: the reference's jax.profiler flag; "
                        "use --torch-profile")
    p.add_argument("--record", default="off",
                   choices=["off", "deliveries", "full"],
                   help="causal flight recorder (obs/flight.py): a "
                        "bounded per-superstep event plane — "
                        "bit-exact, and 'off' runs no code of it. "
                        "'deliveries' = one event per delivered "
                        "message; 'full' = + sends and fault actions "
                        "— the input of `explain` and the event side "
                        "of `bisect`")
    p.add_argument("--record-cap", type=int, default=None,
                   help="flight-recorder events per superstep "
                        "(default 256); the excess is dropped but "
                        "counted, never silent")
    p.add_argument("--record-out", default=None,
                   help="drain the recorded events to this JSONL "
                        "event log (needs --record; query with "
                        "`explain`)")
    p.add_argument("--verify", default="off",
                   choices=["off", "guard", "digest", "shadow"],
                   help="online state-integrity checking (integrity/): "
                        "guard = on-device invariant checks; digest = "
                        "+ per-chunk rolling state digest with "
                        "deterministic rollback recovery; shadow = + "
                        "sampled re-execution. 'off' runs no code of "
                        "the plane")
    p.add_argument("--verify-chunk", type=int, default=None,
                   help="supersteps per verified chunk, default 64 "
                        "(--verify digest|shadow)")
    p.add_argument("--verify-cadence", type=int, default=None,
                   help="shadow-sample every Nth chunk for "
                        "re-execution, default 1 (--verify shadow)")
    p.add_argument("--inject-flip", default=None,
                   help="deterministic state corruption for testing "
                        "the detection law: flip:SEED[:CHUNK[:PLANE]] "
                        "(needs --verify digest|shadow)")
    p.add_argument("--speculate", default="off",
                   help="optimistic time-warp execution (speculate/): "
                        "'auto' ladders the superstep window up past "
                        "the provable link floor, rolling back on a "
                        "causality violation; 'fixed:W' speculates at "
                        "exactly W µs; 'off' (default) the static "
                        "window")
    p.add_argument("--speculate-chunk", type=int, default=None,
                   help="supersteps per speculative chunk (the "
                        "rollback granularity), default 64 "
                        "(needs --speculate)")
    p.add_argument("--canon-out", default=None,
                   help="write the run's canonical equivalence "
                        "surface (speculate/equiv.py), one CSV row per "
                        "world — `cmp` a speculative run's file "
                        "against the conservative run's")
    p.add_argument("--timings", action="store_true",
                   help="print one JSON line of the invocation's wall "
                        "split on standard error: the epoch at main's "
                        "entry, then seconds of set-up (imports, the "
                        "device, the scenario), the construction lint, "
                        "the engine's build, the run and the output")
    return p


def check_args(args) -> None:
    """The flag guards, before anything is built: a knob the run would
    ignore, or two that cannot combine, is refused with a clean exit."""
    if args.insert is not None:
        raise SystemExit(
            f"--insert {args.insert} selects one of the reference's "
            "insertion strategies; the port has one insertion stage "
            "(kernels K2 then K1 on the card, their plain versions on "
            "the CPU) — drop --insert (--insert-cap still sizes K2's "
            "batch)")
    if args.jax_profile is not None:
        raise SystemExit(
            "--jax-profile wraps the reference's jax.profiler; the port "
            "profiles with torch.profiler: pass --torch-profile DIR")
    if args.telemetry == "off" and (args.metrics_out or args.trace_out):
        raise SystemExit(
            "--metrics-out/--trace-out need --telemetry counters|full "
            "(off-mode engines record nothing, by contract)")
    if args.record_out and args.record == "off":
        raise SystemExit(
            "--record-out drains the flight recorder's event log; "
            "pass --record deliveries|full (off-mode engines record "
            "nothing, by contract)")
    if args.record_cap is not None and args.record == "off":
        raise SystemExit(
            "--record-cap sizes the flight recorder's per-superstep "
            "event plane; pass --record deliveries|full (the knob "
            "would be silently ignored)")
    if args.decisions_out and args.controller == "off" \
            and args.speculate == "off":
        raise SystemExit("--decisions-out needs --controller "
                         "auto|replay:* or --speculate auto|fixed:W "
                         "(static runs decide nothing)")
    if args.canon_out and args.engine in ("oracle", "edge",
                                          "sharded-edge"):
        raise SystemExit(
            "--canon-out digests an EngineState's canonical surface "
            "(speculate/equiv.py); the oracle keeps host-side state "
            "and the edge engines carry EdgeState (different counter "
            "layout) — run a general-family engine (bit-identical by "
            "the parity/sharding laws)")
    if args.controller != "off" and args.resume:
        raise SystemExit(
            "--controller and --resume cannot combine: decision "
            "traces index chunks from the run start — checkpointed "
            "controller runs are the sweep service's business "
            f"({PROG} sweep)")
    if args.controller != "off" and args.engine == "oracle":
        raise SystemExit(
            "--controller drives the chunked engines; the host oracle "
            "has no chunks to adapt")
    if args.verify != "off" and args.engine == "oracle":
        raise SystemExit(
            "--verify checks the engines' device state; the host "
            "oracle's state is host Python (cross-check it against an "
            "engine via the parity law instead)")
    if args.inject_flip and args.verify not in ("digest", "shadow"):
        # the guard must live HERE, not in the run branch: a
        # controller run takes run_controlled and would otherwise
        # silently never apply the flip
        raise SystemExit(
            "--inject-flip corrupts state BETWEEN chunks (the "
            "verified driver's window); pass --verify digest|shadow "
            "— off/guard runs would leave the flip UNDETECTED (or "
            "never applied) by design")
    if args.verify in ("digest", "shadow") and args.controller != "off":
        raise SystemExit(
            "--verify digest|shadow runs the verified chunked driver "
            "(run_verified); --controller runs the adaptive one — "
            "combine them via the sweep service (--state-verify). "
            "--verify guard rides any driver")
    if args.speculate != "off":
        from .speculate import parse_speculate
        try:
            parse_speculate(args.speculate, who="--speculate")
        except ValueError as e:
            raise SystemExit(str(e)) from None
        if args.controller != "off":
            raise SystemExit(
                "--speculate and --controller are both per-chunk "
                "window decision sources — pick one")
        if args.verify in ("digest", "shadow"):
            raise SystemExit(
                "--speculate runs the optimistic chunked driver "
                "(run_speculative); --verify digest|shadow runs the "
                "verified one — combine them via the sweep service "
                "(--state-verify + --speculate). --verify guard rides "
                "any driver")
        if args.resume:
            raise SystemExit(
                "--speculate and --resume cannot combine: decision "
                "traces index chunks from the run start — "
                "checkpointed speculative runs are the sweep "
                f"service's business ({PROG} sweep --speculate)")
    if args.speculate_chunk is not None:
        if args.speculate == "off":
            raise SystemExit(
                "--speculate-chunk shapes the optimistic chunked "
                "driver; pass --speculate auto|fixed:W (the knob "
                "would be silently ignored)")
        if args.speculate_chunk < 1:
            raise SystemExit(
                f"--speculate-chunk must be >= 1, got "
                f"{args.speculate_chunk}")
    if args.verify_chunk is not None \
            and args.verify not in ("digest", "shadow"):
        raise SystemExit(
            "--verify-chunk shapes the verified chunked driver; "
            "pass --verify digest|shadow (guard/off runs are "
            "unchunked — the knob would be silently ignored)")
    if args.verify_cadence is not None and args.verify != "shadow":
        raise SystemExit(
            "--verify-cadence samples chunks for shadow "
            "re-execution; pass --verify shadow (the digest entry "
            "check runs every chunk regardless — the knob would be "
            "silently ignored)")
    if args.verify_chunk is not None and args.verify_chunk < 1:
        raise SystemExit(
            f"--verify-chunk must be >= 1, got {args.verify_chunk}")
    if args.verify_cadence is not None and args.verify_cadence < 1:
        raise SystemExit(
            f"--verify-cadence must be >= 1, got {args.verify_cadence}")
    if args.engine in SHARDED_ENGINES:
        if args.devices is None and args.device == "cpu":
            raise SystemExit(
                "--devices N is required with --device cpu: the "
                "sharded engines start one rank per shard")
        if args.devices is not None and args.devices < 1:
            raise SystemExit(f"--devices must be >= 1, got "
                             f"{args.devices}")
        if args.dist_backend == "nccl" and args.device == "cpu":
            raise SystemExit(
                "--dist-backend nccl ships device tensors, one CUDA "
                "device a rank, and --device cpu has none; run CPU ranks "
                "with --dist-backend gloo")
    elif args.dist_backend != "gloo":
        raise SystemExit(
            "--dist-backend chooses the sharded engines' ranks; pass "
            "--engine sharded|sharded-edge|sharded-fused|sharded-batched "
            "(the knob would be silently ignored)")


def main(argv=None) -> int:
    entry = time.time()
    if argv is None:
        argv = sys.argv[1:]
    argv = list(argv)
    if argv and argv[0] in SUBCOMMANDS:
        import importlib
        mod, _, fn = SUBCOMMANDS[argv[0]].partition(":")
        return getattr(importlib.import_module(mod), fn)(argv[1:])
    args = run_parser().parse_args(argv)
    clock = _Clock(entry) if args.timings else None
    check_args(args)
    flip_inj = None
    if args.inject_flip:
        # parse WITH the other argument guards: a malformed spec must
        # die as a grammar-named clean exit before any engine builds
        from .integrity import FlipInjector
        try:
            flip_inj = FlipInjector(args.inject_flip)
        except ValueError as e:
            raise SystemExit(str(e)) from None
    device = require_device(args.device)

    from .utils.logconfig import load_log_config
    load_log_config(args.log_config)

    if args.engine in SHARDED_ENGINES:
        summary = _run_sharded(args, argv, device)
    else:
        summary = execute(args, device, flip_inj, clock=clock)
    print(json.dumps(summary))
    if clock is not None:
        clock.lap("output_s")
        print(json.dumps({"timings": clock.laps}), file=sys.stderr)
    return 0


class _Clock:
    """``--timings``: laps of one invocation, in seconds, from the epoch
    ``entry`` at main's entry."""

    def __init__(self, entry: float) -> None:
        self.laps = {"entry_epoch_s": entry}
        self._t = entry

    def lap(self, name: str) -> None:
        now = time.time()
        self.laps[name] = self.laps.get(name, 0.0) + now - self._t
        self._t = now


def _run_sharded(args, argv, device) -> dict:
    """Start ``--devices`` ranks of the sharded engine over
    ``--dist-backend`` (gloo ranks share the card; NCCL's own one each);
    each re-parses ``argv`` and runs :func:`execute` over the mesh. Rank
    0's summary."""
    import torch

    from .parallel.launch import RankFailed, spawn
    from .parallel.mesh import check_backend
    n = args.devices
    if n is None:
        n = torch.cuda.device_count()
    try:
        check_backend(args.dist_backend, n)
    except RuntimeError as e:
        raise SystemExit(f"--dist-backend {args.dist_backend} "
                         f"--devices {n}: {e}") from None
    try:
        res = spawn("timewarp_tpu_torch.cli:rank_main", n,
                    backend=args.dist_backend, device=device,
                    args=(argv, n),
                    threads=max(1, torch.get_num_threads() // n))
    except RankFailed as e:
        # a refusal raised in every rank (SystemExit) is the clean exit
        # it would have been in one process
        tb = str(e).rstrip().splitlines()
        if tb and tb[-1].startswith("SystemExit: "):
            raise SystemExit(tb[-1][len("SystemExit: "):]) from None
        raise
    return res[0]


def rank_main(device, argv, n):
    """One rank of a sharded CLI run (the target of ``spawn``): the run
    over a mesh of ``n`` ranks on this rank's ``device``. Every rank
    returns its summary (the counters are global on each); rank 0 writes
    the run's files."""
    import torch.distributed as dist

    from .parallel.mesh import make_mesh
    args = run_parser().parse_args(argv)
    axis = "worlds" if args.engine == "sharded-batched" else "nodes"
    flip_inj = None
    if args.inject_flip:
        # every rank holds one: the flip lands on the rank that owns its
        # element, and every rank reports it
        from .integrity import FlipInjector
        flip_inj = FlipInjector(args.inject_flip)
    return execute(args, device, flip_inj, mesh=make_mesh(n, axis),
                   rank=dist.get_rank())


def execute(args, device, flip_inj, mesh=None, rank=0,
            clock=None) -> dict:
    """Build and run the configuration ``args`` name on ``device`` and
    return the summary; rank 0 (every single-process run) writes the
    run's files. ``clock`` (``--timings``) takes the laps."""
    sc = build_scenario(args)
    link = parse_link(args.link)
    if clock is not None:
        # the construction lint on its own (the engine below takes the
        # report cached on the scenario)
        from .analysis import check_scenario
        clock.lap("setup_s")
        check_scenario(sc, args.lint, who=PROG)
        clock.lap("lint_s")
    engine = build_engine(args, sc, link, device, mesh=mesh)
    if clock is not None:
        clock.lap("build_s")
    files = rank == 0

    if args.engine == "oracle":
        if args.save or args.resume:
            raise SystemExit(
                "--save/--resume need an engine state; the oracle "
                "keeps host-side state — pick an engine")
        trace = engine.run(args.steps)
        final_info = {"overflow": engine.overflow_total,
                      "bad_dst": engine.bad_dst_total}
        if args.faults:
            final_info["fault_dropped"] = engine.fault_dropped_total
    else:
        batched = getattr(engine, "batch", None)
        state = None
        if args.resume:
            from .utils.checkpoint import load_state
            # a sharded engine loads the global state on every rank and
            # keeps its shard: a checkpoint moves freely between one
            # device, N ranks and the reference
            state, ck_meta = load_state(
                args.resume, engine.init_state() if mesh is None
                else engine.global_init_state(),
                expect_meta={"scenario": sc.name}, scenario=sc)
            if ck_meta.get("faults") != args.faults:
                # the restart ledger (and every masked decision so
                # far) is schedule-specific: resuming under a
                # different schedule would be neither run
                raise SystemExit(
                    f"checkpoint was written under --faults "
                    f"{ck_meta.get('faults')!r}; resuming under "
                    f"{args.faults!r} would diverge — pass the "
                    "matching schedule")
            if batched is not None:
                if ck_meta.get("seeds") != list(batched.seeds):
                    # per-world RNG streams are part of the state
                    raise SystemExit(
                        f"checkpoint holds the world fleet "
                        f"{ck_meta.get('seeds')}; resuming it under "
                        f"{list(batched.seeds)} would diverge — pass "
                        "the matching --batch/--seeds")
            elif ck_meta.get("seed", args.seed) != args.seed:
                # the RNG stream is part of the state: resuming under a
                # different seed would silently diverge from both runs
                args.seed = ck_meta["seed"]
                engine = build_engine(args, sc, link, device, mesh=mesh)
            if mesh is not None:
                state = engine.scatter_state(state)
        if args.metrics_out and files:
            # attach BEFORE the run: chunked drivers flush every chunk's
            # `supersteps` lines and the controller's `decision` lines
            # as they happen
            from .obs import MetricsRegistry
            engine.metrics_label = f"{sc.name}/{args.engine}"
            engine.metrics = MetricsRegistry(path=args.metrics_out,
                                             run=engine.metrics_label)
        if args.record_out and files:
            # attach BEFORE the run, like the metrics registry; truncate:
            # a re-run must replace the log, not append to it
            from .obs.flight import FlightWriter
            engine.flight_out = FlightWriter(args.record_out,
                                             truncate=True)
        from .obs.profiler import profile_session
        with profile_session(args.torch_profile if files else None):
            if engine.controller is not None:
                final, trace = engine.run_controlled(args.steps,
                                                     state=state)
            elif args.speculate != "off":
                # the optimistic chunked driver; a floor violation (the
                # link model's declared minimum lied) exits clean
                from .speculate import SpeculationViolation
                try:
                    final, trace = engine.run_speculative(
                        args.steps, state=state,
                        chunk=(64 if args.speculate_chunk is None
                               else args.speculate_chunk))
                except SpeculationViolation as e:
                    raise SystemExit(str(e)) from None
            elif args.verify in ("digest", "shadow"):
                # the self-verifying chunked driver; explicit None
                # checks let run_verified's own >= 1 guard refuse a 0
                final, trace = engine.run_verified(
                    args.steps, state=state,
                    chunk=(64 if args.verify_chunk is None
                           else args.verify_chunk),
                    cadence=(1 if args.verify_cadence is None
                             else args.verify_cadence),
                    inject=flip_inj)
            else:
                final, trace = engine.run(args.steps, state=state)
        if clock is not None:
            if device != "cpu":
                import torch
                torch.cuda.synchronize()
            clock.lap("run_s")
        if mesh is not None and (batched is not None or args.save):
            # the global state on every rank (a collective: every rank
            # gathers), rank 0 writing the checkpoint
            final = engine.gather_state(final)
        if args.save and files:
            from .utils.checkpoint import save_state
            meta = {"scenario": sc.name, "seed": args.seed}
            if batched is not None:
                meta["seeds"] = list(batched.seeds)
            if args.faults:
                meta["faults"] = args.faults
            save_state(args.save, final, meta=meta, scenario=sc)
        if batched is not None:
            # per-world counters, route_drop / fault_dropped per WORLD
            # (the never-silent contract on the world axis)
            final_info = {
                "worlds": batched.B,
                "seeds": list(batched.seeds),
                "overflow": final.overflow.tolist(),
                "route_drop": final.route_drop.tolist(),
                "fault_dropped": final.fault_dropped.tolist(),
                "steps": final.steps.tolist(),
                "virtual_time_us": final.time.tolist()}
        else:
            final_info = {"overflow": int(final.overflow),
                          "steps": int(final.steps),
                          "virtual_time_us": int(final.time)}
            if args.faults:
                final_info["fault_dropped"] = int(final.fault_dropped)

    if args.events_csv and files:
        import csv
        records, dropped = engine.events(final)
        with open(args.events_csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["kind", "time_us", "node", "src", "payload0"])
            for r in records:
                # fire records have no src/payload: pad so the file
                # stays rectangular under the 5-column header
                w.writerow(tuple(r) + ("",) * (5 - len(r)))
        if dropped:
            print(json.dumps({"events_dropped_over_capacity": dropped}))

    if args.trace_csv and files:
        import csv
        with open(args.trace_csv, "w", newline="") as f:
            w = csv.writer(f)
            if isinstance(trace, list):
                # batched: one row block per world, world id leading
                w.writerow(["world", "t_us", "fired", "fired_hash",
                            "recv", "recv_hash", "sent", "sent_hash",
                            "overflow"])
                for b, tr in enumerate(trace):
                    for i in range(len(tr)):
                        w.writerow((b,) + tr.row(i))
            else:
                w.writerow(["t_us", "fired", "fired_hash", "recv",
                            "recv_hash", "sent", "sent_hash",
                            "overflow"])
                for i in range(len(trace)):
                    w.writerow(trace.row(i))

    if isinstance(trace, list):
        summary = {"scenario": sc.name, "engine": args.engine,
                   "supersteps": [len(t) for t in trace],
                   "delivered": [t.total_delivered() for t in trace],
                   **final_info}
    else:
        summary = {"scenario": sc.name, "engine": args.engine,
                   "supersteps": len(trace),
                   "delivered": trace.total_delivered(),
                   **final_info}
    summary["device"] = str(device)
    if args.telemetry != "off":
        summary.update(_export_telemetry(args, sc, engine, trace, files))
    if args.record != "off":
        # the flight-recorder receipt: event/drop counts per run (per
        # world, batched) — a dropped count > 0 says the log is
        # incomplete and names the fix (--record-cap)
        log = getattr(engine, "last_run_flight", None)
        fo = getattr(engine, "flight_out", None)
        if fo is not None:
            fo.close()
        if isinstance(log, list):
            summary["flight"] = {"mode": args.record,
                                 "events": [len(lg) for lg in log],
                                 "dropped": [lg.dropped for lg in log]}
        else:
            summary["flight"] = {
                "mode": args.record,
                "events": 0 if log is None else len(log),
                "dropped": 0 if log is None else log.dropped}
        if args.record_out:
            summary["flight"]["out"] = args.record_out
    if args.verify != "off":
        ri = getattr(engine, "last_run_integrity", None)
        summary["integrity"] = {"mode": args.verify} if ri is None \
            else {"mode": ri["mode"], "chunks": ri["chunks"],
                  "checks": ri["checks"],
                  "rollbacks": ri["rollbacks"],
                  "violations": len(ri["violations"]),
                  "digest_chain": ri["digest_chain"]}
        if flip_inj is not None:
            # the detection law's receipt: the flip fired AND the run
            # rolled back (a fired flip with zero rollbacks is a
            # detection failure)
            summary["integrity"]["flip_fired"] = flip_inj.fired
            summary["integrity"]["flip"] = flip_inj.desc
    if getattr(engine, "controller", None) is not None:
        decs = engine.last_run_decisions or []
        summary["controller"] = {
            "mode": engine.controller.mode,
            "decisions": len(decs),
            "windows": sorted({d.window_us for d in decs}),
            "chunk_lens": sorted({d.chunk_len for d in decs}),
        }
        if args.decisions_out and files:
            from .dispatch import DecisionTrace
            DecisionTrace.of(decs).save(args.decisions_out)
            summary["controller"]["out"] = args.decisions_out
    if args.speculate != "off":
        # the speculation receipt: committed windows, the rollback
        # count, and the conservative floor
        si = dict(engine.last_run_speculation or {})
        si.pop("violations", None)   # scalars only on the one line
        summary["speculation"] = {"spec": args.speculate, **si}
        if args.decisions_out and files:
            from .dispatch import DecisionTrace
            DecisionTrace.of(engine.last_run_decisions or []).save(
                args.decisions_out)
            summary["speculation"]["out"] = args.decisions_out
    if args.canon_out and files:
        # the equivalence-law surface (speculate/equiv.py):
        # byte-deterministic, so `cmp` of two files IS the law check
        from .speculate import canonical_rows, write_canon_csv
        B = None if getattr(engine, "batch", None) is None \
            else engine.batch.B
        write_canon_csv(args.canon_out,
                        canonical_rows(final, trace, B))
        summary["canon"] = args.canon_out
    return summary


def _export_telemetry(args, sc, engine, trace, files=True) -> dict:
    """Post-run observability export: flush the decoded telemetry + the
    uniform run stats to the metrics JSONL, build the Perfetto trace,
    and return the summary-line fields. The run itself is already over —
    nothing here can touch the emulation."""
    from .obs.perfetto import TraceBuilder
    label = f"{sc.name}/{args.engine}"
    stats = engine.last_run_stats
    frames = engine.last_run_telemetry
    info = {"telemetry": {"mode": args.telemetry,
                          "supersteps": stats["supersteps"],
                          "wall_seconds": round(stats["wall_seconds"],
                                                4),
                          "compiles": stats["compiles"]}}
    if args.metrics_out and files:
        # the registry was attached before the run: the engine already
        # chunk-flushed its `supersteps` (and any `decision`) lines —
        # only the run-level summary is owed here
        reg = engine.metrics
        reg.run_summary(label, stats)
        reg.close()
        info["metrics"] = args.metrics_out
    if args.trace_out and files:
        tb = TraceBuilder(process=label)
        if isinstance(frames, list):
            for b, fr in enumerate(frames):
                tb.add_superstep_track(fr, trace[b], world=b)
        elif frames is not None:
            tb.add_superstep_track(frames, trace)
        tb.compile_marks(label, stats["compiles"])
        info["trace"] = tb.save(args.trace_out)
    return info


def explain_main(argv) -> int:
    """``explain EVENTS.jsonl --dst N``: reconstruct a delivery's causal
    chain from a recorded flight log (obs/query.py) — which send produced
    it, which fault windows deferred/degraded it along the way — and
    optionally draw the log's send→deliver arrows onto a Perfetto trace.
    Host code over a file: it needs no device."""
    p = argparse.ArgumentParser(
        prog=f"{PROG} explain",
        description="Reconstruct a delivery's causal chain from a "
                    "flight-recorder event log (--record-out).")
    p.add_argument("events", help="JSONL event log written by "
                                  "--record-out / sweep --record")
    p.add_argument("--dst", type=int, required=True,
                   help="destination node of the delivery to explain")
    p.add_argument("--t-us", type=int, default=None,
                   help="the delivery's due instant (µs); unset = "
                        "the --nth matching delivery")
    p.add_argument("--src", type=int, default=None,
                   help="restrict to deliveries from this source")
    p.add_argument("--nth", type=int, default=0,
                   help="which matching delivery (0-based, log order)")
    p.add_argument("--world", type=int, default=None,
                   help="world filter for batched/sweep logs")
    p.add_argument("--run-id", default=None,
                   help="run_id filter for sweep event logs")
    p.add_argument("--faults", default=None,
                   help="the run's --faults schedule, for the "
                        "fault-window cross-reference")
    p.add_argument("--flows", default=None,
                   help="also write a Perfetto trace with the log's "
                        "send->deliver flow arrows to this file")
    p.add_argument("--json", action="store_true",
                   help="one JSON chain instead of text lines")
    args = p.parse_args(argv)
    from .obs.flight import load_flight_jsonl
    from .obs.query import (add_flight_flows, chain_lines,
                            explain_delivery)
    try:
        log = load_flight_jsonl(args.events, run_id=args.run_id,
                                world=args.world)
        res = explain_delivery(log, dst=args.dst, t_us=args.t_us,
                               nth=args.nth, src=args.src,
                               faults=args.faults)
    except (OSError, ValueError) as e:
        raise SystemExit(str(e)) from None
    if args.flows:
        from .obs.perfetto import TraceBuilder
        tb = TraceBuilder(process=f"{PROG} explain")
        n = add_flight_flows(tb, log)
        res["flows"] = {"file": tb.save(args.flows), "arrows": n}
    if args.json:
        print(json.dumps(res))
    else:
        for line in chain_lines(res):
            print(line)
        if "flows" in res:
            print(f"flows   {res['flows']['arrows']} arrows -> "
                  f"{res['flows']['file']} (open at ui.perfetto.dev)")
    return 0


def bisect_main(argv) -> int:
    """``bisect FAMILY``: binary-search two divergent runs' per-chunk
    digest chains to the first diverging chunk, re-run that chunk with
    the flight recorder on, and name the first diverging superstep,
    field, and message-event delta in one pinned line (obs/bisect.py).
    ``--inject-flip`` pits a corrupted run against the clean run (state
    basis); ``--engine-b`` pits two engines against each other (trace
    basis — state layouts legitimately differ)."""
    p = argparse.ArgumentParser(
        prog=f"{PROG} bisect",
        description="Locate the first diverging chunk/superstep/"
                    "field between two runs of one config.")
    p.add_argument("scenario",
                   choices=["token-ring", "gossip", "praos",
                            "ping-pong"])
    p.add_argument("--engine", default="general",
                   choices=["general", "edge", "fused-sparse"])
    p.add_argument("--engine-b", default=None,
                   choices=["general", "edge", "fused-sparse"],
                   help="compare --engine against THIS engine "
                        "(default: same engine — needs "
                        "--inject-flip to have anything to find)")
    p.add_argument("--inject-flip", default=None,
                   help="corrupt run B deterministically: "
                        "flip:SEED[:CHUNK[:PLANE]] "
                        "(integrity/inject.py grammar)")
    _device_arg(p)
    p.add_argument("--nodes", type=int, default=64)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--chunk", type=int, default=64,
                   help="bisection chunk granularity (supersteps)")
    p.add_argument("--link", default="uniform:1000:5000")
    p.add_argument("--faults", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--window", type=_window_arg, default=1)
    p.add_argument("--record-cap", type=int, default=4096,
                   help="event capacity per superstep for the "
                        "diverging chunk's recorded re-run")
    p.add_argument("--mailbox-cap", type=int, default=8)
    p.add_argument("--edge-cap", type=int, default=2)
    p.add_argument("--tokens", type=int, default=None)
    p.add_argument("--think-us", type=int, default=3_000_000)
    p.add_argument("--end-us", type=int, default=20_000_000)
    p.add_argument("--observer", action="store_true")
    p.add_argument("--steady", action="store_true")
    p.add_argument("--burst", action="store_true")
    p.add_argument("--fanout", type=int, default=8)
    p.add_argument("--slots", type=int, default=10)
    p.add_argument("--leader-prob", type=float, default=0.05)
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)
    engine_b = args.engine_b or args.engine
    if args.engine_b is None and not args.inject_flip:
        raise SystemExit(
            "nothing to bisect: the two sides are the same "
            "deterministic run — pass --inject-flip flip:SEED[:CHUNK"
            "[:PLANE]] (corrupt vs clean) or --engine-b ENGINE "
            "(engine vs engine)")
    if args.engine_b is not None and args.inject_flip:
        raise SystemExit(
            "--engine-b and --inject-flip are mutually exclusive: a "
            "cross-engine comparison must chain trace rows (state "
            "layouts legitimately differ), but a flip can land in a "
            "plane trace rows never observe (a payload word) and "
            "would read as a clean all-clear — bisect corrupt vs "
            "clean on ONE engine (the state basis sees every plane), "
            "or engine vs engine without the flip")
    device = require_device(args.device)
    sc = build_scenario(args)
    link = parse_link(args.link)
    faults = build_faults(args)

    def factory(engine_name):
        def make(record="off"):
            kw = dict(seed=args.seed, lint="off", record=record,
                      record_cap=args.record_cap, device=device)
            if engine_name == "general":
                from .interp.torch_engine.engine import TorchEngine
                return TorchEngine(sc, link, window=args.window,
                                   faults=faults, **kw)
            if engine_name == "edge":
                from .interp.torch_engine.edge_engine import EdgeEngine
                return EdgeEngine(sc, link, cap=args.edge_cap,
                                  faults=faults, **kw)
            from .interp.torch_engine.fused_sparse import \
                FusedSparseEngine
            if faults is not None:
                raise SystemExit(
                    "fused-sparse has no fault masks (the kernels "
                    "bypass the mask points); drop --faults or "
                    "bisect the general engine")
            return FusedSparseEngine(sc, link, window=args.window, **kw)
        return make

    inject_b = None
    if args.inject_flip:
        from .integrity import FlipInjector
        spec = args.inject_flip
        try:
            FlipInjector(spec)   # grammar check BEFORE any run
        except ValueError as e:
            raise SystemExit(str(e)) from None

        def inject_b():  # noqa: F811 — the factory form bisect wants
            return FlipInjector(spec)
    from .obs.bisect import bisect_engines
    names = ((args.engine, engine_b) if args.engine_b
             else ("clean", "corrupt"))
    try:
        rep = bisect_engines(
            factory(args.engine), factory(engine_b), args.steps,
            chunk=args.chunk, names=names, inject_b=inject_b,
            basis="trace" if args.engine_b else "state")
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if rep is None:
        detail = f"{names[0]} == {names[1]} at every chunk boundary"
        if args.json:
            print(json.dumps({"divergence": None, "detail": detail}))
        else:
            print(detail)
        return 1
    if args.json:
        print(json.dumps({"divergence": rep.to_json()}))
    else:
        print(rep.line())
    return 0


def profile_main(argv) -> int:
    """``profile FAMILY``: run a (small, overridable) config of the
    family under ``--telemetry full`` and emit a ready-to-open Perfetto
    trace. Extra flags pass through to the run CLI verbatim, so any run
    the CLI can express can be profiled."""
    p = argparse.ArgumentParser(
        prog=f"{PROG} profile",
        description="Run a scenario under full telemetry and write a "
                    "Perfetto trace (open at ui.perfetto.dev).")
    p.add_argument("scenario",
                   choices=["token-ring", "gossip", "praos",
                            "ping-pong"])
    p.add_argument("--out", default=None,
                   help="trace file (default "
                        "tw_profile_<family>.trace.json)")
    p.add_argument("--metrics-out", default=None,
                   help="also write the metrics JSONL here")
    p.add_argument("--torch-profile", default=None,
                   help="additionally capture a torch.profiler session "
                        "into this log dir")
    args, passthrough = p.parse_known_args(argv)
    out = args.out or f"tw_profile_{args.scenario}.trace.json"
    run_argv = [args.scenario, "--telemetry", "full",
                "--trace-out", out]
    if args.metrics_out:
        run_argv += ["--metrics-out", args.metrics_out]
    if args.torch_profile:
        run_argv += ["--torch-profile", args.torch_profile]
    # profiling defaults lean small; any passthrough flag overrides
    # (argparse: the last occurrence wins)
    defaults = ["--nodes", "512", "--steps", "256"]
    rc = main(run_argv + defaults + list(passthrough))
    if rc == 0:
        print(json.dumps({"profile": args.scenario, "trace": out,
                          "open": "https://ui.perfetto.dev"}))
    return rc


if __name__ == "__main__":
    sys.exit(main())

"""``timewarp-tpu-torch search run|repro`` — the adversarial chaos search CLI.

::

    timewarp-tpu-torch search run FAMILY --params JSON [--link SPEC]
        [--seed S] [--window W|auto] [--budget N]
        [--objective eventually-delivered[:T] | convergence:LIMIT]
        [--population P] [--generations G] [--search-seed S]
        [--fork K] [--fork-frac F] [--horizon-us H]
        [--base-faults SPEC] [--journal DIR]
    timewarp-tpu-torch search repro REPRO.json

``run`` drives one :class:`~timewarp_tpu_torch.search.campaign.ChaosSearch`
campaign and prints one JSON result line; with ``--journal DIR`` the
campaign journals its history (``search_*`` events) and writes the
minimized repro artifact to ``DIR/repro.json``. Exit 0 = a violation
was found, minimized, and its repro emitted; 3 = the search exhausted
its generations without a counterexample — 3, not 2, because argparse
exits 2 on usage errors, and CI must be able to tell "no bug found"
from "search never started".

``repro`` replays a repro artifact solo and re-judges the recorded
objective: exit 0 iff the violation REPRODUCES (the artifact's whole
point), 1 with a loud message when it does not.
"""

from __future__ import annotations

import argparse
import json

from ..sweep.spec import RunConfig, SweepConfigError

__all__ = ["search_main"]


def _loud(fn):
    try:
        return fn()
    except (SweepConfigError, ValueError) as e:
        raise SystemExit(str(e)) from None


def _run(argv) -> int:
    p = argparse.ArgumentParser(
        prog="timewarp-tpu-torch search run",
        description="Adversarial chaos search over fault-schedule "
                    "space (timewarp_tpu_torch/search/, docs/search.md).")
    p.add_argument("family",
                   choices=["token-ring", "gossip", "praos",
                            "ping-pong"],
                   help="scenario family (the sweep pack families)")
    p.add_argument("--params", default="{}",
                   help="scenario builder params as one JSON object, "
                        "e.g. '{\"nodes\": 8, \"fanout\": 2, "
                        "\"end_us\": 120000, \"burst\": true}'")
    p.add_argument("--link", default="uniform:1000:5000")
    p.add_argument("--seed", type=int, default=0,
                   help="the emulated world's engine seed (part of "
                        "the repro identity)")
    from ..cli import _window_arg
    p.add_argument("--window", type=_window_arg, default="auto",
                   help="superstep window µs, or 'auto' (a bad value "
                        "is an argparse usage error, never a raw "
                        "traceback)")
    p.add_argument("--budget", type=int, default=1000,
                   help="superstep budget per evaluation")
    p.add_argument("--base-faults", default=None,
                   help="seed schedule for generation 0 (--faults "
                        "grammar); default: start from no faults")
    p.add_argument("--objective", default="eventually-delivered",
                   help="the property to violate: "
                        "eventually-delivered[:AFTER_T] | "
                        "convergence:LIMIT")
    p.add_argument("--population", type=int, default=12)
    p.add_argument("--generations", type=int, default=8)
    p.add_argument("--search-seed", type=int, default=0,
                   help="campaign seed: the whole search is a pure "
                        "function of (config, knobs, this seed)")
    p.add_argument("--fork", type=int, default=0, metavar="K",
                   help="counterfactual forking: fan K fault-suffix "
                        "continuations out from a mid-run snapshot "
                        "of each generation's best candidate, "
                        "paying only for the suffix that differs")
    p.add_argument("--fork-frac", type=float, default=0.5,
                   help="fork point as a fraction of the supersteps "
                        "the candidate's own evaluation actually "
                        "executed (worlds usually quiesce far below "
                        "the nominal budget — docs/search.md)")
    p.add_argument("--horizon-us", type=int, default=None,
                   help="search-domain time horizon (default: the "
                        "params' end_us)")
    p.add_argument("--max-bucket", type=int, default=64)
    p.add_argument("--chunk", type=int, default=64)
    p.add_argument("--minimize-trials", type=int, default=256)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the evaluations' device: the CUDA device "
                        "(default) or the CPU")
    p.add_argument("--journal", default=None,
                   help="journal directory: search_* event history "
                        "+ repro.json (ingest with `timewarp-tpu-torch "
                        "ledger add` — the 'search' kind)")
    args = p.parse_args(argv)

    try:
        params = json.loads(args.params)
        if not isinstance(params, dict):
            raise ValueError("must be a JSON object")
    except (json.JSONDecodeError, ValueError) as e:
        raise SystemExit(f"--params must be one JSON object of "
                         f"builder params ({e})")

    from ..cli import require_device
    device = require_device(args.device)

    def build():
        from .campaign import ChaosSearch
        from .domain import domain_for
        base = RunConfig(
            run_id="search-base", family=args.family,
            params=tuple(sorted(params.items())), link=args.link,
            seed=args.seed, window=args.window, budget=args.budget,
            faults=args.base_faults)
        base.parse_link()
        base.parse_faults()
        return ChaosSearch(
            base=base, objective=args.objective,
            domain=domain_for(base, horizon_us=args.horizon_us),
            population=args.population,
            generations=args.generations, seed=args.search_seed,
            fork_k=args.fork, fork_frac=args.fork_frac,
            max_bucket=args.max_bucket, chunk=args.chunk,
            minimize_trials=args.minimize_trials,
            journal_dir=args.journal, device=device)
    campaign = _loud(build)
    # run() raises user-input-shaped ValueErrors too (e.g. the
    # gen-0 "base already violates" guard) — same clean-exit wrap
    result = _loud(campaign.run)
    print(json.dumps(result.to_json()))
    # 3, not 2: argparse owns exit 2 for usage errors (docstring)
    return 0 if result.found else 3


def _repro(argv) -> int:
    p = argparse.ArgumentParser(
        prog="timewarp-tpu-torch search repro",
        description="Replay a chaos-search repro artifact solo and "
                    "re-judge its objective: exit 0 iff the recorded "
                    "violation reproduces.")
    p.add_argument("repro", help="repro.json written by `search run`")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the replay's device: the CUDA device (default) "
                        "or the CPU")
    args = p.parse_args(argv)
    from ..cli import require_device
    device = require_device(args.device)
    try:
        with open(args.repro) as f:
            rec = json.load(f)
    except OSError as e:
        raise SystemExit(f"cannot read repro artifact: {e}") from None
    except json.JSONDecodeError as e:
        raise SystemExit(
            f"{args.repro!r} is not JSON ({e}) — expected the "
            "repro.json `search run` writes") from None
    if not isinstance(rec, dict) \
            or rec.get("kind") != "chaos-search-repro":
        raise SystemExit(
            f"{args.repro!r} is not a chaos-search repro artifact "
            "(kind != 'chaos-search-repro')")

    def judge():
        from .objectives import rejudge_repro
        try:
            return rejudge_repro(rec, device=device)
        except KeyError as e:
            raise SystemExit(
                f"{args.repro!r} is missing repro field {e} — "
                "truncated or hand-edited artifact "
                "(docs/search.md names the format)") from None
    obj, violated, score = _loud(judge)
    out = {"repro": args.repro, "objective": obj.name,
           "faults": rec["faults"], "reproduced": bool(violated)}
    print(json.dumps(out))
    if not violated:
        import sys
        sys.stderr.write(
            f"repro FAILED to reproduce: {obj.name} holds under "
            f"--faults {rec['faults']!r} (score {score})\n")
        return 1
    return 0


def search_main(argv) -> int:
    if not argv or argv[0] not in ("run", "repro"):
        raise SystemExit(
            "usage: timewarp-tpu-torch search run FAMILY --params JSON "
            "[--objective ...] | search repro REPRO.json  "
            "(docs/search.md)")
    return _run(argv[1:]) if argv[0] == "run" else _repro(argv[1:])

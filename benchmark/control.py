"""The readings the check's limits are set from, on the card at a
cell's own size: for each seed, a run of the program (its lower
readings) and, on the first ``--control`` seeds, a run with the control
in the program's place (the configuration's ``control``: the reference
at the precision below the one it states), each with a short window.
One process, so the set-up is paid once. The benchmark's own runs never
run the control.

    python3 benchmark/control.py --workload praos-1m.diffusion \\
        --seeds 101,102,...,112 --control 3 --seconds 2

Prints one JSON line per run: the seed, ``program`` or ``control``, and
each compared number.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds of the program's runs")
    ap.add_argument("--control", type=int, default=3,
                    help="how many of them also run the control")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness
    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        for control in (False, True) if i < args.control else (False,):
            line = harness.run_cell(args.workload, seed, args.seconds,
                                    False, args.device, ROOT,
                                    control=control)
            print(json.dumps({
                "workload": args.workload, "seed": seed,
                "run": "control" if control else "program",
                "correct": line["correct"],
                "checks": {k: c["value"] for k, c in
                           line["checks"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

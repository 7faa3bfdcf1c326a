"""``timewarp-tpu-torch pack fit`` — fit the superstep forecaster.

::

    timewarp-tpu-torch pack fit --ledger DIR [--out PATH]

Reads every ``pack_stats`` row the run ledger holds (assembled at
``ledger add`` ingest from each run's configs + ``world_done``
results), fits the realized-fraction coefficients (predict.py), and
writes the sha-stamped artifact (default
``<ledger>/pack-predictor.json``). The artifact then feeds ``sweep
run --pack predicted --pack-artifact PATH`` and ``serve --pack
predicted --pack-artifact PATH``.

An absent or empty ledger is refused with ONE actionable line
(exit 1) — never a silent empty artifact, which would shadow the
honest budget fallback with fabricated coefficients.
"""

from __future__ import annotations

import argparse
import json
import os

from .predict import PackFitError, fit_from_ledger, save_artifact

__all__ = ["pack_main"]


def _fit(argv) -> int:
    p = argparse.ArgumentParser(
        prog="timewarp-tpu-torch pack fit",
        description="Fit the packing predictor from run-ledger "
                    "history (timewarp_tpu_torch/pack/, docs/sweeps.md "
                    "'Predictive packing').")
    p.add_argument("--ledger", required=True,
                   help="run-ledger directory (obs/ledger.py) holding "
                        "ingested sweep/serve runs")
    p.add_argument("--out", default=None,
                   help="artifact path (default "
                        "<ledger>/pack-predictor.json)")
    args = p.parse_args(argv)
    try:
        art = fit_from_ledger(args.ledger)
    except PackFitError as e:
        raise SystemExit(f"pack fit: {e}") from None
    out = args.out or os.path.join(args.ledger, "pack-predictor.json")
    sha = save_artifact(art, out)
    print(json.dumps({"artifact": out, "sha": sha,
                      "rows": art["rows"],
                      "keys": len(art["keys"]),
                      "families": sorted(art["families"])}))
    return 0


def pack_main(argv) -> int:
    if not argv or argv[0] != "fit":
        raise SystemExit(
            "usage: timewarp-tpu-torch pack fit --ledger DIR [--out PATH]")
    return _fit(argv[1:])

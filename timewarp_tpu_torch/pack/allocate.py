"""The packing planner: best-fit-decreasing by predicted supersteps
(the port's copy of ``timewarp_tpu/pack/allocate.py``).

Shape-bucketing (sweep/bucket.py) fixes WHICH worlds may share an
executable; this module decides the ORDER they fill buckets in. Under
``first-fit`` (the historical default) an oversize shape group chunks
in pack order, so a 100-superstep world routinely lands beside a
10000-superstep one — the short world quiesces almost immediately and
its slot idles (budget-masked) until the whole bucket drains, while
every chunk still pays the pow2 scan pad of the longest runner.

``predicted`` sorts each shape group by forecast supersteps,
descending (:func:`predicted_order`) before chunking. With bins of
equal capacity filled from a decreasing sequence, best-fit-decreasing
degenerates to exactly this sort-then-chunk: each bucket holds
neighbors of similar horizon, which simultaneously

- **equalizes per-bucket quiescence horizons** (worlds in a bucket
  finish together, so no slot idles budget-masked for long), and
- **minimizes pad waste** (the pow2 scan pad is paid per bucket at
  its longest member; grouping like with like keeps the pad
  proportional to the work actually done).

Ties sort stably by pack order, so the plan is a pure function of
``(pack, artifact)`` — the journaled ``pack_decision`` records
(sweep/service.py) carry it across resume bit-identically.

The same shape drives serve-side placement
(:func:`best_horizon_bucket`): an admitted config joins the open
bucket whose predicted remaining horizon best matches its own
forecast — continuous-batching slot allocation, inference-server
style.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

from ..sweep.spec import RunConfig, SweepConfigError

__all__ = ["PACK_MODES", "PACK_MODE_GRAMMAR", "validate_pack_mode",
           "predicted_order", "best_horizon_bucket"]

#: accepted ``--pack`` knob values
PACK_MODES = ("first-fit", "predicted")

#: the loud-refusal grammar (LINK_GRAMMAR discipline): malformed
#: values name this, never a raw traceback
PACK_MODE_GRAMMAR = "first-fit | predicted"


def validate_pack_mode(mode: str, who: str = "--pack") -> str:
    """Loud knob validation: anything outside :data:`PACK_MODES` is
    refused naming the grammar (tests/test_zgrammar.py
    BAD_PACK_MODES)."""
    if mode not in PACK_MODES:
        raise SweepConfigError(
            f"malformed pack mode {mode!r} for {who}; grammar: "
            f"{PACK_MODE_GRAMMAR}")
    return mode


def predicted_order(cfgs: Sequence[RunConfig],
                    predict: Callable[[RunConfig], int]
                    ) -> List[RunConfig]:
    """Best-fit-decreasing item order for one shape group: sort by
    forecast supersteps, descending, ties kept in pack order (stable
    sort). Chunking the result at ``max_bucket`` IS the bin packing —
    equal-capacity bins filled from a decreasing sequence (module
    docstring)."""
    return sorted(cfgs, key=lambda c: -int(predict(c)))


def best_horizon_bucket(pred: int,
                        candidates: Sequence[Tuple[str, int]]
                        ) -> Optional[str]:
    """Serve-side placement: among open buckets with free slots
    (``(bucket_id, predicted_remaining_horizon)`` pairs, in the
    frontend's stable discovery order), pick the one whose horizon is
    CLOSEST to the admitted config's forecast ``pred`` — a short
    world joins a bucket about to drain, a long one joins a bucket
    that will run anyway. Ties resolve to the earliest candidate, so
    the choice is deterministic in the candidate order."""
    best: Optional[str] = None
    best_d = None
    for bid, horizon in candidates:
        d = abs(int(horizon) - int(pred))
        if best_d is None or d < best_d:
            best, best_d = bid, d
    return best

"""Delta-minimization: shrink a counterexample until it stops failing
(the port's copy of ``timewarp_tpu/search/minimize.py``; its rounds run
on ``device``, the card unless the caller passes ``device="cpu"``).

A raw counterexample schedule carries everything evolution happened
to accrete — events that do nothing, windows wider than needed. The
minimizer is a deterministic greedy delta-debugger over the schedule
structure: (1) drop whole events — each round evaluates EVERY
single-event drop as ONE batched fleet (they share a bucket key by
construction) and applies the lowest-index still-violating drop,
restarting until no single event can be removed (bit-identical to
the sequential front-to-back greedy, one engine build per round
instead of one per trial); (2) tighten every surviving event's
window by binary search — latest still-violating open, earliest
still-violating close. Every trial is a full from-scratch evaluation
of the trial schedule under the SAME objective
(objectives.evaluate_configs — the batched evaluator), so "still
fails" means exactly what the campaign's verdict meant; no state is
shared between trials. The result is the repro artifact's schedule:
re-parse its grammar string and the violation reproduces bit-for-bit
by the determinism the engines already pin.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

from ..faults.schedule import (FaultSchedule, LinkWindow, NodeCrash,
                               Partition)
from ..sweep.spec import RunConfig
from .domain import candidate_config
from .objectives import Objective, evaluate_configs

__all__ = ["minimize_counterexample", "MinimizeResult"]


class MinimizeResult(NamedTuple):
    schedule: FaultSchedule
    trials: int
    dropped_events: int
    tightened_us: int


def _with_window(e, lo: int, hi: int):
    if isinstance(e, NodeCrash):
        return NodeCrash(e.node, lo, hi, e.reset_state)
    if isinstance(e, Partition):
        return Partition(e.groups, lo, hi)
    if isinstance(e, LinkWindow):
        return LinkWindow(e.src, e.dst, lo, hi, e.scale, e.extra_us)
    return None


def _window_of(e) -> Optional[Tuple[int, int]]:
    if isinstance(e, NodeCrash):
        return e.t_down, e.t_up
    if isinstance(e, (Partition, LinkWindow)):
        return e.t_start, e.t_end
    return None                                   # skew: no window


def minimize_counterexample(
        base: RunConfig, schedule: FaultSchedule,
        objective: Objective, *,
        max_trials: int = 256, chunk: int = 64,
        fault_pad: Optional[Tuple[int, int, int]] = None,
        lint: str = "off", device=None,
        _judge: Optional[Callable] = None) -> MinimizeResult:
    """Greedy-minimize ``schedule`` while ``objective`` still judges
    the world violated (module docstring). ``base`` is the config the
    counterexample was found against (family/params/link/seed/window/
    budget — everything but the faults). Deterministic: fixed scan
    order, integer binary search, bounded by ``max_trials`` (budget
    exhaustion returns the best-so-far, never a non-violating
    schedule). Every round is one fleet on ``device`` (the card by
    default). ``_judge`` overrides the evaluation (tests)."""
    trials = 0

    def _eval_many(schedules: List[FaultSchedule]) -> List[bool]:
        """One batched verdict per trial schedule. All trials of a
        round share the base config's bucket key (faults only ever
        differ), so the round is ONE fleet — one engine build instead
        of one per trial; ``fault_pad`` (the campaign passes its
        domain caps) additionally pins the fault-table shape."""
        nonlocal trials
        trials += len(schedules)
        if _judge is not None:
            return [bool(_judge(s)) for s in schedules]
        cfgs = [candidate_config(base, s, f"min{i}")
                for i, s in enumerate(schedules)]
        evals = evaluate_configs(cfgs, chunk=chunk,
                                 fault_pad=fault_pad, lint=lint,
                                 device=device)
        return [objective.judge(evals[c.run_id])[0] for c in cfgs]

    def violates(s: FaultSchedule) -> bool:
        if trials >= max_trials:
            return False                # budget gone: stop shrinking
        return _eval_many([s])[0]

    # the entry check runs UNCONDITIONALLY and OUTSIDE the trial
    # budget (the count resets after): with max_trials=0 a genuinely
    # violating input must still return unminimized, never be
    # misreported as non-violating
    if not _eval_many([schedule])[0]:
        raise ValueError(
            "minimize_counterexample was handed a schedule that does "
            f"not violate {objective.name!r} — nothing to minimize "
            "(the campaign confirms counterexamples from t=0 before "
            "minimizing)")
    trials = 0

    # phase 1 — drop whole events: each round batch-evaluates every
    # single-event drop and applies the LOWEST still-violating index
    # (≡ the sequential front-to-back greedy with restart). A round
    # is clipped to the REMAINING budget, so `trials` never exceeds
    # max_trials — the docstring's bound is exact
    events: List = list(schedule.events)
    dropped = 0
    changed = True
    while changed and len(events) > 1 and trials < max_trials:
        changed = False
        drops = [FaultSchedule(tuple(events[:i] + events[i + 1:]))
                 for i in range(len(events))]
        drops = drops[:max_trials - trials]
        for i, ok in enumerate(_eval_many(drops)):
            if ok:
                events = list(drops[i].events)
                dropped += 1
                changed = True
                break

    # phase 2 — tighten windows: latest open / earliest close that
    # still violates, by integer binary search per edge
    tightened = 0

    def _edge_violates(i: int, lo: int, hi: int) -> bool:
        trial = list(events)
        trial[i] = _with_window(events[i], lo, hi)
        return violates(FaultSchedule(tuple(trial)))

    def try_edges(i: int, pick_lo: bool) -> None:
        nonlocal events, tightened
        win = _window_of(events[i])
        if win is None:
            return
        lo, hi = win
        good = lo if pick_lo else hi          # known-violating edge
        bad = (hi - 1) if pick_lo else (lo + 1)   # tightest possible
        if (good >= bad if pick_lo else good <= bad):
            return
        # establish the bisection invariant by TESTING the tightest
        # edge first: if even the minimal window still violates, it
        # IS the answer — an untested 'bad' endpoint could otherwise
        # never be converged onto, leaving the window 1 µs wider
        # than the tightest still-violating form
        if _edge_violates(i, bad if pick_lo else lo,
                          hi if pick_lo else bad):
            good = bad
        else:
            while (abs(bad - good) > 1) and trials < max_trials:
                mid = (good + bad) // 2
                if _edge_violates(i, mid if pick_lo else lo,
                                  hi if pick_lo else mid):
                    good = mid
                else:
                    bad = mid
        if good != (lo if pick_lo else hi):
            tightened += abs(good - (lo if pick_lo else hi))
            events[i] = _with_window(events[i],
                                     good if pick_lo else lo,
                                     hi if pick_lo else good)

    for i in range(len(events)):
        try_edges(i, pick_lo=False)     # close early first
        try_edges(i, pick_lo=True)      # then open late

    return MinimizeResult(FaultSchedule(tuple(events)), trials,
                          dropped, tightened)

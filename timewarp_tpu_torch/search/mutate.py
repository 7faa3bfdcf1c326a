"""Seeded deterministic mutation/crossover over fault schedules (the
port's copy of ``timewarp_tpu/search/mutate.py``: the same
:class:`random.Random` streams, so equal seeds give the reference's
schedules).

Every operator is a pure function of its :class:`random.Random`
stream — the campaign derives one stream per (campaign seed,
generation, slot) via sha256 (campaign.py), so the whole search is
replayable from its seed with no dependence on dict ordering, wall
time, or platform. Operators only generate events inside the
domain's bounds (domain.py: window-safe slow-down degradations,
in-range nodes, per-kind row caps), so every candidate of a campaign
evaluates under one shared executable shape.

The operator vocabulary: shift/widen crash windows,
retarget crashes, toggle reset, add/remove partitions (contiguous
two-group cuts — always valid, and they print as compact ``a-b|c-d``
range grammar), add/remove/perturb degrade windows, add/remove
crashes, one-point crossover. ``suffix_mutate`` is the
counterfactual-forking form: it only APPENDS events whose windows
start at or after the fork instant, so the mutated world shares the
snapshot's past bit-for-bit (fork.py validates the same invariant).
"""

from __future__ import annotations

import random
from typing import List, Optional, Tuple

from ..faults.schedule import (FaultSchedule, LinkWindow, NodeCrash,
                               Partition)
from .domain import ScheduleDomain

__all__ = ["mutate", "suffix_mutate", "crossover"]

#: degrade slow-down factors the operators draw from (>= 1 only —
#: the domain's window-invariance rule)
_SCALES = (2.0, 4.0, 8.0)


def _window(rng: random.Random, dom: ScheduleDomain,
            t_lo: int = 0) -> Tuple[int, int]:
    """One event window in ``[t_lo, dom.t_max)``. Half the draws are
    'early-long' — starting near ``t_lo`` and outlasting the horizon
    — because liveness violations usually need a window that covers
    the protocol's whole active phase; the other half are uniform
    windows that the shift/widen operators can then hill-climb."""
    h, tm = dom.horizon_us, dom.t_max
    span = tm - t_lo
    if span < 2:
        return t_lo, t_lo + 1
    if rng.random() < 0.5:
        lo = t_lo + rng.randrange(0, max(1, min(span - 1, h // 8 + 1)))
        hi = max(lo + 1, t_lo + (3 * span) // 4
                 + rng.randrange(0, max(1, span // 4)))
    else:
        lo = t_lo + rng.randrange(0, span - 1)
        ln = rng.randrange(max(1, h // 8), h + 1)
        hi = lo + ln
    return lo, min(max(hi, lo + 1), tm)


def _node(rng: random.Random, dom: ScheduleDomain) -> int:
    """A target node: biased toward low ids (protocol roles — rumor
    origins, token holders, leaders — concentrate there in every
    shipped family), uniform otherwise, so the bias helps at any
    node count without ever excluding a target."""
    if rng.random() < 0.25:
        return 0
    return rng.randrange(dom.n_nodes)


def _add_crash(rng, dom, t_lo=0) -> NodeCrash:
    lo, hi = _window(rng, dom, t_lo)
    return NodeCrash(_node(rng, dom), lo, hi,
                     reset_state=rng.random() < 0.25)


def _add_partition(rng, dom, t_lo=0) -> Partition:
    # contiguous prefix cuts, half of them small (isolate a few
    # low-id nodes) — the low-id role bias again, and small cuts
    # print as tight `0-k|...` range grammar
    if rng.random() < 0.5:
        cut = rng.randrange(1, max(2, dom.n_nodes // 8))
    else:
        cut = rng.randrange(1, dom.n_nodes)
    lo, hi = _window(rng, dom, t_lo)
    return Partition((tuple(range(cut)),
                      tuple(range(cut, dom.n_nodes))), lo, hi)


def _add_degrade(rng, dom, t_lo=0) -> LinkWindow:
    lo, hi = _window(rng, dom, t_lo)
    if rng.random() < 0.5:
        src = dst = None                       # all:all
    else:
        src, dst = (rng.randrange(dom.n_nodes),), None
    return LinkWindow(src, dst, lo, hi, rng.choice(_SCALES),
                      extra_us=rng.choice((0, dom.horizon_us // 20,
                                           dom.horizon_us // 8)))


def _ops(evs: List, dom: ScheduleDomain) -> List[str]:
    """The applicable operator deck, weighted by repetition (adds
    dominate while the schedule is small; perturbations once there
    is something to climb on)."""
    crashes = [e for e in evs if isinstance(e, NodeCrash)]
    parts = [e for e in evs if isinstance(e, Partition)]
    links = [e for e in evs if isinstance(e, LinkWindow)]
    deck: List[str] = []
    if len(crashes) < dom.crash_cap:
        deck += ["add_crash"] * 3
    if len(parts) < dom.part_cap:
        deck += ["add_partition"] * 2
    if len(links) < dom.link_cap:
        deck += ["add_degrade"]
    if evs:
        deck += ["drop", "shift", "shift"]
    if crashes:
        deck += ["widen", "widen", "retarget", "toggle_reset"]
    if links:
        deck += ["perturb_degrade"]
    return deck or ["add_crash"]


def _apply(op: str, rng: random.Random, evs: List,
           dom: ScheduleDomain) -> Optional[List]:
    out = list(evs)
    idx = {
        "crash": [i for i, e in enumerate(out)
                  if isinstance(e, NodeCrash)],
        "link": [i for i, e in enumerate(out)
                 if isinstance(e, LinkWindow)],
    }
    if op == "add_crash":
        out.append(_add_crash(rng, dom))
    elif op == "add_partition":
        out.append(_add_partition(rng, dom))
    elif op == "add_degrade":
        out.append(_add_degrade(rng, dom))
    elif op == "drop":
        out.pop(rng.randrange(len(out)))
    elif op == "shift":
        i = rng.randrange(len(out))
        e = out[i]
        d = rng.randrange(1, dom.horizon_us) * rng.choice((-1, 1))
        if isinstance(e, NodeCrash):
            e = NodeCrash(e.node, max(0, e.t_down + d),
                          max(1, e.t_up + d), e.reset_state)
        elif isinstance(e, Partition):
            e = Partition(e.groups, e.t_start + d, e.t_end + d)
        elif isinstance(e, LinkWindow):
            e = LinkWindow(e.src, e.dst, e.t_start + d, e.t_end + d,
                           e.scale, e.extra_us)
        else:
            return None                       # skews are not mutated
        e = dom.clamp_event(e)
        if e is None:
            return None
        out[i] = e
    elif op == "widen":
        i = rng.choice(idx["crash"])
        e = out[i]
        grow = rng.randrange(1, dom.horizon_us)
        if rng.random() < 0.5:
            e = NodeCrash(e.node, max(0, e.t_down - grow), e.t_up,
                          e.reset_state)
        else:
            e = NodeCrash(e.node, e.t_down, e.t_up + grow,
                          e.reset_state)
        out[i] = dom.clamp_event(e)
    elif op == "retarget":
        i = rng.choice(idx["crash"])
        e = out[i]
        out[i] = NodeCrash(_node(rng, dom), e.t_down,
                           e.t_up, e.reset_state)
    elif op == "toggle_reset":
        i = rng.choice(idx["crash"])
        e = out[i]
        out[i] = NodeCrash(e.node, e.t_down, e.t_up,
                           not e.reset_state)
    elif op == "perturb_degrade":
        i = rng.choice(idx["link"])
        e = out[i]
        out[i] = LinkWindow(e.src, e.dst, e.t_start, e.t_end,
                            rng.choice(_SCALES),
                            extra_us=rng.choice(
                                (0, dom.horizon_us // 20,
                                 dom.horizon_us // 8)))
    else:
        raise ValueError(f"unknown mutation op {op!r}")
    return [e for e in out if e is not None]


def mutate(rng: random.Random, schedule: FaultSchedule,
           dom: ScheduleDomain) -> FaultSchedule:
    """One seeded mutation of ``schedule`` inside ``dom`` (module
    docstring). Always returns an admissible schedule; an operator
    that no-ops (empty clamp, inadmissible result) retries from the
    same stream, falling back to the input unchanged after a bounded
    number of draws — determinism over cleverness."""
    evs = list(schedule.events)
    for _ in range(8):
        deck = _ops(evs, dom)
        out = _apply(rng.choice(deck), rng, evs, dom)
        if out is None:
            continue
        cand = FaultSchedule(tuple(out))
        if dom.admissible(cand):
            return cand
    return FaultSchedule(tuple(evs))


def suffix_mutate(rng: random.Random, base: FaultSchedule,
                  t_open: int,
                  dom: ScheduleDomain) -> Optional[FaultSchedule]:
    """The counterfactual-forking mutation: ``base``'s events plus
    ONE appended event whose window starts at or after ``t_open`` —
    the snapshot's executed horizon, fork instant + window
    (fork.validate_fork_suffix re-validates; the last snapshot
    superstep already fired every instant below it). The only
    mutation shape that provably leaves the snapshot's past
    untouched. Returns None when the appended kind's row cap is
    already full or no window fits."""
    if t_open >= dom.t_max - 1:
        return None
    deck: List[str] = []
    if len(base.crashes) < dom.crash_cap:
        deck += ["crash"] * 3
    if len(base.partitions) < dom.part_cap:
        deck += ["partition"] * 2
    if len(base.link_windows) < dom.link_cap:
        deck += ["degrade"]
    if not deck:
        return None
    kind = rng.choice(deck)
    if kind == "crash":
        ev = _add_crash(rng, dom, t_lo=t_open)
    elif kind == "partition":
        ev = _add_partition(rng, dom, t_lo=t_open)
    else:
        ev = _add_degrade(rng, dom, t_lo=t_open)
    return FaultSchedule(tuple(base.events) + (ev,))


def crossover(rng: random.Random, a: FaultSchedule,
              b: FaultSchedule,
              dom: ScheduleDomain) -> Optional[FaultSchedule]:
    """One-point recombination: a prefix of ``a``'s events spliced to
    a suffix of ``b``'s. Returns None when the child is inadmissible
    (over a row cap) — the campaign falls back to mutation."""
    i = rng.randrange(0, len(a.events) + 1)
    j = rng.randrange(0, len(b.events) + 1)
    child = FaultSchedule(tuple(a.events[:i]) + tuple(b.events[j:]))
    return child if dom.admissible(child) else None

"""Robustness properties over traces and event streams (a copy of
``timewarp_tpu/faults/properties.py`` over the port's ``SuperstepTrace``).

The small assertion vocabulary chaos tests and bench gates speak:
does the protocol keep making progress after the faults clear? did
anything fire while it was supposed to be down? Properties are
deliberately simple host-side checks over the observables the
framework already emits — :class:`~timewarp_tpu_torch.trace.events.
SuperstepTrace` rows (aggregate, always available) and per-event
streams (``SuperstepOracle(record_events=True).events`` or the
engine's device ring) when per-node resolution is needed.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, NamedTuple, Optional

import numpy as np

from ..trace.events import SuperstepTrace

__all__ = ["TraceRow", "eventually_delivered", "converged",
           "no_fire_while_down",
           "WorldProp", "WorldCheckFailure", "FleetCheck",
           "prop_eventually_delivered", "prop_converged",
           "check_worlds"]


class TraceRow(NamedTuple):
    """One superstep's aggregates, as handed to ``converged``
    predicates."""
    t: int
    fired_count: int
    fired_hash: int
    recv_count: int
    recv_hash: int
    sent_count: int
    sent_hash: int
    overflow: int


def _rows(trace: SuperstepTrace):
    return (TraceRow(*trace.row(i)) for i in range(len(trace)))


def eventually_delivered(trace: SuperstepTrace, after_t: int) -> bool:
    """True iff some superstep at virtual time >= ``after_t`` delivers
    at least one message — "traffic still flows after the faults
    clear" (e.g. after a partition heals)."""
    return any(r.t >= after_t and r.recv_count > 0 for r in _rows(trace))


def converged(trace: SuperstepTrace,
              pred: Callable[[TraceRow], bool]) -> bool:
    """Eventually-always: there is a superstep from which ``pred``
    holds for every remaining row (vacuously False on an empty
    trace — a run that never fired converged to nothing)."""
    rows = list(_rows(trace))
    if not rows:
        return False
    ok_from = len(rows)
    for i in range(len(rows) - 1, -1, -1):
        if not pred(rows[i]):
            break
        ok_from = i
    return ok_from < len(rows)


# -- batched (world-sliced) evaluation -------------------------------------
#
# The solo functions above take one trace; fleet consumers — the
# adversarial chaos search, sweep-level chaos
# gates — evaluate a whole world axis at once. A WorldProp is one
# named per-world predicate over (trace, that world's FaultSchedule);
# check_worlds folds a list of them over every world of a fleet and
# reports both the bool[B] verdict vector and per-world failure
# detail, so a violating world is named, never a bare False.


class WorldProp(NamedTuple):
    """One named per-world property. ``fn(trace, schedule)`` returns
    a bool, or ``(bool, detail_str)`` when it can say *why* it
    failed."""
    name: str
    fn: Callable


class WorldCheckFailure(NamedTuple):
    world: int
    run_id: Optional[str]
    prop: str
    detail: str


class FleetCheck(NamedTuple):
    """``check_worlds``'s verdict: ``ok[b]`` iff every property held
    in world ``b``; ``failures`` carries one record per (world,
    property) violation, in world-major order."""
    ok: np.ndarray            # bool[B]
    failures: List[WorldCheckFailure]

    @property
    def all_ok(self) -> bool:
        return bool(self.ok.all())


def prop_eventually_delivered(after_t: int) -> WorldProp:
    """The solo :func:`eventually_delivered` as a WorldProp."""
    t = int(after_t)

    def fn(trace, schedule):
        if eventually_delivered(trace, t):
            return True
        return (False, f"no delivery at or after t={t}")
    return WorldProp(f"eventually-delivered:{t}", fn)


def prop_converged(pred: Callable[[TraceRow], bool],
                   name: str = "converged") -> WorldProp:
    """The solo :func:`converged` as a WorldProp."""
    def fn(trace, schedule):
        if converged(trace, pred):
            return True
        return (False, "predicate never holds to the end of the "
                       "trace")
    return WorldProp(name, fn)


def _world_schedules(fleet, B: int):
    from .schedule import FaultFleet, FaultSchedule
    if fleet is None:
        return [FaultSchedule(())] * B
    if isinstance(fleet, FaultFleet):
        scheds = list(fleet.schedules)
    else:
        scheds = list(fleet)
    if len(scheds) != B:
        raise ValueError(
            f"fleet carries {len(scheds)} world schedules but "
            f"{B} traces were handed in")
    return scheds


def check_worlds(traces, fleet, props,
                 run_ids=None) -> FleetCheck:
    """Evaluate ``props`` (WorldProps) against every world of a
    fleet: ``traces`` is the per-world trace list a batched engine
    returns, ``fleet`` a :class:`~timewarp_tpu_torch.faults.schedule.
    FaultFleet` (or a plain sequence of FaultSchedules, or None for
    a fault-free fleet). Returns ``ok: bool[B]`` plus per-world
    failure detail; ``run_ids`` (optional, length B) names worlds in
    the failure records the way the sweep journal would."""
    B = len(traces)
    scheds = _world_schedules(fleet, B)
    if run_ids is not None and len(run_ids) != B:
        raise ValueError(
            f"run_ids names {len(run_ids)} worlds for {B} traces")
    ok = np.ones(B, bool)
    failures: List[WorldCheckFailure] = []
    for b in range(B):
        for prop in props:
            res = prop.fn(traces[b], scheds[b])
            detail = f"property {prop.name} failed"
            if isinstance(res, tuple):
                res, detail = res[0], f"{prop.name}: {res[1]}"
            if not res:
                ok[b] = False
                failures.append(WorldCheckFailure(
                    b, None if run_ids is None else run_ids[b],
                    prop.name, detail))
    return FleetCheck(ok, failures)


def no_fire_while_down(events: Iterable[tuple], schedule) -> bool:
    """True iff no ``("fire", t, node)`` event lands inside one of the
    ``schedule``'s crash windows — the firing-suppression contract,
    checked at per-node resolution over an event stream
    (``SuperstepOracle(record_events=True).events`` or the engine
    ring's decode)."""
    windows = [(c.node, c.t_down, c.t_up) for c in schedule.crashes
               if c.t_up > c.t_down]
    if not windows:
        return True
    for ev in events:
        if ev[0] != "fire":
            continue
        _, t, node = ev[0], ev[1], ev[2]
        for k, d, u in windows:
            if node == k and d <= t < u:
                return False
    return True

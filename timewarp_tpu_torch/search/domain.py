"""The schedule-space search domain: bounds, seeding, candidates
(the port's copy of ``timewarp_tpu/search/domain.py``).

A :class:`ScheduleDomain` bounds what the mutation operators
(mutate.py) may generate for one scenario: node range, time horizon,
and per-kind fault-table row caps. The caps are load-bearing for the
evaluator, not just taste: every candidate of a campaign stays within
``(crash_cap, part_cap, link_cap)`` rows, the evaluation buckets pin
``fault_pad`` to exactly those caps, and so every generation maps
onto ONE batched executable shape (padding rows are inert —
faults/schedule.py FaultTables) instead of recompiling per candidate
mix.

Operators generate only **liveness-relevant, window-safe** events:
crashes, partitions, and slow-down degradations (``scale >= 1``,
``extra_us >= 0``). A shrink degradation (scale < 1) could undercut
the link model's declared delay floor and change the config's
resolved window — which would scatter candidates across bucket keys
AND change superstep granularity mid-search; slow-downs can only
raise delays, so :func:`~timewarp_tpu_torch.sweep.spec.resolve_window` is
candidate-invariant by construction. Clock skews are excluded from
the generated space (a skew rewrites a node's *view* of all time, so
it can never be a valid fork suffix — fork.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

from ..faults.schedule import (FaultSchedule, LinkWindow, NodeCrash,
                               Partition, format_faults)
from ..sweep.spec import RunConfig

__all__ = ["ScheduleDomain", "domain_for", "candidate_config"]


@dataclass(frozen=True)
class ScheduleDomain:
    """Mutation bounds for one scenario (module docstring)."""
    n_nodes: int
    horizon_us: int
    crash_cap: int = 3
    part_cap: int = 2
    link_cap: int = 2

    def __post_init__(self):
        if self.n_nodes < 2:
            raise ValueError(
                f"a schedule domain needs >= 2 nodes, got "
                f"{self.n_nodes}")
        if self.horizon_us < 2:
            raise ValueError(
                f"horizon_us must be >= 2 µs, got {self.horizon_us}")
        for name in ("crash_cap", "part_cap", "link_cap"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0")

    @property
    def table_pad(self) -> Tuple[int, int, int]:
        """The fixed fault-table row shape every campaign bucket pins
        via ``Bucket.fault_pad`` — one executable per generation."""
        return (self.crash_cap, self.part_cap, self.link_cap)

    @property
    def t_max(self) -> int:
        """Latest event-window end the operators generate: past the
        horizon (so a window can outlast the scenario's own deadline)
        but bounded, keeping candidate times small and printable."""
        return 2 * self.horizon_us

    def admissible(self, schedule: FaultSchedule) -> bool:
        """Whether a schedule fits this domain's table caps (the
        mutation operators maintain this invariant; crossover uses it
        to reject over-full recombinations)."""
        return (len(schedule.crashes) <= self.crash_cap
                and len(schedule.partitions) <= self.part_cap
                and len(schedule.link_windows) <= self.link_cap)

    def clamp_event(self, e):
        """An event with its window clamped into ``[0, t_max]``
        (shift/widen mutations may push past either edge); returns
        None when clamping empties the window."""
        tm = self.t_max
        if isinstance(e, NodeCrash):
            # same rule as the other kinds: a crash shifted entirely
            # past t_max empties (None → the operator retries), it
            # does NOT clamp to a phantom sliver at the horizon edge
            # that would squat on a crash_cap row forever
            lo = max(e.t_down, 0)
            hi = min(max(e.t_up, 0), tm)
            if hi <= lo:
                return None
            return NodeCrash(e.node % self.n_nodes, lo, hi,
                             e.reset_state)
        if isinstance(e, Partition):
            lo, hi = max(e.t_start, 0), min(max(e.t_end, 0), tm)
            if hi <= lo:
                return None
            return Partition(e.groups, lo, hi)
        if isinstance(e, LinkWindow):
            lo, hi = max(e.t_start, 0), min(max(e.t_end, 0), tm)
            if hi <= lo:
                return None
            return LinkWindow(e.src, e.dst, lo, hi, e.scale,
                              e.extra_us)
        return e


def domain_for(cfg: RunConfig, *,
               horizon_us: Optional[int] = None,
               **caps) -> ScheduleDomain:
    """The natural domain of one base config: node count from the
    family params (ping-pong is the fixed 2-node scenario), horizon
    from an explicit override or the params' own ``end_us`` deadline.
    A family without a deadline param must pass ``horizon_us`` —
    guessing one silently would make campaign identity depend on a
    heuristic."""
    params = dict(cfg.params)
    n = int(params.get("nodes", 2))
    h = horizon_us if horizon_us is not None else params.get("end_us")
    if h is None:
        raise ValueError(
            f"config {cfg.run_id!r} ({cfg.family}) declares no "
            "end_us param — pass horizon_us= explicitly so the "
            "search domain's time bounds are part of the campaign's "
            "identity")
    return ScheduleDomain(n, int(h), **caps)


def candidate_config(base: RunConfig, schedule: FaultSchedule,
                     run_id: str) -> RunConfig:
    """One candidate as a :class:`~timewarp_tpu_torch.sweep.spec.RunConfig`:
    the base config with ``faults`` replaced by the schedule's grammar
    string (None for an empty schedule — the RunConfig convention).
    Candidates differ ONLY in their fault schedule, so a whole
    generation shares one bucket key (family, params, link signature,
    window — window invariance is the domain's slow-down-only rule)."""
    return dataclasses.replace(
        base, run_id=run_id,
        faults=format_faults(schedule) if schedule.events else None)

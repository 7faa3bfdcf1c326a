"""Property objectives: what "the schedule broke the protocol" means
(the port's copy of ``timewarp_tpu/search/objectives.py``; its
evaluator runs every fleet as one batched ``TorchEngine`` on ``device``,
the card unless the caller passes ``device="cpu"``).

An :class:`Objective` turns one world's evaluation record into a
``(violated, score)`` verdict: ``violated`` is the hard property
violation (the counterexample condition, stated over the same
observables :mod:`timewarp_tpu_torch.faults.properties` checks), ``score``
an integer *pressure gradient* the evolutionary loop maximizes —
schedules that delay delivery or stretch convergence outrank
schedules that merely exist, so the search hill-climbs toward the
violation instead of waiting to stumble on it. Scores are ints
(virtual-time µs and counters), so selection is bit-deterministic.

The module also owns :func:`evaluate_configs`, the batched evaluator
both the campaign driver and the minimizer share: candidates pack
into shape-shared buckets (sweep/bucket.py — one executable per
generation, the domain's ``table_pad`` pinned via
``Bucket.fault_pad``) and run under the engine's chunked fleet
driver, producing one :class:`WorldEval` per candidate.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from ..faults.properties import eventually_delivered
from ..sweep.spec import RunConfig

__all__ = ["WorldEval", "Objective", "DeliveryBlackout",
           "ConvergenceBlowup", "PredicateObjective",
           "parse_objective", "evaluate_configs", "repro_config",
           "rejudge_repro", "OBJECTIVE_GRAMMAR"]

#: score stamped on a hard violation — above any virtual-time value
#: (|t| < 2^61, faults/schedule.py), so violating candidates always
#: outrank every gradient score
VIOLATION_SCORE = 1 << 62


class WorldEval(NamedTuple):
    """One candidate's evaluation record: the observables objectives
    read. ``trace`` covers the evaluated span only — a fork
    continuation's trace starts at the fork instant (``trace_from``),
    which is why fork-phase verdicts are re-confirmed from t=0 before
    they are reported (campaign.py)."""
    run_id: str
    trace: object               # SuperstepTrace
    schedule: object            # FaultSchedule
    supersteps: int
    budget: int
    quiesced: bool
    trace_from: int = 0         # virtual time the trace starts at


@dataclass(frozen=True)
class Objective:
    """Base protocol: ``judge(ev) -> (violated, score)``."""
    name: str = "objective"

    def judge(self, ev: WorldEval) -> Tuple[bool, int]:
        raise NotImplementedError


def _recv_times(trace) -> np.ndarray:
    return trace.times[trace.recv_count > 0]


@dataclass(frozen=True)
class DeliveryBlackout(Objective):
    """Violation of ``eventually_delivered(after_t)``: no superstep
    at or after ``after_t`` delivers a message — the protocol starved
    (default ``after_t=0``: the rumor/token/block never reached
    anyone at all). Gradient: the virtual time of the FIRST delivery
    at/after ``after_t`` — a schedule that pushes first delivery
    later is closer to starving it entirely."""
    after_t: int = 0

    def judge(self, ev: WorldEval) -> Tuple[bool, int]:
        if not eventually_delivered(ev.trace, self.after_t):
            return True, VIOLATION_SCORE
        ts = _recv_times(ev.trace)
        first = int(ts[ts >= self.after_t][0])
        return False, first


@dataclass(frozen=True)
class ConvergenceBlowup(Objective):
    """Convergence-time blowup: the world must quiesce (within its
    superstep budget) by virtual time ``limit_us``. Violated when it
    ran out of budget still live, or quiesced past the limit.
    Gradient: the final virtual time reached."""
    limit_us: int = 0

    def judge(self, ev: WorldEval) -> Tuple[bool, int]:
        t_end = int(ev.trace.times[-1]) if len(ev.trace) else 0
        if not ev.quiesced or t_end > self.limit_us:
            return True, VIOLATION_SCORE
        return False, t_end


@dataclass(frozen=True)
class PredicateObjective(Objective):
    """Custom predicate over the evaluation record: ``fn(ev)``
    returns ``(violated, score)`` (or a bare bool — scored 0/
    VIOLATION_SCORE). The hook for campaign embedders with
    properties this vocabulary does not name."""
    fn: Optional[Callable] = None

    def judge(self, ev: WorldEval) -> Tuple[bool, int]:
        res = self.fn(ev)
        if isinstance(res, tuple):
            return bool(res[0]), int(res[1])
        return bool(res), VIOLATION_SCORE if res else 0


OBJECTIVE_GRAMMAR = ("eventually-delivered[:AFTER_T] | "
                     "convergence:LIMIT  (times µs ints or 10ms/5s)")


def parse_objective(spec: str) -> Objective:
    """Parse the CLI's ``--objective`` grammar; malformation dies
    naming :data:`OBJECTIVE_GRAMMAR` (the parse_faults convention).
    The string form round-trips through the repro artifact, so a
    repro re-judges under exactly the objective that found it."""
    from ..faults.schedule import _parse_time
    parts = spec.split(":")
    try:
        if parts[0] == "eventually-delivered" and len(parts) in (1, 2):
            t = _parse_time(parts[1], "AFTER_T") if len(parts) == 2 \
                else 0
            return DeliveryBlackout(name=f"eventually-delivered:{t}",
                                    after_t=t)
        if parts[0] == "convergence" and len(parts) == 2:
            t = _parse_time(parts[1], "LIMIT")
            return ConvergenceBlowup(name=f"convergence:{t}",
                                     limit_us=t)
        raise ValueError(f"unknown objective {parts[0]!r}")
    except (IndexError, ValueError) as e:
        raise SystemExit(
            f"malformed objective spec {spec!r} ({e}); grammar: "
            f"{OBJECTIVE_GRAMMAR}") from None


def repro_config(rec: Dict, run_id: str = "repro") -> RunConfig:
    """The :class:`RunConfig` a chaos-search repro artifact names —
    ONE reconstruction shared by ``search repro``, the bench's
    replayability gate, and tests, so a repro-schema change can never
    drift them apart."""
    return RunConfig(
        run_id=run_id, family=rec["scenario"],
        params=tuple(sorted(rec["params"].items())),
        link=rec["link"], seed=rec["seed"], window=rec["window"],
        budget=rec["budget"], faults=rec["faults"])


def rejudge_repro(rec: Dict, *, lint: str = "off", device=None):
    """Replay a repro artifact solo on ``device`` (the card by default)
    and re-judge its recorded objective: returns ``(objective,
    violated, score)`` — exit-0 semantics (``violated`` True = the
    repro reproduces) belong to the callers."""
    obj = parse_objective(rec["objective"])
    ev = evaluate_configs([repro_config(rec)], lint=lint,
                          device=device)["repro"]
    violated, score = obj.judge(ev)
    return obj, violated, score


def evaluate_configs(configs: List[RunConfig], *,
                     fault_pad: Optional[Tuple[int, int, int]] = None,
                     max_bucket: int = 64, chunk: int = 64,
                     lint: str = "off",
                     device=None) -> Dict[str, WorldEval]:
    """Run every config to quiescence (or budget) and return one
    :class:`WorldEval` per run_id. Candidates bucket by the standard
    plan (sweep/bucket.py); ``fault_pad`` pins each bucket's
    fault-table rows to the domain caps so every generation of a
    campaign reuses ONE executable shape (padding rows inert). This
    is plain host-side composition over the existing engines — the
    traces and final states it reads are the same objects the sweep
    survival law pins. Every bucket runs on ``device`` (the card
    unless the caller passes ``device="cpu"``; without a card and
    without ``device=`` it raises before any engine is built)."""
    from ..faults.schedule import FaultSchedule
    from ..interp.torch_engine.engine import resolve_device
    from ..sweep.bucket import build_bucket_engine, plan_buckets
    device = resolve_device(device, "evaluate_configs")
    out: Dict[str, WorldEval] = {}
    buckets = plan_buckets(configs, max_bucket)
    if fault_pad is not None:
        buckets = [replace(b, fault_pad=tuple(fault_pad))
                   for b in buckets]
    for bucket in buckets:
        eng = build_bucket_engine(bucket, lint=lint, device=device)
        final, traces = eng.run_stream(bucket.budgets, chunk=chunk)
        steps_done, _, _ = eng.fleet_progress(final, bucket.budgets)
        live = eng.world_active(final).cpu().numpy()
        for b, cfg in enumerate(bucket.configs):
            out[cfg.run_id] = WorldEval(
                run_id=cfg.run_id, trace=traces[b],
                schedule=cfg.parse_faults() or FaultSchedule(()),
                supersteps=int(steps_done[b]),
                budget=int(cfg.budget),
                quiesced=not bool(live[b]))
    return out

"""The causality-violation plane and its host-side decode (the port's
copy of ``timewarp_tpu/speculate/plane.py``, host numpy).

A :class:`SpecRow` is the per-superstep violation plane a speculating
engine builds (``speculate != "off"``): the ``spec`` field of the port's
``PlaneRows``, None when off, so an engine that does not speculate
builds nothing (interp/torch_engine/planes.py).

What a violation IS: the engine's windowed-execution exactness argument
needs every message *sent within a superstep's window* to have flight
time >= the window — then in-window firings are causally independent and
the windowed run is event-identical to the window=1 run. A **straggler**
— a sampled flight shorter than the superstep's effective window — lands
before the window's committed horizon ``t + W``, where a node may already
have fired at an instant past the straggler's arrival without seeing it.
That is the one hazard wide windows introduce (messages already resident
in the mailbox are visible to every firing decision; only same-window
sends can arrive "in the past"), so ``flight < W_effective`` — the exact
condition the never-silent ``short_delay`` counter counts — is a *sound*
detector: zero violations in every committed superstep re-establishes
the exactness precondition dynamically, chunk by chunk, and the
speculative run is event-identical to the conservative one
(docs/speculation.md states the law precisely).

The decode mirrors integrity/checks.py: first violating superstep (then
world), one pinned diagnostic line carrying the superstep, the committed
horizon, and the earliest offending delivery time — scalars only, never
an array dump.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np

__all__ = ["SPECULATE_MODES", "SPECULATE_GRAMMAR", "SpecRow",
           "SpeculationViolation", "parse_speculate",
           "first_spec_violation", "world_spec_violations",
           "spec_violation_error", "hit_scalars"]

#: the engine knob's legal value shapes
SPECULATE_MODES = ("off", "auto", "fixed")

#: the speculate spec grammar, named in every parse error
SPECULATE_GRAMMAR = (
    "off | auto | fixed:W  (auto ladders the speculative window up "
    "from the conservative floor, doubling after clean chunks and "
    "backing off below any width that violated; fixed:W speculates "
    "at exactly W µs until the first violation — W integer µs, "
    "wider than the conservative floor)")


class SpeculationViolation(RuntimeError):
    """A straggler delivery undercut a speculative superstep's
    committed horizon. NOT corruption — the expected, detected cost
    of optimism: ``run_speculative`` catches it, rolls back to the
    last committed snapshot, and re-runs the chunk at the
    conservative floor (a plain ``run`` surfaces it to the caller,
    loudly). Message format is held to the TraceMismatch contract:
    one line, first violating superstep + horizon + offending
    delivery time, never arrays. The decoded hit dict rides on
    ``.hit`` for the driver."""

    def __init__(self, msg: str, hit: Optional[dict] = None) -> None:
        super().__init__(msg)
        self.hit = hit


def parse_speculate(spec, who: str = "speculate"):
    """``off`` | ``auto`` | ``fixed:W`` -> ``(mode, W_or_None)``.
    Malformed specs raise ``ValueError`` naming
    :data:`SPECULATE_GRAMMAR` (the CLI catches and exits clean)."""
    if spec is None or spec == "off":
        return "off", None
    if spec == "auto":
        return "auto", None
    if isinstance(spec, str) and spec.startswith("fixed:"):
        raw = spec[len("fixed:"):]
        try:
            w = int(raw)
        except ValueError:
            raise ValueError(
                f"{who}: fixed:W needs an integer µs width, got "
                f"{raw!r}; grammar: {SPECULATE_GRAMMAR}") from None
        if w < 2:
            raise ValueError(
                f"{who}: fixed:W must be >= 2 µs (W=1 is the classic "
                f"engine — nothing to speculate), got {w}; grammar: "
                f"{SPECULATE_GRAMMAR}")
        return "fixed", w
    raise ValueError(
        f"{who}: unknown speculate spec {spec!r}; grammar: "
        f"{SPECULATE_GRAMMAR}")


class SpecRow(NamedTuple):
    """One superstep's causality plane, or a run's rows stacked on the
    host (``[T]`` solo, ``[T, B]`` for a fleet). All-clean supersteps
    carry ``violations == 0`` and ``straggler == NEVER``."""
    violations: Any   # int32 — stragglers sent this superstep
    horizon: Any      # int64 — the committed horizon t + W_effective
    straggler: Any    # int64 — earliest offending delivery time (abs
    #                 # µs; NEVER when clean)


def _scan_worlds(spec, valid, t_us):
    """The shared per-world scanner behind both decodes: a closure
    mapping a world index (None = solo) to its first violating
    superstep's hit dict, or None when that world is clean."""
    valid = np.asarray(valid)
    t_us = np.asarray(t_us)
    viol = np.asarray(spec.violations)
    hor = np.asarray(spec.horizon)
    strag = np.asarray(spec.straggler)

    def scan_world(world: Optional[int]):
        m = valid if world is None else valid[:, world]
        idxs = np.nonzero(m)[0]
        if idxs.size == 0:
            return None
        v = viol[m] if world is None else viol[m, world]
        hits = np.nonzero(v != 0)[0]
        if hits.size == 0:
            return None
        si = int(hits[0])
        i = int(idxs[si])

        def at(a):
            return int(a[i] if world is None else a[i, world])
        return {"superstep": i, "t": at(t_us), "world": world,
                "count": int(v[si]), "horizon": at(hor),
                "straggler": at(strag)}
    return scan_world


def world_spec_violations(spec, valid, t_us, n_worlds: int) -> list:
    """Per-world decode of a batched run's spec plane ([T, B]
    leaves): a length-``n_worlds`` list holding each world's first
    violating superstep's hit dict, or ``None`` for clean worlds —
    the mask the masked re-run driver (runner.py) re-runs only the
    violating worlds from, preserving every clean world's committed
    progress."""
    scan_world = _scan_worlds(spec, valid, t_us)
    return [scan_world(b) for b in range(n_worlds)]


def first_spec_violation(spec, valid, t_us,
                         n_worlds: Optional[int] = None
                         ) -> Optional[dict]:
    """Host-side decode of a traced run's stacked spec rows ([T]
    leaves; [T, B] batched): the FIRST violating superstep (earliest
    index, then world), or None when the run is clean. Rows outside
    ``valid`` (a frozen world's) are never read."""
    if n_worlds is None:
        return _scan_worlds(spec, valid, t_us)(None)
    hits = [h for h in world_spec_violations(spec, valid, t_us,
                                             n_worlds) if h]
    if not hits:
        return None
    return min(hits, key=lambda h: (h["superstep"], h["world"]))


#: the violation-hit scalars worth carrying beyond the diagnostic —
#: the ONE key list the metrics emit, the journal's spec_rollback
#: record, and the rolled-back decision's obs all share (a drift here
#: would give the three sinks different views of the same violation)
HIT_FIELDS = ("superstep", "horizon", "straggler", "count", "world")


def hit_scalars(hit, fields=HIT_FIELDS) -> dict:
    """The int scalars of a decoded violation hit, filtered for a
    metrics line / journal record / decision-obs payload — shared by
    every sink (module comment on :data:`HIT_FIELDS`)."""
    if not hit:
        return {}
    return {k: v for k, v in hit.items()
            if k in fields and isinstance(v, int)}


def spec_violation_error(hit: dict, who: str) -> SpeculationViolation:
    """The pinned diagnostic: superstep + committed horizon + earliest
    offending delivery time + straggler count, one line, never an
    array (tests/test_zzzzzzspec.py pins it the way
    tests/test_zzdiag.py pins TraceMismatch). Phrased by the
    detector's exact condition — the stragglers *flew shorter than
    the effective window* — because a violator sent late in the
    window can legitimately LAND past the horizon (flight < W but
    woff + flight >= W): the conservative detector flags the flight,
    and the line must never claim more than the detector proved."""
    w = "" if hit["world"] is None else f", world {hit['world']}"
    n = hit["count"]
    return SpeculationViolation(
        f"superstep {hit['superstep']} (t={hit['t']}{w}): {who} "
        f"speculative window violated — {n} straggler"
        f"{'s' if n != 1 else ''} flew shorter than the effective "
        f"window (committed horizon {hit['horizon']} µs; earliest "
        f"offending delivery at {hit['straggler']} µs); roll back "
        "and re-run at the conservative floor "
        "(docs/speculation.md)", hit)

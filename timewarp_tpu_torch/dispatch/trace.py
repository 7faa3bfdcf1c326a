"""The dispatch decision trace: schema'd, journalable, replayable (the
port's copy of ``timewarp_tpu/dispatch/trace.py``; host code, so a trace
recorded by either package replays under the other).

One :class:`Decision` per executed chunk of a controller-driven run
(dispatch/controller.py): the three knob values the chunk ran with —
requested window width, routing-ladder rung pin, chunk length — plus
an ``obs`` dict recording the telemetry the decision was derived from
(including, for batched fleets, the *reduction* used to aggregate
per-world signals into one fleet decision). The trace IS the run's
dispatch identity: re-executing the same engine configuration while
replaying the trace is bit-identical on states, traces, digests, and
checkpoints — the **replay law** (docs/dispatch.md;
tests/test_zzzdispatch.py pins it solo, batched, and under faults).

Serialized form is JSONL, one record per line::

    {"schema": 1, "kind": "decision", "chunk": 0, "window_us": 8000,
     "rung_pin": -1, "chunk_len": 32, "obs": {...}}

the same record shape the sweep journal embeds as
``dispatch_decision`` events (sweep/journal.py) and the metrics
registry validates as the ``decision`` kind (obs/metrics.py) — one
schema, three sinks.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

__all__ = ["DISPATCH_SCHEMA", "Decision", "DecisionTrace",
           "DispatchTraceError"]

#: bump when the decision record's required fields change shape
DISPATCH_SCHEMA = 1


class DispatchTraceError(ValueError):
    """A decision trace is malformed or contradicts the run it is
    replayed against — never silently reconciled."""


@dataclass(frozen=True)
class Decision:
    """One chunk's knob values (module docstring). ``obs`` is
    observability metadata — replay applies only the knobs, so two
    decisions with equal knobs and different obs replay identically
    (equality for the replay-consistency checks therefore compares
    knobs only via :meth:`same_knobs`)."""
    chunk: int          # 0-based chunk index within the run
    window_us: int      # requested superstep window width
    rung_pin: int       # ladder index floor (-1 = unpinned)
    chunk_len: int      # supersteps this chunk may run per world
    obs: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        for name in ("chunk", "window_us", "rung_pin", "chunk_len"):
            v = getattr(self, name)
            if isinstance(v, bool) or not isinstance(v, int):
                raise DispatchTraceError(
                    f"decision field {name!r} must be an int, "
                    f"got {v!r}")
        if self.chunk < 0:
            raise DispatchTraceError(
                f"decision chunk index must be >= 0, got {self.chunk}")
        if self.window_us < 1:
            raise DispatchTraceError(
                f"decision window_us must be >= 1, got {self.window_us}")
        if self.rung_pin < -1:
            raise DispatchTraceError(
                f"decision rung_pin must be >= -1, got {self.rung_pin}")
        if self.chunk_len < 1:
            raise DispatchTraceError(
                f"decision chunk_len must be >= 1, got {self.chunk_len}")

    def same_knobs(self, other: "Decision") -> bool:
        """Replay-relevant equality: the knob values (obs is free)."""
        return (self.chunk == other.chunk
                and self.window_us == other.window_us
                and self.rung_pin == other.rung_pin
                and self.chunk_len == other.chunk_len)

    def to_json(self) -> Dict[str, Any]:
        return {"schema": DISPATCH_SCHEMA, "kind": "decision",
                "chunk": self.chunk, "window_us": self.window_us,
                "rung_pin": self.rung_pin, "chunk_len": self.chunk_len,
                "obs": dict(self.obs)}

    @classmethod
    def from_json(cls, d: Any, where: str = "decision") -> "Decision":
        if not isinstance(d, dict):
            raise DispatchTraceError(
                f"{where}: a decision record is a JSON object, "
                f"got {type(d).__name__}")
        if d.get("schema") != DISPATCH_SCHEMA:
            raise DispatchTraceError(
                f"{where}: decision schema {d.get('schema')!r} != "
                f"{DISPATCH_SCHEMA} (this reader)")
        if d.get("kind") != "decision":
            raise DispatchTraceError(
                f"{where}: kind {d.get('kind')!r} != 'decision'")
        try:
            return cls(chunk=d["chunk"], window_us=d["window_us"],
                       rung_pin=d["rung_pin"], chunk_len=d["chunk_len"],
                       obs=dict(d.get("obs") or {}))
        except KeyError as e:
            raise DispatchTraceError(
                f"{where}: decision record is missing field {e}"
            ) from None


@dataclass(frozen=True)
class DecisionTrace:
    """An ordered, gapless run of decisions (chunk 0, 1, 2, …) — what
    ``--decisions-out`` writes and ``--controller replay:<trace>``
    loads. Construction validates the indexing, so a truncated or
    shuffled file fails at load, not mid-run."""
    decisions: Tuple[Decision, ...]

    def __post_init__(self):
        for i, d in enumerate(self.decisions):
            if d.chunk != i:
                raise DispatchTraceError(
                    f"decision trace is not gapless: position {i} "
                    f"holds chunk {d.chunk} (a trace is the full "
                    "ordered decision sequence of one run)")

    def __len__(self) -> int:
        return len(self.decisions)

    def __getitem__(self, i: int) -> Decision:
        return self.decisions[i]

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            for d in self.decisions:
                f.write(json.dumps(d.to_json(), sort_keys=True) + "\n")
        return path

    @classmethod
    def load(cls, path: str) -> "DecisionTrace":
        decs: List[Decision] = []
        try:
            with open(path) as f:
                lines = f.read().splitlines()
        except OSError as e:
            raise DispatchTraceError(
                f"cannot read decision trace {path!r}: {e}") from None
        for i, line in enumerate(lines, 1):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise DispatchTraceError(
                    f"{path}:{i}: not JSON ({e})") from None
            decs.append(Decision.from_json(rec, where=f"{path}:{i}"))
        if not decs:
            raise DispatchTraceError(
                f"decision trace {path!r} holds no decisions")
        return cls(tuple(decs))

    @classmethod
    def of(cls, decisions) -> "DecisionTrace":
        return cls(tuple(decisions))

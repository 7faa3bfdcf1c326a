"""The speculative-window decision source (the port's copy of
``timewarp_tpu/speculate/policy.py``, host code).

A :class:`SpeculationPolicy` decides, chunk by chunk, how far past
the provable link floor the next chunk may run — the Jefferson
time-warp lever reframed as exactly the journaled-decision shape the
dispatch controller established (dispatch/trace.py): one
:class:`~timewarp_tpu_torch.dispatch.trace.Decision` per executed chunk,
serializable to the same JSONL record, journaled as the same
``dispatch_decision`` sweep event, replayable by the same machinery.
That is the whole integration story — the r13 replay law and the
sweep's resume/retry/``--verify`` paths carry over to speculation
unchanged because a speculative run IS a decision-trace-governed run.

Unlike the telemetry-driven controller, the policy is a **pure
function of its own committed decision chain** (plus the engine's
floor/bound): it reads no telemetry, so a crash can never destroy the
evidence a decision was derived from — re-deciding chunk k after a
kill, given the journaled chunks 0..k-1, reproduces the same decision
bit-for-bit. That is why the sweep may journal speculation decisions
at *commit* time (sweep/runner.py) instead of the controller's
journal-before-run discipline, which in turn is what lets a rollback
replace an uncommitted decision without double-journaling a chunk.

The auto ladder: propose double the widest window that has committed
cleanly (starting from the conservative floor), capped at the bound;
after a violation, the tried width becomes a ceiling and proposals
hold at the widest clean width below half of it — multiplicative
probe up, one rollback per ceiling discovery, converging to the
distribution's practical floor within O(log) chunks. ``fixed:W``
proposes W until the first violation and the conservative floor
thereafter (one rollback total — the honest fixed-bet semantics)."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..dispatch.trace import Decision, DecisionTrace, DispatchTraceError

__all__ = ["SpeculationPolicy"]


class SpeculationPolicy:
    """Module docstring. Duck-types the DispatchController decision
    surface the drivers consume — ``begin(engine)`` / ``decide(ci,
    frames, t_now) -> (Decision, fresh)`` — plus :meth:`rollback`,
    the speculation-specific move the controller never needed."""

    MODES = ("auto", "fixed", "replay")

    def __init__(self, mode: str = "auto", *,
                 fixed_w: Optional[int] = None, chunk: int = 64,
                 replay=None) -> None:
        if mode not in self.MODES:
            raise ValueError(
                f"speculation policy mode must be one of {self.MODES},"
                f" got {mode!r} ('off' is no policy at all)")
        if mode == "fixed" and (fixed_w is None or fixed_w < 2):
            raise ValueError(
                f"mode='fixed' needs fixed_w >= 2 µs, got {fixed_w!r}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.mode = mode
        self.fixed_w = None if fixed_w is None else int(fixed_w)
        self.chunk_len = int(chunk)
        #: every decision governing this run, keyed by chunk index —
        #: a replay chain/prefix lands here up front; fresh decisions
        #: and rollback replacements join as they are made
        self.made: Dict[int, Decision] = {}
        self._replay_len = 0
        if replay is not None:
            for d in (replay.decisions if isinstance(replay,
                                                     DecisionTrace)
                      else replay):
                if isinstance(d, dict):
                    d = Decision.from_json(d, where="speculate replay")
                if d.chunk in self.made \
                        and not self.made[d.chunk].same_knobs(d):
                    raise DispatchTraceError(
                        f"speculation replay holds two DIFFERENT "
                        f"decisions for chunk {d.chunk} — refusing "
                        "to pick one")
                self.made[d.chunk] = d
            self._replay_len = (max(self.made) + 1) if self.made else 0
        elif mode == "replay":
            raise ValueError(
                "mode='replay' needs replay= (a DecisionTrace, a "
                "decision list, or journal records)")
        self.floor: Optional[int] = None
        self.bound: Optional[int] = None

    # -- binding -----------------------------------------------------------

    def begin(self, engine) -> None:
        """Bind to a speculating engine for one run: capture the
        conservative floor and the speculative bound, and validate
        every replayed decision against them — a trace recorded for a
        different configuration fails HERE, loudly."""
        floor = getattr(engine, "spec_floor", None)
        if floor is None:
            raise ValueError(
                f"{type(engine).__name__} does not speculate (build "
                "it with speculate='auto'|'fixed:W', "
                "docs/speculation.md)")
        self.floor = int(floor)
        self.bound = int(engine.window)
        for d in self.made.values():
            if not self.floor <= d.window_us <= self.bound:
                raise DispatchTraceError(
                    f"replayed speculation decision for chunk "
                    f"{d.chunk} requests window {d.window_us} µs "
                    f"outside this engine's [floor={self.floor}, "
                    f"bound={self.bound}] µs — the trace was "
                    "recorded for a different configuration")

    @property
    def decisions(self) -> List[Decision]:
        """Every decision made/replayed so far, in chunk order."""
        return [self.made[i] for i in sorted(self.made)]

    def trace(self) -> DecisionTrace:
        return DecisionTrace.of(self.decisions)

    # -- chain-derived signals --------------------------------------------

    def _chain_state(self, ci: int) -> Tuple[int, Optional[int]]:
        """(widest clean committed window BELOW the ceiling, lowest
        violated width or None) over chunks < ci — the ONLY inputs of
        a fresh proposal, so the policy is replay-deterministic from
        the journaled chain alone (module docstring). A width that
        committed cleanly once but violated LATER counts as violated,
        not clean: stragglers are stochastic, so the ceiling must
        trump every earlier clean commit at or above it — otherwise
        the hold branch would re-propose a known-bad width and pay a
        rollback every time the distribution produces a short sample."""
        bad_min: Optional[int] = None
        for k, d in self.made.items():
            if k < ci and d.obs.get("tried_us") is not None:
                t = d.obs["tried_us"]
                bad_min = t if bad_min is None else min(bad_min, t)
        clean_max = self.floor
        for k, d in self.made.items():
            if k >= ci or d.obs.get("tried_us") is not None:
                continue
            if bad_min is None or d.window_us < bad_min:
                clean_max = max(clean_max, d.window_us)
        return clean_max, bad_min

    # -- the per-chunk decision point -------------------------------------

    def decide(self, ci: int, frames, t_now: int
               ) -> Tuple[Decision, bool]:
        """The decision for chunk ``ci`` — ``(decision, fresh)``,
        ``fresh=False`` for replayed/already-made chunks (the
        controller's contract). ``frames``/``t_now`` are accepted for
        interface parity and recorded only as observability — the
        proposal itself is a pure function of the committed chain."""
        if ci in self.made:
            return self.made[ci], False
        if self.mode == "replay":
            raise DispatchTraceError(
                f"speculation replay exhausted at chunk {ci} (holds "
                f"{self._replay_len}): the replayed run needed more "
                "chunks than the recorded one — the engine "
                "configuration does not match the trace")
        clean_max, bad_min = self._chain_state(ci)
        if self.mode == "fixed":
            w = self.floor if bad_min is not None else self.fixed_w
        else:
            w = min(clean_max * 2, self.bound)
            if bad_min is not None and w >= bad_min:
                # hold at the widest width known clean — the probe
                # already found the ceiling, never bang into it again
                w = clean_max
        obs = {"spec": self.mode, "floor_us": self.floor,
               "clean_max_us": clean_max, "t_now": int(t_now)}
        if bad_min is not None:
            obs["ceiling_us"] = bad_min
        dec = Decision(chunk=ci, window_us=int(max(w, 1)),
                       rung_pin=-1, chunk_len=self.chunk_len, obs=obs)
        self.made[ci] = dec
        return dec, True

    # -- the rollback move -------------------------------------------------

    def rollback(self, ci: int, hit: Optional[dict] = None) -> Decision:
        """Replace chunk ``ci``'s (uncommitted, violating) decision
        with the conservative-floor decision the re-run commits. The
        tried width rides ``obs.tried_us`` — the ceiling signal every
        later proposal reads — plus the violation scalars for the
        audit trail. Refused in replay mode: a committed chain is
        violation-free by construction, so a violation during replay
        is a configuration mismatch, never a legitimate rollback."""
        if self.mode == "replay":
            raise DispatchTraceError(
                f"speculation replay hit a causality violation at "
                f"chunk {ci} — committed chains are violation-free, "
                "so the replayed engine configuration does not match "
                "the trace (docs/speculation.md)")
        prev = self.made.get(ci)
        if prev is None:
            raise ValueError(f"rollback for undecided chunk {ci}")
        from .plane import hit_scalars
        obs = {"spec": self.mode, "floor_us": self.floor,
               "rolled_back": True, "tried_us": prev.window_us,
               **hit_scalars(hit)}
        dec = Decision(chunk=ci, window_us=self.floor, rung_pin=-1,
                       chunk_len=prev.chunk_len, obs=obs)
        self.made[ci] = dec
        return dec

"""The online adaptive dispatch controller (the port's copy of
``timewarp_tpu/dispatch/controller.py``, host code; ROADMAP "Online
adaptive dispatch"; TempoNet's slack-quantized deadline-centric framing,
PAPERS.md). On ``TorchEngine`` (``_dyn_ok``) it adapts the window and the
chunk length; the port routes at one static width and has no rung
ladder, so ``begin`` finds none and the rung pin stays -1. On
``FusedSparseEngine`` and ``EdgeEngine`` (``_dyn_ok`` False) it adapts
chunk length only and records the window and rung pinned.

A :class:`DispatchController` sits **between** jitted chunks of the
chunked drivers (``run_controlled`` — interp/jax_engine/controlled.py;
the sweep service's BucketRunner drives the same contract per bucket)
and adapts three dispatch knobs online from the telemetry the previous
chunk streamed (``engine.last_run_telemetry``, obs/):

- **window width** — widen toward the engine's window *bound* (the
  undegraded link floor) when supersteps run sparse, narrow when the
  fault schedule's per-window link floor says a degradation window
  overlaps the upcoming virtual-time span
  (``FaultSchedule.min_delay_floor_in``; the device-side clamp
  ``faults.apply.window_floor`` independently guarantees exactness,
  so the host query is *policy*, never a correctness dependence);
- **rung pinning** — a floor on the adaptive routing ladder's selected
  index when the observed rung column thrashes (the effective index
  is ``max(computed, pin)``: a pin can only widen, so it is
  result-identical by the ladder's own construction);
- **chunk length** — a pow2 ladder between ``chunk_min`` and
  ``chunk_max``, shrunk when worlds quiesce mid-chunk (budget-mask
  waste — the ``bucket_util`` signal) and grown when every superstep
  of the chunk ran.

Nothing here touches a traced value: knobs reach the executable as
ordinary traced scalars (``DynDispatch``), so **no adaptation ever
retraces** — the pow2 scan pad stays the drivers' only static compile
input, and every adapted configuration resolves through the already-
compiled executable cache (the zero-recompile acceptance,
tests/test_zzzdispatch.py).

Every decision is recorded (dispatch/trace.py) and the controller
accepts a prior trace: ``mode="replay"`` re-applies a full recorded
run (the **replay law** — bit-identical states/traces/digests/
checkpoints), while ``mode="auto"`` with ``replay=`` re-applies a
journaled *prefix* before deciding fresh — exactly what ``sweep
resume`` needs so decisions journaled before a kill are never re-made
differently (sweep/runner.py).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .trace import Decision, DecisionTrace, DispatchTraceError

__all__ = ["DispatchController", "parse_controller",
           "CONTROLLER_GRAMMAR"]

#: the --controller grammar, named in every parse error
CONTROLLER_GRAMMAR = ("auto | off | replay:<trace.jsonl>  "
                      "(auto adapts from telemetry and records a "
                      "decision trace; replay re-applies a recorded "
                      "trace bit-for-bit)")


def parse_controller(spec: Optional[str]):
    """The CLI constructor: ``auto`` | ``off``/None | ``replay:PATH``.
    Malformed specs die naming :data:`CONTROLLER_GRAMMAR`."""
    if spec is None or spec == "off":
        return None
    if spec == "auto":
        return DispatchController()
    if spec.startswith("replay:"):
        path = spec[len("replay:"):]
        if not path:
            raise SystemExit(
                f"replay needs a trace path; grammar: "
                f"{CONTROLLER_GRAMMAR}")
        try:
            return DispatchController(
                mode="replay", replay=DecisionTrace.load(path))
        except DispatchTraceError as e:
            raise SystemExit(str(e)) from None
    raise SystemExit(f"unknown --controller spec {spec!r}; grammar: "
                     f"{CONTROLLER_GRAMMAR}")


def _pow2_at_most(x: int) -> int:
    return 1 << (max(int(x), 1).bit_length() - 1)


class DispatchController:
    """Module docstring. One controller drives one run at a time
    (:meth:`begin` rebinds it to an engine); decisions accumulate in
    :attr:`made` keyed by chunk index, so a sweep retry that re-runs a
    chunk REUSES its decision instead of re-deriving it from telemetry
    the crash destroyed."""

    MODES = ("auto", "replay")

    def __init__(self, mode: str = "auto", *, replay=None,
                 chunk: int = 32, chunk_min: int = 8,
                 chunk_max: int = 256,
                 density_lo: int = 2) -> None:
        if mode not in self.MODES:
            raise ValueError(
                f"controller mode must be one of {self.MODES}, got "
                f"{mode!r} (the 'off' state is no controller at all)")
        for name, v in (("chunk", chunk), ("chunk_min", chunk_min),
                        ("chunk_max", chunk_max)):
            if v < 1:
                raise ValueError(f"{name} must be >= 1, got {v}")
        if chunk_min > chunk_max:
            raise ValueError(
                f"chunk_min={chunk_min} > chunk_max={chunk_max}")
        self.mode = mode
        self.chunk_init = _pow2_at_most(chunk)
        self.chunk_min = _pow2_at_most(chunk_min)
        self.chunk_max = _pow2_at_most(chunk_max)
        #: mean active senders per superstep below which a chunk is
        #: "sparse" and the window widens toward the bound
        self.density_lo = int(density_lo)
        #: every decision governing this run, keyed by chunk index —
        #: the replay prefix lands here up front, fresh auto decisions
        #: join as they are made
        self.made: Dict[int, Decision] = {}
        self._replay_len = 0
        if replay is not None:
            for d in (replay.decisions if isinstance(replay,
                                                     DecisionTrace)
                      else replay):
                if isinstance(d, dict):
                    d = Decision.from_json(d, where="replay record")
                if d.chunk in self.made \
                        and not self.made[d.chunk].same_knobs(d):
                    raise DispatchTraceError(
                        f"replay holds two DIFFERENT decisions for "
                        f"chunk {d.chunk} — refusing to pick one")
                self.made[d.chunk] = d
            self._replay_len = (max(self.made) + 1) if self.made else 0
        elif mode == "replay":
            raise ValueError(
                "mode='replay' needs replay= (a DecisionTrace, a "
                "decision list, or journal records)")
        # engine binding (begin)
        self._bound: Optional[int] = None
        self._dyn_ok = False
        self._rungs: Optional[List[int]] = None
        self._sched = None
        self._batched = False
        self._mb_cap = 0

    # -- binding -----------------------------------------------------------

    def begin(self, engine) -> None:
        """Bind to an engine for one run: capture the window bound,
        the rung ladder (when one will actually run), and the fault
        schedule for per-window floor queries — and validate every
        replay/prefix decision against those bounds, so a trace
        recorded for a different configuration fails HERE, loudly,
        not as a silent clamp mid-run."""
        self._dyn_ok = bool(getattr(engine, "_dyn_ok", False))
        self._bound = int(getattr(engine, "window", 1))
        self._sched = getattr(engine, "faults", None)
        self._batched = getattr(engine, "batch", None) is not None
        self._mb_cap = int(getattr(engine.scenario, "mailbox_cap", 0))
        self._rungs = None
        if self._dyn_ok and not self._batched:
            regime = getattr(engine, "_adaptive_regime", None)
            if regime is not None and regime():
                rungs = engine._sender_rungs(engine.scenario.n_nodes)
                if len(rungs) > 1:
                    self._rungs = list(rungs)
        top_pin = -1 if self._rungs is None else len(self._rungs) - 1
        for d in self.made.values():
            if d.window_us > self._bound:
                raise DispatchTraceError(
                    f"replayed decision for chunk {d.chunk} requests "
                    f"window {d.window_us} µs beyond this engine's "
                    f"bound {self._bound} µs — the trace was recorded "
                    "for a different configuration")
            if d.rung_pin > top_pin:
                raise DispatchTraceError(
                    f"replayed decision for chunk {d.chunk} pins rung "
                    f"index {d.rung_pin} but this engine's ladder has "
                    f"{top_pin + 1} pinnable rungs")

    @property
    def decisions(self) -> List[Decision]:
        """Every decision made/replayed so far, in chunk order."""
        return [self.made[i] for i in sorted(self.made)]

    def trace(self) -> DecisionTrace:
        return DecisionTrace.of(self.decisions)

    # -- the per-chunk decision point -------------------------------------

    def decide(self, chunk_index: int, frames, t_now: int
               ) -> Tuple[Decision, bool]:
        """The decision for chunk ``chunk_index``. Returns
        ``(decision, fresh)`` — ``fresh=False`` means it was replayed
        (from a prior trace, a journaled prefix, or an earlier attempt
        of the same chunk) and must NOT be re-journaled. ``frames`` is
        the previous chunk's decoded telemetry
        (``engine.last_run_telemetry``: a TelemetryFrames, a per-world
        list, or None before the first chunk / after a retry reload);
        ``t_now`` the fleet's current virtual time."""
        if chunk_index in self.made:
            return self.made[chunk_index], False
        if self.mode == "replay":
            raise DispatchTraceError(
                f"replay trace exhausted at chunk {chunk_index} "
                f"(holds {self._replay_len}): the replayed run needed "
                "more chunks than the recorded one — the engine "
                "configuration does not match the trace")
        dec = self._auto(chunk_index, frames, int(t_now))
        self.made[chunk_index] = dec
        return dec, True

    # -- the auto policy ---------------------------------------------------

    def _signals(self, frames) -> Optional[dict]:
        """Fold one chunk's telemetry into the scalar signals the
        policy reads. Batched fleets reduce per-world columns with the
        RECORDED aggregations: quiescence slack by ``min`` over worlds
        (a fleet window/chunk must suit the tightest world), load by
        ``max``, density by ``mean`` — the reductions land in the
        decision's ``obs`` so a trace reader can audit them."""
        if frames is None:
            return None
        flist = frames if isinstance(frames, list) else [frames]
        if all(len(f) == 0 for f in flist):
            return None
        sup = max(len(f) for f in flist)
        act = np.concatenate([f.data["active_senders"] for f in flist
                              if len(f)])
        rungs = np.concatenate([f.data["rung"] for f in flist
                                if len(f)])
        slack = np.concatenate([f.data["qslack_us"] for f in flist
                                if len(f)])
        live_slack = slack[slack >= 0]
        sig = {
            "supersteps": int(sup),
            "active_mean": float(act.mean()),
            "active_max": int(act.max()),
            "rung_used": sorted(int(r) for r in set(rungs.tolist())
                                if r >= 0),
            "qslack_min": int(live_slack.min()) if live_slack.size
            else -1,
            "span_us": int(max(int(f.t_us[-1]) - int(f.t_us[0])
                               for f in flist if len(f))),
            "agg": "slack:min-over-worlds,load:max-over-worlds"
            if len(flist) > 1 else "solo",
        }
        if any("mb_peak" in f.data and len(f) for f in flist):
            sig["mb_peak"] = int(max(
                int(f.data["mb_peak"].max()) for f in flist
                if "mb_peak" in f.data and len(f)))
        return sig

    def _auto(self, ci: int, frames, t_now: int) -> Decision:
        prev = self.made.get(ci - 1)
        sig = self._signals(frames)
        chunk = prev.chunk_len if prev is not None else self.chunk_init
        chunk = min(max(chunk, self.chunk_min), self.chunk_max)
        obs: Dict[str, Any] = {"t_now": t_now}
        # -- window: start wide (the bound — exactness never depends
        # on the request: the per-superstep device clamp
        # faults/apply.window_floor is the narrowing authority, at
        # finer granularity than any per-chunk request could be),
        # halve under observed mailbox pressure (the overflow-boundary
        # caveat is what makes a narrower window ever preferable),
        # re-widen when pressure clears. The fault tables' per-window
        # link floor over the upcoming span is consumed and RECORDED
        # (obs.floor_h_us) so a trace reader sees the degradation
        # narrowing the controller expects the clamp to apply.
        w = prev.window_us if prev is not None else self._bound
        if self._dyn_ok:
            if sig is not None:
                mbp = sig.get("mb_peak")
                if mbp is not None and self._mb_cap \
                        and 10 * mbp >= 9 * self._mb_cap:
                    w = max(1, w // 2)
                elif w < self._bound:
                    w = min(self._bound, max(1, w) * 2)
            else:
                w = self._bound
            if self._sched is not None \
                    and hasattr(self._sched, "min_delay_floor_in"):
                span = sig["span_us"] if sig is not None \
                    else self._bound * chunk
                horizon = max(int(span), self._bound)
                obs["floor_h_us"] = int(
                    self._sched.min_delay_floor_in(
                        self._bound, t_now, t_now + horizon))
                obs["horizon_us"] = horizon
        else:
            # window is a static compile parameter on this engine
            # (fused kernels bake it; the edge engine runs classic
            # supersteps) — recorded as the pinned value
            w = max(1, self._bound)
            obs["window"] = "static"
        if sig is not None:
            obs.update({k: (round(v, 3) if isinstance(v, float) else v)
                        for k, v in sig.items()})
            # -- chunk length: shrink when the chunk ran mostly masked
            # tail (worlds quiesced / budgets exhausted mid-chunk),
            # grow when every superstep ran
            if prev is not None:
                full = sig["supersteps"] / max(prev.chunk_len, 1)
                obs["full_frac"] = round(full, 3)
                if full <= 0.5:
                    chunk = max(self.chunk_min,
                                _pow2_at_most(max(sig["supersteps"],
                                                  1)))
                elif full >= 1.0:
                    chunk = min(self.chunk_max, chunk * 2)
            # -- rung pin: the ladder thrashed across rungs within one
            # chunk -> floor it at the widest rung the chunk needed
            # (result-identical: max(computed, pin) can only widen)
            if self._rungs is not None and len(sig["rung_used"]) > 1:
                widest = max(sig["rung_used"])
                pin = self._rungs.index(widest) \
                    if widest in self._rungs else -1
            else:
                pin = -1
        else:
            pin = -1
        if self._rungs is None:
            pin = -1
        return Decision(chunk=ci, window_us=int(w), rung_pin=int(pin),
                        chunk_len=int(chunk), obs=obs)

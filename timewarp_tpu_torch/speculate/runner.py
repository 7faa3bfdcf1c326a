"""The optimistic chunked driver: speculate, detect, roll back, commit (the
port of ``timewarp_tpu/speculate/runner.py``, on ``TorchEngine``).

``run_speculative`` is ``run_verified``'s optimistic sibling
(integrity/runner.py — the same snapshot/restore skeleton, the same
metrics/flight shielding): the run executes one ``run`` chunk at a time
with the chunk's window handed over as a ``DynDispatch`` tensor (made
once per chunk on the engine's device, so no host sync is added inside
the chunk), WIDER than the provable link floor. Around every chunk:

1. the policy (policy.py) proposes the chunk's speculative window — a
   journaled :class:`~timewarp_tpu_torch.dispatch.trace.Decision`;
2. the chunk runs; the causality-violation plane (plane.py, a
   ``PlaneRows.spec`` row per superstep, on the device until the run's
   end) is decoded host-side by the engine's ``run``;
3. **clean** -> commit: trace rows append, telemetry/metrics/flight
   flush (exactly the lines ``run`` would have flushed), the snapshot
   advances;
4. **violation** -> roll back and re-run at the conservative floor.
   Solo: the engine's ``run`` raised the pinned
   :class:`~timewarp_tpu_torch.speculate.plane.SpeculationViolation`;
   the restore is just "keep the snapshot" (``run`` never writes into
   its input state) and the whole chunk re-runs. A fleet: worlds are
   independent, so the rollback is **masked** — the per-world violation
   decode (plane.py ``world_spec_violations``) splits the fleet, the
   CLEAN worlds' chunk commits exactly as if no other world existed, and
   only the violating worlds re-run from their snapshot slices at the
   floor (a ``[B]`` mask merges ``where(violating, snapshot,
   speculative)`` per leaf; per-world budgets of 0 freeze everyone
   else). Either way the floor chunk is safe by the link model's
   declared bound, so recovery is deterministic and bit-exact.

Laws (tests/test_torch_speculate.py, docs/speculation.md):

- **equivalence law** — the committed run is event-identical to the
  conservative run: bit-for-bit equal scenario-visible final state and
  granularity-invariant trace aggregates (speculate/equiv.py);
- **replay law** — re-running with ``replay=`` over the emitted decision
  trace is bit-identical on states, traces and checkpoints, rollbacks
  included (committed chains carry the floor decision a rollback settled
  on, so a replay never rolls back);
- **off is free** — an engine with ``speculate="off"`` enters none of
  this module and builds no violation row.
"""

from __future__ import annotations

import numpy as np

__all__ = ["SpeculativeRunMixin"]


def _merge_worlds(mask, a, b):
    """Per leaf of two fleet states: world w from ``a`` where ``mask[w]``
    (a ``[B]`` bool tensor), else from ``b``."""
    import torch

    def pick(x, y):
        return torch.where(mask.view((-1,) + (1,) * (y.dim() - 1)), x, y)
    return type(a)(**{
        f: ({k: pick(x[k], y[k]) for k in x} if isinstance(x, dict)
            else pick(x, y))
        for f, x, y in zip(a._fields, a, b)})


class SpeculativeRunMixin:
    """``speculate=`` state + the optimistic chunked driver (module
    docstring). Host state only: an engine with ``speculate="off"``
    builds no violation row and runs none of this."""

    #: the engine's speculate mode ("off" | "auto" | "fixed")
    speculate = "off"
    #: fixed:W width (None unless mode == "fixed")
    _spec_w = None
    #: the conservative floor — the window the engine would have run
    #: statically (None unless speculating; the engine's __init__ sets it)
    spec_floor = None
    #: the last decoded violation hit (None = clean), whatever driver
    last_run_spec = None
    #: fleets: the per-world first-hit list (None entries = clean worlds)
    #: behind ``last_run_spec`` — the masked-rollback driver's re-run mask
    last_run_spec_world = None
    #: the last run_speculative call's speculation record (dict)
    last_run_speculation = None
    #: per-world committed decision chains of the last run_speculative
    #: call (fleets; None solo) — world b's chain holds one Decision per
    #: chunk world b actually ran, the floor decision where it was rolled
    #: back
    last_run_decisions_world = None
    #: run_speculative's bind: when True, a decoded violation is RECORDED
    #: (last_run_spec/last_run_spec_world), not raised — the masked
    #: rollback needs the clean worlds' results back. Plain ``run``
    #: always raises (loud, never silent).
    _spec_defer = False

    # -- host-side decode of the violation plane --------------------------

    def _capture_spec(self, spec, valid, t_us) -> None:
        """Decode a traced run's causality plane (a SpecRow of numpy
        ``[T]`` leaves, ``[T, B]`` for a fleet, with the run's ``valid``
        and ``t_us``): raise the pinned one-line
        :class:`SpeculationViolation` on the FIRST violating superstep —
        ``run_speculative`` catches it and rolls back; a plain ``run``
        surfaces it to the caller. For a fleet the per-world hit list also
        lands on ``last_run_spec_world`` (the masked re-run's mask); under
        the driver's ``_spec_defer`` bind the hit is recorded without
        raising."""
        from .plane import (first_spec_violation, spec_violation_error,
                            world_spec_violations)
        self.last_run_spec = None
        self.last_run_spec_world = None
        batch = getattr(self, "batch", None)
        if batch is None:
            hit = first_spec_violation(spec, valid, t_us, None)
        else:
            hits = world_spec_violations(spec, valid, t_us, batch.B)
            self.last_run_spec_world = hits
            live = [h for h in hits if h]
            hit = min(live, key=lambda h: (h["superstep"],
                                           h["world"])) if live else None
        if hit is not None:
            self.last_run_spec = hit
            if self._spec_defer:
                return
            raise spec_violation_error(hit, type(self).__name__)

    def _quiet_spec_guard(self, before, final) -> None:
        """The traceless driver's (``run_quiet``) violation check: no
        per-superstep rows exist there, so detection degrades to the
        never-silent ``short_delay`` counter delta — a speculating quiet
        run can never be silently wrong, it just cannot localize (run the
        traced driver for the pinned line). ``before`` is the run's input
        state, None for a fresh one. Only a speculating engine calls it."""
        d = final.short_delay.cpu().numpy().astype(np.int64)
        if before is not None:
            d = d - before.short_delay.cpu().numpy().astype(np.int64)
        if int(d.sum()) > 0:
            from .plane import SpeculationViolation
            raise SpeculationViolation(
                f"{type(self).__name__} run_quiet: {int(d.sum())} "
                "straggler deliveries violated the speculative window "
                "(short_delay delta) — run()/run_speculative localize "
                "the first (docs/speculation.md)")

    # -- the driver --------------------------------------------------------

    def run_speculative(self, budgets, state=None, *, chunk: int = 64,
                        replay=None, on_quiesce=None, policy=None):
        """Run to quiescence/budget under the engine's ``speculate`` mode,
        chunk by chunk, rolling back and re-running at the conservative
        floor on any causality violation (module docstring) — solo runs
        roll the whole chunk back; fleets re-run ONLY the violating
        worlds, committing every clean world's chunk untouched (the masked
        rollback). Accepts the same budget forms as ``run`` (int; fleets
        also a per-world vector) and returns ``(final_state, trace)`` — a
        fleet's per-world trace list — exactly like ``run``. ``replay``
        re-applies a recorded decision trace bit-for-bit (the replay law).
        ``policy`` accepts a caller-owned
        :class:`~timewarp_tpu_torch.speculate.policy.SpeculationPolicy`
        that PERSISTS across calls: this call's chunks then continue the
        policy's committed chain numbering; mutually exclusive with
        ``replay``. ``on_quiesce(b, state)`` fires exactly once per world
        at a COMMITTED boundary, the moment the world has quiesced or
        exhausted its budget — never for a rolled-back chunk. The
        speculation record (mode, windows, rollbacks, violations) lands on
        ``last_run_speculation``, the decision list on
        ``last_run_decisions``, and — fleets — the per-world committed
        chains on ``last_run_decisions_world``."""
        import contextlib

        import torch

        from ..interp.torch_engine.common import stats_merge
        from ..trace.events import SuperstepTrace
        from .plane import SpeculationViolation, hit_scalars
        from .policy import SpeculationPolicy
        if self.speculate == "off":
            raise ValueError(
                "run_speculative needs a speculating engine; build it "
                "with speculate='auto'|'fixed:W' (docs/speculation.md)"
                " — static runs use run()/run_quiet")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        batch = getattr(self, "batch", None)
        nworld = 1 if batch is None else batch.B
        if batch is not None:
            budgets = np.broadcast_to(
                np.asarray(budgets, np.int64), (batch.B,)).copy()
        else:
            budgets = int(budgets)
        if np.min(budgets) < 0:
            raise ValueError("step budgets must be >= 0")
        external = policy is not None
        if external and replay is not None:
            raise ValueError(
                "policy= is a caller-owned persistent decision source "
                "and replay= builds its own — pass exactly one "
                "(docs/speculation.md)")
        if policy is None:
            policy = SpeculationPolicy(
                mode="replay" if replay is not None else self.speculate,
                fixed_w=self._spec_w, chunk=chunk, replay=replay)
        policy.begin(self)
        st = state if state is not None else self.init_state()
        start = st.steps.cpu().numpy().astype(np.int64)
        rows = [[] for _ in range(nworld)]
        chunk_stats, frame_chunks, flight_chunks = [], [], []
        self.last_run_telemetry = None
        self.last_run_flight = None
        self.last_run_speculation = None
        emitted = np.zeros(nworld, bool)
        violations: list = []
        rollbacks = 0
        rerun_worlds = 0
        dec_world = [[] for _ in range(nworld)]
        metrics = getattr(self, "metrics", None)
        # an external (persistent) policy continues its committed chain:
        # this call's chunks number from past the last made decision
        ci = (max(policy.made) + 1) if (external and policy.made) else 0
        first_ci = ci
        while True:
            _, remaining, active = self._controlled_progress(
                st, budgets, start)
            act = np.atleast_1d(np.asarray(active))
            for b in np.nonzero(~act & ~emitted)[0]:
                # a COMMITTED boundary by construction: `st` only ever
                # advances at commit, so a rolled-back chunk can never
                # quiesce a world (the exactly-once contract)
                emitted[int(b)] = True
                if on_quiesce is not None:
                    on_quiesce(int(b), st)
            if not act.any():
                break
            t_now = int(np.min(st.time.cpu().numpy()))
            dec, _fresh = policy.decide(ci, self.last_run_telemetry, t_now)
            dyn = self.dyn_values(dec)
            if batch is not None:
                budget = np.where(active,
                                  np.minimum(remaining, dec.chunk_len), 0)
            else:
                budget = int(min(int(remaining), dec.chunk_len))
            # shield the metrics stream and the flight-event log while the
            # chunk runs: THIS chunk is uncommitted — a violating chunk's
            # lines/events must never reach the sinks (the run_verified
            # discipline, integrity/runner.py)
            self.metrics = None
            fout, self.flight_out = getattr(self, "flight_out", None), None
            # a re-run of a rolled-back chunk is the recovery work — span
            # it so the rollback cost is visible on the timeline
            roll_cm = (metrics.span("spec_rollback_rerun", chunk=ci)
                       if metrics is not None
                       and dec.obs.get("rolled_back")
                       else contextlib.nullcontext())
            hit = None
            try:
                # a fleet defers the raise — the per-world decode decides
                # host-side what to re-run (masked rollback); solo keeps
                # the exception flow (whole-chunk rollback)
                self._spec_defer = batch is not None
                with roll_cm:
                    st2, tr = self.run(budget, state=st, _dyn=dyn)
                hit = self.last_run_spec
            except SpeculationViolation as e:
                hit = e.hit or {}
                st2 = tr = None
            finally:
                self._spec_defer = False
                self.metrics = metrics
                self.flight_out = fout
            if hit is not None:
                rollbacks += 1
                violations.append({
                    "chunk": ci, "window_us": dec.window_us,
                    **{k: v for k, v in hit.items() if isinstance(v, int)}})
                # convergence is structural, not counted: a rollback
                # always replaces the decision with the floor, and a floor
                # violation is terminal here — so a chunk rolls back at
                # most once before committing or raising
                if dec.window_us <= policy.floor:
                    raise SpeculationViolation(
                        f"{self.metrics_label}: chunk {ci} violated "
                        f"causality at the conservative floor "
                        f"{policy.floor} µs — the link model's "
                        "declared min_delay_us is not a true lower "
                        "bound of its samples; fix the model "
                        "(docs/speculation.md)", hit)
                fdec = policy.rollback(ci, hit)
                if metrics is not None:
                    metrics.emit(
                        "speculation", label=self.metrics_label,
                        chunk=ci, window_us=dec.window_us,
                        outcome="rollback", **hit_scalars(hit))
                if batch is None:
                    # the tainted chunk's telemetry must not leak to any
                    # post-run consumer (frames flush per COMMITTED
                    # chunk); the loop re-decides chunk ci — now the floor
                    # decision — and re-runs whole
                    self.last_run_telemetry = None
                    continue
                # -- masked rollback (a fleet): the clean worlds' chunk
                # COMMITS exactly as if no other world existed, and only
                # the violating worlds re-run from their snapshot slices
                # at the floor — the same run, masked budgets
                viol = np.array([h is not None
                                 for h in self.last_run_spec_world])
                rerun_worlds += int(viol.sum())
                stats1 = self.last_run_stats
                tel1 = self.last_run_telemetry
                fl1 = self.last_run_flight
                vmask = torch.as_tensor(viol, device=self.device)
                merged = _merge_worlds(vmask, st, st2)
                bud_f = np.where(viol, budget, 0)
                dyn_f = self.dyn_values(fdec)
                self.metrics = None
                self.flight_out = None
                rerun_cm = (metrics.span("spec_rollback_rerun", chunk=ci,
                                         masked=True)
                            if metrics is not None
                            else contextlib.nullcontext())
                try:
                    self._spec_defer = True
                    with rerun_cm:
                        st3, tr2 = self.run(bud_f, state=merged, _dyn=dyn_f)
                finally:
                    self._spec_defer = False
                    self.metrics = metrics
                    self.flight_out = fout
                if self.last_run_spec is not None:
                    raise SpeculationViolation(
                        f"{self.metrics_label}: chunk {ci} violated "
                        f"causality at the conservative floor "
                        f"{policy.floor} µs — the link model's "
                        "declared min_delay_us is not a true lower "
                        "bound of its samples; fix the model "
                        "(docs/speculation.md)", self.last_run_spec)
                # commit the mixed chunk: clean worlds' rows/frames from
                # the speculative run, violators' from the floor re-run —
                # per world, never interleaved
                st = st3
                chunk_stats.append(stats1)
                chunk_stats.append(self.last_run_stats)
                tel2 = self.last_run_telemetry
                fl2 = self.last_run_flight
                telem = None
                if tel1 is not None and tel2 is not None:
                    telem = [tel2[b] if viol[b] else tel1[b]
                             for b in range(nworld)]
                frame_chunks.append(telem)
                fl = None
                if isinstance(fl1, list) and isinstance(fl2, list):
                    fl = [fl2[b] if viol[b] else fl1[b]
                          for b in range(nworld)]
                flight_chunks.append(fl)
                if metrics is not None and telem is not None:
                    metrics.superstep_chunk(self.metrics_label, telem)
                if fout is not None and fl is not None:
                    for b, one in enumerate(fl):
                        fout.write(one, world=b)
                ran = np.asarray(budget) > 0
                for b in range(nworld):
                    src = tr2[b] if viol[b] else tr[b]
                    rows[b].extend(src.row(i) for i in range(len(src)))
                    if ran[b]:
                        dec_world[b].append(fdec if viol[b] else dec)
                if metrics is not None:
                    metrics.emit(
                        "speculation", label=self.metrics_label,
                        chunk=ci, window_us=dec.window_us,
                        outcome="committed", rerun_worlds=int(viol.sum()))
                ci += 1
                continue
            # commit: the chunk is violation-free — advance the snapshot
            # and flush exactly the lines run() would have
            st = st2
            chunk_stats.append(self.last_run_stats)
            frame_chunks.append(self.last_run_telemetry)
            flight_chunks.append(self.last_run_flight)
            if metrics is not None and self.last_run_telemetry is not None:
                metrics.superstep_chunk(self.metrics_label,
                                        self.last_run_telemetry)
            if fout is not None and self.last_run_flight is not None:
                lg = self.last_run_flight
                if isinstance(lg, list):
                    for b, one in enumerate(lg):
                        fout.write(one, world=b)
                else:
                    fout.write(lg)
            if batch is not None:
                ran = np.asarray(budget) > 0
                for b in range(nworld):
                    rows[b].extend(tr[b].row(i) for i in range(len(tr[b])))
                    if ran[b]:
                        dec_world[b].append(dec)
            else:
                rows[0].extend(tr.row(i) for i in range(len(tr)))
            if metrics is not None:
                metrics.emit("speculation", label=self.metrics_label,
                             chunk=ci, window_us=dec.window_us,
                             outcome="committed")
            ci += 1
        if chunk_stats:
            self.last_run_stats = stats_merge(chunk_stats)
        else:
            # a zero-chunk run must not leave a previous run's stats behind
            self.last_run_stats = {"supersteps": 0, "wall_seconds": 0.0,
                                   "compiles": 0, "chunks": 0,
                                   "per_chunk_compiles": [],
                                   "fleet_supersteps": 0}
        if self.telemetry != "off":
            from ..obs.telemetry import concat_frames
            self.last_run_telemetry = concat_frames(frame_chunks)
        if getattr(self, "record", "off") != "off":
            from ..obs.flight import concat_flight
            self.last_run_flight = concat_flight(flight_chunks)
        decs = policy.decisions
        self.last_run_decisions = decs
        self.last_run_decisions_world = (dec_world if batch is not None
                                         else None)
        self.last_run_speculation = {
            "mode": policy.mode, "floor_us": policy.floor,
            "bound_us": policy.bound, "chunks": ci - first_ci,
            "rollbacks": rollbacks, "rerun_worlds": rerun_worlds,
            "violations": violations,
            "windows": sorted({d.window_us for d in decs}),
        }
        if batch is not None:
            return st, [SuperstepTrace.from_rows(r) for r in rows]
        return st, SuperstepTrace.from_rows(rows[0])

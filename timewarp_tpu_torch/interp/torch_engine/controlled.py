"""The controller-driven chunked driver (the port of
``timewarp_tpu/interp/jax_engine/controlled.py``; dispatch/).

``run_controlled`` is ``run_stream``'s adaptive sibling: the fleet (or
solo run) executes one ``run`` chunk at a time, and between chunks the
bound :class:`~timewarp_tpu_torch.dispatch.DispatchController` reads the
chunk's telemetry (``engine.last_run_telemetry``) and picks the next
chunk's dispatch values.

- On ``TorchEngine`` (``_dyn_ok``), as on the reference's
  ``JaxEngine(insert="xla")``: the chunk's window and chunk length. The
  window reaches the run as a ``DynDispatch`` tensor made once per chunk;
  the superstep clamps it to the engine's bound (a faulted engine keeps
  the undegraded link floor as its bound) and to each world's degraded
  floor of the superstep (``faults.apply.window_floor``), so only the
  supersteps a degradation window overlaps run narrow. K1 and K2 never
  see the window. The port routes at one static width and has no rung
  ladder, so ``rung_pin`` stays -1.
- On ``FusedSparseEngine`` (K3 draws against the window inside the
  kernel) and ``EdgeEngine`` (classic supersteps), as on the reference's
  counterparts: **chunk length only**, the window and rung riding the
  decision trace pinned (``window_us`` the engine's window, ``rung_pin``
  -1).

The replay law (tests/test_torch_dispatch.py): re-running with
``mode="replay"`` over the emitted decision trace is bit-identical on
states, traces and checkpoints, and the trace equals the reference's
counterpart engine's for the same configuration.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ControlledRunMixin"]


class ControlledRunMixin:
    """``controller=`` wiring + the chunk-length-adaptive driver (module
    docstring). Host state only: an engine without a controller runs
    none of it."""

    #: the bound DispatchController (None = static dispatch)
    controller = None
    #: whether the engine threads a dynamic window (TorchEngine); False =
    #: the controller adapts chunk length only
    _dyn_ok = False
    #: the emitted decision list of the last run_controlled call
    last_run_decisions = None

    def _bind_controller(self, controller) -> None:
        """Engine-construction half of the wiring: validate the
        controller against this engine's observability mode — an auto
        controller without telemetry would decide from nothing."""
        if controller is None:
            return
        if not hasattr(controller, "decide") \
                or not hasattr(controller, "begin"):
            raise ValueError(
                f"controller must be a dispatch.DispatchController "
                f"(or duck-type decide/begin), got {controller!r}")
        if getattr(controller, "mode", "auto") == "auto" \
                and self.telemetry == "off":
            raise ValueError(
                "an auto dispatch controller consumes "
                "last_run_telemetry between chunks; build the engine "
                "with telemetry='counters' (or 'full') — replay mode "
                "alone runs with telemetry off (docs/dispatch.md)")
        self.controller = controller

    def dyn_values(self, decision):
        """A decision's dispatch values as tensors on the engine's device
        (a ``DynDispatch``; ``torch.full`` launches a fill, with no copy
        from the host) — None when this engine's window is fixed at
        construction (chunk-length-only adaptation)."""
        if not self._dyn_ok:
            return None
        import torch

        from .common import DynDispatch
        return DynDispatch(
            window=torch.full((), decision.window_us, dtype=torch.int64,
                              device=self.device),
            rung_pin=torch.full((), decision.rung_pin, dtype=torch.int32,
                                device=self.device))

    def _host_worlds(self, x):
        """A per-world tensor (or a solo 0-d one) as the run's host
        value, what the chunked drivers decide on (the world-sharded
        engine gathers every rank's worlds, so its ranks decide alike)."""
        return x.cpu().numpy()

    def _controlled_progress(self, state, budgets, start):
        """(steps_done, remaining, active) — ``fleet_progress``'s law
        generalized to solo states (0-d tensors reduce identically)."""
        steps_done = (self._host_worlds(state.steps).astype(np.int64)
                      - np.asarray(start, np.int64))
        remaining = np.maximum(np.asarray(budgets, np.int64)
                               - steps_done, 0)
        active = self._host_worlds(self.world_active(state)) \
            & (remaining > 0)
        return steps_done, remaining, active

    def run_controlled(self, budgets, state=None):
        """Run to quiescence/budget under the bound controller, deciding
        each chunk's length. Accepts the same budget forms as ``run``
        (int; fleets also a per-world vector) and returns ``(final_state,
        trace)`` — a fleet's per-world trace list — like ``run``; the
        decision trace lands on ``last_run_decisions`` (and streams to an
        attached metrics registry as ``decision`` lines)."""
        from ...obs.flight import concat_flight
        from ...obs.telemetry import concat_frames
        from ...trace.events import SuperstepTrace
        from .common import stats_merge
        ctrl = self.controller
        if ctrl is None:
            raise ValueError(
                "run_controlled needs a dispatch controller; build "
                "the engine with controller=DispatchController(...) "
                "(docs/dispatch.md) — static runs use run()/run_quiet")
        ctrl.begin(self)
        batch = getattr(self, "batch", None)
        if batch is not None:
            budgets = np.broadcast_to(
                np.asarray(budgets, np.int64), (batch.B,)).copy()
        else:
            budgets = int(budgets)
        if np.min(budgets) < 0:
            raise ValueError("step budgets must be >= 0")
        st = state if state is not None else self.init_state()
        start = self._host_worlds(st.steps).astype(np.int64)
        rows = [[] for _ in range(batch.B)] if batch is not None \
            else []
        chunk_stats, frame_chunks, flight_chunks = [], [], []
        self.last_run_telemetry = None
        ci = 0
        while True:
            _, remaining, active = self._controlled_progress(
                st, budgets, start)
            if not np.any(active):
                break
            t_now = int(np.min(self._host_worlds(st.time)))
            dec, fresh = ctrl.decide(ci, self.last_run_telemetry, t_now)
            if self._dyn_ok and dec.window_us > self.window:
                from ...dispatch.trace import DispatchTraceError
                raise DispatchTraceError(
                    f"chunk {ci} decision requests window "
                    f"{dec.window_us} µs beyond the engine bound "
                    f"{self.window} µs")
            if fresh and self.metrics is not None:
                self.metrics.emit("decision", label=self.metrics_label,
                                  chunk=dec.chunk,
                                  window_us=dec.window_us,
                                  rung_pin=dec.rung_pin,
                                  chunk_len=dec.chunk_len)
            dyn = self.dyn_values(dec)
            kw = {} if dyn is None else {"_dyn": dyn}
            if batch is not None:
                vec = np.where(active,
                               np.minimum(remaining, dec.chunk_len), 0)
                st, traces = self.run(vec, state=st, **kw)
                for b in range(batch.B):
                    rows[b].extend(traces[b].row(i)
                                   for i in range(len(traces[b])))
            else:
                step_n = int(min(int(remaining), dec.chunk_len))
                st, tr = self.run(step_n, state=st, **kw)
                rows.extend(tr.row(i) for i in range(len(tr)))
            chunk_stats.append(self.last_run_stats)
            frame_chunks.append(self.last_run_telemetry)
            flight_chunks.append(self.last_run_flight)
            ci += 1
        if chunk_stats:
            self.last_run_stats = stats_merge(chunk_stats)
        if self.telemetry != "off":
            # post-run consumers must see the WHOLE run's telemetry, not
            # the final chunk's
            self.last_run_telemetry = concat_frames(frame_chunks)
        if self.record != "off":
            self.last_run_flight = concat_flight(flight_chunks)
        self.last_run_decisions = ctrl.decisions
        if batch is not None:
            return st, [SuperstepTrace.from_rows(r) for r in rows]
        return st, SuperstepTrace.from_rows(rows)

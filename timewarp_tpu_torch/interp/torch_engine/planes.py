"""The run-mode planes on the torch engines: telemetry, integrity, the
flight recorder, controlled runs and speculation's causality plane (the
engine wiring of ``obs/``, ``integrity/``, ``dispatch/`` and
``speculate/``; the reference's ``JaxEngine`` mixins).

Each plane keeps the reference's contract in torch form:

- **off is free** — with every plane off, an engine's superstep runs the
  same launches as without this module and enters none of its code
  (``_planes_on`` is decided at construction);
- **on is exact** — plane rows are derived only from values the
  superstep already computed, so states, trace rows and counters equal
  the plane-off run's bit for bit;
- **one host sync per superstep** — plane rows stay on the device, one
  small tensor per plane and superstep (telemetry ``[B, F]``, guard
  ``[B, 5]``, the flight recorder's ``[B, R]`` columns, the causality
  plane's ``[B, 3]``), and come to the
  host once per ``run`` call, stacked, where the plane modules decode
  them exactly as the reference decodes its scan outputs.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ...core.scenario import NEVER
from ...integrity.runner import VerifiedRunMixin
from ...obs.flight import FlightRecorderMixin
from ...ops.numeric import I32MAX
from ...speculate.runner import SpeculativeRunMixin
from .controlled import ControlledRunMixin

__all__ = ["PlaneRows", "PlanesMixin"]


class PlaneRows(NamedTuple):
    """One superstep's plane rows (each None when its plane is off)."""
    telem: Any = None    # int64[B, 5 or 7] — TelemetryRow's fields
    integ: Any = None    # int32[B, 5] — IntegrityRow's fields
    rec: Any = None      # RecordRow of [B] / [B, R] tensors
    spec: Any = None     # int64[B, 3] — SpecRow's violations, horizon,
    #                    # straggler (only while speculating)


#: the reference's dtype of each TelemetryRow field
_TELEM_DTYPES = {"active_senders": np.int32, "rung": np.int32,
                 "route_drop": np.int32, "fault_dropped": np.int32,
                 "qslack_us": np.int64, "mb_fill": np.int32,
                 "mb_peak": np.int32}


class PlanesMixin(ControlledRunMixin, VerifiedRunMixin,
                  FlightRecorderMixin, SpeculativeRunMixin):
    """The planes' construction knobs, per-superstep row builders and
    host-side capture, shared by ``TorchEngine`` (and through it
    ``FusedSparseEngine``) and ``EdgeEngine``; only ``TorchEngine``
    speculates."""

    telemetry = "off"
    #: attachable obs.metrics.MetricsRegistry: every traced run flushes
    #: one aggregated ``supersteps`` line (per world for a fleet)
    metrics = None
    metrics_label = None
    last_run_telemetry = None
    #: whether any per-superstep plane is on (decided at construction)
    _planes_on = False
    #: the telemetry ``rung`` column: -1 (no rung) unless the engine
    #: routes at a static batch width
    _t_rung = -1

    def _bind_planes(self, telemetry: str, verify: str, record: str,
                     record_cap: Optional[int]) -> None:
        from ...obs import telemetry as _tel
        name = type(self).__name__
        self.telemetry = _tel.validate_mode(telemetry, name)
        self._bind_verify(verify)
        self._bind_record(record, record_cap)
        self.metrics = None
        self.metrics_label = name
        self.last_run_telemetry = None
        self._planes_on = (self.telemetry, self.verify, self.record) \
            != ("off", "off", "off")

    # -- per-superstep rows (device) -----------------------------------------

    def _telemetry_row(self, senders, route_drop, fault_dropped, wake,
                       rel, t) -> torch.Tensor:
        """The counter plane of one superstep, ``[B, F]`` int64: active
        senders, rung, route/fault drops, the quiescence slack from the
        post-step ``wake`` ``[B, N]`` and post-insertion ``rel`` ``[B, ...,
        N]`` (relative to the new epoch ``t`` ``[B]``), and in ``"full"``
        mode the mailbox fill and per-node peak."""
        B = wake.shape[0]
        comm = self.comm
        rel2 = rel.reshape(B, -1)
        mmin = rel2.amin(dim=1)
        nxt = comm.all_min(torch.minimum(
            wake.amin(dim=1), torch.where(mmin == I32MAX, NEVER,
                                          t + mmin.long())))
        cols = [senders.long(), torch.full_like(t, self._t_rung),
                route_drop.long(), fault_dropped.long(),
                torch.where(nxt >= NEVER, -1, nxt - t)]
        if self.telemetry == "full":
            # the mailbox occupancy plane: one extra pass over it
            fill = (rel < I32MAX).reshape(B, -1, rel.shape[-1]).sum(
                dim=1, dtype=torch.int64)                          # [B, N]
            cols += [comm.all_sum(fill.sum(dim=1)),
                     comm.all_max(fill.amax(dim=1))]
        return torch.stack(cols, dim=1)

    # -- host-side capture ----------------------------------------------------

    def _capture_planes(self, planes, valid, t_us, steps_before) -> None:
        """Decode one traced run's plane rows (a list of
        :class:`PlaneRows`, one per loop iteration; ``valid`` and ``t_us``
        ``[T, B]`` numpy) onto ``last_run_telemetry`` / ``last_run_flight``,
        raise the guard's first violation, then decode the causality
        plane — the reference's capture order. Each field's rows cross to
        the host in one stacked copy."""
        from ...integrity.checks import IntegrityRow
        from ...obs import telemetry as _tel
        from ...obs.flight import RecordRow
        solo = self.batch is None
        B = None if solo else self.batch.B
        lead = () if solo else (B,)

        def host(xs, tail, dtype):
            """``[T, (B,) *tail]`` numpy from one tensor per iteration."""
            if not xs:
                return np.zeros((0,) + lead + tail, dtype)
            a = torch.stack(xs).cpu().numpy()
            return a[:, 0] if solo else a
        v = valid[:, 0] if solo else valid
        tt = t_us[:, 0] if solo else t_us
        self.last_run_telemetry = None
        if self.telemetry != "off":
            fields = [f for f in _tel.FIELDS
                      if self.telemetry == "full"
                      or f not in ("mb_fill", "mb_peak")]
            cols = host([p.telem for p in planes], (len(fields),), np.int64)
            row = _tel.TelemetryRow(**{
                f: cols[..., i].astype(_TELEM_DTYPES[f])
                for i, f in enumerate(fields)})
            self.last_run_telemetry = _tel.decode_frames(row, v, tt, B)
            if self.metrics is not None:
                self.metrics.superstep_chunk(self.metrics_label,
                                             self.last_run_telemetry)
        if self.record != "off":
            slim = self.record == "deliveries"

            def field(name, dtype, tail=(self.record_cap,)):
                return None if slim and name in ("kind", "send_t", "tag") \
                    else host([getattr(p.rec, name) for p in planes], tail,
                              dtype)
            rec = RecordRow(
                n_ev=field("n_ev", np.int32, ()),
                kind=field("kind", np.int32), src=field("src", np.int32),
                dst=field("dst", np.int32), send_t=field("send_t", np.int64),
                t=field("t", np.int64), tag=field("tag", np.int32))
            self._capture_flight(rec, v, tt, steps_before[0] if solo
                                 else steps_before)
        if self.verify != "off":
            g = host([p.integ for p in planes], (5,), np.int32)
            self._capture_integrity(
                IntegrityRow(*(g[..., i] for i in range(5))), v, tt)
        if self.speculate != "off":
            from ...speculate.plane import SpecRow
            g = host([p.spec for p in planes], (3,), np.int64)
            self._capture_spec(SpecRow(g[..., 0].astype(np.int32),
                                       g[..., 1], g[..., 2]), v, tt)

    # -- the quiet driver's guard ----------------------------------------------

    def _quiet_guard(self, final) -> None:
        """``run_quiet`` under ``verify != "off"``: no per-superstep rows
        exist there, so the guard degrades to the final-state check (of
        the global state on a sharded engine)."""
        if self.verify != "off":
            from ...integrity.checks import final_state_guard
            sh = self._sharding()
            final_state_guard(final, type(self).__name__,
                              None if sh is None else sh.shard_comm)

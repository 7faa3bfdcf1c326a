"""The fused dense-ring engine on PyTorch (port of
``timewarp_tpu/interp/jax_engine/fused_ring.py``): the whole superstep
of the lean token ring — deliver, step, shift-route, insert, rebase — as
one launch of the hand-written kernel K4 (cuda_ring.py).

The state is one stacked ``int32[10, N]`` array (cuda_ring.py), every
time relative to an int64 epoch ``base`` kept outside it, plus the
``delivered``/``overflow``/``steps`` counters. Each superstep the driver
reads the pop-min ``t`` (the loop's one host sync, which is also the
quiescence test), decides ``alive = base + t < end_us`` on the host and
launches K4 from one buffer into the other.

Scope, as the reference's guards: ``FixedDelay`` links, ``cap == 2``, the
lean ring (``max_out 1``, ``payload_width 2``, commutative inbox), a
``meta`` carrying ``think_us`` and ``end_us``, and ``2*think + delay <
I32MAX``. The reference's ``n % 8192`` guard is a TPU block shape and is
lifted: any ``n >= 1``.

The exactness law: :meth:`FusedRingEngine.to_edge_state` of its state
equals :class:`EdgeEngine`'s state bit for bit after the same supersteps,
queue payloads and stale slots included (tests/test_torch_fused_ring.py).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

from ...core.scenario import NEVER, Scenario
from ...net.delays import FixedDelay
from ...ops.numeric import I32MAX
from .common import run_stats
from .cuda_ring import (CNT, QK0, QK1, QR0, QR1, QV0, QV1, SEND, VAL, WAKE,
                        fused_ring)
from .edge_engine import EdgeEngine, EdgeState

__all__ = ["FusedRingEngine", "FusedRingState"]


class FusedRingState(NamedTuple):
    """The dense-ring state: the stacked planes and 0-d counters on the
    engine's device. All plane times are µs relative to ``base``;
    ``I32MAX`` = empty slot / no timer."""
    planes: torch.Tensor     # int32[10, N]
    base: torch.Tensor       # int64[]
    delivered: torch.Tensor  # int64[]
    overflow: torch.Tensor   # int32[]
    steps: torch.Tensor      # int64[]


class FusedRingEngine:
    """Single-kernel dense-ring executor: ``run_quiet`` as
    :class:`EdgeEngine`'s, ``to_edge_state`` back for the exactness law.
    ``device`` defaults to the card. Per-superstep telemetry and integrity
    planes need a traced driver this engine does not have: any mode but
    "off" is refused (run :class:`EdgeEngine`, bit-exact to this one)."""

    last_run_stats = None

    def __init__(self, scenario: Scenario, link, *, cap: int = 2,
                 device=None, telemetry: str = "off",
                 verify: str = "off") -> None:
        if telemetry != "off":
            raise ValueError(
                "FusedRingEngine runs the whole superstep as one kernel — "
                "there is no traced driver to thread per-superstep "
                "telemetry planes through; run EdgeEngine (bit-exact to "
                f"this engine) with telemetry={telemetry!r} instead")
        if verify != "off":
            raise ValueError(
                "FusedRingEngine has no chunked driver to verify; run "
                f"EdgeEngine (bit-exact to this engine) with "
                f"verify={verify!r} instead")
        if not isinstance(link, FixedDelay):
            raise ValueError("FusedRingEngine supports FixedDelay links "
                             "(the delay is a kernel scalar)")
        if cap != 2:
            raise ValueError("FusedRingEngine is specialized to cap=2 (two "
                             "queue slots)")
        if scenario.max_out != 1 or scenario.payload_width != 2 \
                or not scenario.commutative_inbox:
            raise ValueError("FusedRingEngine runs the lean dense token "
                             "ring (models/token_ring.py "
                             "with_observer=False)")
        meta = scenario.meta or {}
        if "think_us" not in meta or "end_us" not in meta:
            # never silent: a missing knob must not default — a wrong think
            # time gives a silently different protocol
            raise ValueError("scenario.meta must carry think_us and end_us "
                             "(models/token_ring.py does)")
        self.think = int(meta["think_us"])
        self.end_us = int(meta["end_us"])
        self.drel = max(1, int(link.delay))
        if 2 * self.think + self.drel >= I32MAX:
            # t + think is int32 in the kernel, and a relative t can itself
            # be ~think after a rebase
            raise ValueError("2*think_us + delay must fit int32")
        if self.drel >= I32MAX - 1:
            raise ValueError("delay must fit int32")
        self.scenario, self.link = scenario, link
        self.n = scenario.n_nodes
        self._edge = EdgeEngine(scenario, link, cap=2, device=device)
        self.device = self._edge.device

    # -- state conversion --------------------------------------------------

    def init_state(self) -> FusedRingState:
        return self.from_edge_state(self._edge.init_state())

    @staticmethod
    def _rel(x64: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
        r = torch.where(x64 >= NEVER, I32MAX, x64 - base)
        return torch.clamp(r, max=I32MAX).to(torch.int32)

    def from_edge_state(self, st: EdgeState) -> FusedRingState:
        base = st.time
        # never silent: a finite time beyond base + 2^31 - 2 µs has no
        # int32-relative form — refuse rather than clamp a real event to
        # the no-timer sentinel
        horizon = base + (I32MAX - 1)
        for x in (st.wake, st.states["send_at"]):
            if bool(((x < NEVER) & (x > horizon)).any()):
                raise ValueError(
                    "a wake/send_at time exceeds the int32-relative horizon "
                    "(~35 min of virtual time past the state's epoch); run "
                    "EdgeEngine instead")
        q_rel, q_pay = st.q_rel[0], st.q_pay[0]
        planes = torch.stack([
            q_rel[0], q_rel[1], q_pay[0, 0], q_pay[1, 0], q_pay[0, 1],
            q_pay[1, 1], self._rel(st.wake, base), st.states["cnt"],
            st.states["val"], self._rel(st.states["send_at"], base)])
        return FusedRingState(planes=planes, base=base,
                              delivered=st.delivered, overflow=st.overflow,
                              steps=st.steps)

    def to_edge_state(self, fs: FusedRingState) -> EdgeState:
        """Back to the edge engine's layout: the exactness law's
        comparison surface."""
        p = fs.planes

        def abs64(plane):
            r = plane.long()
            return torch.where(r >= I32MAX, NEVER, fs.base + r)

        def scalar(dtype):
            return torch.zeros((), dtype=dtype, device=p.device)
        return EdgeState(
            states={"cnt": p[CNT].clone(), "val": p[VAL].clone(),
                    "send_at": abs64(p[SEND])},
            wake=abs64(p[WAKE]),
            q_rel=torch.stack([p[QR0], p[QR1]])[None],
            # commutative inbox: q_step has width 0
            q_step=torch.zeros((1, 0, self.n), dtype=torch.int32,
                               device=p.device),
            q_pay=torch.stack([torch.stack([p[QV0], p[QK0]]),
                               torch.stack([p[QV1], p[QK1]])])[None],
            overflow=fs.overflow, unrouted=scalar(torch.int32),
            misrouted=scalar(torch.int32), bad_delay=scalar(torch.int32),
            delivered=fs.delivered, steps=fs.steps, time=fs.base,
            fault_dropped=scalar(torch.int32),
            restart_done=torch.zeros((0,), dtype=torch.bool,
                                     device=p.device))

    # -- supersteps --------------------------------------------------------

    @staticmethod
    def _pop_min(planes: torch.Tensor) -> torch.Tensor:
        """The epoch-relative next event (>= I32MAX: quiesced), an int32
        0-d tensor."""
        return torch.minimum(planes[QR0:QR1 + 1].amin(), planes[WAKE].amin())

    def _next_event(self, fs: FusedRingState) -> torch.Tensor:
        """The next event time (NEVER = quiesced), an int64 0-d tensor."""
        m = self._pop_min(fs.planes)
        return torch.where(m >= I32MAX, NEVER, fs.base + m.long())

    def _superstep(self, fs: FusedRingState) -> Optional[FusedRingState]:
        """One superstep, or None once quiesced."""
        final, taken = self._run(fs, 1)
        return final if taken else None

    def _run(self, fs: FusedRingState, max_steps: int):
        """Up to ``max_steps`` supersteps from ``fs``: ``(state, taken)``.
        K4 writes into two buffers of the run's own in turn, never into
        ``fs.planes``, so the caller's state stays intact."""
        base = int(fs.base)
        planes = fs.planes
        bufs = [torch.empty_like(planes), None]
        acc = torch.zeros(2, dtype=torch.int64, device=planes.device)
        taken = 0
        for _ in range(max_steps):
            t = int(self._pop_min(planes))   # the superstep's host sync
            if t >= I32MAX:
                break
            if taken == 1:
                bufs[1] = torch.empty_like(planes)
            planes, _ = fused_ring(planes, t, base + t < self.end_us,
                                   self.think, self.drel,
                                   out=bufs[taken % 2], acc=acc)
            base += t
            taken += 1
        if taken == 0:
            return fs, 0
        return FusedRingState(
            planes=planes,
            base=torch.tensor(base, dtype=torch.int64, device=planes.device),
            delivered=fs.delivered + acc[0],
            overflow=fs.overflow + acc[1].to(torch.int32),
            steps=fs.steps + taken), taken

    def run_quiet(self, max_steps: int,
                  state: Optional[FusedRingState] = None) -> FusedRingState:
        """Up to ``max_steps`` supersteps, stopping at quiescence."""
        fs = self.init_state() if state is None else state
        steps0 = int(fs.steps)
        t0 = time.perf_counter()
        final = self._run(fs, max_steps)[0]
        # int() waits for the device, so the wall time covers the work
        self.last_run_stats = run_stats(t0, steps0, int(final.steps))
        return final

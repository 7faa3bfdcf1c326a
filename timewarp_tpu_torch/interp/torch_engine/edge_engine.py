"""The edge engine on PyTorch (port of
``timewarp_tpu/interp/jax_engine/edge_engine.py``): batched execution
for static topologies, with no sort on the routing path and no scatter.

When every outbox slot always targets the same destination
(``Scenario.static_dst``), routing needs no batch:

- the graph is inverted on the host into per-node in-edge tables
  (:class:`EdgeTopology`);
- per-edge bounded queues hold in-flight messages in ``[E, C, N]``
  layout (node axis minor), deliver times int32 relative to the epoch
  (``I32MAX`` = empty slot);
- delivery moves each sender's outbox slot to its receiver's edge queue
  by a static index map: ``torch.roll`` for pure-shift edges (the ring:
  ``dst = (i + 1) mod N``), a gather through ``in_flat`` otherwise;
- insertion fills the first free slot of the capacity axis ``C``, one
  elementwise pass per edge.

Capacity is per edge (``cap`` messages in flight per (src, slot) → dst
edge), not the general engine's per-node ``mailbox_cap``; overflow is
counted and dropped, never silent (and a run that overflows warns, as
the reference does). Ordered inboxes are sorted by ``(deliver time,
insert step, src, slot)``; commutative ones are presented unsorted.

The trace and every state leaf equal the reference's bit for bit
(tests/test_torch_edge_engine.py). Every superstep is classic W=1: all
nodes due at the global minimum fire at that instant. ``faults=`` takes
one ``FaultSchedule`` (the edge engine runs one world, as the
reference's): crashes defer and reboot, partitions cut and down windows
drop at each edge's send, degradation windows stretch the delay — the
general engine's masks (faults/apply.py), held against the JAX
``EdgeEngine`` in tests/test_torch_faults.py. The run-mode planes are
the reference's (planes.py): ``telemetry`` (its own row: no rung, -1, and
``route_drop`` 0 — per-edge losses are ``overflow``), ``verify`` with
``run_verified``, ``record``/``record_cap`` (deliveries node-major over
the ``[E, C]`` queue axes, then defer, restart, purge, and each edge's
cuts and sends) and ``controller`` (chunk length only; window 1, rung -1
pinned).
"""

from __future__ import annotations

import time
import warnings
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...core.rng import fire_bits, msg_bits, seed_words
from ...core.scenario import NEVER, Inbox, Scenario
from ...faults.apply import (consume_restarts, cut_mask, defer_next,
                             degrade, device_tables, down_mask,
                             restart_fire, skewed_step)
from ...faults.schedule import FaultSchedule
from ...net.delays import LinkModel
from ...ops.numeric import I32MAX, thi, tlo, u32sum
from ...trace.events import SuperstepTrace
from ...obs.flight import TAG_DEFER, TAG_PURGE, TAG_RESTART
from ...trace.hashing import FIRED, RECV, SENT, mix32
from . import traced_ops
from .common import (LocalComm, init_states_wake,
                     run_stats)
from .engine import _sort_rows, resolve_device
from .planes import PlaneRows, PlanesMixin

__all__ = ["EdgeEngine", "EdgeState", "EdgeTopology"]


class EdgeTopology(NamedTuple):
    """Host-side inversion of ``Scenario.static_dst`` (int32 ``[N, M]``,
    -1 = unused slot) into receiver-centric in-edge tables, numpy
    throughout (the reference's own, field for field).

    Edge order per node is arbitrary: the inbox order owed by ordered
    scenarios comes from explicit sort keys, never from the edge index."""
    n_edges: int               # E = max in-degree
    in_valid: np.ndarray       # bool [E, N] — edge exists
    in_src: np.ndarray         # int32 [E, N] — sender (0 where invalid)
    in_slot: np.ndarray        # int32 [E, N] — sender's outbox slot
    in_flat: np.ndarray        # int32 [E, N] — slot*N + src, for 1D gather
    shift: List[Optional[Tuple[int, int]]]  # per edge: (roll, slot) or None

    @staticmethod
    def build(static_dst: np.ndarray, n: int) -> "EdgeTopology":
        sd = np.asarray(static_dst, np.int32)
        if sd.shape[0] != n:
            raise ValueError(f"static_dst rows {sd.shape[0]} != n_nodes {n}")
        if n * sd.shape[1] >= 2**31:
            raise ValueError(
                "n_nodes * max_out must fit int32 (in_flat gather index)")
        used = sd >= 0
        if np.any(sd[used] >= n):
            raise ValueError("static_dst contains out-of-range destination")
        M = sd.shape[1]
        # slot-major fast path: when every declared outbox column is a
        # uniform ring shift, each column is one shift edge
        ids64 = np.arange(n, dtype=np.int64)
        col_shift: List[Optional[int]] = []
        for k in range(M):
            col = sd[:, k]
            if (col < 0).all():
                col_shift.append(-1)        # unused column: skip
            elif (col >= 0).all():
                d = (col.astype(np.int64) - ids64) % n
                col_shift.append(int(d[0]) if (d == d[0]).all() else None)
            else:
                col_shift.append(None)      # partially declared
        if all(s is not None for s in col_shift) \
                and any(s != -1 for s in col_shift):
            cols = [k for k in range(M) if col_shift[k] != -1]
            E = len(cols)
            in_valid = np.ones((E, n), bool)
            in_src = np.stack([
                ((ids64 - col_shift[k]) % n).astype(np.int32)
                for k in cols])
            in_slot = np.stack([np.full(n, k, np.int32) for k in cols])
            in_flat = in_slot * np.int32(n) + in_src
            shift = [(int(col_shift[k]), k) for k in cols]
            return EdgeTopology(E, in_valid, in_src, in_slot, in_flat,
                                shift)
        # graph inversion: flatten (src, slot) pairs, order by (dst, src,
        # slot) — sender-major within each receiver
        flat = sd.ravel()
        srcs = np.repeat(np.arange(n, dtype=np.int32), M)
        slots = np.tile(np.arange(M, dtype=np.int32), n)
        mask = flat >= 0
        d, s, sl = flat[mask], srcs[mask], slots[mask]
        if d.size == 0:
            raise ValueError("static_dst declares no edges")
        o = np.lexsort((sl, s, d))
        d, s, sl = d[o], s[o], sl[o]
        starts = np.searchsorted(d, np.arange(n, dtype=np.int32))
        e_idx = np.arange(d.size, dtype=np.int64) - starts[d]
        E = int(e_idx.max()) + 1
        in_valid = np.zeros((E, n), bool)
        in_src = np.zeros((E, n), np.int32)
        in_slot = np.zeros((E, n), np.int32)
        in_valid[e_idx, d] = True
        in_src[e_idx, d] = s
        in_slot[e_idx, d] = sl
        in_flat = in_slot * np.int32(n) + in_src
        # pure-shift detection: edge e is src = (i - s) mod N for all i
        shift: List[Optional[Tuple[int, int]]] = []
        for e in range(E):
            if in_valid[e].all() and (in_slot[e] == in_slot[e, 0]).all():
                d = (ids64 - in_src[e]) % n
                if (d == d[0]).all():
                    shift.append((int(d[0]), int(in_slot[e, 0])))
                    continue
            shift.append(None)
        return EdgeTopology(E, in_valid, in_src, in_slot, in_flat, shift)


class EdgeState(NamedTuple):
    """The complete simulation state — the reference's ``EdgeState`` leaf
    for leaf, same dtypes and ``[E, C, N]`` queue layout (so states carry
    across, state_io.py). Scalars are 0-d tensors on the engine's
    device."""
    states: Any                  # dict of [N, ...] tensors
    wake: torch.Tensor           # int64[N]
    #: int32[E, C, N] deliver time minus ``time``; I32MAX = empty slot
    q_rel: torch.Tensor
    #: int32[E, C, N] insertion superstep (C is 0 for commutative inboxes:
    #: the table only feeds the ordered inbox's sort)
    q_step: torch.Tensor
    q_pay: torch.Tensor          # int32[E, C, P, N]
    overflow: torch.Tensor       # int32[]
    unrouted: torch.Tensor       # int32[] — valid sends on undeclared slots
    misrouted: torch.Tensor      # int32[] — out.dst != static_dst
    bad_delay: torch.Tensor      # int32[] — delays >= 2^31 - 1 µs, clamped
    delivered: torch.Tensor      # int64[]
    steps: torch.Tensor          # int64[]
    time: torch.Tensor           # int64[] — current virtual time == epoch
    fault_dropped: torch.Tensor  # int32[] — cut, down-dropped and purged
    restart_done: torch.Tensor   # bool[C] — reboot rows consumed


class EdgeEngine(PlanesMixin):
    """Batched engine for static-topology scenarios (module docstring):
    ``run`` (traced, one row per superstep) and ``run_quiet``. ``cap`` is
    the per-edge queue capacity; ``device`` defaults to the card. After a
    run, ``last_run_stats`` holds the call's supersteps, wall seconds and
    compiles (0). ``telemetry``, ``verify``, ``record``/``record_cap`` and
    ``controller`` are the run-mode planes (module docstring)."""

    last_run_stats = None
    #: the edge engine carries no world axis
    batch = None
    #: classic supersteps: the controller's pinned window
    window = 1
    _faulted = False
    #: the TW5xx report of ``faults`` (None: no schedule or lint "off")
    fault_lint_report = None

    def __init__(self, scenario: Scenario, link: LinkModel, *,
                 seed: int = 0, cap: int = 2, faults=None,
                 telemetry: str = "off", controller=None,
                 verify: str = "off", record: str = "off",
                 record_cap: Optional[int] = None, lint: str = "warn",
                 device=None) -> None:
        from ...analysis import check_scenario
        name = type(self).__name__
        self._bind_planes(telemetry, verify, record, record_cap)
        self.lint = lint
        self.lint_report = check_scenario(scenario, lint, who=name)
        if scenario.static_dst is None:
            raise ValueError(
                f"scenario {scenario.name!r} declares no static_dst; "
                "use the general TorchEngine")
        self.device = dev = resolve_device(device, name)
        self.scenario, self.link = scenario, link
        self.s0, self.s1 = seed_words(seed)
        self.cap = int(cap)
        n = scenario.n_nodes
        self.topo = topo = EdgeTopology.build(scenario.static_dst, n)
        self.comm = comm = self._make_comm(n, dev)
        self._node_ids = ids = comm.node_ids()

        def tab(a):
            return comm.local_rows(torch.from_numpy(np.ascontiguousarray(a)))
        # per edge: its senders (elementwise for shift edges), their
        # outbox slots and, for gather edges, the static index map; each
        # over this device's nodes
        self._src_rows = torch.stack([
            torch.remainder(ids - sh[0], n).to(torch.int32)
            if sh is not None else tab(topo.in_src[e])
            for e, sh in enumerate(topo.shift)])                  # [E, N]
        self._slot_rows = torch.stack([
            torch.full((comm.n_local,), sh[1], dtype=torch.int32,
                       device=dev)
            if sh is not None else tab(topo.in_slot[e])
            for e, sh in enumerate(topo.shift)])                  # [E, N]
        self._gather = [None if sh is not None else
                        (tab(topo.in_flat[e]).long(), tab(topo.in_valid[e]))
                        for e, sh in enumerate(topo.shift)]
        self._sd = tab(np.asarray(scenario.static_dst, np.int32).T)  # [M, N]
        self._setup_faults(faults)
        self._bind_controller(controller)

    def _make_comm(self, n_global: int, device: torch.device):
        """The node-ownership object: every node on this device (the
        sharded edge engine gives this rank's nodes, sharded.py)."""
        return LocalComm(n_global, device)

    def _setup_faults(self, faults) -> None:
        """Hold one schedule's tensor tables (the edge engine runs one
        world, as the reference's) and the reboot template."""
        self.faults, self._ft = faults, None
        self._faulted = faults is not None
        self._has_skew = self._has_reset = False
        self._n_restarts = 0
        if faults is None:
            return
        if not isinstance(faults, FaultSchedule):
            raise ValueError(
                f"the edge engine runs one world; faults must be a "
                f"FaultSchedule, got {faults!r}")
        from ...analysis import check_faults
        self.fault_lint_report = check_faults(
            faults, self.scenario, self.lint, who=type(self).__name__)
        self._has_skew = faults.has_skew
        self._has_reset = faults.has_reset
        self._n_restarts = faults.n_restarts
        self._ft = device_tables(faults.tables(self.scenario.n_nodes),
                                 self.device)
        if self._has_reset:
            self._reset_states, _ = init_states_wake(self.scenario,
                                                     self.device)

    # -- state -------------------------------------------------------------

    def init_state(self) -> EdgeState:
        sc, dev = self.scenario, self.device
        n, E, C, P = sc.n_nodes, self.topo.n_edges, self.cap, \
            sc.payload_width
        states, wake = init_states_wake(sc, dev)
        # q_step orders same-deliver-time messages for the ordered inbox's
        # sort; a commutative inbox never sorts, so it has width 0
        C_step = 0 if sc.commutative_inbox else C

        def scalar(dtype):
            return torch.zeros((), dtype=dtype, device=dev)
        return EdgeState(
            states=states, wake=wake,
            q_rel=torch.full((E, C, n), I32MAX, dtype=torch.int32,
                             device=dev),
            q_step=torch.zeros((E, C_step, n), dtype=torch.int32, device=dev),
            q_pay=torch.zeros((E, C, P, n), dtype=torch.int32, device=dev),
            overflow=scalar(torch.int32), unrouted=scalar(torch.int32),
            misrouted=scalar(torch.int32), bad_delay=scalar(torch.int32),
            delivered=scalar(torch.int64), steps=scalar(torch.int64),
            time=scalar(torch.int64), fault_dropped=scalar(torch.int32),
            restart_done=torch.zeros((self._n_restarts,), dtype=torch.bool,
                                     device=dev))

    def _next_event(self, st: EdgeState) -> torch.Tensor:
        """The next event time (NEVER = quiesced), an int64 0-d tensor."""
        qmin = st.q_rel.min()
        return torch.minimum(
            st.wake.min(),
            torch.where(qmin < I32MAX, st.time + qmin.long(), NEVER))

    def world_active(self, state) -> torch.Tensor:
        """Liveness: True (a 0-d tensor) while an event is pending — what
        the chunked drivers test between chunks."""
        return self._next_event(state) < NEVER

    # -- one superstep -----------------------------------------------------

    def _inbox(self, st: EdgeState, deliver, base):
        """Step 3: the ``[W, N]`` inbox (W = E·C), sorted by ``(deliver
        time, insert step, src, slot)`` for ordered inboxes."""
        sc = self.scenario
        E, C, P = self.topo.n_edges, self.cap, sc.payload_width
        n = self.comm.n_local
        W = E * C
        iv = deliver.reshape(W, n)
        rel = torch.where(iv, st.q_rel.reshape(W, n), I32MAX)
        isrc = self._src_rows[:, None, :].expand(E, C, n).reshape(W, n)
        ipay = st.q_pay.reshape(W, P, n)
        if not sc.commutative_inbox:
            # the reference's five-key sort (~valid, rel, step, src, slot)
            # as two stable sorts: (step, src·M + slot) packed into one
            # int64, then (~valid, rel). Ties remain only among invalid
            # rows, which are masked below, so stability makes it exact.
            islot = self._slot_rows[:, None, :].expand(E, C, n).reshape(W, n)
            istep = st.q_step.reshape(W, n)
            minor = ((istep.long() + 2**31) << 31) \
                | (isrc.long() * sc.max_out + islot.long())
            o1 = _sort_rows(minor)
            major = ((~iv).long() << 32) | rel.long()
            order = o1.gather(0, _sort_rows(major.gather(0, o1)))
            iv, rel, isrc = (x.gather(0, order) for x in (iv, rel, isrc))
            ipay = ipay.gather(0, order[:, None, :].expand(W, P, n))
        return Inbox(
            valid=iv,
            src=torch.where(iv, isrc, 0) if sc.inbox_src
            else torch.zeros_like(isrc),
            time=torch.where(iv, base + rel.long(), NEVER),
            payload=torch.where(iv[:, None, :], ipay, 0))

    @staticmethod
    def _quiesced(t) -> bool:
        """The run loop's host read of the popped minimum: no event left.
        A fake trace (the sanitizer's, analysis/determinism.py) reads no
        value: its superstep body is traced as a live one."""
        return not traced_ops.is_fake(t) and int(t) >= NEVER

    def _lint_body(self, st: EdgeState):
        """One traced superstep from ``st`` (analysis/determinism.py)."""
        if self.record == "full":
            self._rec_extra = []      # the run loop's per-superstep captures
        try:
            return self._superstep(st, True)
        finally:
            self._rec_extra = None

    def _superstep(self, st: EdgeState, with_trace: bool
                   ) -> Optional[Tuple[EdgeState, Optional[torch.Tensor]]]:
        """One superstep: ``(new_state, trace_row)`` — the row an int64
        ``[8]`` tensor when ``with_trace`` — or None once quiesced (the
        quiet run, as the reference's, before the schedule's deferrals;
        the traced one after them)."""
        sc, topo = self.scenario, self.topo
        E, C, P = topo.n_edges, self.cap, sc.payload_width
        n = self.comm.n_local
        node_ids = self._node_ids
        base = st.time
        q_live = st.q_rel < I32MAX                           # [E, C, N]

        # 1. global next event time (the batched "pop min")
        nnr = st.q_rel.amin(dim=(0, 1))
        node_next = torch.minimum(
            st.wake, torch.where(nnr == I32MAX, NEVER, base + nnr.long()))
        ft = self._ft
        if ft is None:
            t = self.comm.all_min(node_next.min())
            if self._quiesced(t):  # the loop's one host sync per superstep
                return None
        else:
            # crash suppression: events inside a down window slide to its
            # t_up, unconsumed reboots inject their restart firing
            t_raw = node_next.min()
            pre = node_next
            node_next = defer_next(ft, node_ids, node_next, st.restart_done)
            if self._rec_extra is not None:
                self._rec_fault(TAG_DEFER,
                                ((node_next > pre) & (pre < NEVER))[None],
                                node_ids, node_ids, pre, node_next)
            t = node_next.min()
            if self._quiesced(torch.stack([t, t_raw])[0 if with_trace
                                                      else 1]):
                return None
        fire = node_next == t

        # restart bookkeeping: a reboot row whose node fires at its t_up
        # consumes; the node's state resets, its pre-crash queue entries
        # are purged (counted)
        restart_done, purge = st.restart_done, None
        fault_step = torch.zeros((), dtype=torch.int32, device=self.device)
        states_in = st.states
        if ft is not None and self._has_reset:
            now = t.expand(n)
            reset_now, purge_before = restart_fire(ft, fire, now, node_ids,
                                                   st.restart_done)
            restart_done = consume_restarts(ft, fire, now, node_ids,
                                            st.restart_done)
            purge = q_live & ((base + st.q_rel.long())
                              < purge_before[None, None, :])
            fault_step = purge.sum(dtype=torch.int32)
            states_in = {k: torch.where(
                reset_now.view((n,) + (1,) * (v.dim() - 1)),
                self._reset_states[k], v) for k, v in st.states.items()}
            if self._rec_extra is not None:
                # the injected reboot firing, then the purged queue
                # entries (node-major over [E, C])
                self._rec_fault(TAG_RESTART, reset_now[None], node_ids,
                                node_ids, -1, now)
                self._rec_fault(
                    TAG_PURGE, purge.permute(2, 0, 1)[None],
                    self._src_rows[:, None, :].expand(E, C, n)
                    .permute(2, 0, 1) if sc.inbox_src else 0,
                    node_ids.view(n, 1, 1), -1,
                    st.q_rel.permute(2, 0, 1), t_off=base.view(1))

        # 2. deliverable messages: every queued one due at a fired node
        shift32 = torch.clamp(t - base, max=I32MAX - 1).to(torch.int32)
        deliver = q_live & (st.q_rel <= shift32) & fire
        if purge is not None:
            deliver = deliver & ~purge

        # 3-4. inbox, then fire every node at t; mask the non-fired
        inbox = self._inbox(st, deliver, base)
        now = t.expand(n)
        bits = fire_bits(self.s0, self.s1, node_ids, now) \
            if sc.needs_key else None
        step = sc.step
        if ft is not None and self._has_skew:
            step = skewed_step(sc.step, ft.skew)
        new_states, out, new_wake = step(states_in, inbox, now, node_ids,
                                         bits)
        states = {k: torch.where(
            fire.view((n,) + (1,) * (v.dim() - 1)), new_states[k], v)
            for k, v in st.states.items()}
        new_wake = torch.where(new_wake >= NEVER, NEVER,
                               torch.maximum(new_wake, t + 1))  # contract #5
        wake = torch.where(fire, new_wake, st.wake)
        out_valid = out.valid & fire[None, :]                # [M, N]
        senders = out_valid.any(dim=0).sum(dtype=torch.int32) \
            if with_trace and self.telemetry != "off" else None
        out_pay = out.payload.to(torch.int32)                # [M, P, N]
        # never silent: a valid send on an undeclared slot (static_dst -1)
        # has nowhere to go, and one whose dst disagrees with the
        # declaration is routed by the table — both counted
        declared = self._sd >= 0
        unrouted_step = (out_valid & ~declared).sum(dtype=torch.int32)
        misrouted_step = (out_valid & declared & (out.dst != self._sd)
                          ).sum(dtype=torch.int32)

        # 5. rebase surviving queue entries to the new epoch t
        keep = q_live & ~deliver
        if purge is not None:
            keep = keep & ~purge
        q_rel = torch.where(keep, st.q_rel - shift32, I32MAX)

        # 6-7. route and enqueue, one static in-edge at a time
        step32 = st.steps.to(torch.int32)
        cids = torch.arange(C, dtype=torch.int32, device=self.device)[:, None]
        rel_rows, step_rows, pay_rows = [], [], []
        overflow_step = bad_delay_step = sent_count = torch.zeros(
            (), dtype=torch.int32, device=self.device)
        sent_hash = None
        for e, sh in enumerate(topo.shift):
            if sh is not None:
                s, slot = sh
                # the ring's delivery: a roll along the node axis (over
                # the mesh, one boundary slice to the next rank)
                arr_v = self.comm.roll(out_valid[slot], s)
                arr_p = self.comm.roll(out_pay[slot], s)         # [P, N]
                slot_e = slot
            else:
                flat_idx, in_valid = self._gather[e]
                arr_v = out_valid.reshape(-1)[flat_idx] & in_valid
                arr_p = out_pay.transpose(0, 1).reshape(P, -1)[:, flat_idx]
                slot_e = self._slot_rows[e]
            src_e = self._src_rows[e]
            mb = msg_bits(self.s0, self.s1, src_e, node_ids, t, slot_e) \
                if self.link.needs_key else None
            delay, drop = self.link.sample(src_e, node_ids, t, mb)
            ok = arr_v & ~drop
            if ft is not None:
                # the reference's drop order: the partition cut at the
                # send instant, degradation of the sampled delay, the
                # down window at the deliver time
                cutm = ok & cut_mask(ft, src_e, node_ids, t)
                delay = degrade(ft, delay, src_e, node_ids, t)
                downm = (ok & ~cutm) & down_mask(
                    ft, node_ids, t + torch.clamp(delay, min=1))
                fault_step = fault_step + (cutm | downm).sum(
                    dtype=torch.int32)
                if self._rec_extra is not None:
                    # this edge's cuts, then its sends (down-dropped ones
                    # re-tagged)
                    self._rec_cut(cutm[None], src_e, node_ids, t)
                    self._rec_sends((ok & ~cutm)[None], downm[None], src_e,
                                    node_ids, t, t + torch.clamp(delay, min=1))
                ok = ok & ~cutm & ~downm
            elif self._rec_extra is not None:
                self._rec_sends(ok[None], None, src_e, node_ids, t,
                                t + torch.clamp(delay, min=1))
            flight = torch.clamp(delay, min=1)                 # contract #4
            # queue times are int32-relative: a delay >= 2^31 - 1 µs is
            # clamped and counted, never wrapped
            bad_delay_step = bad_delay_step + (
                ok & (flight > I32MAX - 1)).sum(dtype=torch.int32)
            drel = torch.clamp(flight, max=I32MAX - 1).to(torch.int32)
            if with_trace:
                dt_abs = t + flight
                smix = mix32(SENT, src_e, node_ids, tlo(dt_abs), thi(dt_abs),
                             arr_p[0])
                h = u32sum(torch.where(ok, smix, 0))
                sent_hash = h if sent_hash is None else sent_hash + h
                sent_count = sent_count + ok.sum(dtype=torch.int32)
            # first-free-slot insert over the static C axis
            free = q_rel[e] == I32MAX                          # [C, N]
            ff = torch.where(free, cids, C).amin(dim=0)        # [N]
            ins = ok[None, :] & (cids == ff)                   # [C, N]
            rel_rows.append(torch.where(ins, drel, q_rel[e]))
            if not sc.commutative_inbox:
                step_rows.append(torch.where(ins, step32, st.q_step[e]))
            pay_rows.append(torch.where(ins[:, None, :], arr_p[None],
                                        st.q_pay[e]))
            overflow_step = overflow_step + (ok & (ff == C)).sum(
                dtype=torch.int32)

        recv_count = deliver.sum(dtype=torch.int32)
        traced = ()
        if with_trace:
            # 8. trace digests (order-independent): from the pre-sort mask
            fired_hash = u32sum(torch.where(fire, mix32(FIRED, node_ids),
                                            0))
            d_abs = base + torch.where(deliver, st.q_rel, 0).long()
            rsrc = self._src_rows[:, None, :].expand(E, C, n) \
                if sc.inbox_src else torch.zeros(
                    (E, C, n), dtype=torch.int32, device=self.device)
            rmix = mix32(RECV, node_ids.expand(E, C, n), rsrc, tlo(d_abs),
                         thi(d_abs), st.q_pay[:, :, 0, :])
            recv_hash = u32sum(torch.where(deliver, rmix, 0))
            traced = (fire.sum(), fired_hash, recv_hash, sent_count,
                      sent_hash & 0xFFFFFFFF)
        # the step's counters and digests over every device, in one
        # reduction (the identity on one device; digests wrap at 2^32)
        sums = self.comm.all_sum(
            (overflow_step, unrouted_step, misrouted_step, bad_delay_step,
             recv_count, fault_step) + traced
            + (() if senders is None else (senders,)),
            u32=(7, 8, 10) if traced else ())
        (overflow_step, unrouted_step, misrouted_step, bad_delay_step,
         recv_count, fault_step) = sums[:6]
        if senders is not None:
            senders = sums[-1]
        new_st = EdgeState(
            states=states, wake=wake,
            q_rel=torch.stack(rel_rows),
            q_step=st.q_step if sc.commutative_inbox
            else torch.stack(step_rows),
            q_pay=torch.stack(pay_rows),
            overflow=st.overflow + overflow_step,
            unrouted=st.unrouted + unrouted_step,
            misrouted=st.misrouted + misrouted_step,
            bad_delay=st.bad_delay + bad_delay_step,
            delivered=st.delivered + recv_count.long(),
            steps=st.steps + 1,
            time=t,
            fault_dropped=st.fault_dropped + fault_step,
            restart_done=restart_done)
        if not with_trace:
            return new_st, None, None
        planes = None
        if self._planes_on:
            planes = self._plane_rows(st, new_st, deliver, t, base, senders,
                                      fault_step)

        fired_count, fired_hash, recv_hash, sent_count, sent_hash = \
            sums[6:11]
        row = torch.stack([
            t, fired_count.long(), fired_hash, recv_count.long(), recv_hash,
            sent_count.long(), sent_hash, overflow_step.long()])
        return new_st, row, planes

    def _plane_rows(self, st, new_st, deliver, t, base, senders,
                    fault_step) -> PlaneRows:
        """This superstep's plane rows (the reference edge engine's
        ``telem``/``rec``/``integ``), with a world axis of 1."""
        sc = self.scenario
        E, C, n = self.topo.n_edges, self.cap, self.comm.n_local
        one = t.view(1)
        telem = integ = rec = None
        if self.telemetry != "off":
            telem = self._telemetry_row(
                senders.view(1), torch.zeros_like(fault_step).view(1),
                fault_step.view(1), new_st.wake[None], new_st.q_rel[None],
                one)
        if self.record != "off":
            rec = self._record_row(
                deliver.permute(2, 0, 1)[None],
                self._src_rows[:, None, :].expand(E, C, n).permute(2, 0, 1)
                if sc.inbox_src else 0,
                self._node_ids.view(n, 1, 1), st.q_rel.permute(2, 0, 1),
                base.view(1))
        if self.verify != "off":
            from ...integrity.checks import make_guard_row
            m = new_st
            integ = torch.stack(make_guard_row(
                self.comm, one, st.time.view(1),
                tuple(x.view(1) for x in (
                    m.overflow, m.unrouted, m.misrouted, m.bad_delay,
                    m.fault_dropped, m.delivered, m.steps, m.time)),
                m.wake[None], NEVER, (m.q_rel[None],),
                st.restart_done[None], m.restart_done[None],
                self._faulted), dim=1)
        return PlaneRows(telem, integ, rec)

    # -- run loops ---------------------------------------------------------

    def _warn_on_overflow(self, final: EdgeState) -> None:
        """Per-edge capacity (``cap``) is not the per-node ``mailbox_cap``
        of the general engine and the oracle: once anything overflows,
        which message is dropped legitimately differs, so such a run is
        not trace-comparable to them — said out loud, not silently."""
        ovf = int(final.overflow)
        if ovf > 0:
            warnings.warn(
                f"edge engine counted {ovf} overflowed messages; per-edge "
                "capacity semantics diverge from the per-node-capacity "
                "oracle under overflow — raise cap=, or use the general "
                "TorchEngine for overflow-exact parity",
                RuntimeWarning, stacklevel=3)

    def run(self, max_steps: int, state: Optional[EdgeState] = None
            ) -> Tuple[EdgeState, SuperstepTrace]:
        """Execute up to ``max_steps`` supersteps (stopping early once
        quiesced); returns the final state and the trace of the
        supersteps that fired (and captures the planes' rows)."""
        st = self.init_state() if state is None else state
        steps0 = int(st.steps)
        t0 = time.perf_counter()
        rows, planes = [], []
        rec_full = self._planes_on and self.record == "full"
        try:
            for _ in range(max_steps):
                if rec_full:
                    self._rec_extra = []
                res = self._superstep(st, True)
                if res is None:
                    break
                st, row, pl = res
                rows.append(row)
                if pl is not None:
                    planes.append(pl)
        finally:
            self._rec_extra = None
        cols = torch.stack(rows).cpu().numpy().T if rows \
            else np.zeros((8, 0), np.int64)
        self.last_run_stats = run_stats(t0, steps0, int(st.steps))
        if self._planes_on:
            self._capture_planes(planes, np.ones((len(rows), 1), bool),
                                 cols[0][:, None], np.asarray([steps0]))
        self._warn_on_overflow(st)
        return st, SuperstepTrace.from_columns(cols)

    def run_quiet(self, max_steps: int,
                  state: Optional[EdgeState] = None) -> EdgeState:
        """Traceless run: no digest work and no plane rows (under
        ``verify != "off"`` the final state is guarded). Stops at
        quiescence or after ``max_steps`` supersteps."""
        st = self.init_state() if state is None else state
        steps0 = int(st.steps)
        t0 = time.perf_counter()
        for _ in range(max_steps):
            res = self._superstep(st, False)
            if res is None:
                break
            st = res[0]
        # int() waits for the device, so the wall time covers the work
        self.last_run_stats = run_stats(t0, steps0, int(st.steps))
        self._quiet_guard(st)
        return st

"""Host reference executor for state-machine scenarios — the oracle (port
of ``timewarp_tpu/interp/ref/superstep.py``).

Runs a :class:`~timewarp_tpu_torch.core.scenario.Scenario` sequentially,
implementing the shared superstep semantics (core/scenario.py) with
plain Python data structures: per-node mailbox *lists*, a Python
min-scan for the clock, Python loops for routing and overflow. The
engines (interp/torch_engine) must reproduce this executor's trace bit
for bit.

The scenario's batched ``step`` and the link's ``sample`` are the *same*
functions the engines call — evaluated here once per superstep over the
firing nodes only (their states gathered, their results scattered back;
the step is elementwise over the node axis, so the subset cannot change
a value), on ``device`` (the card unless the caller passes
``device="cpu"``). Every *scheduling* decision — who fires, what each
inbox holds, message order, capacity, fault cuts and drops — is made by
independent host code, which is what makes this an oracle rather than a
second copy of the engine. One step call and one host copy of its
outputs a superstep keep it fast enough for thousand-node runs.
"""

from __future__ import annotations

import time as _time
from typing import List, Optional

import numpy as np
import torch

from ...core.rng import fire_bits, seed_words
from ...core.scenario import NEVER, Inbox, Scenario
from ...core.time import Microsecond
from ...net.delays import LinkModel
from ...ops.numeric import I32MAX, MASK32
from ...trace.events import SuperstepTrace
from ...trace.hashing import FIRED, RECV, SENT, mix32
from ..torch_engine.common import init_states_wake

__all__ = ["SuperstepOracle"]


def _combine(hashes) -> int:
    """Order-independent combination: wrapping uint32 sum."""
    return sum(hashes) & MASK32


class SuperstepOracle:
    """Sequential host executor; oracle for trace parity.

    ``window`` mirrors the engines' multi-instant windowed supersteps:
    one superstep fires every node with an event in ``[t, t+window)``,
    each at its own instant, routing in chronological ``(instant,
    sender, slot)`` order. Exact when link delays are ≥ window (validated
    here too; dynamic violations counted in ``short_delay_total``).
    ``faults`` is one ``FaultSchedule``; ``lint`` the engines' knob.
    ``device`` defaults to the card.
    """

    #: the uniform driver-accounting surface (populated by run())
    last_run_stats = None

    def __init__(self, scenario: Scenario, link: LinkModel, *,
                 seed: int = 0, record_events: bool = False,
                 window=1, lint: str = "warn", faults=None,
                 device=None) -> None:
        # static scenario sanitizer — same knob contract as the engines;
        # the oracle is the referee, so catching a contract violation
        # here names it before a digest mismatch would
        from ...analysis import check_scenario
        from ..torch_engine.engine import resolve_device
        self.lint = lint
        self.lint_report = check_scenario(scenario, lint,
                                          who=type(self).__name__)
        link_floor = link.min_delay_us
        self._setup_faults(faults, scenario, lint)
        if self._faulted:
            # shrink-degradation windows lower the exact-window floor
            link_floor = self.faults.min_delay_floor(link_floor)
        if isinstance(window, str) and window != "auto":
            raise ValueError(
                f"window must be an int µs count or the string "
                f"'auto', got {window!r}")
        if window == "auto":    # the engines' resolution, int32-clamped
            window = max(1, min(int(link_floor), I32MAX - 1))
        if window < 1:
            raise ValueError(f"window must be >= 1 µs, got {window}")
        if window > 1 and window > link_floor:
            raise ValueError(
                f"window={window} µs exceeds the link model's declared "
                f"min_delay_us={link_floor}"
                f"{' (degradation-adjusted)' if self._faulted else ''}")
        self.device = dev = resolve_device(device, type(self).__name__)
        self.scenario = scenario
        self.link = link
        self.window = int(window)
        self.s0, self.s1 = seed_words(seed)
        #: optional per-event debug log: ("fire", t, node) / ("recv", t,
        #: node, src, deliver_t, pay0) / ("sent", t, src, dst,
        #: deliver_t, pay0) in execution order
        self.events: Optional[List[tuple]] = [] if record_events else None
        states, wake = init_states_wake(scenario, dev)
        #: the nodes' states, ``[N, ...]`` tensors on the device
        self.states = {k: v.clone() for k, v in states.items()}
        self.wake: List[int] = [int(w) for w in wake.cpu().tolist()]
        #: per-node arrival-ordered pending (deliver_time, src, payload)
        self.mailbox: List[List[tuple]] = [[] for _ in
                                           range(scenario.n_nodes)]
        self.overflow_total = 0
        self.bad_dst_total = 0
        self.short_delay_total = 0
        #: messages the fault schedule killed (cuts + down-window
        #: deliveries + reset purges) — the engines' ``fault_dropped``
        self.fault_dropped_total = 0
        self.time: Microsecond = 0
        if self._faulted and self.faults.has_reset:
            self._reset_states = {k: v.clone() for k, v in states.items()}
        self._ft_dev = None
        if self._faulted:
            from ...faults.apply import device_tables
            self._ft_dev = device_tables(self._ft, dev)

    # -- faults (host-side mirror of faults/apply.py) -------------------

    def _setup_faults(self, faults, scenario, lint) -> None:
        """Validate ``faults`` and precompute the plain-Python crash and
        partition row lists the run loop's *independent* scheduling
        decisions use (the oracle shares only the value functions —
        step, sample, degrade, skew — with the engines)."""
        self.faults = faults
        self._faulted = faults is not None
        self._ft = None
        self.fault_lint_report = None
        if faults is None:
            return
        from ...faults.schedule import FaultFleet, FaultSchedule
        if isinstance(faults, FaultFleet):
            raise ValueError(
                "the oracle runs one world; pass one FaultSchedule "
                "(fleet.world_schedule(b) for a batched world's twin)")
        if not isinstance(faults, FaultSchedule):
            raise ValueError(
                f"faults must be a FaultSchedule, got {faults!r}")
        from ...analysis import check_faults
        self.fault_lint_report = check_faults(faults, scenario, lint,
                                              who=type(self).__name__)
        self._ft = ft = faults.tables(scenario.n_nodes)
        #: (node, down, up, reset, row) for ACTIVE crash rows
        self._crash_rows = [
            (int(ft.crash_node[c]), int(ft.crash_down[c]),
             int(ft.crash_up[c]), bool(ft.crash_reset[c]), c)
            for c in range(ft.crash_node.shape[0])
            if ft.crash_up[c] > ft.crash_down[c]]
        self._restart_done = [False] * ft.crash_node.shape[0]
        self._parts = [
            (ft.part_group[p], int(ft.part_start[p]), int(ft.part_end[p]))
            for p in range(ft.part_group.shape[0])
            if ft.part_end[p] > ft.part_start[p]]

    def _fault_next(self, i: int, x: int) -> int:
        """Crash-adjusted next-event time for node ``i`` (engine twin:
        ``defer_next``): defer an in-window event to its t_up, then min
        in any unconsumed restart injection."""
        ups = [u for (k, d, u, _r, _c) in self._crash_rows
               if k == i and d <= x < u]
        if ups:
            x = max(ups)
        inj = min((u for (k, _d, u, r, c) in self._crash_rows
                   if k == i and r and not self._restart_done[c]),
                  default=NEVER)
        return min(x, inj)

    def _cut(self, src: int, dst: int, t: int) -> bool:
        """Does a (src -> dst) message sent at ``t`` cross a live
        partition cut?"""
        for group, start, end in self._parts:
            if start <= t < end:
                gs, gd = int(group[src]), int(group[dst])
                if gs >= 0 and gd >= 0 and gs != gd:
                    return True
        return False

    def _down(self, node: int, t: int) -> bool:
        """Is ``node`` inside a crash window at time ``t``?"""
        return any(k == node and d <= t < u
                   for (k, d, u, _r, _c) in self._crash_rows)

    def _restart(self, i: int, ti: int) -> None:
        """Consume restart rows for node ``i`` firing at ``ti``; on a
        reset restart, reboot the state from the pristine template and
        purge mailbox entries older than the crash (memory loss, counted
        in ``fault_dropped_total``)."""
        purge_before, rebooted = 0, False
        for (k, d, u, r, c) in self._crash_rows:
            if r and not self._restart_done[c] and k == i and ti == u:
                self._restart_done[c] = True
                rebooted = True
                purge_before = max(purge_before, d)
        if rebooted:
            for k, v in self.states.items():
                v[i] = self._reset_states[k][i]
            kept = [m for m in self.mailbox[i] if m[0] >= purge_before]
            self.fault_dropped_total += len(self.mailbox[i]) - len(kept)
            self.mailbox[i] = kept

    # ------------------------------------------------------------------

    def _node_next(self, i: int) -> int:
        m = min((mm[0] for mm in self.mailbox[i]), default=NEVER)
        nxt = min(self.wake[i], m)
        if self._faulted:
            nxt = self._fault_next(i, nxt)
        return nxt

    def _step(self, fired: List[int], inbox: Inbox, now: np.ndarray):
        """The scenario's step over the firing nodes (gathered states,
        the engines' entropy and clock skew), its outputs on the host."""
        sc, dev = self.scenario, self.device
        ids = torch.as_tensor(fired, dtype=torch.int32, device=dev)
        idx = ids.long()
        now_t = torch.as_tensor(now, device=dev)
        stepf = sc.step
        if self._faulted and self.faults.has_skew:
            from ...faults.apply import skewed_step
            stepf = skewed_step(sc.step, self._ft_dev.skew)
        bits = fire_bits(self.s0, self.s1, ids, now_t) \
            if sc.needs_key else None
        ib = Inbox(*(torch.as_tensor(x, device=dev) for x in inbox))
        new_states, out, new_wake = stepf(
            {k: v[idx] for k, v in self.states.items()}, ib, now_t, ids,
            bits)
        for k, v in self.states.items():
            v[idx] = new_states[k].to(v.dtype)
        return (out.valid.cpu().numpy(),
                out.dst.to(torch.int32).cpu().numpy(),
                out.payload.to(torch.int32).cpu().numpy(),
                new_wake.cpu().numpy())

    def _sample(self, fired: List[int], out_dst: np.ndarray,
                now: np.ndarray):
        """The link's draw (degraded under the schedule) for every outbox
        slot of the firing nodes: ``(delay, drop)`` numpy ``[M, F]``."""
        from ..torch_engine.cuda_insert import link_sample
        dev = self.device
        M, F = out_dst.shape
        src = torch.as_tensor(fired, dtype=torch.int32,
                              device=dev).expand(M, F)
        dst = torch.as_tensor(out_dst, device=dev)
        tmsg = torch.as_tensor(now, device=dev).expand(M, F)
        slot = torch.arange(M, dtype=torch.int32,
                            device=dev)[:, None].expand(M, F)
        delay, drop = link_sample(self.link, self.s0, self.s1, src, dst,
                                  tmsg, slot)
        if self._faulted:
            from ...faults.apply import degrade
            delay = degrade(self._ft_dev, delay, src, dst, tmsg)
        return (delay.expand(M, F).cpu().numpy(),
                drop.expand(M, F).cpu().numpy())

    # ------------------------------------------------------------------

    def run(self, max_steps: int = 1 << 30,
            until: Optional[Microsecond] = None) -> SuperstepTrace:
        wall0 = _time.perf_counter()
        sc = self.scenario
        n, M, K, P = sc.n_nodes, sc.max_out, sc.mailbox_cap, sc.payload_width
        W = self.window
        rows = []
        for _ in range(max_steps):
            nexts = [self._node_next(i) for i in range(n)]
            t = min(nexts)
            if t >= NEVER or (until is not None and t > until):
                break
            self.time = t
            # windowed firing: every node with an event in [t, t+W), each
            # at its own instant nexts[i]; an `until` horizon bounds the
            # instants, not just the window start
            fired = [i for i in range(n)
                     if nexts[i] < NEVER and nexts[i] - t < W
                     and (until is None or nexts[i] <= until)]
            fired_hash = _combine(mix32(FIRED, i) for i in fired)
            if self.events is not None:
                self.events.extend(("fire", nexts[i], i) for i in fired)
            if self._faulted:
                # restart firings: consume the injected reboot, reset
                # state from the template, purge pre-crash mailbox memory
                # — BEFORE inboxes are built
                for i in fired:
                    self._restart(i, nexts[i])

            # build the firing nodes' inboxes (host decision: contract #2
            # ordering); deliverable = due at the node's own instant
            F = len(fired)
            ib_valid = np.zeros((K, F), bool)
            ib_src = np.zeros((K, F), np.int32)
            ib_time = np.full((K, F), NEVER, np.int64)
            ib_pay = np.zeros((K, P, F), np.int32)
            recv_hashes: List[int] = []
            for f, i in enumerate(fired):
                ti = nexts[i]
                pend = self.mailbox[i]
                picked = sorted(
                    ((m, idx) for idx, m in enumerate(pend) if m[0] <= ti),
                    key=lambda mi: (mi[0][0], mi[1]))
                self.mailbox[i] = [m for m in pend if m[0] > ti]
                for j, (m, _) in enumerate(picked):
                    ib_valid[j, f] = True
                    ib_time[j, f] = m[0]
                    # inbox_src=False: every interpreter presents (and
                    # hashes) 0 as the sender
                    src_word = m[1] if sc.inbox_src else 0
                    ib_src[j, f] = src_word
                    ib_pay[j, :, f] = m[2]
                    p0 = int(m[2][0]) if P else 0
                    recv_hashes.append(mix32(
                        RECV, i, src_word, m[0] & MASK32, m[0] >> 32, p0))
                    if self.events is not None:
                        self.events.append(("recv", ti, i, int(m[1]),
                                            int(m[0]), p0))
            now_arr = np.asarray([nexts[i] for i in fired], np.int64)

            out_valid, out_dst, out_pay, new_wake = self._step(
                fired, Inbox(ib_valid, ib_src, ib_time, ib_pay), now_arr)
            for f, i in enumerate(fired):
                w = int(new_wake[f])
                # contract #5: clamp re-arm strictly past the node's now
                self.wake[i] = NEVER if w >= NEVER else max(w, nexts[i] + 1)

            # route in chronological (send instant, sender, slot) order —
            # contract #3; link entropy keyed by each message's own
            # send instant
            delay, drop = self._sample(fired, out_dst, now_arr)
            sent_hashes: List[int] = []
            overflow_step = 0
            order = sorted(range(F), key=lambda f: (now_arr[f], fired[f]))
            for f in order:
                i, ti = fired[f], int(now_arr[f])
                for slot in range(M):
                    if not out_valid[slot, f]:
                        continue
                    dst = int(out_dst[slot, f])
                    if not (0 <= dst < n):
                        self.bad_dst_total += 1   # surfaced, never silent
                        continue
                    if drop[slot, f]:
                        continue
                    if self._faulted and self._cut(i, dst, ti):
                        # lost in transit across a live cut: counted,
                        # never hashed
                        self.fault_dropped_total += 1
                        continue
                    flight = max(int(delay[slot, f]), 1)   # contract #4
                    if W > 1 and flight < W:
                        # windowed-causality violation, counted loudly
                        self.short_delay_total += 1
                    dt = ti + flight
                    if self._faulted and self._down(dst, dt):
                        # lands inside the destination's down window
                        self.fault_dropped_total += 1
                        continue
                    p0 = int(out_pay[slot, 0, f]) if P else 0
                    sent_hashes.append(mix32(
                        SENT, i, dst, dt & MASK32, dt >> 32, p0))
                    if self.events is not None:
                        self.events.append(("sent", ti, i, dst, dt, p0))
                    if len(self.mailbox[dst]) >= K:
                        overflow_step += 1   # contract #6: counted, dropped
                    else:
                        self.mailbox[dst].append(
                            (dt, i, out_pay[slot, :, f].copy()))
            self.overflow_total += overflow_step
            rows.append((t, F, fired_hash, len(recv_hashes),
                         _combine(recv_hashes), len(sent_hashes),
                         _combine(sent_hashes), overflow_step))
        # the uniform driver-accounting surface every engine carries; the
        # oracle compiles nothing
        self.last_run_stats = {
            "supersteps": len(rows),
            "wall_seconds": _time.perf_counter() - wall0,
            "compiles": 0,
        }
        return SuperstepTrace.from_rows(rows)

"""The general engine on PyTorch (port of
``timewarp_tpu/interp/jax_engine/engine.py``, single device).

Whole-network emulation as a Python loop of supersteps over tensors:
per-node ``next_wake`` plus bounded ``[K, N]`` mailboxes with int32
epoch-relative deliver times (``I32MAX`` = empty slot). Each superstep,
in the reference's order:

1. pop the minimum event (``t``) — the one host sync of the loop, which
   is also the run loop's quiescence test;
2. fire every node whose next event lies in ``[t, t + window)``, each at
   its own instant;
3. deliver and build the inbox (sorted by ``(deliver time, slot)`` for
   ordered inboxes);
4. run the scenario's batched step;
5. drop what was delivered and rebase to the new epoch;
6. route, in one of the reference's three regimes, and insert into the
   mailbox (kernel K1). Adaptive (no ``route_cap``, a drop-free link,
   and ``window > 1`` or ``max_out > 1``): fire-compact the outbox
   (kernel K2), sort the batch by ``(destination, window offset,
   sender-major rank)``, then sample the link. Otherwise the outbox is
   flattened slot-major at ``S = N·max_out``: the eager path samples
   every slot (a droppy link's draw decides validity) and then sorts;
   the lazy path (``route_cap`` with a drop-free link) sorts first,
   slices to ``route_cap`` and samples only that prefix.

With ``record_events > 0`` every superstep also appends its fires and
deliveries to an on-device event ring (:meth:`TorchEngine.events`).

The emitted trace and final state equal ``JaxEngine``'s bit for bit
(tests/test_torch_engine.py, tests/test_torch_routing.py). Batched
worlds, faults and the run-mode planes are refused at construction.
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple, Optional, Tuple

import torch

from ...core.rng import fire_bits, seed_words
from ...core.scenario import NEVER, Inbox, Scenario
from ...net.delays import LinkModel
from ...ops.numeric import I32MAX, thi, tlo, u32sum
from ...trace.events import SuperstepTrace
from ...trace.hashing import FIRED, RECV, SENT, mix32
from .common import LocalComm, init_states_wake, refuse_unported, run_stats
from .cuda_insert import (InsertStage, flight_times, link_sample,
                          sample_nodrop)

__all__ = ["TorchEngine", "EngineState", "resolve_device", "resolve_window",
           "sort_batch", "sent_digest"]


class EngineState(NamedTuple):
    """The complete simulation state — the reference's ``EngineState``
    leaf for leaf, same dtypes and ``[K, N]`` layout (so states carry
    across, state_io.py). Scalars are 0-d tensors on the engine's
    device."""
    states: Any                  # dict of [N, ...] tensors
    wake: torch.Tensor           # int64[N]
    mb_rel: torch.Tensor         # int32[K, N]; I32MAX = empty slot
    mb_src: torch.Tensor         # int32[K, N]
    mb_payload: torch.Tensor     # int32[K, P, N]
    overflow: torch.Tensor       # int32[]
    bad_dst: torch.Tensor        # int32[]
    bad_delay: torch.Tensor      # int32[]
    short_delay: torch.Tensor    # int32[]
    route_drop: torch.Tensor     # int32[]
    delivered: torch.Tensor      # int64[]
    steps: torch.Tensor          # int64[]
    time: torch.Tensor           # int64[] — current epoch
    ev_time: torch.Tensor        # int64[E] — event ring, E = record_events
    ev_meta: torch.Tensor        # int32[4, E] — kind, node, src, payload0
    ev_count: torch.Tensor       # int64[] — events seen, stored or not
    fault_dropped: torch.Tensor  # int32[] — faults are not ported: 0
    restart_done: torch.Tensor   # bool[0]


#: the reference engine's options this slice does not port, with the
#: value that means "off" — any other value is refused at construction
_UNPORTED = {"batch": None, "faults": None, "telemetry": "off",
             "controller": None, "verify": "off", "record": "off",
             "speculate": "off"}


def resolve_device(device, who: str = "TorchEngine") -> torch.device:
    """The engine's device: the card unless the caller asks for another.
    Without CUDA, a caller that did not pass ``device="cpu"`` gets an
    error, never a silent move to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who} runs on the CUDA device by default and none "
                "is available; pass device='cpu' to run the kernels' plain "
                "versions on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} but CUDA is not available")
    return dev


def resolve_window(window, link: LinkModel) -> int:
    """The superstep window in µs: an int, or ``"auto"`` for the link's
    declared floor. A window wider than that floor would reorder causally
    dependent events and is refused."""
    floor = link.min_delay_us
    if isinstance(window, str) and window != "auto":
        raise ValueError(f"window must be an int µs count or 'auto', "
                         f"got {window!r}")
    if window == "auto":
        window = max(1, min(int(floor), I32MAX - 1))
    if window < 1:
        raise ValueError(f"window must be >= 1 µs, got {window}")
    if window > 1 and window > floor:
        raise ValueError(
            f"window={window} µs exceeds the link model's declared "
            f"min_delay_us={floor}; windowed supersteps would reorder "
            "causally dependent events")
    if window >= I32MAX:
        raise ValueError("window must fit int32")
    return int(window)


def _sort_rows(key: torch.Tensor) -> torch.Tensor:
    """Indices of a stable ascending sort along axis 0."""
    return torch.sort(key, dim=0, stable=True).indices


def sort_batch(dst, woff, smrank) -> torch.Tensor:
    """The permutation that orders a message batch by ``(dst, woff,
    smrank)``: the reference's 3-key sort as two stable sorts, ``(woff,
    smrank)`` packed into one int64 (each < 2^31), then ``dst``."""
    o1 = _sort_rows((woff.long() << 31) | smrank.long())
    return o1[_sort_rows(dst[o1])]


def sent_digest(ok, src, dst, tmsg, flight, pay0) -> torch.Tensor:
    """The SENT digest of a sorted, sampled batch over its ``ok``
    entries: each message hashed with its absolute deliver time."""
    dt_abs = tmsg + flight
    sent_mix = mix32(SENT, src, dst, tlo(dt_abs), thi(dt_abs), pay0)
    return u32sum(torch.where(ok, sent_mix, 0))


class TorchEngine:
    """Single-device engine for dynamic-destination scenarios —
    ``JaxEngine(insert="pallas")`` on one device, with the
    fire-compaction and mailbox-insertion kernels on the card (their
    plain versions on the CPU).

    ``window`` is an int µs width or ``"auto"`` (the link's declared
    floor); it must not exceed ``link.min_delay_us``, and sampled delays
    shorter than it are counted in ``short_delay``. ``route_cap`` bounds
    the sorted batch outside the adaptive regime, unrounded (the excess
    is counted in ``route_drop``); ``insert_cap`` bounds the adaptive
    regime's fired batch (default ``n_nodes * max_out``: nothing can
    drop) and is refused in the other regimes. ``record_events`` is the
    capacity of the event ring (0: off). ``device`` defaults to the card.
    After ``run``/``run_quiet``, ``last_run_stats`` holds the call's
    supersteps, wall seconds and compiles (0)."""

    last_run_stats = None

    def __init__(self, scenario: Scenario, link: LinkModel, *,
                 seed: int = 0, window=1, route_cap: Optional[int] = None,
                 record_events: int = 0, insert_cap: Optional[int] = None,
                 device=None, **unported) -> None:
        self._hold(scenario, link, seed, device, record_events, unported)
        self.window = resolve_window(window, link)
        if route_cap is not None and route_cap < 1:
            raise ValueError(f"route_cap must be >= 1, got {route_cap}")
        self.route_cap = None if route_cap is None else int(route_cap)
        #: the regime step 6 takes (reference ``_adaptive_regime``)
        self.adaptive = (self.route_cap is None and not link.can_drop
                         and (self.window > 1 or scenario.max_out > 1))
        #: outside it: sort first and sample only the route_cap prefix
        #: (the lazy path), else sample every slot (the eager path)
        self.lazy = self.route_cap is not None and not link.can_drop
        self.stage = InsertStage(scenario, scenario.n_nodes,
                                 window=self.window, insert_cap=insert_cap,
                                 adaptive=self.adaptive,
                                 route_cap=self.route_cap)

    def _hold(self, sc: Scenario, link: LinkModel, seed: int, device,
              record_events: int, unported: dict) -> None:
        """What every engine of this package checks and holds, before its
        own regime guards: the unported options, the device, the event
        ring's capacity, the seed words and the node axis."""
        name = type(self).__name__
        refuse_unported(name, unported, _UNPORTED, "JaxEngine")
        self.device = resolve_device(device, name)
        if sc.n_nodes * sc.max_out >= 2**31:
            raise ValueError(
                "n_nodes * max_out must fit int32 (sender-major rank)")
        if record_events < 0:
            raise ValueError("record_events must be >= 0")
        self.record_events = int(record_events)
        self.scenario, self.link = sc, link
        self.s0, self.s1 = seed_words(seed)
        self.comm = LocalComm(sc.n_nodes, self.device)
        self._node_ids = self.comm.node_ids()

    # -- state -------------------------------------------------------------

    def init_state(self) -> EngineState:
        sc, dev = self.scenario, self.device
        n, K, P = sc.n_nodes, sc.mailbox_cap, sc.payload_width
        states, wake = init_states_wake(sc, dev)

        def scalar(dtype):
            return torch.zeros((), dtype=dtype, device=dev)
        return EngineState(
            states=states, wake=wake,
            mb_rel=torch.full((K, n), I32MAX, dtype=torch.int32, device=dev),
            mb_src=torch.zeros((K, n), dtype=torch.int32, device=dev),
            mb_payload=torch.zeros((K, P, n), dtype=torch.int32, device=dev),
            overflow=scalar(torch.int32), bad_dst=scalar(torch.int32),
            bad_delay=scalar(torch.int32), short_delay=scalar(torch.int32),
            route_drop=scalar(torch.int32), delivered=scalar(torch.int64),
            steps=scalar(torch.int64), time=scalar(torch.int64),
            ev_time=torch.zeros((self.record_events,), dtype=torch.int64,
                                device=dev),
            ev_meta=torch.zeros((4, self.record_events), dtype=torch.int32,
                                device=dev),
            ev_count=scalar(torch.int64),
            fault_dropped=scalar(torch.int32),
            restart_done=torch.zeros((0,), dtype=torch.bool, device=dev))

    def _next_event(self, st: EngineState) -> torch.Tensor:
        """The next event time (NEVER = quiesced), an int64 0-d tensor."""
        mmin = st.mb_rel.min()
        return torch.minimum(
            st.wake.min(),
            torch.where(mmin == I32MAX, NEVER, st.time + mmin.long()))

    # -- one superstep -----------------------------------------------------

    def _premask(self, out, out_valid):
        """The outbox's destinations with invalid and out-of-range
        messages as -1 (``pdst`` int32 ``[M, N]``), and the count of
        valid messages to an out-of-range node (``bad_dst``)."""
        dst32 = out.dst.to(torch.int32)
        dst_okf = (dst32 >= 0) & (dst32 < self.comm.n_global)
        bad_dst_step = (out_valid & ~dst_okf).sum(dtype=torch.int32)
        return (torch.where(out_valid & dst_okf, dst32, -1).contiguous(),
                bad_dst_step)

    def _route_firecompact(self, out, out_valid, now_vec, t, mb_rel,
                           mb_src, mb_payload, counts, with_trace):
        """Step 6: pre-mask, fire-compact (K2), order by ``(dst, woff,
        smrank)``, sample, insert (K1), and the SENT digest."""
        sc = self.scenario
        M = sc.max_out
        n = self.comm.n_local
        pdst, bad_dst_step = self._premask(out, out_valid)
        woff_n = (now_vec - t).to(torch.int32)
        dst_f, woff_f, smrank, pay_f, route_drop_step = self.stage.compact(
            pdst, woff_n, out.payload.to(torch.int32).contiguous())
        ok = dst_f < n
        perm = sort_batch(dst_f, woff_f, smrank)
        sd, woff_s, smrank_s = dst_f[perm], woff_f[perm], smrank[perm]
        pay_s = pay_f[:, perm]
        ok_s = sd < n
        src_s = torch.div(smrank_s, M, rounding_mode="floor")
        tmsg_s = t + woff_s.long()
        flight_s, drel_s, bad_delay_step, short_step = sample_nodrop(
            self.link, self.s0, self.s1, self.window, src_s, sd, tmsg_s,
            smrank_s - src_s * M, woff_s, ok_s)
        mrel, msrc, mpay, overflow_step = self.stage.insert(
            sd, drel_s, src_s, pay_s.contiguous(), mb_rel, mb_src,
            mb_payload, counts)
        sent_count = ok.sum(dtype=torch.int32)
        sent_hash = sent_digest(ok_s, src_s, sd, tmsg_s, flight_s,
                                pay_s[0]) if with_trace else None
        return (mrel, msrc, mpay, overflow_step, bad_dst_step,
                bad_delay_step, short_step, route_drop_step, sent_count,
                sent_hash)

    def _route_flat(self, out, out_valid, now_vec, t, mb_rel, mb_src,
                    mb_payload, counts, with_trace):
        """Step 6 outside the adaptive regime: the outbox flattened
        slot-major at ``S = N·M``, sampled (eager: every slot, before the
        sort; lazy: the sorted ``route_cap`` prefix), ordered by ``(dst or
        sentinel n, woff, smrank)``, sliced to ``route_cap`` when set,
        inserted (K1), and the path's SENT digest."""
        sc = self.scenario
        M, P = sc.max_out, sc.payload_width
        n = self.comm.n_local
        S = n * M
        src_f = self._node_ids.repeat(M)
        slot_f = torch.arange(M, dtype=torch.int32,
                              device=self.device).repeat_interleave(n)
        tmsg = now_vec.repeat(M)                                # int64[S]
        dst_f = out.dst.reshape(S).to(torch.int32)
        pay_f = out.payload.to(torch.int32).permute(1, 0, 2).reshape(P, S)
        v_f = out_valid.reshape(S)
        dst_ok = (dst_f >= 0) & (dst_f < self.comm.n_global)
        bad_dst_step = (v_f & ~dst_ok).sum(dtype=torch.int32)
        woff = (tmsg - t).to(torch.int32)                       # [0, W)
        smrank = src_f * M + slot_f
        if self.lazy:
            ok = v_f & dst_ok
        else:
            # every slot is drawn, invalid and out-of-range ones too (the
            # draw is elementwise); a droppy link's draw decides validity
            delay, drop = link_sample(self.link, self.s0, self.s1, src_f,
                                      dst_f, tmsg, slot_f)
            ok = v_f & ~drop & dst_ok
            flight, drel, bad_delay_step, short_step = flight_times(
                delay, woff, ok, self.window)
        sort_dst = torch.where(ok, dst_f, n)
        perm = sort_batch(sort_dst, woff, smrank)
        route_drop_step = torch.zeros((), dtype=torch.int32,
                                      device=self.device)
        if self.route_cap is not None and self.route_cap < S:
            # valid messages sort ahead of the sentinel: the prefix is
            # exact while the active count fits, the excess is counted
            perm = perm[:self.route_cap]
            route_drop_step = ok.sum(dtype=torch.int32) \
                - (sort_dst[perm] < n).sum(dtype=torch.int32)
        sd, smrank_s = sort_dst[perm], smrank[perm]
        src_s = torch.div(smrank_s, M, rounding_mode="floor")
        pay_s = pay_f[:, perm].contiguous()
        ok_s = sd < n
        if self.lazy:
            woff_s = woff[perm]
            tmsg_s = t + woff_s.long()
            flight_s, drel_s, bad_delay_step, short_step = sample_nodrop(
                self.link, self.s0, self.s1, self.window, src_s, sd, tmsg_s,
                smrank_s - src_s * M, woff_s, ok_s)
        else:
            drel_s = drel[perm]
        mrel, msrc, mpay, overflow_step = self.stage.insert(
            sd, drel_s, src_s, pay_s, mb_rel, mb_src, mb_payload, counts)
        # the SENT digest: lazy over the sliced survivors (all that has a
        # delay), eager over every ok message at the unsliced width
        if self.lazy:
            sent_count = ok_s.sum(dtype=torch.int32)
            sent_hash = sent_digest(ok_s, src_s, sd, tmsg_s, flight_s,
                                    pay_s[0]) if with_trace else None
        else:
            sent_count = ok.sum(dtype=torch.int32)
            sent_hash = sent_digest(ok, src_f, dst_f, tmsg, flight,
                                    pay_f[0]) if with_trace else None
        return (mrel, msrc, mpay, overflow_step, bad_dst_step,
                bad_delay_step, short_step, route_drop_step, sent_count,
                sent_hash)

    def _route(self, *args):
        """Step 6, the routing stage, in the engine's regime. An engine
        subclass replaces it (fused_sparse.py) and keeps everything
        else."""
        if self.adaptive:
            return self._route_firecompact(*args)
        return self._route_flat(*args)

    def _superstep(self, st: EngineState, with_trace: bool
                   ) -> Optional[Tuple[EngineState, Optional[torch.Tensor]]]:
        """One superstep: ``(new_state, trace_row)`` — the row an int64
        ``[8]`` tensor when ``with_trace`` — or None once quiesced."""
        sc = self.scenario
        K, P = sc.mailbox_cap, sc.payload_width
        n = self.comm.n_local
        node_ids = self._node_ids
        base = st.time
        W = self.window
        mb_live = st.mb_rel < I32MAX                            # [K, N]

        # 1. global next event time (the batched "pop min")
        nnr = st.mb_rel.amin(dim=0)
        node_next = torch.minimum(
            st.wake, torch.where(nnr == I32MAX, NEVER, base + nnr.long()))
        t = node_next.min()
        if int(t) >= NEVER:        # the loop's one host sync per superstep
            return None
        # 2. windowed firing, each node at its own instant
        fire = (node_next < NEVER) & (node_next - t < W)
        now_vec = torch.where(fire, node_next, t)               # int64[N]
        shift32 = torch.clamp(t - base, max=I32MAX - 1).to(torch.int32)
        nrel = torch.clamp(now_vec - base, max=I32MAX - 1).to(torch.int32)
        deliver = mb_live & (st.mb_rel <= nrel[None, :]) & fire[None, :]

        # 3. inbox: delivered slots first, by (time, slot) — a stable sort
        #    on the packed (undelivered, rel) key keeps slot order on ties.
        #    Commutative inboxes waive the order.
        if sc.commutative_inbox:
            inbox = Inbox(
                valid=deliver,
                src=torch.where(deliver, st.mb_src, 0) if sc.inbox_src
                else torch.zeros_like(st.mb_src),
                time=torch.where(deliver, base + st.mb_rel.long(), NEVER),
                payload=torch.where(deliver[:, None, :], st.mb_payload, 0))
        else:
            rel_key = torch.where(deliver, st.mb_rel, I32MAX)
            order = _sort_rows(((~deliver).long() << 32)
                               | (rel_key.long() + 2**31))
            ib_valid = deliver.gather(0, order)
            ib_rel = rel_key.gather(0, order)
            ib_src = st.mb_src.gather(0, order)
            ib_pay = st.mb_payload.gather(
                0, order[:, None, :].expand(K, P, n))
            inbox = Inbox(
                valid=ib_valid,
                src=torch.where(ib_valid, ib_src, 0) if sc.inbox_src
                else torch.zeros_like(ib_src),
                time=torch.where(ib_valid, base + ib_rel.long(), NEVER),
                payload=torch.where(ib_valid[:, None, :], ib_pay, 0))

        # 4. fire every node simultaneously; mask non-fired results
        bits = fire_bits(self.s0, self.s1, node_ids, now_vec) \
            if sc.needs_key else None
        new_states, out, new_wake = sc.step(st.states, inbox, now_vec,
                                            node_ids, bits)
        states = {k: torch.where(
            fire.view((n,) + (1,) * (v.dim() - 1)), new_states[k], v)
            for k, v in st.states.items()}
        new_wake = torch.where(new_wake >= NEVER, NEVER,
                               torch.maximum(new_wake, now_vec + 1))
        wake = torch.where(fire, new_wake, st.wake)
        out_valid = out.valid & fire[None, :]                   # [M, N]

        # 5. drop delivered messages, rebase to the new epoch t.
        #    Commutative: freed slots become holes (mb_src / mb_payload
        #    pass on unchanged — stale in holes, never read). Ordered: a
        #    stable sort on `not kept` compacts kept rows in slot order.
        keep = mb_live & ~deliver
        if sc.commutative_inbox:
            mb_rel = torch.where(keep, st.mb_rel - shift32, I32MAX)
            mb_src, mb_payload, counts = st.mb_src, st.mb_payload, None
        else:
            order = _sort_rows((~keep).to(torch.int32))
            kept = keep.gather(0, order)
            mb_rel = torch.where(kept, st.mb_rel.gather(0, order) - shift32,
                                 I32MAX)
            mb_src = st.mb_src.gather(0, order)
            mb_payload = st.mb_payload.gather(
                0, order[:, None, :].expand(K, P, n))
            counts = kept.sum(dim=0, dtype=torch.int32)

        # 6. route, sample, insert
        (mb_rel, mb_src, mb_payload, overflow_step, bad_dst_step,
         bad_delay_step, short_step, route_drop_step, sent_count,
         sent_hash) = self._route(
            out, out_valid, now_vec, t, mb_rel, mb_src, mb_payload, counts,
            with_trace)
        return self._finish_superstep(
            st, states, wake, mb_rel, mb_src, mb_payload, deliver, fire,
            now_vec, node_ids, t, base, overflow_step, bad_dst_step,
            bad_delay_step, short_step, route_drop_step, sent_count,
            sent_hash, with_trace)

    def _record(self, st, deliver, fire, now_vec, node_ids, base):
        """This superstep's events appended to the ring: fires in
        ascending node order, then deliveries node-major in slot order.
        Each ring slot is written at most once; an event past the
        capacity E goes to a spare slot E that is cut off, while
        ``ev_count`` keeps counting (the overflow evidence)."""
        sc = self.scenario
        K, n, E = sc.mailbox_cap, self.comm.n_local, self.record_events
        base_i = torch.clamp(st.ev_count, max=E)
        f = fire.long()
        pos_f = base_i + torch.cumsum(f, 0) - f
        idx_f = torch.where(fire & (pos_f < E), pos_f, E)
        nf = f.sum()
        dv = deliver.T.reshape(K * n)                          # node-major
        d = dv.long()
        pos_r = base_i + nf + torch.cumsum(d, 0) - d
        idx_r = torch.where(dv & (pos_r < E), pos_r, E)
        ev_time = torch.cat([st.ev_time, st.ev_time.new_zeros(1)])
        ev_time[idx_f] = now_vec
        ev_time[idx_r] = (base + st.mb_rel.long()).T.reshape(K * n)
        meta = torch.cat([st.ev_meta, st.ev_meta.new_zeros((4, 1))], dim=1)
        meta[0, idx_f] = 1
        meta[1, idx_f] = node_ids
        meta[0, idx_r] = 2
        meta[1, idx_r] = node_ids.repeat_interleave(K)
        meta[2, idx_r] = st.mb_src.T.reshape(K * n) if sc.inbox_src else 0
        meta[3, idx_r] = st.mb_payload[:, 0, :].T.reshape(K * n)
        return (ev_time[:E], meta[:, :E].contiguous(),
                st.ev_count + nf + d.sum())

    def _finish_superstep(self, st, states, wake, mb_rel, mb_src,
                          mb_payload, deliver, fire, now_vec, node_ids, t,
                          base, overflow_step, bad_dst_step, bad_delay_step,
                          short_step, route_drop_step, sent_count,
                          sent_hash, with_trace):
        """Assemble the post-superstep state, the event ring included,
        and (optionally) the trace row ``(t, fired_count, fired_hash,
        recv_count, recv_hash, sent_count, sent_hash, overflow)``."""
        sc = self.scenario
        K, n = sc.mailbox_cap, self.comm.n_local
        recv_count = deliver.sum(dtype=torch.int32)
        ev_time, ev_meta, ev_count = st.ev_time, st.ev_meta, st.ev_count
        if self.record_events:
            ev_time, ev_meta, ev_count = self._record(
                st, deliver, fire, now_vec, node_ids, base)
        new_st = st._replace(
            states=states, wake=wake,
            mb_rel=mb_rel, mb_src=mb_src, mb_payload=mb_payload,
            overflow=st.overflow + overflow_step,
            bad_dst=st.bad_dst + bad_dst_step,
            bad_delay=st.bad_delay + bad_delay_step,
            short_delay=st.short_delay + short_step,
            route_drop=st.route_drop + route_drop_step,
            delivered=st.delivered + recv_count.long(),
            steps=st.steps + 1,
            time=t, ev_time=ev_time, ev_meta=ev_meta, ev_count=ev_count)
        if not with_trace:
            return new_st, None
        # trace digests (order-independent): from the pre-sort mask
        fired_hash = u32sum(torch.where(fire, mix32(FIRED, node_ids), 0))
        d_abs = base + torch.where(deliver, st.mb_rel, 0).long()
        recv_mix = mix32(
            RECV, node_ids[None, :].expand(K, n),
            st.mb_src if sc.inbox_src else torch.zeros_like(st.mb_src),
            tlo(d_abs), thi(d_abs), st.mb_payload[:, 0, :])
        recv_hash = u32sum(torch.where(deliver, recv_mix, 0))
        row = torch.stack([
            t, fire.sum().long(), fired_hash, recv_count.long(), recv_hash,
            sent_count.long(), sent_hash, overflow_step.long()])
        return new_st, row

    # -- run loops ---------------------------------------------------------

    def _start(self, state: Optional[EngineState]) -> EngineState:
        """A run's first state: a fresh one, or ``state`` if its event
        ring has this engine's capacity."""
        if state is None:
            return self.init_state()
        if tuple(state.ev_meta.shape) != (4, self.record_events):
            raise ValueError(
                f"state's event ring holds {state.ev_meta.shape[1]} "
                f"events, this engine's record_events={self.record_events}")
        return state

    def run(self, max_steps: int, state: Optional[EngineState] = None
            ) -> Tuple[EngineState, SuperstepTrace]:
        """Execute up to ``max_steps`` supersteps (stopping early once
        quiesced); returns the final state and the trace of the
        supersteps that fired."""
        st = self._start(state)
        steps0 = int(st.steps)
        t0 = time.perf_counter()
        rows = []
        for _ in range(max_steps):
            res = self._superstep(st, True)
            if res is None:
                break
            st, row = res
            rows.append(row)
        cols = torch.stack(rows).cpu().numpy().T if rows else [[]] * 8
        self.last_run_stats = run_stats(t0, steps0, int(st.steps))
        return st, SuperstepTrace.from_columns(cols)

    def run_quiet(self, max_steps: int,
                  state: Optional[EngineState] = None) -> EngineState:
        """Traceless run: no digest work. Stops at quiescence or after
        ``max_steps`` supersteps."""
        st = self._start(state)
        steps0 = int(st.steps)
        t0 = time.perf_counter()
        for _ in range(max_steps):
            res = self._superstep(st, False)
            if res is None:
                break
            st = res[0]
        # int() waits for the device, so the wall time covers the work
        self.last_run_stats = run_stats(t0, steps0, int(st.steps))
        return st

    def events(self, state: EngineState):
        """The event ring decoded on the host: ``("fire", time, node)`` and
        ``("recv", deliver_time, node, src, payload0)`` tuples in ring
        order, and the count of events that did not fit (0: the record
        is complete). ``src`` is 0 for scenarios without ``inbox_src``."""
        if not self.record_events:
            raise ValueError("engine built with record_events=0")
        ev_time = state.ev_time.cpu().numpy()
        ev_meta = state.ev_meta.cpu().numpy()
        total = int(state.ev_count)
        filled = min(total, self.record_events)
        out = []
        for j in range(filled):
            kind, node, src, pay = (int(x) for x in ev_meta[:, j])
            if kind == 1:
                out.append(("fire", int(ev_time[j]), node))
            else:
                out.append(("recv", int(ev_time[j]), node, src, pay))
        return out, total - filled

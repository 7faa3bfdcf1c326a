"""The fused-sparse engine on PyTorch (port of
``timewarp_tpu/interp/jax_engine/fused_sparse.py``).

:class:`FusedSparseEngine` is :class:`TorchEngine` with the routing
stage replaced: live senders are compacted by node id (one N-wide sort),
their messages sorted by ``(destination, window offset, sender-major
rank)``, and the sorted batch handed ONCE to the sample-and-insert kernel
K3 (``cuda_insert.sample_insert``), which draws each message's link delay
and inserts it into its destination's mailbox holes. State, drivers,
traces and ``last_run_stats`` are ``TorchEngine``'s, so the exactness
law is state and trace equality with the general engine whenever
``route_drop`` is 0 (tests/test_torch_fused_sparse.py).

Capacity: the batch holds the first ``A = min(n, max_batch // max_out)``
live senders by id; the messages of the others are dropped WHOLE, by
sender, and counted in ``route_drop``. This is not K2's cut (block order,
message granularity), so the two engines differ whenever a run drops.
``max_batch >= n_nodes * max_out`` never drops.

The run-mode planes are ``TorchEngine``'s (``telemetry``, ``verify``,
``record``/``record_cap``, ``controller``), as the reference's fused
engine takes them: the telemetry ``rung`` is the static batch ``A``, the
flight recorder's sends re-derive each message's flight outside K3 (as
the SENT digest does), and a controller adapts chunk length only: K3
draws each delay and counts ``short_delay`` against the window inside
the kernel, so there is no point at which a dynamic window could be
clamped. For the same reason ``speculate`` is refused, as the reference
refuses it on its kernel path.

Scope guards (constructor, never silent): a drop-free link that
:func:`lower_link` can express, ``window > 1`` or ``max_out > 1``, a
commutative inbox, and ``max_delay + window < 2^32``. Like the
reference's fused engine it takes no ``batch`` and no ``faults``: both
are refused as unexpected arguments. The reference's
``n % 1024``, ``mailbox_cap <= 128`` and 12 MB VMEM budget are TPU
artefacts and are not carried over.
"""

from __future__ import annotations

import torch

from ...core.scenario import Scenario
from ...net.delays import (FixedDelay, LinkModel, LogNormalDelay, Quantize,
                           SeededHashUniform, UniformDelay)
from .cuda_insert import (LoweredLink, bucket_bounds, sample_insert,
                          sample_nodrop)
from .engine import TorchEngine, resolve_window, sent_digest, sort_batch

__all__ = ["FusedSparseEngine", "lower_link"]


def _lower_base(link: LinkModel):
    """``(kind, ints, floats, max_delay_us)`` of an unwrapped model."""
    if isinstance(link, FixedDelay):
        d = int(link.delay)
        if not 0 <= d < 2**31:
            raise ValueError("FixedDelay delay must fit int32 for the "
                             "fused kernel's uint32 deliver arithmetic")
        return "fixed", (d, 0, 0, 0), (0.0,) * 4, d
    if isinstance(link, (UniformDelay, SeededHashUniform)):
        hashed = isinstance(link, SeededHashUniform)
        lo, hi = ((int(link.lo_us), int(link.hi_us)) if hashed
                  else (int(link.lo), int(link.hi)))
        if not 0 <= lo <= hi < 2**31:
            raise ValueError(f"{type(link).__name__} bounds must satisfy "
                             "0 <= lo <= hi < 2**31 for the fused kernel")
        salt = (link._s0, link._s1) if hashed else (0, 0)
        return ("seeded_hash" if hashed else "uniform",
                (lo, hi - lo + 1) + salt, (0.0,) * 4, hi)
    if isinstance(link, LogNormalDelay):
        cap = int(link.cap_us)
        if not 0 <= cap < 2**31:
            raise ValueError("LogNormalDelay cap_us must fit int32 for "
                             "the fused kernel")
        return ("lognormal", (0,) * 4,
                (float(link.median_us), float(link.sigma),
                 float(link.floor_us), float(cap)), cap)
    raise ValueError(
        f"FusedSparseEngine cannot lower link model {link!r} into the "
        "kernel (supported: FixedDelay / UniformDelay / SeededHashUniform "
        "/ LogNormalDelay, optionally wrapped in one Quantize); run "
        "TorchEngine instead")


def lower_link(link: LinkModel) -> LoweredLink:
    """What K3 needs to draw ``link``'s delays in-kernel — the model kind
    with its uint32 and float32 parameters, the Quantize step (0 when
    unwrapped) and the largest delay it can draw — plus the model itself,
    whose ``sample`` is the plain torch sampler of the same function
    (reference ``fused_sparse._lower_link``). Anything else raises."""
    q = 0
    inner = link
    if isinstance(link, Quantize):
        q, inner = int(link.quantum_us), link.inner
        if not 1 <= q < 2**31:
            raise ValueError("Quantize quantum_us must be in [1, 2**31) "
                             "for the fused kernel")
    kind, ints, floats, mx = _lower_base(inner)
    if q:
        mx = ((max(mx, 1) + q - 1) // q) * q
    return LoweredLink(kind, ints, floats, q, mx, link)


class FusedSparseEngine(TorchEngine):
    """:class:`TorchEngine` with the routing stage replaced by sender
    compaction, one batch sort and K3 (module docstring). ``max_batch``
    bounds the messages per superstep (default ``2**16``, as the
    reference); ``record_events`` is the event ring's capacity, as in
    :class:`TorchEngine`; ``device`` defaults to the card."""

    #: K3 takes the window at launch: a controller adapts chunk length only
    _dyn_ok = False

    def __init__(self, scenario: Scenario, link: LinkModel, *,
                 seed: int = 0, window=1, record_events: int = 0,
                 max_batch: int = 1 << 16, telemetry: str = "off",
                 controller=None, verify: str = "off",
                 record: str = "off", record_cap=None,
                 speculate: str = "off", lint: str = "warn",
                 device=None) -> None:
        sc = scenario
        if speculate not in (None, "off"):
            raise ValueError(
                f"speculate={speculate!r} threads the dynamic "
                "per-superstep window; FusedSparseEngine's kernel K3 "
                "bakes the window into kernel arithmetic (it draws each "
                "delay and counts short_delay in-kernel) and has no clamp "
                "point — run speculation on TorchEngine "
                "(docs/speculation.md)")
        # TorchEngine's holdings, not its K2/K1 stage: _route replaces it
        self._hold(sc, link, seed, device, record_events, telemetry,
                   verify, record, record_cap, lint)
        if link.can_drop:
            raise ValueError(
                "FusedSparseEngine requires a drop-free link (message "
                "validity must not depend on the sample)")
        self.window = window = resolve_window(window, link)
        if not (window > 1 or sc.max_out > 1):
            raise ValueError(
                "FusedSparseEngine serves the windowed / wide-outbox "
                "sparse regime (window > 1 or max_out > 1); the classic "
                "regime routes nothing the kernel can batch")
        if not sc.commutative_inbox:
            raise ValueError(
                "FusedSparseEngine requires a commutative_inbox scenario "
                "(insertion targets mailbox holes)")
        self.lowered = lower_link(link)
        if self.lowered.max_delay_us + window >= 2**32:
            raise ValueError("max link delay + window must fit the "
                             "kernel's uint32 deliver arithmetic")
        #: live senders per superstep that fit the batch
        self.A = min(sc.n_nodes, max(1, int(max_batch) // sc.max_out))
        #: the telemetry rung: the static batch slice, in senders
        self._t_rung = self.A
        self._bind_controller(controller)

    def _route(self, out, out_valid, now_vec, t, mb_rel, mb_src,
               mb_payload, counts, with_trace):
        """Step 6 (reference ``_route_adaptive``): pre-mask, keep the
        first ``A`` live senders by id (the rest counted whole into
        ``route_drop``), sort their messages by ``(dst, woff, smrank)``,
        then K3 samples and inserts. Static shapes throughout: the only
        host sync stays the pop-min. The engine takes no fleet, so the
        superstep's world axis is 1 and is dropped here and restored on
        the results."""
        sc = self.scenario
        M, P = sc.max_out, sc.payload_width
        n, A = self.comm.n_local, self.A
        pdst, bad_dst_step = self._premask(out, out_valid)
        pdst, now_vec, t = pdst[0], now_vec[0], t[0]
        mb_rel, mb_src, mb_payload = mb_rel[0], mb_src[0], mb_payload[0]
        sender_live = (pdst >= 0).any(dim=0)                      # [N]
        sids = torch.sort(torch.where(sender_live, self._node_ids,
                                      n)).values[:A]
        real = sids < n
        sidc = torch.where(real, sids, 0).long()
        # window offsets are 0 throughout when the window is 1 (every
        # fired node fires at t), so no special case is needed
        woff_a = (now_vec[sidc] - t).to(torch.int32)              # [A]
        dst_f = pdst[:, sidc].reshape(-1)                         # [M*A]
        ok = (dst_f >= 0) & real[None, :].expand(M, A).reshape(-1)
        smrank = (sidc.to(torch.int32)[None, :] * M
                  + torch.arange(M, dtype=torch.int32,
                                 device=pdst.device)[:, None]).reshape(-1)
        woff_f = woff_a[None, :].expand(M, A).reshape(-1)
        pay_f = out.payload[0].to(torch.int32)[:, :, sidc] \
            .permute(1, 0, 2).reshape(P, M * A)
        kept = ok.sum(dtype=torch.int32)
        route_drop_step = (pdst >= 0).sum(dtype=torch.int32) - kept
        sort_dst = torch.where(ok, dst_f, n)
        perm = sort_batch(sort_dst, woff_f, smrank)
        sd, woff_s, smrank_s = sort_dst[perm], woff_f[perm], smrank[perm]
        pay_s = pay_f[:, perm].contiguous()
        start, cnt = bucket_bounds(sd, n)
        mrel, msrc, mpay, overflow_step, bad_delay_step, short_step = \
            sample_insert(start, cnt, sd, woff_s, smrank_s, pay_s, t,
                          mb_rel, mb_src, mb_payload, link=self.lowered,
                          s0=self.s0, s1=self.s1, M=M, W=self.window,
                          inbox_src=sc.inbox_src)
        sent_hash = None
        if with_trace:
            # the SENT digest needs each message's flight: re-derived by
            # the plain sampler from the same counters (bit-identical
            # stream — entropy is keyed by message identity, not venue)
            ok_s = sd < n
            src_s = torch.div(smrank_s, M, rounding_mode="floor")
            tmsg_s = t + woff_s.long()
            flight_s = sample_nodrop(self.link, self.s0, self.s1,
                                     self.window, src_s, sd, tmsg_s,
                                     smrank_s - src_s * M, woff_s, ok_s)[0]
            sent_hash = sent_digest(ok_s, src_s, sd, tmsg_s, flight_s,
                                    pay_s[0])[None]
            if self._rec_extra is not None:
                self._rec_sends(ok_s[None], None, src_s[None], sd[None],
                                tmsg_s[None], (tmsg_s + flight_s)[None])
        return (mrel[None], msrc[None], mpay[None], overflow_step[None],
                bad_dst_step, bad_delay_step[None], short_step[None],
                route_drop_step[None], kept[None], sent_hash)

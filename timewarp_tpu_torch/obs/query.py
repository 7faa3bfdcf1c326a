"""Causal queries over a recorded flight log: "why was this message
delivered at t?" (copy of ``timewarp_tpu/obs/query.py`` over the port's
``obs/flight.py`` ``FlightLog``).

Given a :class:`~timewarp_tpu_torch.obs.flight.FlightLog` (decoded from a
run, or loaded back from the JSONL event log), :func:`explain_delivery`
reconstructs one delivery's causal chain:

1. **the send** that produced it — joined on ``(dst, deliver_t)``
   refined by ``src`` (``inbox_src=False`` scenarios elide the source
   at delivery — all interpreters present 0 — so the deliver event's
   src is 0 and the join falls back to ``(dst, deliver_t)``; a
   deliveries-only log has no send events at all, and the chain says
   so rather than guessing);
2. **every fault window that acted on it along the way** — ``defer``
   events for the destination between send and consumption (a crash
   window slid the node's firing), cross-referenced against the
   :class:`~timewarp_tpu_torch.faults.schedule.FaultSchedule` itself:
   ``LinkWindow`` degradations covering the send instant (with the
   exact rational transform), ``NodeCrash`` windows of the
   destination overlapping the flight, ``ClockSkew`` on either end;
3. **the delivery** — due instant vs the superstep instant it was
   actually consumed at (a gap is deferral evidence even in a
   deliveries-only log).

:func:`add_flight_flows` draws the chains onto the Perfetto
virtual-time timeline as flow arrows (send→deliver across node
tracks, obs/perfetto.py).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .flight import EV_DELIVER, EV_FAULT, EV_SEND, TAG_DEFER, FlightLog

__all__ = ["explain_delivery", "find_deliveries", "chain_lines",
           "add_flight_flows"]


def find_deliveries(log: FlightLog, *, dst: int,
                    t_us: Optional[int] = None,
                    src: Optional[int] = None) -> List[int]:
    """Indices of deliver events matching the query, in log order."""
    m = (log.kind == EV_DELIVER) & (log.dst == dst)
    if t_us is not None:
        m &= log.t == t_us
    if src is not None:
        m &= log.src == src
    return [int(i) for i in np.nonzero(m)[0]]


def _schedule(faults):
    if faults is None:
        return None
    if isinstance(faults, str):
        from ..faults.schedule import parse_faults
        return parse_faults(faults)
    return faults


def explain_delivery(log: FlightLog, *, dst: int,
                     t_us: Optional[int] = None, nth: int = 0,
                     src: Optional[int] = None,
                     faults=None) -> dict:
    """Reconstruct one delivery's causal chain (module docstring).
    ``dst`` + optional ``t_us``/``src`` select the delivery (``nth``
    among the matches); ``faults`` (a FaultSchedule or a ``--faults``
    grammar string) enables the schedule cross-reference. Raises
    ``ValueError`` naming what WAS found when nothing matches —
    never an empty chain."""
    hits = find_deliveries(log, dst=dst, t_us=t_us, src=src)
    if not hits:
        total = int((log.kind == EV_DELIVER).sum())
        raise ValueError(
            f"no delivery to node {dst}"
            + (f" at t={t_us}" if t_us is not None else "")
            + (f" from {src}" if src is not None else "")
            + f" in this log ({total} deliveries total"
            + (f", {log.dropped} events dropped over record_cap —"
               " raise it and re-record" if log.dropped else "")
            + ")")
    if nth >= len(hits):
        raise ValueError(
            f"delivery #{nth} to node {dst} out of range — the log "
            f"holds {len(hits)} matching deliveries")
    i = hits[nth]
    d_src, d_dst = int(log.src[i]), int(log.dst[i])
    d_t = int(log.t[i])           # the message's DUE instant
    d_tsup = int(log.t_sup[i])    # the superstep that consumed it
    chain: List[dict] = []

    # 1. the producing send — (dst, deliver_t) join, src-refined when
    # the scenario carries sources (inbox_src)
    sm = (log.kind == EV_SEND) & (log.dst == d_dst) & (log.t == d_t)
    if d_src != 0:
        sm_ref = sm & (log.src == d_src)
        if sm_ref.any():
            sm = sm_ref
    si = np.nonzero(sm)[0]
    send_t = None
    if si.size:
        j = int(si[0])
        send_t = int(log.send_t[j])
        chain.append({"step": "send", "src": int(log.src[j]),
                      "dst": d_dst, "t_us": send_t,
                      "deliver_t_us": d_t,
                      "flight_us": d_t - send_t,
                      "superstep": int(log.superstep[j]),
                      "ambiguous": int(si.size) > 1})
    else:
        chain.append({"step": "send", "unknown": True,
                      "why": "no matching send event — the log was "
                             "recorded with record='deliveries' "
                             "(sends need record='full'), or the "
                             "send predates the recorded span"})

    # 2. fault windows that acted on the message, from the schedule…
    sched = _schedule(faults)
    if sched is not None:
        for w in sched.link_windows:
            # send_t is only known when a send event matched (si
            # non-empty), so the src refinement reads that event
            s_ok = w.src is None or (send_t is not None
                                     and int(log.src[int(si[0])])
                                     in w.src)
            d_ok = w.dst is None or d_dst in w.dst
            in_w = send_t is not None \
                and w.t_start <= send_t < w.t_end
            if s_ok and d_ok and in_w:
                chain.append({
                    "step": "degrade",
                    "window": [int(w.t_start), int(w.t_end)],
                    "scale": w.scale, "extra_us": int(w.extra_us),
                    "detail": f"LinkWindow [{w.t_start}, {w.t_end}) "
                              f"transformed the sampled delay "
                              f"(×{w._num}/{w._den} + {w.extra_us} "
                              "µs)"})
        for c in sched.crashes:
            if c.node != d_dst:
                continue
            lo = send_t if send_t is not None else d_t
            if c.t_down < max(d_t, d_tsup) and c.t_up > lo:
                chain.append({
                    "step": "crash_window", "node": c.node,
                    "window": [int(c.t_down), int(c.t_up)],
                    "reset": bool(c.reset_state),
                    "detail": f"NodeCrash({c.node}) "
                              f"[{c.t_down}, {c.t_up}) overlapped "
                              "the flight — deliveries inside drop; "
                              "pending events slide to t_up"})
        for s in sched.skews:
            if s.node == d_dst and s.offset_us:
                chain.append({
                    "step": "skew", "node": s.node,
                    "offset_us": int(s.offset_us),
                    "detail": f"ClockSkew({s.node}) shifts the "
                              "node's VIEW of time; true-time "
                              "delivery is unaffected"})

    # …and from the log itself: defer events for the destination
    # between send and consumption (each crash superstep re-records
    # the slide, so dedup on the deferred-to instant)
    lo = send_t if send_t is not None else d_t
    dm = ((log.kind == EV_FAULT) & (log.tag == TAG_DEFER)
          & (log.dst == d_dst) & (log.t_sup >= lo)
          & (log.send_t <= d_tsup))
    seen = set()
    for j in np.nonzero(dm)[0]:
        key = int(log.t[j])
        if key in seen:
            continue
        seen.add(key)
        chain.append({"step": "defer", "node": d_dst,
                      "from_t_us": int(log.send_t[j]),
                      "to_t_us": key,
                      "detail": f"node {d_dst}'s pending event slid "
                                f"{int(log.send_t[j])} -> {key} "
                                "(crash window)"})

    # 3. the delivery
    chain.append({"step": "deliver", "src": d_src, "dst": d_dst,
                  "t_us": d_t, "consumed_t_us": d_tsup,
                  "superstep": int(log.superstep[i]),
                  "deferred_us": max(d_tsup - d_t, 0)})
    return {"dst": d_dst, "src": d_src, "t_us": d_t,
            "send_t_us": send_t, "chain": chain}


def chain_lines(result: dict) -> List[str]:
    """Human rendering of an :func:`explain_delivery` result — one
    line per chain step (the ``explain`` CLI's text output)."""
    out = []
    for step in result["chain"]:
        kind = step["step"]
        if kind == "send" and step.get("unknown"):
            out.append(f"send    ? {step['why']}")
        elif kind == "send":
            amb = " (ambiguous join: several sends share this "\
                  "deliver instant)" if step.get("ambiguous") else ""
            out.append(
                f"send    {step['src']} -> {step['dst']} at "
                f"t={step['t_us']} (flight {step['flight_us']} µs, "
                f"superstep {step['superstep']}){amb}")
        elif kind == "degrade":
            out.append(f"degrade {step['detail']}")
        elif kind == "crash_window":
            out.append(f"crash   {step['detail']}")
        elif kind == "defer":
            out.append(f"defer   {step['detail']}")
        elif kind == "skew":
            out.append(f"skew    {step['detail']}")
        elif kind == "deliver":
            extra = (f", consumed at t={step['consumed_t_us']} "
                     f"(+{step['deferred_us']} µs deferred)"
                     if step["deferred_us"] else "")
            out.append(
                f"deliver {step['src']} -> {step['dst']} due at "
                f"t={step['t_us']} (superstep {step['superstep']}"
                f"){extra}")
    return out


def add_flight_flows(tb, log: FlightLog, *, limit: int = 512,
                     dst: Optional[int] = None) -> int:
    """Draw send→deliver flow arrows onto a TraceBuilder's
    virtual-time timeline (obs/perfetto.py ``flow_arrow``): every
    full-mode send event becomes an arrow from its source node track
    at the send instant to the destination track at the deliver
    instant. ``limit`` bounds the arrow count (a dense log would
    drown the view — the skipped count is returned alongside via the
    builder's instant marker, never silent)."""
    sm = log.kind == EV_SEND
    if dst is not None:
        sm &= log.dst == dst
    idx = np.nonzero(sm)[0]
    n = 0
    for j in idx[:limit]:
        tb.flow_arrow("msg", int(log.src[j]), int(log.send_t[j]),
                      int(log.dst[j]), int(log.t[j]), flow_id=int(j))
        n += 1
    if idx.size > limit:
        tb.instant(f"flight flows truncated: {idx.size - limit} of "
                   f"{idx.size} arrows skipped (limit={limit})")
    return n

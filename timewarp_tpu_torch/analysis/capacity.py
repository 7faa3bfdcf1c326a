"""Static capacity proofs: worst-case mailbox fan-in vs ``mailbox_cap``
(copy of ``timewarp_tpu/analysis/capacity.py`` over the port's link
models and fault schedules).

Determinism contract #6 (core/scenario.py) makes overflow *counted and
dropped, never silent* — but a parity run must keep the counter at 0,
and a scenario whose topology makes overflow inevitable should be
rejected before any superstep runs, not discovered as a nonzero
``EngineState.overflow`` after a million-node run.

For ``static_dst`` scenarios the communication graph is fully known at
build time, so the worst case is computable exactly: the maximum
in-degree counted in outbox-slot edges is the number of messages that
can land co-temporally on one node in a single superstep wave (every
in-neighbor fires at the same instant and each declared slot sends).
A superstep delivers before it inserts, so ``mailbox_cap`` must absorb
at least one full wave; in-degree > cap is *provable* overflow —
an error. Dynamic-destination scenarios can't be proved either way
statically; they get the trivially sound ``n_nodes × max_out`` bound
reported (info) so the author sees what a flood could do.

``static_dst`` entries are also range-checked against ``[-1, n_nodes)``
(-1 = slot never used): an out-of-range declaration would make the
edge-engine topology inversion (edge_engine.py ``EdgeTopology.build``)
raise later with less context, and silently count as ``bad_dst`` on
the general engine.

**Fault-aware proofs (TW205/TW206).** The single-wave proof above is
about the fault-free graph; a fault schedule changes the worst case in
one way a static analysis can still bound: a ``degrade`` window whose
``scale`` stretches delays *widens the arrival spread* of the messages
sent inside it, so sends from several distinct supersteps of one
sender compress into one post-window arrival superstep — the deferred
deliveries "pile up". :func:`lint_capacity_faulted` recomputes the
worst-case co-temporal fan-in under the schedule: per degrade row the
number of send-supersteps whose messages can land inside one arrival
window of width ``W`` is ``1 + (degraded_spread - base_spread) // W``
(capped by how many supersteps the degrade window even contains),
applied per matching edge, with relief for senders provably dark for
the whole window (crashed, or partitioned away from the receiver) and
receivers provably down across the entire arrival span (down-node
deliveries are dropped, faults/apply.py). ``extra_us``-only rows and
``scale <= 1`` rows shift or shrink delays without widening the
spread — no pileup, no finding. The proof needs an upper delay bound;
link models without one (``FnDelay``) take the window-length cap.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from ..core.scenario import Scenario
from .report import ERROR, INFO, Finding, LintReport

__all__ = ["lint_capacity", "worst_case_fan_in",
           "lint_capacity_faulted", "max_delay_us"]


def worst_case_fan_in(sc: Scenario):
    """``(fan_in, node)`` — the provable worst-case number of messages
    landing co-temporally on one node for a ``static_dst`` scenario, or
    ``(n_nodes * max_out, None)`` as the sound bound for dynamic
    destinations."""
    if sc.static_dst is None:
        return sc.n_nodes * sc.max_out, None
    sd = np.asarray(sc.static_dst)
    used = (sd >= 0) & (sd < sc.n_nodes)
    if not used.any():
        return 0, None
    deg = np.bincount(sd[used].astype(np.int64).ravel(),
                      minlength=sc.n_nodes)
    node = int(deg.argmax())
    return int(deg[node]), node


def lint_capacity(sc: Scenario) -> LintReport:
    rep = LintReport()
    name, K = sc.name, sc.mailbox_cap

    if sc.static_dst is None:
        bound = sc.n_nodes * sc.max_out
        rep.add(Finding(
            "TW203", INFO, name,
            f"dynamic destinations: worst-case co-temporal fan-in is "
            f"only boundable as n_nodes*max_out = {bound} "
            f"(mailbox_cap={K}); overflow is counted at run time "
            "(EngineState.overflow), not provable statically"))
        return rep

    sd = np.asarray(sc.static_dst)
    # shape is validated by Scenario.__post_init__; re-derive defensively
    # so a hand-built scenario bypassing the dataclass still lints
    if sd.shape != (sc.n_nodes, sc.max_out):
        rep.add(Finding(
            "TW201", ERROR, name,
            f"static_dst shape {sd.shape} != (n_nodes, max_out) = "
            f"({sc.n_nodes}, {sc.max_out})"))
        return rep

    bad = (sd < -1) | (sd >= sc.n_nodes)
    if bad.any():
        i, k = map(int, np.argwhere(bad)[0])
        rep.add(Finding(
            "TW201", ERROR, name,
            f"static_dst contains {int(bad.sum())} out-of-range "
            f"entr{'y' if bad.sum() == 1 else 'ies'} (first: "
            f"[{i}, {k}] = {int(sd[i, k])}); destinations must lie in "
            f"[-1, {sc.n_nodes}) with -1 = slot never used"))

    fan_in, node = worst_case_fan_in(sc)
    if fan_in > K:
        rep.add(Finding(
            "TW202", ERROR, name,
            f"provable mailbox overflow: node {node} has static "
            f"in-degree {fan_in} (outbox-slot edges) > "
            f"mailbox_cap={K}; one co-temporal firing wave of its "
            f"senders must drop {fan_in - K} message(s). Raise "
            f"mailbox_cap to >= {fan_in} or thin the topology"))
    else:
        rep.add(Finding(
            "TW204", INFO, name,
            f"static capacity proof: worst-case co-temporal fan-in "
            f"{fan_in} (node {node}) <= mailbox_cap={K}; a single "
            "superstep wave can never overflow"))
    return rep


# ---------------------------------------------------------------------------
# fault-aware proofs (TW205/TW206)
# ---------------------------------------------------------------------------

def max_delay_us(link) -> Optional[int]:
    """A static upper bound on ``link``'s sampled delay, or None when
    the model declares none (``FnDelay``, unknown classes). The dual of
    the declared ``min_delay_us``: heavy-tail models clamp at
    ``cap_us`` (net/delays.py), so every shipped model is bounded."""
    name = type(link).__name__
    if name == "FixedDelay":
        return int(link.delay)
    if name == "UniformDelay":
        return int(link.hi)
    if name in ("LogNormalDelay", "ParetoDelay"):
        return int(link.cap_us)
    if name == "SeededHashUniform":
        return int(link.hi_us)
    if name == "WithDrop":
        return max_delay_us(link.inner)
    if name == "Quantize":
        m = max_delay_us(link.inner)
        if m is None:
            return None
        q = int(link.quantum_us)
        # sample clamps to [min, cap] BEFORE rounding up to the grid
        return ((max(m, 1) + q - 1) // q) * q
    return None


def _window_fold(lw, base_min: int, base_max: Optional[int],
                 window: int) -> int:
    """How many distinct send-supersteps one degrade row can compress
    into a single arrival superstep (module docstring). 1 = no pileup
    beyond the fault-free single wave."""
    length = int(lw.t_end) - int(lw.t_start)
    if length <= 0:
        return 1                      # inert (padding) row
    W = max(1, int(window))
    # supersteps are at least W of virtual time apart (windowed
    # execution), so the degrade window spans at most this many
    # distinct send instants per sender
    sends_cap = max(1, math.ceil(length / W))
    if base_max is None:
        return sends_cap              # unbounded link: worst case
    d_min = max(1, (int(base_min) * lw._num) // lw._den + lw.extra_us)
    d_max = (int(base_max) * lw._num) // lw._den + lw.extra_us
    base_spread = max(0, int(base_max) - int(base_min))
    spread = max(0, d_max - d_min)
    # only the spread GROWTH vs the fault-free link compresses extra
    # send-supersteps into one arrival window (extra_us shifts, and
    # scale <= 1 shrinks — neither widens)
    return min(sends_cap, 1 + max(0, spread - base_spread) // W)


def _covering(events, t_lo: int, t_hi: int, lo, hi) -> set:
    """Node ids from ``events`` whose [lo(e), hi(e)) window covers the
    whole of ``[t_lo, t_hi)``."""
    return {e.node for e in events
            if lo(e) <= t_lo and hi(e) >= t_hi}


def lint_capacity_faulted(sc: Scenario, faults, link,
                          window: int, *,
                          subject: Optional[str] = None) -> LintReport:
    """Fault-aware static capacity proof (module docstring): prove
    ``mailbox_cap`` absorbs the worst-case co-temporal fan-in *under
    the fault schedule*, or name the violating degrade window and
    node (TW205 error / TW206 info proof). ``faults`` is a
    FaultSchedule or FaultFleet (every world's schedule is proved;
    the first violation is reported tagged with its world)."""
    rep = LintReport()
    name = subject or sc.name
    if sc.static_dst is None or faults is None:
        return rep                    # TW203 already reported the bound
    scheds = faults.schedules if hasattr(faults, "schedules") \
        else (faults,)
    K = sc.mailbox_cap
    sd = np.asarray(sc.static_dst)
    if sd.shape != (sc.n_nodes, sc.max_out):
        return rep                    # TW201 already errored
    used = (sd >= 0) & (sd < sc.n_nodes)
    if not used.any():
        return rep
    src_of = np.broadcast_to(
        np.arange(sc.n_nodes)[:, None], sd.shape)[used].ravel()
    dst_of = sd[used].astype(np.int64).ravel()
    base_deg = np.bincount(dst_of, minlength=sc.n_nodes)
    base_min = int(link.min_delay_us)
    base_max = max_delay_us(link)

    worst = (int(base_deg.max()), int(base_deg.argmax()), None, 1)
    violation = None
    windows = 0
    for b, sched in enumerate(scheds):
        tag = f"{name}[world {b}]" if len(scheds) > 1 else name
        for lw in sched.link_windows:
            if lw.t_end <= lw.t_start:
                continue
            windows += 1
            fold = _window_fold(lw, base_min, base_max, window)
            if fold <= 1:
                continue
            # the folded senders: matched by the row's src set, minus
            # senders provably dark for the WHOLE window (crashed, or
            # partitioned away from every receiver — handled per-edge
            # below for partitions)
            dark = _covering(sched.crashes, lw.t_start, lw.t_end,
                             lambda c: c.t_down, lambda c: c.t_up)
            in_src = np.ones(sc.n_nodes, bool) if lw.src is None \
                else np.isin(np.arange(sc.n_nodes), list(lw.src))
            if dark:
                in_src &= ~np.isin(np.arange(sc.n_nodes), list(dark))
            edge_fold = in_src[src_of]
            if lw.dst is not None:
                edge_fold &= np.isin(dst_of, list(lw.dst))
            # partition relief: an edge cut for the whole degrade
            # window sends nothing across it during the window
            for part in sched.partitions:
                if part.t_start <= lw.t_start \
                        and part.t_end >= lw.t_end:
                    gid = np.full(sc.n_nodes, -1)
                    for gi, g in enumerate(part.groups):
                        for i in g:
                            if i < sc.n_nodes:
                                gid[i] = gi
                    cut = (gid[src_of] >= 0) & (gid[dst_of] >= 0) \
                        & (gid[src_of] != gid[dst_of])
                    edge_fold &= ~cut
            deg = base_deg + np.bincount(
                dst_of[edge_fold], minlength=sc.n_nodes) * (fold - 1)
            # receiver relief: a node down across the entire arrival
            # span never enqueues these deliveries (down-node drops
            # are counted as fault_dropped, faults/apply.py)
            if base_max is not None:
                d_min = max(1, (base_min * lw._num) // lw._den
                            + lw.extra_us)
                d_max = (base_max * lw._num) // lw._den + lw.extra_us
                down = _covering(sched.crashes,
                                 lw.t_start + d_min, lw.t_end + d_max,
                                 lambda c: c.t_down, lambda c: c.t_up)
                for r in down:
                    if r < sc.n_nodes:
                        deg[r] = 0
            node = int(deg.argmax())
            fan = int(deg[node])
            if fan > worst[0]:
                worst = (fan, node, lw, fold)
            if fan > K and violation is None:
                violation = (tag, fan, node, lw, fold)
    if violation is not None:
        tag, fan, node, lw, fold = violation
        rep.add(Finding(
            "TW205", ERROR, tag,
            f"provable mailbox overflow under the fault schedule: "
            f"degrade window [{lw.t_start}, {lw.t_end}) (scale "
            f"{lw.scale}, +{lw.extra_us}us) defers deliveries from "
            f"up to {fold} send-supersteps into one post-window "
            f"arrival wave — node {node} takes worst-case fan-in "
            f"{fan} > mailbox_cap={K}. Raise mailbox_cap to >= {fan}, "
            "shorten/weaken the degrade window, or widen the window "
            "so fewer send instants fit inside it"))
    elif windows:
        fan, node, lw, fold = worst
        at = "" if lw is None else (
            f" (tightest: degrade [{lw.t_start}, {lw.t_end}) folding "
            f"{fold} send-supersteps onto node {node})")
        rep.add(Finding(
            "TW206", INFO, name,
            f"fault-aware capacity proof: worst-case co-temporal "
            f"fan-in stays {fan} <= mailbox_cap={K} under all "
            f"{windows} degrade window(s){at}; restarts purge and "
            "partitions only cut — neither grows a wave"))
    return rep

"""Fault masks in torch: ``(FaultTables, virtual time) -> masks`` (port
of ``timewarp_tpu/faults/apply.py``).

Every function here is elementwise/broadcast torch over the fixed-shape
tables of :mod:`timewarp_tpu_torch.faults.schedule`, held as tensors by
:func:`device_tables`. Each takes tables with or without a leading world
axis B (a :class:`~timewarp_tpu_torch.faults.schedule.FaultFleet`'s
stacked tables, or one schedule's): with it, every other operand carries
the same leading axis (or 1, broadcast) and so does the result. The
reference maps the solo function over the fleet with ``vmap``; here the
world axis is spelled out, so one launch serves every world. Zero-row
tables short-circuit on their static shape, as in the reference.

The one piece of *state* faults need is ``restart_done: bool[C]`` —
whether each crash row's injected restart firing has been consumed.
Everything else is a pure function of the schedule and the clock.
"""

from __future__ import annotations

import torch

from ..core.scenario import NEVER
from .schedule import FaultTables

__all__ = [
    "device_tables", "defer_next", "restart_fire", "consume_restarts",
    "cut_mask", "down_mask", "degrade", "skewed_step", "window_floor",
]


def device_tables(tables: FaultTables, device) -> FaultTables:
    """The numpy tables of ``FaultSchedule.tables`` / ``FaultFleet.tables``
    as tensors on ``device``, dtypes kept (int32, int64, bool)."""
    return FaultTables(*(torch.as_tensor(x).to(device) for x in tables))


def _worlds(ft: FaultTables):
    """``(tables with a leading world axis, solo)``: a solo schedule's
    tables gain a world axis of 1, and ``solo`` says to drop it from the
    result."""
    if ft.crash_node.dim() == 2:
        return ft, False
    return FaultTables(*(x.unsqueeze(0) for x in ft)), True


def _lead(x, solo: bool):
    """An operand in world form: a solo call's operands gain the axis."""
    x = torch.as_tensor(x)
    return x.unsqueeze(0) if solo else x


def _flat(B: int, *xs):
    """Broadcast world-form operands to one ``[B, ...]`` shape and flatten
    each to ``[B, L]`` lanes; returns ``(shape, flats)``."""
    bs = torch.broadcast_tensors(*xs)
    shape = (B,) + tuple(bs[0].shape[1:])
    return shape, tuple(b.expand(shape).reshape(B, -1) for b in bs)


def _active(ft):
    return ft.crash_up > ft.crash_down            # [B, C] (inert rows off)


def _crash_rows(ft, node):
    """``[B, C, L]``: crash row c is live and names lane l's node."""
    return (ft.crash_node[:, :, None] == node[:, None, :]) \
        & _active(ft)[:, :, None]


def defer_next(ft, node_ids, node_next, restart_done):
    """Crash-adjusted next-event times: an event inside the node's down
    window slides to ``t_up``, and every unconsumed ``reset_state`` row
    injects a restart firing at exactly ``t_up``. ``node_ids`` int32
    ``[N]``, ``node_next`` int64 ``[(B,) N]``, ``restart_done`` bool
    ``[(B,) C]``."""
    if ft.crash_node.shape[-1] == 0:
        return node_next
    ft, solo = _worlds(ft)
    x = _lead(node_next, solo)                              # [B, N]
    done = _lead(restart_done, solo)
    m = _crash_rows(ft, node_ids.view(1, -1))               # [B, C, N]
    down, up = ft.crash_down[:, :, None], ft.crash_up[:, :, None]
    xx = x[:, None, :]
    inwin = m & (down <= xx) & (xx < up)
    deferred = torch.where(inwin, up, xx).amax(dim=1)
    pend = m & ft.crash_reset[:, :, None] & ~done[:, :, None]
    inject = torch.where(pend, up, NEVER).amin(dim=1)
    out = torch.minimum(deferred, inject)
    return out[0] if solo else out


def restart_fire(ft, fire, now_vec, node_ids, restart_done):
    """The restart firings happening *this* superstep: a fired node whose
    instant equals an unconsumed reset row's ``t_up``. Returns
    ``(reset_now bool[(B,) N], purge_before int64[(B,) N])``."""
    n = node_ids.shape[0]
    if ft.crash_node.shape[-1] == 0:
        shape = tuple(fire.shape)
        return (torch.zeros(shape, dtype=torch.bool, device=fire.device),
                torch.zeros(shape, dtype=torch.int64, device=fire.device))
    ft, solo = _worlds(ft)
    hit = _hits(ft, _lead(fire, solo), _lead(now_vec, solo),
                node_ids.view(1, n)) & ~_lead(restart_done, solo)[:, :, None]
    reset_now = hit.any(dim=1)
    purge_before = torch.where(hit, ft.crash_down[:, :, None], 0).amax(dim=1)
    if solo:
        return reset_now[0], purge_before[0]
    return reset_now, purge_before


def _hits(ft, fire, now_vec, node_ids):
    """``[B, C, N]``: a reset row's node fires at exactly its ``t_up``."""
    return _crash_rows(ft, node_ids) & ft.crash_reset[:, :, None] \
        & fire[:, None, :] & (now_vec[:, None, :] == ft.crash_up[:, :, None])


def consume_restarts(ft, fire, now_vec, node_ids, restart_done):
    """``restart_done`` after this superstep: a row is consumed when its
    node fires at exactly its ``t_up``."""
    if ft.crash_node.shape[-1] == 0:
        return restart_done
    ft, solo = _worlds(ft)
    hit = _hits(ft, _lead(fire, solo), _lead(now_vec, solo),
                node_ids.view(1, -1))
    out = _lead(restart_done, solo) | hit.any(dim=2)
    return out[0] if solo else out


def cut_mask(ft, src, dst, t_send):
    """True where a message crosses a live partition cut: some partition
    row active at the *send instant* puts src and dst in different
    (non-absent) groups. Operands broadcast; out-of-range ids must be
    pre-masked by the caller (clipped here only for gather safety)."""
    wt, solo = _worlds(ft)
    B = wt.crash_node.shape[0]
    shape, (s, d, t) = _flat(B, *(_lead(x, solo) for x in (src, dst,
                                                            t_send)))
    if wt.part_group.shape[1] == 0:
        out = torch.zeros(shape, dtype=torch.bool, device=s.device)
    else:
        Pn, n = wt.part_group.shape[1], wt.part_group.shape[2]
        L = s.shape[1]

        def group(x):
            idx = x.clamp(0, n - 1).long()[:, None, :].expand(B, Pn, L)
            return wt.part_group.gather(2, idx)             # [B, Pn, L]
        gs, gd = group(s), group(d)
        tt = t[:, None, :]
        act = (wt.part_start[:, :, None] <= tt) \
            & (tt < wt.part_end[:, :, None])
        cut = act & (gs != gd) & (gs >= 0) & (gd >= 0)
        out = cut.any(dim=1).reshape(shape)
    return out[0] if solo else out


def down_mask(ft, node, t):
    """True where ``node`` is inside a crash window at time ``t`` — the
    routing stage drops messages whose *deliver* time lands in the
    destination's down window (the NIC is off)."""
    wt, solo = _worlds(ft)
    B = wt.crash_node.shape[0]
    shape, (nd, tt) = _flat(B, _lead(node, solo), _lead(t, solo))
    if wt.crash_node.shape[1] == 0:
        out = torch.zeros(shape, dtype=torch.bool, device=nd.device)
    else:
        win = (wt.crash_down[:, :, None] <= tt[:, None, :]) \
            & (tt[:, None, :] < wt.crash_up[:, :, None])
        out = (_crash_rows(wt, nd) & win).any(dim=1).reshape(shape)
    return out[0] if solo else out


def degrade(ft, delay, src, dst, t_send):
    """Apply every live link-degradation window to the sampled delays:
    ``delay' = (delay * num) // den + extra`` for affected messages. Rows
    compose in table order. Integer arithmetic throughout: bit-exact on
    every backend."""
    L = ft.link_start.shape[-1]
    if L == 0:
        return delay
    wt, solo = _worlds(ft)
    B = wt.crash_node.shape[0]
    shape, (dl, s, d, t) = _flat(B, *(_lead(x, solo) for x in (
        delay, src, dst, t_send)))
    n = wt.link_src.shape[-1]
    sc, dc = s.clamp(0, n - 1).long(), d.clamp(0, n - 1).long()
    for i in range(L):
        aff = (wt.link_start[:, i, None] <= t) & (t < wt.link_end[:, i, None]) \
            & wt.link_src[:, i, :].gather(1, sc) \
            & wt.link_dst[:, i, :].gather(1, dc)
        dl = torch.where(
            aff, torch.div(dl * wt.link_num[:, i, None],
                           wt.link_den[:, i, None], rounding_mode="floor")
            + wt.link_add[:, i, None], dl)
    out = dl.reshape(shape)
    return out[0] if solo else out


def window_floor(ft, t, w_req, base_floor: int):
    """Effective exact superstep window at instant ``t`` for a requested
    width ``w_req``: the degraded delay floor over sends in ``[t, t +
    w_req)``, clamped to ``[1, w_req]`` (the reference's greedy fold over
    the rows whose window overlaps that span; inert pad rows never
    match). With world tables ``t`` is ``[B]`` and so is the result.
    ``TorchEngine`` calls this every superstep of a controlled or
    speculative chunk (its bound then the undegraded floor), so only the
    supersteps a degradation window overlaps run narrow; a static faulted
    engine runs at the schedule-wide degraded floor instead. Device
    tensors throughout: no host sync."""
    L = ft.link_start.shape[-1]
    t = torch.as_tensor(t, dtype=torch.int64)
    w = torch.as_tensor(w_req, dtype=torch.int64, device=t.device)
    f = torch.full_like(t, int(base_floor))
    for i in range(L):
        start, end = ft.link_start[..., i], ft.link_end[..., i]
        live = (end > start) & (start < t + w) & (end > t)
        fi = torch.clamp(torch.div(f * ft.link_num[..., i],
                                   ft.link_den[..., i],
                                   rounding_mode="floor")
                         + ft.link_add[..., i], min=1)
        f = torch.where(live, torch.minimum(f, fi), f)
    return torch.minimum(torch.clamp(w, min=1), torch.clamp(f, min=1))


def skewed_step(step, skew):
    """Wrap a scenario step so each node observes skewed time: ``now``
    and (valid) inbox deliver times shift by its offset; the returned
    wake shifts back to true time (NEVER stays NEVER). ``skew`` is int64
    ``[N]`` indexed by node id, or ``[B, N]`` for a fleet whose nodes the
    step sees flattened world-major (``B·N`` lanes, in-world ids)."""
    def wrapped(state, inbox, now, node_ids, key):
        ids = node_ids.long()
        off = skew[ids] if skew.dim() == 1 else \
            skew.gather(1, ids.view(skew.shape[0], -1)).reshape(-1)
        ib = inbox._replace(
            time=torch.where(inbox.valid, inbox.time + off, inbox.time))
        st, out, wake = step(state, ib, now + off, node_ids, key)
        wake = torch.where(wake >= NEVER, wake, wake - off)
        return st, out, wake
    return wrapped

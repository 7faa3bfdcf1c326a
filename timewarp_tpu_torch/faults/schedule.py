"""Fault schedules: declarative, fixed-shape, validated at construction
(a copy of ``timewarp_tpu/faults/schedule.py``: numpy only, kept here so
the port imports nothing of the reference).

A :class:`FaultSchedule` is a static list of fault events — known from
t=0, like the reference's seeded ``Delays`` function was — lowered to
a :class:`FaultTables` pytree of fixed-shape int64-µs event tables the
engines can close over (solo) or ``vmap`` a leading world axis through
(:class:`FaultFleet`). Nothing here is sampled at run time: the same
schedule produces the same masks in every interpreter, which is what
keeps chaos runs inside the oracle ≡ engine parity law.

Event semantics (normative statement in docs/faults.md):

- :class:`NodeCrash` ``(node, t_down, t_up, reset_state)`` — the node
  cannot fire at any instant in ``[t_down, t_up)``; its pending events
  inside the window slide to ``t_up``; messages that would be
  *delivered* inside the window are dropped at routing time (the NIC
  is off) and counted in ``fault_dropped``. With ``reset_state`` the
  node also reboots: a restart firing is injected at exactly ``t_up``,
  the node's state re-initializes to ``Scenario.init``'s state, and
  mailbox entries older than ``t_down`` are purged (memory loss) —
  in-flight messages due at or after ``t_up`` survive (they were in
  the network, not the node).
- :class:`Partition` ``(groups, t_start, t_end)`` — while live at a
  message's *send instant*, a message whose source and destination sit
  in different groups is dropped (and counted). Nodes in no group are
  unaffected.
- :class:`LinkWindow` ``(src, dst, t_start, t_end, scale, extra_us)`` —
  degradation: messages sent inside the window from a ``src`` node to
  a ``dst`` node have their sampled delay transformed
  ``delay' = (delay * num) // den + extra_us`` (``scale`` is held as
  the exact integer rational ``num/den``, so the transform is
  bit-exact on every backend). Rows compose in declaration order.
- :class:`ClockSkew` ``(node, offset_us)`` — the node's *view* of time
  (the ``now`` and inbox times its step function sees) is shifted by
  ``offset_us``; returned wake times are shifted back. Engine
  internals (entropy keys, digests, fault windows) stay on true time.

All times are int64 µs and validated eagerly. The scenario-dependent
checks (node ranges, overlapping crash windows, …) are the TW5xx lint
rules (analysis/fault_lint.py), which the engines run under their
``lint`` knob: an event naming an out-of-range node lowers to an inert
row here, as in the reference, and TW501 names it.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np

from ..core.time import FOREVER

__all__ = [
    "NodeCrash", "Partition", "LinkWindow", "ClockSkew",
    "FaultSchedule", "FaultFleet", "FaultTables",
    "parse_faults", "format_faults", "FAULT_GRAMMAR",
]

#: ceiling every schedule time must stay under (NEVER arithmetic
#: headroom: a deferred event at t_up must still be < FOREVER)
_T_MAX = FOREVER // 2


def _t(us, what: str) -> int:
    if isinstance(us, bool) or not isinstance(us, (int, np.integer)):
        raise ValueError(f"{what} must be an int µs count, got {us!r}")
    v = int(us)
    if not -_T_MAX < v < _T_MAX:
        raise ValueError(f"{what}={v} outside the int64-µs schedule "
                         f"range (|t| < 2^61)")
    return v


def _node(i, what: str) -> int:
    if isinstance(i, bool) or not isinstance(i, (int, np.integer)) or i < 0:
        raise ValueError(f"{what} must be a node id >= 0, got {i!r}")
    return int(i)


@dataclass(frozen=True)
class NodeCrash:
    """Crash ``node`` for ``[t_down, t_up)``; ``reset_state`` reboots
    it (state loss + injected restart firing at ``t_up``)."""
    node: int
    t_down: int
    t_up: int
    reset_state: bool = False

    def __post_init__(self):
        object.__setattr__(self, "node", _node(self.node, "crash node"))
        object.__setattr__(self, "t_down", _t(self.t_down, "t_down"))
        object.__setattr__(self, "t_up", _t(self.t_up, "t_up"))
        if self.t_down < 0:
            raise ValueError(f"t_down={self.t_down} must be >= 0")
        object.__setattr__(self, "reset_state", bool(self.reset_state))


@dataclass(frozen=True)
class Partition:
    """Cut the network into ``groups`` (sequences of node ids) for
    ``[t_start, t_end)``. Cross-group messages *sent* while the cut is
    live are dropped; nodes in no group keep full connectivity."""
    groups: Tuple[Tuple[int, ...], ...]
    t_start: int
    t_end: int

    def __post_init__(self):
        gs = tuple(tuple(_node(i, "partition member") for i in g)
                   for g in self.groups)
        if len(gs) < 2:
            raise ValueError(
                f"a partition needs at least two groups, got {len(gs)} "
                "(one group cuts nothing)")
        for gi, g in enumerate(gs):
            if not g:
                raise ValueError(
                    f"partition group {gi} is empty — an empty side "
                    "cuts nothing (drop it, or name its members)")
        seen = set()
        for g in gs:
            for i in g:
                if i in seen:
                    raise ValueError(
                        f"node {i} appears in two partition groups")
                seen.add(i)
        object.__setattr__(self, "groups", gs)
        object.__setattr__(self, "t_start", _t(self.t_start, "t_start"))
        object.__setattr__(self, "t_end", _t(self.t_end, "t_end"))


@dataclass(frozen=True)
class LinkWindow:
    """Degrade messages from ``src`` nodes to ``dst`` nodes sent in
    ``[t_start, t_end)``: sampled delay becomes
    ``(delay * num) // den + extra_us``. ``src``/``dst`` are node-id
    sequences, or ``None`` for "all nodes"."""
    src: Optional[Tuple[int, ...]]
    dst: Optional[Tuple[int, ...]]
    t_start: int
    t_end: int
    scale: float = 1.0
    extra_us: int = 0

    def __post_init__(self):
        for name in ("src", "dst"):
            v = getattr(self, name)
            if v is not None:
                object.__setattr__(
                    self, name,
                    tuple(_node(i, f"link-window {name}") for i in v))
        object.__setattr__(self, "t_start", _t(self.t_start, "t_start"))
        object.__setattr__(self, "t_end", _t(self.t_end, "t_end"))
        object.__setattr__(self, "extra_us",
                           _t(self.extra_us, "extra_us"))
        if self.extra_us < 0:
            raise ValueError("extra_us must be >= 0 (a negative offset "
                             "could time-travel a message; shrink "
                             "delays with scale < 1 instead)")
        if not (isinstance(self.scale, (int, float))
                and not isinstance(self.scale, bool)) or self.scale <= 0:
            raise ValueError(f"scale must be a number > 0, "
                             f"got {self.scale!r}")
        # normalize to a plain float: np.float64 IS a float subclass,
        # but its repr ('np.float64(2.0)') would make format_faults
        # emit an unparseable grammar string — and numpy is exactly
        # where programmatic scales come from (link-param vectors)
        object.__setattr__(self, "scale", float(self.scale))
        # exact rational form: the engines transform integer delays as
        # (d * num) // den, identical on every backend
        fr = Fraction(self.scale).limit_denominator(1 << 20)
        object.__setattr__(self, "_num", fr.numerator)
        object.__setattr__(self, "_den", fr.denominator)


@dataclass(frozen=True)
class ClockSkew:
    """Shift ``node``'s view of time by ``offset_us`` (may be
    negative). Multiple skews on one node sum."""
    node: int
    offset_us: int

    def __post_init__(self):
        object.__setattr__(self, "node", _node(self.node, "skew node"))
        object.__setattr__(self, "offset_us",
                           _t(self.offset_us, "offset_us"))


class FaultTables(NamedTuple):
    """The lowered schedule: fixed-shape arrays the superstep masks
    are derived from (:mod:`timewarp_tpu_torch.faults.apply`). A plain
    pytree, so a leading world axis stacks/``vmap``s through it.

    Inert (padding) rows are windows with ``t_up <= t_down`` /
    ``t_end <= t_start`` — every mask guards on window non-emptiness,
    so padded and unpadded schedules are result-identical.
    """
    crash_node: Any    # int32[C]
    crash_down: Any    # int64[C]
    crash_up: Any      # int64[C]
    crash_reset: Any   # bool[C]
    part_group: Any    # int32[Pn, N]  (-1 = not in any group)
    part_start: Any    # int64[Pn]
    part_end: Any      # int64[Pn]
    link_src: Any      # bool[L, N]
    link_dst: Any      # bool[L, N]
    link_start: Any    # int64[L]
    link_end: Any      # int64[L]
    link_num: Any      # int64[L]
    link_den: Any      # int64[L]
    link_add: Any      # int64[L]
    skew: Any          # int64[N]


@dataclass(frozen=True)
class FaultSchedule:
    """An ordered collection of fault events (module docstring), plus
    the pad counts :class:`FaultFleet` uses to equalize table shapes
    across worlds (padding rows are inert — see
    :class:`FaultTables`)."""
    events: Tuple[Any, ...] = ()
    pad: Tuple[int, int, int] = (0, 0, 0)   # extra (crash, part, link) rows

    def __post_init__(self):
        evs = tuple(self.events)
        kinds = (NodeCrash, Partition, LinkWindow, ClockSkew)
        for e in evs:
            if not isinstance(e, kinds):
                raise ValueError(
                    f"fault events must be NodeCrash / Partition / "
                    f"LinkWindow / ClockSkew, got {e!r}")
        object.__setattr__(self, "events", evs)
        object.__setattr__(self, "pad", tuple(int(p) for p in self.pad))

    # -- views -----------------------------------------------------------

    def _of(self, kind):
        return [e for e in self.events if isinstance(e, kind)]

    @property
    def crashes(self) -> List[NodeCrash]:
        return self._of(NodeCrash)

    @property
    def partitions(self) -> List[Partition]:
        return self._of(Partition)

    @property
    def link_windows(self) -> List[LinkWindow]:
        return self._of(LinkWindow)

    @property
    def skews(self) -> List[ClockSkew]:
        return self._of(ClockSkew)

    @property
    def has_skew(self) -> bool:
        return any(s.offset_us for s in self.skews)

    @property
    def has_reset(self) -> bool:
        return any(c.reset_state for c in self.crashes)

    @property
    def n_restarts(self) -> int:
        """Rows of the restart-consumption state vector
        (``restart_done``), padding included — one slot per crash row
        (only active reset rows ever flip theirs)."""
        return len(self.crashes) + self.pad[0]

    def min_delay_floor(self, link_floor: int) -> int:
        """Conservative lower bound on any *degraded* delay given the
        link model's declared ``min_delay_us`` — what windowed
        execution must validate against (a shrink window can undercut
        the link's floor; never silently). Degradation rows compose in
        declaration order (apply.degrade), so the bound is the minimum
        over every *subset* of rows a message could match: each
        transform is monotone in its input, so the greedy fold
        ``x <- min(x, T_i(x))`` realizes that minimum exactly —
        overlapping shrink windows compound and the floor reflects it."""
        floor = int(link_floor)
        for lw in self.link_windows:
            if lw.t_end > lw.t_start:
                floor = min(floor, max(
                    1, (floor * lw._num) // lw._den + lw.extra_us))
        return max(1, floor)

    def min_delay_floor_in(self, link_floor: int, t_lo: int,
                           t_hi: int) -> int:
        """:meth:`min_delay_floor` restricted to degradation rows whose
        window overlaps ``[t_lo, t_hi)`` — the *per-window* link floor
        the online dispatch controller consumes (dispatch/): outside
        every degradation window the bound is the link's own floor, so
        a shrink window that undercuts the declared floor only narrows
        the supersteps it actually covers. Host mirror of the device
        clamp ``faults.apply.window_floor`` (same greedy fold, same
        overlap rule), used for *policy* only — exactness never
        depends on this query."""
        floor = int(link_floor)
        for lw in self.link_windows:
            if lw.t_end > lw.t_start and lw.t_start < t_hi \
                    and lw.t_end > t_lo:
                floor = min(floor, max(
                    1, (floor * lw._num) // lw._den + lw.extra_us))
        return max(1, floor)

    def padded(self, crashes: int, parts: int, links: int
               ) -> "FaultSchedule":
        """This schedule with table shapes grown to the given row
        counts (inert rows appended) — what :class:`FaultFleet` hands
        out as ``world_schedule(b)`` so every world's state shapes
        match."""
        c, p, li = len(self.crashes), len(self.partitions), \
            len(self.link_windows)
        if crashes < c or parts < p or links < li:
            raise ValueError("padded() cannot shrink a schedule")
        return FaultSchedule(self.events,
                             pad=(crashes - c, parts - p, links - li))

    # -- lowering ----------------------------------------------------------

    def tables(self, n_nodes: int) -> FaultTables:
        """Lower to fixed-shape numpy tables for ``n_nodes`` nodes.
        Events naming out-of-range nodes lower to inert/ignored rows
        (they can never match a live node id) — TW501 surfaces them."""
        n = int(n_nodes)
        cr = self.crashes
        C = len(cr) + self.pad[0]
        crash_node = np.zeros(C, np.int32)
        crash_down = np.zeros(C, np.int64)
        crash_up = np.zeros(C, np.int64)
        crash_reset = np.zeros(C, bool)
        for i, c in enumerate(cr):
            crash_node[i] = c.node
            crash_down[i] = c.t_down
            crash_up[i] = c.t_up
            crash_reset[i] = c.reset_state

        ps = self.partitions
        Pn = len(ps) + self.pad[1]
        part_group = np.full((Pn, n), -1, np.int32)
        part_start = np.zeros(Pn, np.int64)
        part_end = np.zeros(Pn, np.int64)
        for i, p in enumerate(ps):
            part_start[i] = p.t_start
            part_end[i] = p.t_end
            for g, members in enumerate(p.groups):
                for m in members:
                    if m < n:
                        part_group[i, m] = g

        lws = self.link_windows
        L = len(lws) + self.pad[2]
        link_src = np.zeros((L, n), bool)
        link_dst = np.zeros((L, n), bool)
        link_start = np.zeros(L, np.int64)
        link_end = np.zeros(L, np.int64)
        link_num = np.ones(L, np.int64)
        link_den = np.ones(L, np.int64)
        link_add = np.zeros(L, np.int64)
        for i, lw in enumerate(lws):
            link_start[i] = lw.t_start
            link_end[i] = lw.t_end
            link_num[i] = lw._num
            link_den[i] = lw._den
            link_add[i] = lw.extra_us
            for name, row in (("src", link_src[i]), ("dst", link_dst[i])):
                side = getattr(lw, name)
                if side is None:
                    row[:] = True
                else:
                    for m in side:
                        if m < n:
                            row[m] = True

        skew = np.zeros(n, np.int64)
        for s in self.skews:
            if s.node < n:
                skew[s.node] += s.offset_us
        return FaultTables(
            crash_node, crash_down, crash_up, crash_reset,
            part_group, part_start, part_end,
            link_src, link_dst, link_start, link_end,
            link_num, link_den, link_add, skew)


@dataclass(frozen=True)
class FaultFleet:
    """Per-world fault schedules for a batched engine: world b of a
    ``BatchSpec`` fleet runs ``schedules[b]``. Tables are stacked on a
    leading B axis with shorter worlds padded by inert rows, so the
    ``vmap``-ed superstep maps one fixed-shape pytree — and
    ``world_schedule(b)`` returns world b's schedule *at the padded
    shape*, which is what a solo run must use to reproduce world b's
    state bit-for-bit (padding is inert, so traces and every non-shape
    observable also equal the unpadded solo run —
    tests/test_zfault_parity.py pins both)."""
    schedules: Tuple[FaultSchedule, ...]

    def __post_init__(self):
        scheds = tuple(self.schedules)
        if not scheds:
            raise ValueError("a FaultFleet needs at least one world "
                             "schedule")
        for s in scheds:
            if not isinstance(s, FaultSchedule):
                raise ValueError(
                    f"FaultFleet takes FaultSchedules, got {s!r}")
        object.__setattr__(self, "schedules", scheds)

    @property
    def B(self) -> int:
        return len(self.schedules)

    def _pad_shape(self) -> Tuple[int, int, int]:
        return (max(len(s.crashes) + s.pad[0] for s in self.schedules),
                max(len(s.partitions) + s.pad[1] for s in self.schedules),
                max(len(s.link_windows) + s.pad[2]
                    for s in self.schedules))

    def world_schedule(self, b: int) -> FaultSchedule:
        """World ``b``'s schedule at the fleet's padded table shape —
        the right-hand side of the chaos-fleet exactness law."""
        return self.schedules[b].padded(*self._pad_shape())

    @property
    def has_skew(self) -> bool:
        return any(s.has_skew for s in self.schedules)

    @property
    def has_reset(self) -> bool:
        return any(s.has_reset for s in self.schedules)

    @property
    def n_restarts(self) -> int:
        return self._pad_shape()[0]

    def min_delay_floor(self, link_floor: int) -> int:
        return min(s.min_delay_floor(link_floor)
                   for s in self.schedules)

    def min_delay_floor_in(self, link_floor: int, t_lo: int,
                           t_hi: int) -> int:
        """Fleet-wide per-window floor: the min over every world's
        (the controller makes one fleet decision per chunk, so the
        bound must hold in every world — the recorded ``min`` slack
        aggregation's twin for the floor side)."""
        return min(s.min_delay_floor_in(link_floor, t_lo, t_hi)
                   for s in self.schedules)

    def tables(self, n_nodes: int) -> FaultTables:
        """Stacked ``[B, ...]`` tables (every leaf gains a leading
        world axis)."""
        C, Pn, L = self._pad_shape()
        ts = [s.padded(C, Pn, L).tables(n_nodes) for s in self.schedules]
        return FaultTables(*(np.stack([getattr(t, f) for t in ts])
                             for f in FaultTables._fields))


# -- the CLI grammar -------------------------------------------------------

#: the --faults grammar, named in every parse error (mirrors
#: cli.LINK_GRAMMAR). Events are ';'-separated; node sets are
#: '+'-joined ids/ranges (e.g. 0-3+7); times are µs ints or
#: suffixed (10ms, 5s); 'all' = every node.
FAULT_GRAMMAR = (
    "crash:NODE:DOWN:UP[:reset] | partition:G0|G1[|G2...]:START:END | "
    "degrade:SRC:DST:START:END:SCALE[:EXTRA] | skew:NODE:OFFSET  "
    "(events ';'-separated; times µs ints or 10ms/5s; node sets "
    "'+'-joined ids/ranges like 0-3+7, or 'all')")


def _parse_time(s: str, what: str) -> int:
    s = s.strip()
    for suffix, mult in (("us", 1), ("ms", 1_000), ("s", 1_000_000)):
        if s.endswith(suffix):
            body = s[:-len(suffix)]
            try:
                return int(round(float(body) * mult))
            except ValueError:
                raise ValueError(
                    f"{what}: bad time {s!r} (number before "
                    f"'{suffix}')") from None
    try:
        return int(s)
    except ValueError:
        raise ValueError(
            f"{what}: bad time {s!r} (µs int or 10ms/5s)") from None


def _parse_nodes(s: str, what: str) -> Optional[Tuple[int, ...]]:
    if s == "all":
        return None
    out: List[int] = []
    for part in s.split("+"):
        if "-" in part:
            a, _, b = part.partition("-")
            try:
                lo, hi = int(a), int(b)
            except ValueError:
                raise ValueError(
                    f"{what}: bad node range {part!r}") from None
            if hi < lo:
                raise ValueError(f"{what}: empty node range {part!r}")
            out.extend(range(lo, hi + 1))
        else:
            try:
                out.append(int(part))
            except ValueError:
                raise ValueError(
                    f"{what}: bad node id {part!r}") from None
    return tuple(out)


def _parse_event(spec: str):
    parts = spec.split(":")
    kind = parts[0]
    if kind == "crash":
        if len(parts) not in (4, 5) or (
                len(parts) == 5 and parts[4] != "reset"):
            raise ValueError("crash takes NODE:DOWN:UP[:reset]")
        return NodeCrash(int(parts[1]),
                         _parse_time(parts[2], "crash DOWN"),
                         _parse_time(parts[3], "crash UP"),
                         reset_state=len(parts) == 5)
    if kind == "partition":
        if len(parts) != 4:
            raise ValueError("partition takes G0|G1[|...]:START:END")
        groups = tuple(_parse_nodes(g, "partition group")
                       for g in parts[1].split("|"))
        if any(g is None for g in groups):
            raise ValueError("partition groups must be explicit node "
                             "sets ('all' in one group cuts nothing)")
        return Partition(groups,
                         _parse_time(parts[2], "partition START"),
                         _parse_time(parts[3], "partition END"))
    if kind == "degrade":
        if len(parts) not in (6, 7):
            raise ValueError(
                "degrade takes SRC:DST:START:END:SCALE[:EXTRA]")
        return LinkWindow(_parse_nodes(parts[1], "degrade SRC"),
                          _parse_nodes(parts[2], "degrade DST"),
                          _parse_time(parts[3], "degrade START"),
                          _parse_time(parts[4], "degrade END"),
                          scale=float(parts[5]),
                          extra_us=_parse_time(parts[6], "degrade EXTRA")
                          if len(parts) == 7 else 0)
    if kind == "skew":
        if len(parts) != 3:
            raise ValueError("skew takes NODE:OFFSET")
        return ClockSkew(int(parts[1]),
                         _parse_time(parts[2], "skew OFFSET"))
    raise ValueError(f"unknown fault kind {kind!r}")


def parse_faults(spec: str) -> FaultSchedule:
    """Parse a ``;``-separated fault-event string (the CLI's
    ``--faults``) into a :class:`FaultSchedule`. Malformed specs die
    naming :data:`FAULT_GRAMMAR`, never with a raw
    IndexError/ValueError (the ``parse_link`` convention)."""
    events = []
    for ev in spec.split(";"):
        ev = ev.strip()
        if not ev:
            continue
        try:
            events.append(_parse_event(ev))
        except (IndexError, ValueError) as e:
            raise SystemExit(
                f"malformed fault spec {ev!r} ({e}); "
                f"grammar: {FAULT_GRAMMAR}") from None
    if not events:
        raise SystemExit(
            f"empty fault spec {spec!r}; grammar: {FAULT_GRAMMAR}")
    return FaultSchedule(tuple(events))


def _fmt_nodes(nodes: Optional[Tuple[int, ...]]) -> str:
    """One node set in the grammar's '+'-joined ids/ranges form,
    preserving the stored order (consecutive ascending runs compress
    to ranges; re-parsing yields the identical tuple)."""
    if nodes is None:
        return "all"
    parts: List[str] = []
    i, n = 0, len(nodes)
    while i < n:
        j = i
        while j + 1 < n and nodes[j + 1] == nodes[j] + 1:
            j += 1
        if j - i >= 1:
            parts.append(f"{nodes[i]}-{nodes[j]}")
        else:
            parts.append(str(nodes[i]))
        i = j + 1
    return "+".join(parts)


def _fmt_event(e) -> str:
    if isinstance(e, NodeCrash):
        s = f"crash:{e.node}:{e.t_down}:{e.t_up}"
        return s + ":reset" if e.reset_state else s
    if isinstance(e, Partition):
        gs = "|".join(_fmt_nodes(g) for g in e.groups)
        return f"partition:{gs}:{e.t_start}:{e.t_end}"
    if isinstance(e, LinkWindow):
        s = (f"degrade:{_fmt_nodes(e.src)}:{_fmt_nodes(e.dst)}:"
             f"{e.t_start}:{e.t_end}:{e.scale!r}")
        return s + f":{e.extra_us}" if e.extra_us else s
    if isinstance(e, ClockSkew):
        return f"skew:{e.node}:{e.offset_us}"
    raise ValueError(f"unknown fault event {e!r}")


def format_faults(schedule: FaultSchedule) -> str:
    """The grammar round-trip inverse of :func:`parse_faults`: a
    ``;``-separated :data:`FAULT_GRAMMAR` string whose re-parse is
    field-equal to ``schedule`` (tests/test_zgrammar.py pins the
    law). Times print as raw µs ints — exact, no suffix rounding.
    ``pad`` is a fleet-shape artifact with no grammar form and is
    deliberately not represented (a re-parsed schedule carries pad
    ``(0, 0, 0)``; padding is inert, so the two are result-identical
    — :class:`FaultTables`). This is what lets the chaos search
    of the reference emit every minimized counterexample as a
    paste-able ``--faults`` repro string. An empty schedule has no
    grammar form (``parse_faults`` refuses empty specs) and is
    refused here symmetrically."""
    if not schedule.events:
        raise ValueError(
            "an empty FaultSchedule has no --faults grammar form "
            "(parse_faults refuses empty specs); represent 'no "
            "faults' as None, the RunConfig convention")
    return "; ".join(_fmt_event(e) for e in schedule.events)


def as_fleet(faults, B: int) -> FaultFleet:
    """Normalize a solo schedule onto a ``B``-world fleet (every world
    runs the same schedule) — the CLI's ``--faults`` + ``--batch``
    path. A real per-world study builds the :class:`FaultFleet`
    directly."""
    if isinstance(faults, FaultFleet):
        if faults.B != B:
            raise ValueError(
                f"FaultFleet has {faults.B} world schedules but the "
                f"batch runs {B} worlds")
        return faults
    return FaultFleet((faults,) * B)

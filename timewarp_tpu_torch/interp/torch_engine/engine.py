"""The general engine on PyTorch (port of
``timewarp_tpu/interp/jax_engine/engine.py``, single device).

Whole-network emulation as a Python loop of supersteps over tensors:
per-node ``next_wake`` plus bounded ``[K, N]`` mailboxes with int32
epoch-relative deliver times (``I32MAX`` = empty slot). Each superstep,
in the reference's order:

1. pop the minimum event (``t``) — the one host sync of the loop, which
   is also the run loop's quiescence test; under a fault schedule a
   crashed node's events first slide to its ``t_up`` and pending reboots
   inject their restart firing;
2. fire every node whose next event lies in ``[t, t + window)``, each at
   its own instant (a rebooting node's state reset to the scenario's
   initial state, its pre-crash mailbox entries purged);
3. deliver and build the inbox (sorted by ``(deliver time, slot)`` for
   ordered inboxes);
4. run the scenario's batched step (on a skewed clock where a schedule
   says so);
5. drop what was delivered and rebase to the new epoch;
6. route, in one of the reference's three regimes, and insert into the
   mailbox (kernel K1). Adaptive (no ``route_cap``, a drop-free link,
   and ``window > 1`` or ``max_out > 1``): fire-compact the outbox
   (kernel K2), sort the batch by ``(destination, window offset,
   sender-major rank)``, then sample the link. Otherwise the outbox is
   flattened slot-major at ``S = N·max_out``: the eager path samples
   every slot (a droppy link's draw decides validity) and then sorts;
   the lazy path (``route_cap`` with a drop-free link) sorts first,
   slices to ``route_cap`` and samples only that prefix. A fault schedule
   cuts partitioned sends, degrades delays and drops deliveries into a
   down window, at the reference's points, counting each in
   ``fault_dropped``.

The world axis: every superstep runs over a leading axis of B worlds
(``batch=BatchSpec``), each with its own seed words, link parameters and
fault tables, its own ``t``, and its own quiescence and step budget; a
solo engine is the same superstep at B = 1 with the axis hidden from its
states. One launch of K2 and one of K1 serve every world. World b of a
fleet equals the solo run with world b's seed, link and schedule.

With ``record_events > 0`` every superstep also appends its fires and
deliveries to an on-device event ring (:meth:`TorchEngine.events`).

The run-mode planes (planes.py): ``telemetry``, ``verify`` (with
``run_verified``), ``record``/``record_cap`` (the flight recorder),
``controller`` (``run_controlled``) and ``speculate`` (with
``run_speculative``, speculate/), each giving what
``JaxEngine(insert="xla")`` gives; with every plane off the superstep is
unchanged. A controller or speculation hands each ``run`` chunk its
window as a tensor (``DynDispatch``): the superstep clamps it to the
engine's bound and, under a fault schedule, to each world's degraded link
floor (``faults.apply.window_floor``), and uses it for the firing mask,
the ``short_delay`` count and the causality plane's straggler. K1 and K2
never see the window: K2 compacts the window-offset plane whenever the
bound exceeds 1, and K1 inserts epoch-relative deliver times.

Node ownership is the ``comm`` object (common.py ``LocalComm``: every
node here, its collectives identities). The node-sharded engines
(sharded.py) give a ``parallel.mesh.MeshComm`` instead, and the same
superstep then runs on one rank's nodes: the pop-min is ``all_min``, the
superstep's counters and digests are summed over the ranks in one
``all_sum``, and the eager path hands each message to its destination's
rank in :meth:`TorchEngine._exchange` before the sort. The adaptive and
lazy regimes are single-device only, as in the reference.

The emitted traces and final states equal ``JaxEngine``'s bit for bit
(tests/test_torch_engine.py, test_torch_routing.py,
test_torch_world_batch.py, test_torch_faults.py), and so do the planes'
outputs (tests/test_torch_telemetry.py, test_torch_integrity.py,
test_torch_flight.py, test_torch_dispatch.py).
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ...core.rng import fire_bits, seed_words
from ...core.scenario import NEVER, Inbox, Outbox, Scenario
from ...faults.apply import (consume_restarts, cut_mask, defer_next,
                             degrade, device_tables, down_mask,
                             restart_fire, skewed_step, window_floor)
from ...faults.schedule import FaultFleet, FaultSchedule, as_fleet
from ...net.delays import LinkModel
from ...obs.flight import TAG_DEFER, TAG_PURGE, TAG_RESTART
from ...ops.numeric import I32MAX, thi, tlo, u32sum
from ...trace.events import SuperstepTrace
from ...trace.hashing import FIRED, RECV, SENT, mix32
from .batched import BatchSpec, map_state, rebind_link
from .common import (LocalComm, init_states_wake,
                     run_stats, stats_merge)
from .cuda_insert import InsertStage, flight_times, link_sample
from .planes import PlaneRows, PlanesMixin

__all__ = ["TorchEngine", "EngineState", "resolve_device", "resolve_window",
           "sort_batch", "sent_digest"]


class EngineState(NamedTuple):
    """The complete simulation state — the reference's ``EngineState``
    leaf for leaf, same dtypes and ``[K, N]`` layout (so states carry
    across, state_io.py). Scalars are 0-d tensors on the engine's
    device; a fleet's state has a leading world axis B on every leaf."""
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
    fault_dropped: torch.Tensor  # int32[] — cut, down-dropped and purged
    restart_done: torch.Tensor   # bool[C] — reboot rows consumed


class _World(NamedTuple):
    """What distinguishes the worlds of a superstep: seed words (ints,
    or ``[B, 1]`` tensors), the link (its swept parameters ``[B, 1]``
    tensors) and the fault tables (a leading world axis), or None."""
    s0: Any
    s1: Any
    link: LinkModel
    ft: Any


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


def resolve_window(window, link: LinkModel, floor=None,
                   fleet: bool = False, speculating: bool = False) -> int:
    """The superstep window in µs: an int, or ``"auto"`` for the link's
    declared floor (``floor`` when given: a fleet's minimum over its
    worlds, degraded by a fault schedule). A window wider than that floor
    would reorder causally dependent events and is refused, with the
    reference's advice (``speculating``: the window names a speculating
    engine's conservative floor)."""
    floor = link.min_delay_us if floor is None else floor
    if isinstance(window, str) and window != "auto":
        raise ValueError(f"window must be an int µs count or the string "
                         f"'auto', got {window!r}")
    if window == "auto":
        window = max(1, min(int(floor), I32MAX - 1))
    if window < 1:
        raise ValueError(f"window must be >= 1 µs, got {window}")
    if window > 1 and window > floor:
        hint = (
            "speculate= is already on and window= names its "
            "CONSERVATIVE floor, which must stay provable (<= "
            "the declared min); put the speculative bound in the "
            "spec instead — speculate='fixed:W', or 'auto' to "
            "ladder it (docs/speculation.md)"
        ) if speculating else (
            "to run wider than the provable floor, speculate: "
            "speculate='auto'|'fixed:W' detects and rolls back "
            "the violations statically ruled out here "
            "(docs/speculation.md)")
        raise ValueError(
            f"window={window} µs exceeds the link model's declared "
            f"min_delay_us={floor}"
            f"{' (min over the batch worlds)' if fleet else ''}; "
            "windowed supersteps would reorder causally dependent "
            f"events (engine.py windowed-execution precondition) "
            f"— {hint}")
    if window >= I32MAX:
        raise ValueError("window must fit int32")
    return int(window)


def _sort_rows(key: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Indices of a stable ascending sort along ``dim``."""
    return torch.sort(key, dim=dim, stable=True).indices


def sort_batch(dst, woff, smrank) -> torch.Tensor:
    """The permutation that orders a message batch by ``(dst, woff,
    smrank)``: the reference's 3-key sort as two stable sorts, ``(woff,
    smrank)`` packed into one int64 (each < 2^31), then ``dst``. Along
    the last axis: a ``[B, S]`` fleet batch sorts each world's row."""
    o1 = _sort_rows((woff.long() << 31) | smrank.long(), -1)
    return o1.gather(-1, _sort_rows(dst.gather(-1, o1), -1))


def sent_digest(ok, src, dst, tmsg, flight, pay0) -> torch.Tensor:
    """The SENT digest of a sampled batch over its ``ok`` entries: each
    message hashed with its absolute deliver time (one per batch row)."""
    dt_abs = tmsg + flight
    sent_mix = mix32(SENT, src, dst, tlo(dt_abs), thi(dt_abs), pay0)
    return u32sum(torch.where(ok, sent_mix, 0), dim=-1)


def _take(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``x[..., perm]`` per world: ``x`` ``[B, S]`` or ``[B, P, S]``,
    ``perm`` ``[B, S']``."""
    if x.dim() == 2:
        return x.gather(1, perm)
    return x.gather(2, perm[:, None, :].expand(x.shape[0], x.shape[1],
                                               perm.shape[1]))


def _nodes_minor(x: torch.Tensor) -> torch.Tensor:
    """A ``[B, R..., N]`` plane as the step's ``[R..., B·N]`` layout: the
    worlds' nodes side by side on the minor axis (a view at B = 1)."""
    nd = x.dim()
    return x.permute(*range(1, nd - 1), 0, nd - 1).reshape(
        *x.shape[1:-1], x.shape[0] * x.shape[-1])


def _worlds_major(x: torch.Tensor, B: int) -> torch.Tensor:
    """The inverse of :func:`_nodes_minor`: ``[R..., B·N]`` -> ``[B, R...,
    N]`` (contiguous for a fleet, a view at B = 1)."""
    if B == 1:
        return x.unsqueeze(0)
    lead = x.shape[:-1]
    y = x.reshape(*lead, B, x.shape[-1] // B)
    return y.permute(len(lead), *range(len(lead)), len(lead) + 1) \
        .contiguous()


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A ``[B]`` world mask shaped to broadcast over ``like``."""
    return mask.view((mask.shape[0],) + (1,) * (like.dim() - 1))


class TorchEngine(PlanesMixin):
    """Single-device engine for dynamic-destination scenarios —
    ``JaxEngine(insert="xla")`` on one device (the reference's default
    engine, which threads the dynamic window), with the fire-compaction
    and mailbox-insertion kernels on the card (their plain versions on
    the CPU).

    ``window`` is an int µs width or ``"auto"`` (the link's declared
    floor); it must not exceed ``link.min_delay_us`` (under faults: the
    schedule's degraded floor, unless a controller or speculation clamps
    each superstep to it), and sampled delays shorter than the
    superstep's window are counted in ``short_delay``. ``route_cap`` bounds the sorted batch
    outside the adaptive regime, unrounded (the excess is counted in
    ``route_drop``); ``insert_cap`` bounds the adaptive regime's fired
    batch (default ``n_nodes * max_out``: nothing can drop) and is
    refused in the other regimes. ``record_events`` is the capacity of
    the event ring (0: off). ``batch`` (a :class:`BatchSpec`) runs a
    fleet of worlds; ``faults`` is a ``FaultSchedule`` (solo, or every
    world of a fleet) or a ``FaultFleet`` (one schedule a world).
    ``device`` defaults to the card. After ``run``/``run_quiet``,
    ``last_run_stats`` holds the call's supersteps (summed over worlds),
    its fleet supersteps (loop iterations, each every world's), wall
    seconds and compiles (0).

    The run-mode planes: ``telemetry`` (``"off"``, ``"counters"``,
    ``"full"``; frames on ``last_run_telemetry``, the ``rung`` column the
    compacted batch's static sender width on the adaptive path, -1 on the
    eager and lazy ones — the port has no routing ladder), ``verify``
    (``"off"``, ``"guard"``, ``"digest"``, ``"shadow"``;
    ``run_verified``), ``record``/``record_cap`` (``"off"``,
    ``"deliveries"``, ``"full"``; ``last_run_flight``), ``controller`` (a
    ``DispatchController``; ``run_controlled`` adapts the window and the
    chunk length) and ``speculate`` (``"off"``, ``"auto"``,
    ``"fixed:W"``; ``run_speculative``). Speculating, ``window`` names the
    conservative floor (``spec_floor``) and ``self.window`` becomes the
    speculative bound: W for ``fixed:W``, ``I32MAX - 1`` for ``auto``.

    ``lint`` (``"warn"``, ``"error"``, ``"off"``) runs the scenario
    sanitizer at construction (analysis/; ``lint_report``) and, with
    ``faults``, the TW5xx schedule lint (``fault_lint_report``):
    ``"error"`` refuses a scenario with an error finding, ``"warn"`` logs
    the findings, ``"off"`` looks at nothing."""

    last_run_stats = None
    #: the fleet's BatchSpec (None solo) and fault state; subclasses that
    #: take neither keep these
    batch = None
    faults = None
    #: the TW5xx report of ``faults`` (None: no schedule or lint "off")
    fault_lint_report = None
    _faulted = False
    _has_skew = _has_reset = False
    _n_restarts = 0

    #: the engine threads the dynamic window (controlled.py, speculate/)
    _dyn_ok = True
    #: the run's dispatch values while a controlled or speculative chunk
    #: runs (None otherwise), and the superstep's effective window (set by
    #: each superstep): the Python int ``self.window`` on the static path,
    #: else an int64 ``[B, 1]`` tensor
    _dyn = None
    _w_now = None

    def __init__(self, scenario: Scenario, link: LinkModel, *,
                 seed: int = 0, window=1, route_cap: Optional[int] = None,
                 record_events: int = 0, insert_cap: Optional[int] = None,
                 batch: Optional[BatchSpec] = None, faults=None,
                 telemetry: str = "off", controller=None,
                 verify: str = "off", record: str = "off",
                 record_cap: Optional[int] = None, speculate: str = "off",
                 lint: str = "warn", device=None) -> None:
        if speculate not in (None, "off"):
            from ...speculate.plane import parse_speculate
            self.speculate, self._spec_w = parse_speculate(
                speculate, type(self).__name__)
        self._hold(scenario, link, seed, device, record_events, telemetry,
                   verify, record, record_cap, lint)
        spec = self.speculate != "off"
        if spec:
            # the causality plane is a per-superstep plane row
            self._planes_on = True
        link_floor = self._setup_batch(batch, link)
        self._setup_faults(faults)
        if self._faulted:
            if route_cap is not None:
                raise ValueError(
                    "faults and route_cap cannot combine: the capped "
                    "lazy-sampling path slices before delays (and so "
                    "before down-window drops) exist — run the fault "
                    "study uncapped (adaptive routing never drops)")
            # a shrink-degradation window can undercut the link's floor.
            # A static engine validates against the degraded worst case;
            # an engine under a controller or speculating keeps the
            # undegraded floor as its bound, because every one of its
            # chunks clamps each superstep to the degraded floor of the
            # span it covers (faults.apply.window_floor)
            if controller is None and not spec:
                link_floor = self.faults.min_delay_floor(link_floor)
        window = resolve_window(window, link, link_floor,
                                fleet=batch is not None, speculating=spec)
        if spec:
            # `window` is the CONSERVATIVE floor; the engine's window
            # becomes the speculative bound beyond it, and the causality
            # plane re-proves the exactness precondition chunk by chunk
            if controller is not None:
                raise ValueError(
                    "speculate and controller are both per-chunk "
                    "window decision sources — an engine runs under "
                    "exactly one (docs/speculation.md)")
            self.spec_floor = window
            if self.speculate == "fixed":
                if self._spec_w <= self.spec_floor:
                    raise ValueError(
                        f"speculate='fixed:{self._spec_w}' does not "
                        f"exceed the conservative floor "
                        f"{self.spec_floor} µs — at or below the "
                        "floor the static window already proves "
                        "exactness; nothing to speculate "
                        "(docs/speculation.md)")
                if self._spec_w >= I32MAX:
                    raise ValueError("window must fit int32")
                window = self._spec_w
            else:
                # auto: the widest representable window — the ladder
                # policy doubles up from the floor, so it is a ceiling
                window = I32MAX - 1
        self.window = window
        if route_cap is not None and route_cap < 1:
            raise ValueError(f"route_cap must be >= 1, got {route_cap}")
        self.route_cap = None if route_cap is None else int(route_cap)
        # type checks, NOT isinstance: MeshComm subclasses LocalComm. A
        # sharded engine routes on the eager path only, the one that
        # hands each message to its destination's rank (_exchange)
        local = type(self.comm) is LocalComm
        #: the regime step 6 takes (reference ``_adaptive_regime``)
        self.adaptive = (self.route_cap is None and not link.can_drop
                         and local
                         and (self.window > 1 or scenario.max_out > 1))
        #: outside it: sort first and sample only the route_cap prefix
        #: (the lazy path), else sample every slot (the eager path). The
        #: lazy path never runs sharded: it skips the exchange
        self.lazy = (self.route_cap is not None and not link.can_drop
                     and local)
        self.stage = InsertStage(scenario, self.comm.n_local,
                                 window=self.window, insert_cap=insert_cap,
                                 adaptive=self.adaptive,
                                 route_cap=self.route_cap,
                                 batch=self._exchange_width())
        if self.adaptive:
            # the kernel path's "rung": the compacted batch's static
            # width in senders
            self._t_rung = self.stage.S // scenario.max_out
        self._bind_controller(controller)

    def _hold(self, sc: Scenario, link: LinkModel, seed: int, device,
              record_events: int, telemetry="off", verify="off",
              record="off", record_cap=None, lint="warn") -> None:
        """What every engine of this package checks and holds, before its
        own regime guards: the planes' modes, the scenario's lint, the
        device, the event ring's capacity, the seed words and the node
        axis."""
        from ...analysis import check_scenario
        name = type(self).__name__
        self._bind_planes(telemetry, verify, record, record_cap)
        self.lint = lint
        self.lint_report = check_scenario(sc, lint, who=name)
        self.device = resolve_device(device, name)
        if sc.n_nodes * sc.max_out >= 2**31:
            raise ValueError(
                "n_nodes * max_out must fit int32 (sender-major rank)")
        if record_events < 0:
            raise ValueError("record_events must be >= 0")
        self.record_events = int(record_events)
        self.scenario, self.link = sc, link
        self.s0, self.s1 = seed_words(seed)
        self.comm = self._make_comm(sc.n_nodes, self.device)
        self._node_ids = self.comm.node_ids()
        self._world = _World(self.s0, self.s1, link, None)

    def _make_comm(self, n_global: int, device: torch.device):
        """The node-ownership object: every node on this device (the
        node-sharded engines give this rank's nodes, sharded.py)."""
        return LocalComm(n_global, device)

    def _exchange_width(self) -> Optional[int]:
        """The eager batch's width after :meth:`_exchange` (None: the
        outbox width ``n_nodes * max_out``, nothing exchanged)."""
        return None

    def _exchange(self, ok, drel, dst_f, smrank, woff, pay_f):
        """Hand routed messages to the device that owns their destination
        (reference ``_exchange``), returning ``(ok, drel, row, smrank,
        woff, pay, bucket_overflow)`` for the messages this device's nodes
        receive, ``row`` the local mailbox row. One device: the identity,
        the global destination is the row. The node-sharded engines
        bucket by destination rank and swap the buckets in one
        ``all_to_all`` (sharded.py); insertion sorts on ``(row, woff,
        smrank)``, so the order an exchange returns never matters."""
        return ok, drel, dst_f, smrank, woff, pay_f, None

    def _any_world(self, flags: np.ndarray) -> np.ndarray:
        """The run loop's liveness flags (bool ``[k]``) over the worlds of
        every device (reference ``_any_world``): this device's; the
        world-sharded engine ORs them over the ranks."""
        return flags

    def _local_worlds(self, v: np.ndarray) -> np.ndarray:
        """This device's entries of a per-world host vector over the
        whole fleet (the world-sharded engine's rank slice)."""
        return v

    def _gather_rows(self, cols, act, planes, steps_at):
        """A traced run's trace columns ``[T, B, 8]``, live mask ``[T,
        B]``, plane rows and starting steps, over every world (this
        device's; the world-sharded engine gathers the ranks')."""
        return cols, act, planes, steps_at

    # -- the world axis and the fault schedule ------------------------------

    def _setup_batch(self, batch, link: LinkModel) -> int:
        """Validate ``batch`` and hold the fleet's per-world identity;
        returns the link floor the window validates against (the minimum
        over the worlds' links)."""
        self.batch = batch
        if batch is None:
            self._world_links = None
            return link.min_delay_us
        if not isinstance(batch, BatchSpec):
            raise ValueError(
                f"batch must be a BatchSpec (got {batch!r}); build "
                "one with BatchSpec(seeds=...) or BatchSpec.of()")
        if self.record_events:
            raise ValueError(
                "record_events is a solo-run debug ring; to record "
                "world b's events, run it solo (bit-identical by "
                "the batch exactness law, batched.py)")
        #: per-world host-level links — what a solo run must use to
        #: reproduce world b, and the floor for window validation
        self._world_links = [batch.world_link(link, b)
                             for b in range(batch.B)]
        self._bind_identity(batch)
        return min(lk.min_delay_us for lk in self._world_links)

    def _bind_identity(self, batch: BatchSpec) -> None:
        """The fleet's seed words and link-parameter vectors as ``[B,
        1]`` tensors, and the per-world link they parameterize."""
        dev = self.device
        sw = [seed_words(s) for s in batch.seeds]
        self._s0v = torch.tensor([a for a, _ in sw], dtype=torch.int64,
                                 device=dev)[:, None]
        self._s1v = torch.tensor([b for _, b in sw], dtype=torch.int64,
                                 device=dev)[:, None]
        self._lpv = {k: torch.as_tensor(np.asarray(v)).to(dev)[:, None]
                     for k, v in (batch.link_params or {}).items()}
        link = rebind_link(self.link, self._lpv) if self._lpv else self.link
        self._world = self._world._replace(s0=self._s0v, s1=self._s1v,
                                           link=link)

    @property
    def B(self) -> int:
        """The number of worlds a superstep runs (1 solo)."""
        return 1 if self.batch is None else self.batch.B

    def _setup_faults(self, faults) -> None:
        """Normalize and validate ``faults`` and lower it to tensor
        tables with a leading world axis (of 1 solo), which every
        superstep's masks read."""
        self.faults = faults
        self._faulted = faults is not None
        if faults is None:
            return
        if self.batch is not None:
            faults = as_fleet(faults, self.batch.B)
        elif isinstance(faults, FaultFleet):
            raise ValueError(
                "a FaultFleet carries per-world schedules; it needs "
                "batch=BatchSpec (a solo run takes one FaultSchedule)")
        elif not isinstance(faults, FaultSchedule):
            raise ValueError(
                f"faults must be a FaultSchedule (or a FaultFleet "
                f"with batch=), got {faults!r}; build one with "
                "FaultSchedule((NodeCrash(...), ...)) or "
                "faults.parse_faults()")
        self.faults = faults
        from ...analysis import check_faults
        self.fault_lint_report = check_faults(
            faults, self.scenario, self.lint, who=type(self).__name__)
        self._has_skew = faults.has_skew
        self._has_reset = faults.has_reset
        self._n_restarts = faults.n_restarts
        self._bind_tables(faults)
        if self._has_reset:
            # the reboot template: the scenario's initial states (seed-
            # independent, so one template serves every world)
            self._reset_states, _ = init_states_wake(self.scenario,
                                                     self.device)

    def _bind_tables(self, faults) -> None:
        ft = device_tables(faults.tables(self.scenario.n_nodes), self.device)
        if self.batch is None:
            ft = type(ft)(*(x.unsqueeze(0) for x in ft))
        self._world = self._world._replace(ft=ft)

    def rebind_identity(self, batch: BatchSpec, faults=None) -> bool:
        """Swap this fleet's per-world identity in place — new seeds, link
        values and/or fault schedules. Returns True when the new identity
        is shape-compatible (the reference's test: same B, same
        link-parameter paths and dtypes, fault tables absent on both sides
        or of the same padded shape with the same skew/reset/restart
        gates) and commits it; False when the caller must build a new
        engine. Raises ``ValueError`` for an identity no engine of this
        shape could run (a window wider than the new fleet's floor)."""
        if self.batch is None:
            raise ValueError(
                "rebind_identity swaps a fleet's per-world identity; "
                "a solo engine has none (batch=BatchSpec)")
        if not isinstance(batch, BatchSpec):
            raise ValueError(f"batch must be a BatchSpec, got {batch!r}")
        if batch.B != self.batch.B:
            return False
        old_lp = self.batch.link_params or {}
        new_lp = batch.link_params or {}
        if set(old_lp) != set(new_lp):
            return False
        if any(np.asarray(new_lp[k]).dtype != np.asarray(old_lp[k]).dtype
               for k in new_lp):
            return False
        fleet = None if faults is None else as_fleet(faults, batch.B)
        if (fleet is None) != (self.faults is None):
            return False
        if fleet is not None:
            if (fleet.has_skew, fleet.has_reset, fleet.n_restarts) != \
                    (self._has_skew, self._has_reset, self._n_restarts):
                return False
            tables = fleet.tables(self.scenario.n_nodes)
            if any(np.asarray(getattr(tables, f)).shape
                   != tuple(getattr(self._world.ft, f).shape)
                   for f in type(tables)._fields):
                return False
        # the window re-validates against the NEW fleet's floor, as at
        # construction: degraded unless a controller or speculation
        # clamps each superstep; a speculating engine checks its
        # conservative floor (the bound is checked on the device)
        world_links = [batch.world_link(self.link, b)
                       for b in range(batch.B)]
        link_floor = min(lk.min_delay_us for lk in world_links)
        if fleet is not None and (
                (self.controller is None and self.speculate == "off")
                or not self._dyn_ok):
            link_floor = fleet.min_delay_floor(link_floor)
        floor_ref = (self.spec_floor if self.speculate != "off"
                     else self.window)
        if floor_ref > 1 and floor_ref > link_floor:
            raise ValueError(
                f"rebind_identity: window={floor_ref} µs exceeds the "
                f"new fleet's declared min_delay_us={link_floor} (min "
                "over the batch worlds, fault-degraded where the "
                "engine has no dynamic clamp); windowed supersteps "
                "would reorder causally dependent events — this "
                "identity needs its own engine")
        self.batch = batch
        self._world_links = world_links
        self._bind_identity(batch)
        if fleet is not None:
            self.faults = fleet
            self._bind_tables(fleet)
        return True

    # -- state -------------------------------------------------------------

    def init_state(self) -> EngineState:
        sc, dev = self.scenario, self.device
        n, K, P = sc.n_nodes, sc.mailbox_cap, sc.payload_width
        states, wake = init_states_wake(sc, dev)

        def scalar(dtype):
            return torch.zeros((), dtype=dtype, device=dev)
        st = EngineState(
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
            restart_done=torch.zeros((self._n_restarts,), dtype=torch.bool,
                                     device=dev))
        if self.batch is not None:
            # the world axis: every leaf gains a leading B dim; the worlds
            # diverge from superstep 1 through their own entropy
            B = self.batch.B
            st = map_state(lambda x: x.unsqueeze(0).repeat(
                (B,) + (1,) * x.dim()), st)
        return st

    def _next_event(self, st: EngineState) -> torch.Tensor:
        """The next event time (NEVER = quiesced), an int64 0-d tensor —
        ``[B]`` for a fleet's state, one per world. (The schedule's
        deferrals are not applied: the reference's quiet-loop test.)"""
        if self.batch is None:
            mmin = st.mb_rel.min()
            return torch.minimum(
                st.wake.min(),
                torch.where(mmin == I32MAX, NEVER, st.time + mmin.long()))
        B = st.wake.shape[0]
        mmin = st.mb_rel.reshape(B, -1).amin(dim=1)
        return torch.minimum(
            st.wake.amin(dim=1),
            torch.where(mmin == I32MAX, NEVER, st.time + mmin.long()))

    # -- one superstep -----------------------------------------------------

    def _pop(self, st: EngineState):
        """Step 1 for every world: ``(node_next [B, N], t [B])``, the
        crash deferrals and injected reboots applied, and the undeferred
        minimum ``t_raw [B]`` (the quiet loop's test)."""
        nnr = st.mb_rel.amin(dim=1)                               # [B, N]
        node_next = torch.minimum(
            st.wake, torch.where(nnr == I32MAX, NEVER,
                                 st.time[:, None] + nnr.long()))
        t_raw = self.comm.all_min(node_next.amin(dim=1))
        ft = self._world.ft
        if ft is None:
            return node_next, t_raw, t_raw
        pre = node_next
        node_next = defer_next(ft, self._node_ids, node_next,
                               st.restart_done)
        if self._rec_extra is not None:
            # a crash window slid the node's pending event later: send_t
            # carries the original instant, t the deferred-to one
            ids = self._node_ids
            self._rec_fault(TAG_DEFER, (node_next > pre) & (pre < NEVER),
                            ids, ids, pre, node_next)
        return node_next, node_next.amin(dim=1), t_raw

    def _premask(self, out, out_valid):
        """The outbox's destinations with invalid and out-of-range
        messages as -1 (``pdst`` int32 ``[B, M, N]``), and each world's
        count of valid messages to an out-of-range node (``bad_dst``)."""
        dst32 = out.dst.to(torch.int32)
        dst_okf = (dst32 >= 0) & (dst32 < self.comm.n_global)
        bad_dst_step = (out_valid & ~dst_okf).sum(dim=(1, 2),
                                                  dtype=torch.int32)
        return (torch.where(out_valid & dst_okf, dst32, -1).contiguous(),
                bad_dst_step)

    def _sample_nodrop(self, src, dst, tmsg, slot, woff, ok):
        """Link sampling for the no-drop routing paths (lazy, adaptive):
        each world's draw, its degradation windows applied before the
        flight clamp (the reference's order), then :meth:`_flights`."""
        w = self._world
        delay, _ = link_sample(w.link, w.s0, w.s1, src, dst, tmsg, slot)
        if w.ft is not None:
            delay = degrade(w.ft, delay, src, dst, tmsg)
        return self._flights(delay, woff, ok, tmsg)

    def _flights(self, delay, woff, ok, tmsg):
        """:func:`flight_times` against the superstep's effective window
        ``_w_now``, plus the causality plane's straggler column while
        speculating: each batch row's earliest absolute delivery among
        the same ``ok`` sends that ``short_delay`` counts (``[B]`` int64,
        NEVER when clean; None when not speculating)."""
        flight, drel, bad, short = flight_times(delay, woff, ok, self.window,
                                                self._w_now)
        strag = None
        if self.speculate != "off":
            strag = torch.where(ok & (flight < self._w_now), tmsg + flight,
                                NEVER).amin(dim=-1)
        return flight, drel, bad, short, strag

    def _zeros(self, B: int) -> torch.Tensor:
        return torch.zeros((B,), dtype=torch.int32, device=self.device)

    def _route_firecompact(self, out, out_valid, now_vec, t, mb_rel,
                           mb_src, mb_payload, counts, with_trace):
        """Step 6: pre-mask (and cut partitioned sends), fire-compact
        (K2), order by ``(dst, woff, smrank)``, sample, insert (K1), and
        the SENT digest — every world at once. Under faults the batch is
        sampled before the sort, so the down-window drop can remove
        messages before insertion ranks exist (reference
        ``_route_firecompact``'s faulted branch)."""
        sc = self.scenario
        M = sc.max_out
        n = self.comm.n_local
        ft = self._world.ft
        B = out.dst.shape[0]
        pdst, bad_dst_step = self._premask(out, out_valid)
        fault_cut = self._zeros(B)
        if ft is not None and ft.part_group.shape[1]:
            # partition cuts are sample-independent: killed before
            # compaction (counted)
            cutm = (pdst >= 0) & cut_mask(ft, self._node_ids.view(1, 1, -1),
                                          pdst, now_vec[:, None, :])
            fault_cut = cutm.sum(dim=(1, 2), dtype=torch.int32)
            if self._rec_extra is not None:
                self._rec_cut(cutm, self._node_ids.view(1, 1, -1), pdst,
                              now_vec[:, None, :])
            pdst = torch.where(cutm, -1, pdst)
        woff_n = (now_vec - t[:, None]).to(torch.int32)
        dst_f, woff_f, smrank, pay_f, route_drop_step = self.stage.compact(
            pdst, woff_n, out.payload.to(torch.int32).contiguous())
        ok = dst_f < n
        tt = t[:, None]
        if ft is not None:
            src_l = torch.div(smrank, M, rounding_mode="floor")
            tmsg_l = tt + woff_f.long()
            flight, drel, bad_delay_step, short_step, strag = \
                self._sample_nodrop(src_l, dst_f, tmsg_l,
                                    smrank - src_l * M, woff_f, ok)
            downm = ok & down_mask(ft, dst_f, tmsg_l + flight)
            fault_down = downm.sum(dim=1, dtype=torch.int32)
            ok2 = ok & ~downm
            sent_count = ok2.sum(dim=1, dtype=torch.int32)
            sent_hash = sent_digest(ok2, src_l, dst_f, tmsg_l, flight,
                                    pay_f[:, 0]) if with_trace else None
            if self._rec_extra is not None:
                self._rec_sends(ok, downm, src_l, dst_f, tmsg_l,
                                tmsg_l + flight)
            sort_dst = torch.where(ok2, dst_f, n)
            perm = sort_batch(sort_dst, woff_f, smrank)
            sd, smrank_s = sort_dst.gather(1, perm), smrank.gather(1, perm)
            drel_s = drel.gather(1, perm)
            pay_s = _take(pay_f, perm)
            src_s = torch.div(smrank_s, M, rounding_mode="floor")
            mrel, msrc, mpay, overflow_step = self.stage.insert(
                sd, drel_s, src_s, pay_s, mb_rel, mb_src, mb_payload, counts)
            return (mrel, msrc, mpay, overflow_step, bad_dst_step,
                    bad_delay_step, short_step, route_drop_step, sent_count,
                    sent_hash, fault_cut + fault_down, strag)
        perm = sort_batch(dst_f, woff_f, smrank)
        sd, woff_s = dst_f.gather(1, perm), woff_f.gather(1, perm)
        smrank_s = smrank.gather(1, perm)
        pay_s = _take(pay_f, perm)
        ok_s = sd < n
        src_s = torch.div(smrank_s, M, rounding_mode="floor")
        tmsg_s = tt + woff_s.long()
        flight_s, drel_s, bad_delay_step, short_step, strag = \
            self._sample_nodrop(src_s, sd, tmsg_s, smrank_s - src_s * M,
                                woff_s, ok_s)
        mrel, msrc, mpay, overflow_step = self.stage.insert(
            sd, drel_s, src_s, pay_s, mb_rel, mb_src, mb_payload, counts)
        sent_count = ok.sum(dim=1, dtype=torch.int32)
        sent_hash = sent_digest(ok_s, src_s, sd, tmsg_s, flight_s,
                                pay_s[:, 0]) if with_trace else None
        if self._rec_extra is not None:
            self._rec_sends(ok_s, None, src_s, sd, tmsg_s, tmsg_s + flight_s)
        return (mrel, msrc, mpay, overflow_step, bad_dst_step,
                bad_delay_step, short_step, route_drop_step, sent_count,
                sent_hash, fault_cut, strag)

    def _route_flat(self, out, out_valid, now_vec, t, mb_rel, mb_src,
                    mb_payload, counts, with_trace):
        """Step 6 outside the adaptive regime: the outbox flattened
        slot-major at ``S = N·M``, sampled (eager: every slot, before the
        sort; lazy: the sorted ``route_cap`` prefix), ordered by ``(dst or
        sentinel n, woff, smrank)``, sliced to ``route_cap`` when set,
        inserted (K1), and the path's SENT digest. Under faults (eager
        only) partitioned sends are cut before the flight clamp, delays
        degraded, and deliveries into a down window dropped after it."""
        sc = self.scenario
        M, P = sc.max_out, sc.payload_width
        n = self.comm.n_local
        B = out.dst.shape[0]
        S = n * M
        w = self._world
        src_f = self._node_ids.repeat(M)[None, :]               # [1, S]
        slot_f = torch.arange(M, dtype=torch.int32,
                              device=self.device).repeat_interleave(n)[None]
        tmsg = now_vec.repeat(1, M)                             # [B, S]
        dst_f = out.dst.reshape(B, S).to(torch.int32)
        pay_f = out.payload.to(torch.int32).permute(0, 2, 1, 3) \
            .reshape(B, P, S)
        v_f = out_valid.reshape(B, S)
        dst_ok = (dst_f >= 0) & (dst_f < self.comm.n_global)
        bad_dst_step = (v_f & ~dst_ok).sum(dim=1, dtype=torch.int32)
        woff = (tmsg - t[:, None]).to(torch.int32)              # [0, W)
        smrank = (src_f * M + slot_f).expand(B, S)
        fault_step = self._zeros(B)
        if self.lazy:
            ok = v_f & dst_ok
        else:
            # every slot is drawn, invalid and out-of-range ones too (the
            # draw is elementwise); a droppy link's draw decides validity
            delay, drop = link_sample(w.link, w.s0, w.s1, src_f, dst_f,
                                      tmsg, slot_f)
            ok = v_f & ~drop & dst_ok
            if w.ft is not None:
                cutm = ok & cut_mask(w.ft, src_f, dst_f, tmsg)
                fault_step = cutm.sum(dim=1, dtype=torch.int32)
                if self._rec_extra is not None:
                    self._rec_cut(cutm, src_f, dst_f, tmsg)
                ok = ok & ~cutm
                delay = degrade(w.ft, delay, src_f, dst_f, tmsg)
            flight, drel, bad_delay_step, short_step, strag = \
                self._flights(delay, woff, ok, tmsg)
            downm = None
            if w.ft is not None:
                downm = ok & down_mask(w.ft, dst_f, tmsg + flight)
                fault_step = fault_step + downm.sum(dim=1, dtype=torch.int32)
            if self._rec_extra is not None:
                self._rec_sends(ok, downm, src_f, dst_f, tmsg, tmsg + flight)
            if downm is not None:
                ok = ok & ~downm
        # 6.5. hand each message to the device that owns its destination
        #      (identity on one device; sharded: buckets + all_to_all)
        ok_r, drel_r, row_r, smrank_r, woff_r, pay_r, bucket_ovf = \
            (ok, None, dst_f, smrank, woff, pay_f, None) if self.lazy \
            else self._exchange(ok, drel, dst_f, smrank, woff, pay_f)
        sort_dst = torch.where(ok_r, row_r, n)
        perm = sort_batch(sort_dst, woff_r, smrank_r)
        route_drop_step = self._zeros(B)
        if self.route_cap is not None and self.route_cap < perm.shape[1]:
            # valid messages sort ahead of the sentinel: the prefix is
            # exact while the active count fits, the excess is counted
            perm = perm[:, :self.route_cap]
            route_drop_step = ok_r.sum(dim=1, dtype=torch.int32) \
                - (sort_dst.gather(1, perm) < n).sum(dim=1,
                                                     dtype=torch.int32)
        sd, smrank_s = sort_dst.gather(1, perm), smrank_r.gather(1, perm)
        src_s = torch.div(smrank_s, M, rounding_mode="floor")
        pay_s = _take(pay_r, perm).contiguous()
        ok_s = sd < n
        if self.lazy:
            woff_s = woff.gather(1, perm)
            tmsg_s = t[:, None] + woff_s.long()
            flight_s, drel_s, bad_delay_step, short_step, strag = \
                self._sample_nodrop(src_s, sd, tmsg_s, smrank_s - src_s * M,
                                    woff_s, ok_s)
            if self._rec_extra is not None:
                self._rec_sends(ok_s, None, src_s, sd, tmsg_s,
                                tmsg_s + flight_s)
        else:
            drel_s = drel_r.gather(1, perm)
        mrel, msrc, mpay, overflow_step = self.stage.insert(
            sd, drel_s, src_s, pay_s, mb_rel, mb_src, mb_payload, counts)
        if bucket_ovf is not None:
            overflow_step = overflow_step + bucket_ovf
        # the SENT digest: lazy over the sliced survivors (all that has a
        # delay), eager over every ok message at the unsliced width
        if self.lazy:
            sent_count = ok_s.sum(dim=1, dtype=torch.int32)
            sent_hash = sent_digest(ok_s, src_s, sd, tmsg_s, flight_s,
                                    pay_s[:, 0]) if with_trace else None
        else:
            sent_count = ok.sum(dim=1, dtype=torch.int32)
            sent_hash = sent_digest(ok, src_f, dst_f, tmsg, flight,
                                    pay_f[:, 0]) if with_trace else None
        return (mrel, msrc, mpay, overflow_step, bad_dst_step,
                bad_delay_step, short_step, route_drop_step, sent_count,
                sent_hash, fault_step, strag)

    def _route(self, *args):
        """Step 6, the routing stage, in the engine's regime, over
        world-axis tensors. An engine subclass replaces it
        (fused_sparse.py) and keeps everything else."""
        if self.adaptive:
            return self._route_firecompact(*args)
        return self._route_flat(*args)

    def _superstep(self, st: EngineState, node_next, t, with_trace: bool):
        """One superstep of every world of the world-axis state ``st``,
        from the popped ``node_next`` ``[B, N]`` and ``t`` ``[B]``:
        ``(new_state, trace_rows, plane_rows)``, the rows int64 ``[B, 8]``
        when ``with_trace``, the plane rows a :class:`PlaneRows` when a
        plane is on (else None). A world with nothing to do computes an
        unused result (the run loop freezes it)."""
        sc = self.scenario
        K, P = sc.mailbox_cap, sc.payload_width
        n = self.comm.n_local
        B = st.wake.shape[0]
        node_ids = self._node_ids
        base = st.time                                            # [B]
        W = self.window
        ft = self._world.ft
        mb_live = st.mb_rel < I32MAX                              # [B, K, N]
        tt = t[:, None]
        if self._dyn is not None:
            # the chunk's window (clamped to [1, bound] by `run`) and, under
            # a fault schedule, each world's degraded link floor over
            # [t, t + window): a degradation window narrows exactly the
            # supersteps it overlaps. Device tensors only: no host sync
            Wv = self._dyn.window
            if ft is not None:
                Wv = window_floor(ft, t, Wv, W)
            W = Wv.reshape(-1, 1)                                 # [B|1, 1]
        self._w_now = W

        # 2. windowed firing, each node at its own instant
        fire = (node_next < NEVER) & (node_next - tt < W)
        now_vec = torch.where(fire, node_next, tt)                # [B, N]
        shift32 = torch.clamp(t - base, max=I32MAX - 1).to(torch.int32)
        nrel = torch.clamp(now_vec - base[:, None],
                           max=I32MAX - 1).to(torch.int32)

        # restart bookkeeping: reboot rows whose node fires at its t_up
        # consume; the node's state resets and its mailbox entries older
        # than the crash are purged (counted, never delivered)
        restart_done, purge = st.restart_done, None
        fault_purged = self._zeros(B)
        states_in = st.states
        if ft is not None and self._has_reset:
            reset_now, purge_before = restart_fire(
                ft, fire, now_vec, node_ids, st.restart_done)
            restart_done = consume_restarts(ft, fire, now_vec, node_ids,
                                            st.restart_done)
            purge = mb_live & ((base[:, None, None] + st.mb_rel.long())
                               < purge_before[:, None, :])
            fault_purged = purge.sum(dim=(1, 2), dtype=torch.int32)
            states_in = {k: torch.where(
                reset_now.view((B, n) + (1,) * (v.dim() - 2)),
                self._reset_states[k], v) for k, v in st.states.items()}
            if self._rec_extra is not None:
                # the injected reboot firing, and every mailbox entry its
                # memory loss purged (slot-major, as the reference's)
                self._rec_fault(TAG_RESTART, reset_now, node_ids, node_ids,
                                -1, now_vec)
                self._rec_fault(TAG_PURGE, purge,
                                st.mb_src if sc.inbox_src else 0,
                                node_ids.view(1, 1, n), -1, st.mb_rel,
                                t_off=base)
        deliver = mb_live & (st.mb_rel <= nrel[:, None, :]) \
            & fire[:, None, :]
        if purge is not None:
            deliver = deliver & ~purge

        # 3. inbox: delivered slots first, by (time, slot) — a stable sort
        #    on the packed (undelivered, rel) key keeps slot order on ties.
        #    Commutative inboxes waive the order.
        if sc.commutative_inbox:
            ib_valid, ib_rel = deliver, st.mb_rel
            ib_src, ib_pay = st.mb_src, st.mb_payload
        else:
            rel_key = torch.where(deliver, st.mb_rel, I32MAX)
            order = _sort_rows(((~deliver).long() << 32)
                               | (rel_key.long() + 2**31), 1)
            ib_valid = deliver.gather(1, order)
            ib_rel = rel_key.gather(1, order)
            ib_src = st.mb_src.gather(1, order)
            ib_pay = st.mb_payload.gather(
                1, order[:, :, None, :].expand(B, K, P, n))
        inbox = Inbox(
            valid=_nodes_minor(ib_valid),
            src=_nodes_minor(torch.where(ib_valid, ib_src, 0)
                             if sc.inbox_src else torch.zeros_like(ib_src)),
            time=_nodes_minor(torch.where(ib_valid,
                                          base[:, None, None]
                                          + ib_rel.long(), NEVER)),
            payload=_nodes_minor(torch.where(ib_valid[:, :, None, :],
                                             ib_pay, 0)))

        # 4. fire every node of every world simultaneously, the worlds'
        #    nodes side by side (in-world ids); mask non-fired results
        w = self._world
        bits = None
        if sc.needs_key:
            b0, b1 = fire_bits(w.s0, w.s1, node_ids[None, :], now_vec)
            bits = (b0.reshape(B * n), b1.reshape(B * n))
        step = sc.step
        if ft is not None and self._has_skew:
            # the node's VIEW of time shifts; entropy keys, digests and
            # fault windows stay on true time
            step = skewed_step(sc.step, ft.skew)
        flat_states = {k: v.reshape((B * n,) + v.shape[2:])
                       for k, v in states_in.items()}
        new_states, out, new_wake = step(
            flat_states, inbox, now_vec.reshape(B * n),
            self._flat_ids(B), bits)
        states = {k: torch.where(
            fire.view((B, n) + (1,) * (v.dim() - 2)),
            new_states[k].reshape(v.shape), v)
            for k, v in st.states.items()}
        new_wake = new_wake.reshape(B, n)
        new_wake = torch.where(new_wake >= NEVER, NEVER,
                               torch.maximum(new_wake, now_vec + 1))
        wake = torch.where(fire, new_wake, st.wake)
        out = Outbox(valid=_worlds_major(out.valid, B),
                     dst=_worlds_major(out.dst, B),
                     payload=_worlds_major(out.payload, B))
        out_valid = out.valid & fire[:, None, :]                  # [B, M, N]
        senders = out_valid.any(dim=1).sum(dim=1, dtype=torch.int32) \
            if with_trace and self.telemetry != "off" else None

        # 5. drop delivered messages, rebase to the new epoch t.
        #    Commutative: freed slots become holes (mb_src / mb_payload
        #    pass on unchanged — stale in holes, never read). Ordered: a
        #    stable sort on `not kept` compacts kept rows in slot order.
        keep = mb_live & ~deliver
        if purge is not None:
            keep = keep & ~purge
        if sc.commutative_inbox:
            mb_rel = torch.where(keep, st.mb_rel - shift32[:, None, None],
                                 I32MAX)
            mb_src, mb_payload, counts = st.mb_src, st.mb_payload, None
        else:
            order = _sort_rows((~keep).to(torch.int32), 1)
            kept = keep.gather(1, order)
            mb_rel = torch.where(kept, st.mb_rel.gather(1, order)
                                 - shift32[:, None, None], I32MAX)
            mb_src = st.mb_src.gather(1, order)
            mb_payload = st.mb_payload.gather(
                1, order[:, :, None, :].expand(B, K, P, n))
            counts = kept.sum(dim=1, dtype=torch.int32)

        # 6. route, sample, insert
        res = self._route(out, out_valid, now_vec, t, mb_rel, mb_src,
                          mb_payload, counts, with_trace)
        (mb_rel, mb_src, mb_payload, overflow_step, bad_dst_step,
         bad_delay_step, short_step, route_drop_step, sent_count,
         sent_hash) = res[:10]
        fault_step = fault_purged + res[10] if len(res) > 10 \
            else fault_purged
        strag = res[11] if len(res) > 11 else None
        return self._finish_superstep(
            st, states, wake, mb_rel, mb_src, mb_payload, deliver, fire,
            now_vec, t, base, overflow_step, bad_dst_step, bad_delay_step,
            short_step, route_drop_step, sent_count, sent_hash, fault_step,
            restart_done, with_trace, senders, strag)

    def _flat_ids(self, B: int) -> torch.Tensor:
        """The step's node ids for B worlds side by side: in-world ids,
        ``[B·N]``."""
        if B == 1:
            return self._node_ids
        return self._node_ids.repeat(B)

    def _record(self, st, deliver, fire, now_vec, base):
        """This superstep's events appended to the ring (solo states):
        fires in ascending node order, then deliveries node-major in slot
        order. Each ring slot is written at most once; an event past the
        capacity E goes to a spare slot E that is cut off, while
        ``ev_count`` keeps counting (the overflow evidence)."""
        sc = self.scenario
        K, n, E = sc.mailbox_cap, self.comm.n_local, self.record_events
        node_ids = self._node_ids
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
                          mb_payload, deliver, fire, now_vec, t, base,
                          overflow_step, bad_dst_step, bad_delay_step,
                          short_step, route_drop_step, sent_count,
                          sent_hash, fault_step, restart_done, with_trace,
                          senders=None, strag=None):
        """Assemble the post-superstep state, the event ring included,
        and (optionally) each world's trace row ``(t, fired_count,
        fired_hash, recv_count, recv_hash, sent_count, sent_hash,
        overflow)`` and plane rows."""
        sc = self.scenario
        K, n = sc.mailbox_cap, self.comm.n_local
        node_ids = self._node_ids
        recv_count = deliver.sum(dim=(1, 2), dtype=torch.int32)
        traced = ()
        if with_trace:
            # trace digests (order-independent): from the pre-sort mask
            fired_hash = u32sum(torch.where(fire, mix32(FIRED, node_ids),
                                            0), dim=1)
            d_abs = base[:, None, None] + torch.where(deliver, st.mb_rel,
                                                      0).long()
            recv_mix = mix32(
                RECV, node_ids.view(1, 1, n),
                st.mb_src if sc.inbox_src else torch.zeros_like(st.mb_src),
                tlo(d_abs), thi(d_abs), st.mb_payload[:, :, 0, :])
            recv_hash = u32sum(torch.where(deliver, recv_mix, 0),
                               dim=(1, 2))
            traced = (fire.sum(dim=1), fired_hash, recv_hash, sent_count,
                      sent_hash)
        # the step's counters and digests over every device, in one
        # reduction (the identity on one device; digests wrap at 2^32)
        sums = self.comm.all_sum(
            (overflow_step, bad_dst_step, bad_delay_step, short_step,
             route_drop_step, recv_count, fault_step) + traced
            + (() if senders is None else (senders,)),
            u32=(8, 9, 11) if traced else ())
        (overflow_step, bad_dst_step, bad_delay_step, short_step,
         route_drop_step, recv_count, fault_step) = sums[:7]
        if senders is not None:
            senders = sums[-1]
        ev_time, ev_meta, ev_count = st.ev_time, st.ev_meta, st.ev_count
        if self.record_events:
            one = map_state(lambda x: x[0], st)
            ev_time, ev_meta, ev_count = (x[None] for x in self._record(
                one, deliver[0], fire[0], now_vec[0], base[0]))
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
            time=t, ev_time=ev_time, ev_meta=ev_meta, ev_count=ev_count,
            fault_dropped=st.fault_dropped + fault_step,
            restart_done=restart_done)
        if not with_trace:
            return new_st, None, None
        planes = None
        if self._planes_on:
            planes = self._plane_rows(st, new_st, deliver, mb_rel, t, base,
                                      senders, route_drop_step, fault_step,
                                      short_step, strag)
        fired_count, fired_hash, recv_hash, sent_count, sent_hash = \
            sums[7:12]
        rows = torch.stack([
            t, fired_count, fired_hash, recv_count.long(), recv_hash,
            sent_count.long(), sent_hash, overflow_step.long()], dim=1)
        return new_st, rows, planes

    def _plane_rows(self, st, new_st, deliver, mb_rel, t, base, senders,
                    route_drop_step, fault_step, short_step=None,
                    strag=None) -> PlaneRows:
        """This superstep's plane rows (reference ``_finish_superstep``'s
        ``telem``/``rec``/``integ``/``spec``), from values it already
        computed."""
        telem = integ = rec = spec = None
        if self.telemetry != "off":
            telem = self._telemetry_row(senders, route_drop_step,
                                        fault_step, new_st.wake, mb_rel, t)
        if self.record != "off":
            # deliveries node-major, slot order, then the captures
            sc = self.scenario
            rec = self._record_row(
                deliver.transpose(1, 2),
                st.mb_src.transpose(1, 2) if sc.inbox_src else 0,
                self._node_ids.view(1, -1, 1), st.mb_rel.transpose(1, 2),
                base)
        if self.verify != "off":
            from ...integrity.checks import make_guard_row
            n = new_st
            integ = torch.stack(make_guard_row(
                self.comm, t, st.time,
                (n.overflow, n.bad_dst, n.bad_delay, n.short_delay,
                 n.route_drop, n.fault_dropped, n.delivered, n.steps,
                 n.time, n.ev_count),
                n.wake, NEVER, (mb_rel,), st.restart_done, n.restart_done,
                self._faulted), dim=1)
        if self.speculate != "off":
            # the causality plane: the violations ARE the short_delay step
            # count, the committed horizon t + the effective window, and
            # the earliest offending delivery (NEVER when clean)
            w = self._w_now
            horizon = t + (w.reshape(-1) if isinstance(w, torch.Tensor)
                           else w)
            spec = torch.stack([
                short_step.long(), horizon,
                torch.full_like(t, NEVER) if strag is None else strag],
                dim=1)
        return PlaneRows(telem, integ, rec, spec)

    def _lint_body(self, state: EngineState):
        """One superstep of every world with the trace on, from a solo or
        fleet state: ``_pop`` and ``_superstep``, without the run loop's
        host read of the popped minimum (analysis/determinism.py traces
        this body, the reference's ``_step_all``)."""
        st = self._start(state)
        node_next, t, _ = self._pop(st)
        if self.record == "full":
            self._rec_extra = []      # the run loop's per-superstep captures
        try:
            return self._superstep(st, node_next, t, True)
        finally:
            self._rec_extra = None

    # -- run loops ---------------------------------------------------------

    def _start(self, state: Optional[EngineState]) -> EngineState:
        """A run's first state in world form (a solo state gains a world
        axis of 1, as views): a fresh one, or ``state`` if its event ring
        has this engine's capacity."""
        if state is None:
            state = self.init_state()
        elif tuple(state.ev_meta.shape[-2:]) != (4, self.record_events):
            raise ValueError(
                f"state's event ring holds {state.ev_meta.shape[-1]} "
                f"events, this engine's record_events={self.record_events}")
        if self.batch is None:
            return map_state(lambda x: x.unsqueeze(0), state)
        return state

    def _end(self, st: EngineState) -> EngineState:
        return map_state(lambda x: x[0], st) if self.batch is None else st

    def _budgets(self, max_steps) -> np.ndarray:
        """A run's step budget per world: one int (solo, or every world),
        or — fleets only — one budget per world."""
        if isinstance(max_steps, (int, np.integer)):
            if max_steps < 0:
                raise ValueError("step budgets must be >= 0")
            return np.full(self.B, int(max_steps), np.int64)
        budgets = np.asarray(max_steps)
        if self.batch is None:
            raise ValueError(
                "per-world step budgets need batch=BatchSpec; a solo "
                f"run takes one int budget (got shape {budgets.shape})")
        if budgets.shape != (self.B,) or budgets.dtype.kind not in "iu":
            raise ValueError(
                f"per-world budgets must be one int per world, shape "
                f"[{self.B}]; got shape {budgets.shape} dtype "
                f"{budgets.dtype}")
        if budgets.size and int(budgets.min()) < 0:
            raise ValueError("step budgets must be >= 0")
        return budgets.astype(np.int64)

    def _drive(self, max_steps, state, with_trace: bool):
        """The run loop over every world: each iteration pops every
        world's ``t`` (the one host sync), steps the worlds that are live
        and inside their budget, and leaves the others bit-frozen — a
        world stops exactly where its solo run stops. The traced loop
        (``run``) tests liveness after the schedule's deferrals, the quiet
        one (``run_quiet``) keeps going only while some world within its
        budget has an undeferred pending event, as the reference's two
        drivers do. Returns the final state and, traced, each world's
        rows; a traced run with a plane on also captures the planes'
        rows (planes.py)."""
        st = self._start(state)
        budgets = self._budgets(max_steps)
        done = np.zeros(len(budgets), np.int64)
        planes_on = with_trace and self._planes_on
        steps_at = st.steps.cpu().numpy() if planes_on else None
        steps0 = int(st.steps.sum())
        t0 = time.perf_counter()
        rows, acts, planes, iters = [], [], [], 0
        rec_full = planes_on and self.record == "full"
        steps_first, budgets_dev = st.steps, None
        try:
            while True:
                if rec_full:
                    self._rec_extra = []
                node_next, t, t_raw = self._pop(st)
                hs = torch.stack([t, t_raw]).cpu().numpy()
                left = done < budgets
                act = (hs[0] < NEVER) & left
                go = act if with_trace else (hs[1] < NEVER) & left
                if not all(self._any_world(np.array([go.any(),
                                                     act.any()]))):
                    break
                new, row, pl = self._superstep(st, node_next, t, with_trace)
                if not act.all():
                    if budgets_dev is None:     # one copy a run, not a step
                        budgets_dev = torch.as_tensor(budgets,
                                                      device=self.device)
                    # the host's `act` computed on the device: a world is
                    # live and inside its budget (its steps count the
                    # supersteps it ran) — no copy from the host here
                    keep = (t < NEVER) & (st.steps - steps_first
                                          < budgets_dev)
                    new = type(st)(*(
                        {k: torch.where(_bcast(keep, v), v, st.states[k])
                         for k, v in x.items()} if isinstance(x, dict)
                        else torch.where(_bcast(keep, x), x, y)
                        for x, y in zip(new, st)))
                st = new
                done += act
                iters += 1
                if with_trace:
                    rows.append(row)
                    acts.append(act)
                    if pl is not None:
                        planes.append(pl)
        finally:
            self._rec_extra = None
        # the sum waits for the device, so the wall time covers the work
        self.last_run_stats = run_stats(t0, steps0, int(st.steps.sum()))
        #: the loop's iterations: one superstep of every world each
        self.last_run_stats["fleet_supersteps"] = iters
        if not with_trace:
            return self._end(st), None
        cols = torch.stack(rows).cpu().numpy() if rows else \
            np.zeros((0, len(budgets), 8), np.int64)
        act = np.asarray(acts, bool).reshape(-1, len(budgets))
        cols, act, planes, steps_at = self._gather_rows(cols, act, planes,
                                                        steps_at)
        if planes_on:
            self._capture_planes(planes, act, cols[:, :, 0], steps_at)
        traces = [SuperstepTrace.from_columns(cols[act[:, b], b].T)
                  for b in range(self.B)]
        return self._end(st), traces

    def run(self, max_steps, state: Optional[EngineState] = None, *,
            _dyn=None):
        """Execute up to ``max_steps`` supersteps (each world stopping
        early once quiesced); returns the final state and the trace of
        the supersteps that fired — for a fleet, a list of per-world
        traces, and ``max_steps`` may be one budget per world. ``_dyn``
        (a :class:`DynDispatch`) is the chunk's window from the
        controlled and speculative drivers; it needs a controller or
        speculation, so a stray caller cannot run off-spec values. A
        speculating run raises the pinned ``SpeculationViolation`` on its
        first straggler."""
        if _dyn is not None:
            if self.controller is None and self.speculate == "off":
                raise ValueError(
                    "_dyn carries dispatch-controller knob values; build "
                    "the engine with controller= (docs/dispatch.md) or "
                    "speculate= (docs/speculation.md)")
            # clamped once a run; the superstep reads the tensor as is
            _dyn = _dyn._replace(window=torch.clamp(torch.as_tensor(
                _dyn.window, dtype=torch.int64, device=self.device),
                1, self.window))
        self._dyn = _dyn
        try:
            st, traces = self._drive(max_steps, state, True)
        finally:
            self._dyn = None
        return st, (traces[0] if self.batch is None else traces)

    def run_quiet(self, max_steps,
                  state: Optional[EngineState] = None) -> EngineState:
        """Traceless run: no digest work and no plane rows (under
        ``verify != "off"`` the final state is guarded; speculating, a
        positive ``short_delay`` delta raises ``SpeculationViolation``).
        Stops at quiescence or after ``max_steps`` supersteps (per world
        for a fleet, which may take one budget per world)."""
        final = self._drive(max_steps, state, False)[0]
        self._quiet_guard(final)
        if self.speculate != "off":
            self._quiet_spec_guard(state, final)
        return final

    # -- the streaming fleet driver -----------------------------------------

    def world_active(self, state) -> torch.Tensor:
        """Per-world liveness: True while world b still has a pending
        event (a 0-d tensor for a solo state)."""
        return self._next_event(state) < NEVER

    def fleet_progress(self, state, budgets, start=0):
        """Host-side fleet bookkeeping: per-world ``(steps_done,
        remaining, active)``, ``steps_done`` measured from ``start``,
        ``remaining`` the clipped budgets, and a world active while it
        has a pending event and budget left."""
        steps_done = (self._host_worlds(state.steps).astype(np.int64)
                      - np.asarray(start, np.int64))
        remaining = np.maximum(np.asarray(budgets, np.int64)
                               - steps_done, 0)
        active = self._host_worlds(self.world_active(state)) \
            & (remaining > 0)
        return steps_done, remaining, active

    def run_stream(self, budgets, state: Optional[EngineState] = None,
                   *, chunk: int = 64, on_chunk=None, on_quiesce=None):
        """Chunked fleet driver with per-world budgets and quiesce
        callbacks: ``chunk`` supersteps at a time, each world capped at its
        own remaining budget — bit-identical to one uninterrupted run.
        After every chunk ``on_chunk(state, chunk_traces)`` fires;
        ``on_quiesce(b, state)`` fires once per world, the moment it has
        quiesced or used its budget. On the world-sharded engine both get
        the gathered state (world b at index b), gathered only for a
        chunk whose callback fires. Returns ``(final_state,
        per_world_traces)`` like :meth:`run`; the whole run's telemetry
        frames and flight log land on ``last_run_telemetry`` and
        ``last_run_flight`` (each chunk flushed to an attached metrics
        registry as it ran)."""
        if self.batch is None:
            raise ValueError(
                "run_stream drives a fleet; solo runs use run()")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        B = self.batch.B
        budgets = np.broadcast_to(
            np.asarray(budgets, np.int64), (B,)).copy()
        if budgets.size and int(budgets.min()) < 0:
            raise ValueError("step budgets must be >= 0")
        st = state if state is not None else self.init_state()
        start = self._host_worlds(st.steps).astype(np.int64)
        rows = [[] for _ in range(B)]
        emitted = np.zeros(B, bool)
        chunk_stats, frame_chunks, flight_chunks = [], [], []
        while True:
            _, remaining, active = self.fleet_progress(st, budgets, start)
            newly = np.nonzero(~active & ~emitted)[0]
            seen = self._callback_state(st) \
                if newly.size and on_quiesce is not None else None
            for b in newly:
                emitted[int(b)] = True
                if on_quiesce is not None:
                    on_quiesce(int(b), seen)
            if not active.any():
                break
            vec = np.where(active, np.minimum(remaining, chunk), 0)
            st, traces = self.run(vec, state=st)
            chunk_stats.append(self.last_run_stats)
            frame_chunks.append(self.last_run_telemetry)
            flight_chunks.append(self.last_run_flight)
            if on_chunk is not None:
                on_chunk(self._callback_state(st), traces)
            for b in range(B):
                rows[b].extend(traces[b].row(i)
                               for i in range(len(traces[b])))
        if self.telemetry != "off":
            from ...obs.telemetry import concat_frames
            self.last_run_telemetry = concat_frames(frame_chunks)
        if self.record != "off":
            from ...obs.flight import concat_flight
            self.last_run_flight = concat_flight(flight_chunks)
        if chunk_stats:
            self.last_run_stats = stats_merge(chunk_stats)
        return st, [SuperstepTrace.from_rows(r) for r in rows]

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

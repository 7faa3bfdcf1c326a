"""Shape-bucketing: pack heterogeneous configs into batched executables
(the port's copy of ``timewarp_tpu/sweep/bucket.py``).

A bucket is the largest set of pack configs one batched engine can
serve (engine.py ``batch=BatchSpec``): same scenario family and
builder params (one ``Scenario``, one compiled superstep), same link
*structure* (:func:`~timewarp_tpu_torch.sweep.spec.link_signature`), and the
same solo-resolved window. The key is pure **shape** (plus the
per-bucket decision-source modes, ``_bucket_key``): everything that
picks *which engine* a world runs in. Per-world **identity** — seed
words, sweepable link values, fault tables — rides that engine as
``[B, 1]`` tensors (``WorldIdentity``,
interp/torch_engine/batched.py) and never splits a bucket; swapping
identity rebinds the SAME engine with new device tensors
(``TorchEngine.rebind_identity``, the serving layer's zero-rebuild
admission). Inside a bucket, worlds differ by:

- **seed** — ``BatchSpec.seeds``;
- **sweepable link values** — delay bounds / medians / sigmas /
  quanta as ``BatchSpec.link_params`` dotted-path vectors;
- **fault schedule** — a :class:`~timewarp_tpu_torch.faults.schedule.
  FaultFleet` (schedules of different lengths pad with inert rows;
  worlds without faults run an empty schedule — result-identical to
  no schedule at all, which is what keeps the sweep survival law's
  solo twin honest);
- **step budget** — a per-world budget vector (``TorchEngine.run``
  freezes each world at its own budget).

Under ``pack_mode="first-fit"`` (the default) the plan is a *pure
function of the pack* (dict-insertion order over the pack's config
order, chunked at ``max_bucket``), so a resumed sweep re-derives
bucket membership exactly from the journaled pack — no plan state
needs journaling beyond splits. Under ``pack_mode="predicted"``
(timewarp_tpu_torch/pack/, docs/sweeps.md "Predictive packing") each shape
group is reordered best-fit-decreasing by forecast supersteps before
chunking — the plan is then a pure function of ``(pack, artifact)``,
and the service journals one ``pack_decision`` record per bucket
BEFORE any bucket starts, so resume replays the identical plan
without needing the artifact at all.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .spec import (RunConfig, link_signature, link_sweep_params,
                   linted_scenario, resolve_window)

__all__ = ["Bucket", "plan_buckets", "bucket_identity",
           "build_bucket_engine", "tile_world_state"]


@dataclass(frozen=True)
class Bucket:
    # NOTE: `controller` property below reports whether this bucket's
    # worlds run under online adaptive dispatch (all members agree —
    # it is part of the bucket key).
    """One schedulable unit: an ordered world list sharing a batched
    executable. ``bucket_id`` is stable across resume (derived from
    the deterministic plan; split children append ``.0``/``.1``).

    ``fault_pad`` pins the fault-table row counts (crash, partition,
    link-window) the bucket's FaultFleet must pad to. Split children
    of a bucket that already ran carry the parent's realized pad so
    the sliced ``restart_done`` state keeps its column count — pad
    rows are inert, so results are identical at any pad
    (faults/schedule.py FaultTables docstring)."""
    bucket_id: str
    configs: Tuple[RunConfig, ...]
    window: int
    fault_pad: Optional[Tuple[int, int, int]] = None

    @property
    def B(self) -> int:
        return len(self.configs)

    @property
    def run_ids(self) -> Tuple[str, ...]:
        return tuple(c.run_id for c in self.configs)

    @property
    def budgets(self) -> np.ndarray:
        return np.asarray([c.budget for c in self.configs], np.int64)

    @property
    def controller(self) -> bool:
        return self.configs[0].controller == "auto"

    @property
    def speculate(self) -> str:
        """The bucket's optimistic-execution mode (all members agree
        — part of the bucket key): the whole fleet speculates one
        window sequence, and ANY world's violation rolls the chunk
        back for every world (speculate/, docs/speculation.md)."""
        return self.configs[0].speculate

    def split(self) -> Tuple["Bucket", "Bucket"]:
        """Halve the bucket (the OOM degradation path, service.py):
        two children over the same window, ids suffixed so resume can
        replay the split from the journal. A solo bucket cannot
        split — the caller turns that OOM into a terminal failure."""
        if self.B < 2:
            raise ValueError(
                f"bucket {self.bucket_id!r} holds one world; OOM on a "
                "solo run cannot be split away")
        mid = self.B // 2
        return (Bucket(f"{self.bucket_id}.0", self.configs[:mid],
                       self.window, self.fault_pad),
                Bucket(f"{self.bucket_id}.1", self.configs[mid:],
                       self.window, self.fault_pad))


def _bucket_key(cfg: RunConfig):
    # the bucket key is the executable's SHAPE — scenario family +
    # params, link structure, resolved window — plus the per-bucket
    # decision-source modes. Seed / link values / fault schedules are
    # per-world IDENTITY: traced operands of the shared executable
    # (module docstring), deliberately absent from the key.
    # controller is part of the key: the dispatch controller makes
    # ONE decision sequence per bucket (journaled; replayed by every
    # member's solo twin), so controller-on and controller-off worlds
    # can never share an executable's chunking. speculate likewise:
    # the speculation policy is a per-bucket decision source with
    # per-bucket rollbacks (speculate/); the serving frontend's
    # bucket_key_sha mirrors this key (minus controller, refused at
    # admission there).
    return (cfg.family, cfg.params, link_signature(cfg.parse_link()),
            resolve_window(cfg), cfg.controller, cfg.speculate)


def plan_buckets(configs, max_bucket: int = 64, *,
                 pack_mode: str = "first-fit",
                 predict=None) -> List[Bucket]:
    """Deterministic shape-bucketing of a pack (module docstring).
    ``max_bucket`` caps worlds per bucket. ``pack_mode="first-fit"``
    chunks oversize groups in pack order (byte-identical to the
    historical planner); ``"predicted"`` reorders each group
    best-fit-decreasing by ``predict(cfg)`` forecast supersteps
    (``pack/allocate.predicted_order`` — budget fallback when no
    predictor is given), equalizing per-bucket quiescence horizons."""
    from ..pack.allocate import predicted_order, validate_pack_mode
    validate_pack_mode(pack_mode, "plan_buckets pack_mode")
    if max_bucket < 1:
        raise ValueError(f"max_bucket must be >= 1, got {max_bucket}")
    groups: Dict[tuple, List[RunConfig]] = {}
    for cfg in configs:
        groups.setdefault(_bucket_key(cfg), []).append(cfg)
    buckets: List[Bucket] = []
    for key, cfgs in groups.items():
        if pack_mode == "predicted":
            cfgs = predicted_order(
                cfgs, predict if predict is not None
                else (lambda c: c.budget))
        for i in range(0, len(cfgs), max_bucket):
            part = tuple(cfgs[i:i + max_bucket])
            buckets.append(Bucket(f"b{len(buckets)}", part, key[3]))
    return buckets


def bucket_identity(bucket: Bucket):
    """The bucket's per-world identity as ``(spec, links, fleet)``: the
    :class:`~timewarp_tpu_torch.interp.torch_engine.batched.BatchSpec`
    of seeds and sweepable link values, every world's link model, and
    the padded :class:`~timewarp_tpu_torch.faults.schedule.FaultFleet`
    (None when no world has faults and no pad is pinned). The serving
    layer's open buckets rebind an engine to it
    (``TorchEngine.rebind_identity``) before paying for a build."""
    from ..faults.schedule import FaultFleet, FaultSchedule
    from ..interp.torch_engine.batched import BatchSpec

    cfgs = bucket.configs
    links = [c.parse_link() for c in cfgs]
    rows = [link_sweep_params(lk) for lk in links]
    link_params = {path: np.asarray([r[path] for r in rows])
                   for path in rows[0]} if rows[0] else None
    spec = BatchSpec(seeds=tuple(c.seed for c in cfgs),
                     link_params=link_params)
    scheds = [c.parse_faults() or FaultSchedule(()) for c in cfgs]
    pad = bucket.fault_pad
    if pad is not None and tuple(pad) != (0, 0, 0):
        # grow world 0's tables to (at least) the pinned shape; the
        # fleet pads every other world up to the max, so the whole
        # fleet lands on the parent's realized row counts
        s0 = scheds[0]
        scheds[0] = s0.padded(
            max(pad[0], len(s0.crashes) + s0.pad[0]),
            max(pad[1], len(s0.partitions) + s0.pad[1]),
            max(pad[2], len(s0.link_windows) + s0.pad[2]))
    empty = all(not s.events for s in scheds)
    fleet = None if empty and (pad is None or tuple(pad) == (0, 0, 0)) \
        else FaultFleet(tuple(scheds))
    return spec, links, fleet


def build_bucket_engine(bucket: Bucket, *, lint: str = "warn",
                        telemetry: str = "off", controller=None,
                        verify: str = "off", record: str = "off",
                        record_cap=None, device=None):
    """One batched :class:`~timewarp_tpu_torch.interp.torch_engine.
    engine.TorchEngine` on ``device`` (the card by default) serving
    every world of the bucket: K2 and K1 run once per fleet superstep
    for all of its worlds. World b's seed,
    sweepable link values, and (padded) fault schedule are exactly
    the solo run's (:func:`bucket_identity`) — the batch exactness law
    then carries the sweep
    survival law (telemetry included: the counter planes feed nothing
    back, so the streamed results are mode-independent, obs/)."""
    from ..interp.torch_engine.engine import TorchEngine
    from .spec import check_lint

    check_lint(lint, "build_bucket_engine")
    cfgs = bucket.configs
    sc = linted_scenario(cfgs[0].family, cfgs[0].params, lint)
    spec, links, fleet = bucket_identity(bucket)
    if bucket.controller and telemetry == "off":
        # an auto controller reads last_run_telemetry between chunks
        # — a controller bucket without the sensor layer cannot
        # decide; force the cheap counters mode (bit-exact by the
        # telemetry law, so streamed results are unchanged)
        telemetry = "counters"
    # verify is bit-exact like telemetry (the guard plane feeds
    # nothing back), so streamed results stay mode-independent and
    # the sweep survival law's solo twin needs no knob of its own
    # record is bit-exact like telemetry/verify (the event plane
    # feeds nothing back), so streamed results stay mode-independent
    eng = TorchEngine(sc, links[0], window=bucket.window, batch=spec,
                      faults=fleet, telemetry=telemetry,
                      controller=controller, verify=verify,
                      record=record, record_cap=record_cap,
                      speculate=bucket.speculate, lint=lint, device=device)
    eng.metrics_label = f"bucket:{bucket.bucket_id}"
    return eng


def tile_world_state(engine, solo_state):
    """Fork-from-snapshot bucket admission (timewarp_tpu_torch/search/fork,
    docs/search.md): broadcast ONE world's solo-shaped state slice
    (``utils.checkpoint.load_world_state``) across every world of
    ``engine``'s batch — the initial state of a counterfactual fork
    fleet, where K continuation worlds share a snapshot prefix and
    diverge only through their fault-schedule suffixes. Worlds are
    independent and the copies are bit-identical, so world b of the
    fork fleet ≡ a solo continuation of the snapshot under schedule b
    by the batch exactness law (padding rows inert, identical seeds
    ⇒ identical entropy streams). The copies land on the engine's
    device."""
    if engine.batch is None:
        raise ValueError(
            "tile_world_state targets a batched engine (the fork "
            "fleet); a solo continuation just resumes load_state's "
            "result directly")
    from ..interp.torch_engine.batched import map_state
    B, dev = engine.batch.B, engine.device
    return map_state(lambda x: x.to(dev).unsqueeze(0).repeat(
        (B,) + (1,) * x.dim()), solo_state)

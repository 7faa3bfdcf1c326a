"""Open buckets: reserved world slots, mid-bucket admission, repack
(the port of ``timewarp_tpu/serve/worker.py`` onto ``TorchEngine``).

An **open bucket** is a batched executable with a fixed capacity of
world slots, only some of which hold admitted configs. A reserved
(empty) slot runs with budget 0 — the per-world budget masking the
sweep drivers already pin means it never executes a superstep, so its
state stays the scenario's shared *seed-independent* initial state
(``TorchEngine.init_state`` stacks one init per world; worlds diverge
only through per-world entropy). That is the whole admission trick:

- **admitting** a config into a free slot between chunks needs NO
  state splice — the slot is already bit-identical to the admitted
  config's solo start. Per-world identity (seed words, sweepable
  link values, fault tables) rides the engine as ``[B, 1]`` device
  tensors (``WorldIdentity``, interp/torch_engine/batched.py), so
  admission is a device write: recompute the slot's identity rows
  from the member table, ``rebind_identity`` them onto the SAME
  engine instance, and flip the world's budget on — zero rebuilds
  (the zero-rebuild law, tests/test_zzzzzzzzzzoperand.py;
  ``engine_builds`` counts builds as the reference does, and
  ``compiles`` stays 0: the port compiles nothing per run). A full
  ``_build`` survives only for the first chunk and for fault-pad
  growth, the one admission shape that changes the identity tensors'
  *shapes* rather than their values.
  By the batch exactness law, every world — old and new — continues
  bit-identical to its solo run.
- **fault-pad growth**: an admitted faulted config may need more
  fault-table rows than the bucket realized so far; the rebuilt fleet
  pads every world up, and the in-flight state's ``restart_done``
  ledger gains False columns for the appended rows (a ``torch.cat``
  on the state's device) — exact, because
  pad rows are inert (the pad-inertness law, faults/schedule.py,
  re-pinned at a wider pad by the r18 fork law).
- **re-packing** (docs/serving.md): an under-occupied open bucket can
  be merged into a same-key peer between chunks — each still-active
  world's state slice, digest chain, supersteps, and trail move into
  a free slot of the target (worlds are independent; a slice splice
  is exact by the same law), and the donor closes. The donor's slice
  is copied to the host, and the splice writes it into fresh tensors:
  no rollback snapshot, retained state or donor tensor ever sees the
  write. The occupancy
  numbers driving the decision are exactly the journaled
  ``bucket_util`` arithmetic (sweep/runner.py).

The runner is the serving analogue of ``sweep/runner.BucketRunner``
(chunk loop, digest chains, streamed ``world_done``, atomic
checkpoints) minus supervision-retry machinery — across hosts the
lease steal IS the retry — plus the mutable member table. Controller
configs are still refused at admission (frontend.py): the telemetry
controller's decision source assumes a fixed fleet. Speculate
configs ARE admitted — the bucket owns one persistent
:class:`~timewarp_tpu_torch.speculate.policy.SpeculationPolicy`, drives
chunks through ``run_speculative`` (masked per-world rollback), and
each slot accumulates its OWN committed decision chain
(``spec_chains``; ``last_run_decisions_world``), which is what keeps
per-world replay/audit well-defined when a masked rollback gives
violating worlds a different chunk granularity than clean ones.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from ..interp.torch_engine.engine import resolve_device
from ..sweep.bucket import Bucket, bucket_identity, build_bucket_engine
from ..sweep.journal import SweepJournal
from ..sweep.spec import (DIGEST_ZERO, RunConfig, chain_digest,
                          check_lint, result_leaves, world_result)

__all__ = ["OpenBucketRunner", "checkpoint_meta"]


def checkpoint_meta(path: str) -> Optional[dict]:
    """Read just the meta block of a ``save_state`` checkpoint —
    through the same ``_read_verified`` discipline as a full load
    (every leaf sha checked), because this meta STEERS repack and
    resume (member table, digests, fault pad): a torn checkpoint
    must fail here, loudly, not as a mis-shaped restore or a wrong
    repack three moves later (the at-rest half of the integrity
    detection law, utils/checkpoint.py)."""
    import os
    if not os.path.exists(path):
        return None
    from ..utils.checkpoint import _read_verified
    _, _, meta = _read_verified(path)
    return meta


def _grow_restart(state, new_c: int):
    """Pad the ``restart_done`` ledger's trailing (crash-row) axis to
    ``new_c`` columns of False on the state's device — the state half
    of fault-pad growth (module docstring)."""
    import torch
    rd = state.restart_done
    if rd.shape[-1] == new_c:
        return state
    pad = torch.zeros(rd.shape[:-1] + (new_c - rd.shape[-1],),
                      dtype=torch.bool, device=rd.device)
    return state._replace(restart_done=torch.cat([rd, pad], dim=-1))


def _put_rows(x, rows):
    """A fresh copy of ``x`` with row ``s`` set to ``v`` for every
    ``s -> v`` of ``rows``."""
    y = x.clone()
    for s, v in rows.items():
        y[s] = v.to(y.device)
    return y


def _splice_rows(state, slices):
    """``state`` with world ``s``'s slice replaced by ``sl`` for every
    ``s -> sl`` of ``slices``, written into fresh tensors: the runner's
    state may also be held by a rollback snapshot or a caller, so it is
    never written in place."""
    out = {}
    for f, cur in zip(state._fields, state):
        if isinstance(cur, dict):
            out[f] = {k: _put_rows(x, {s: getattr(sl, f)[k]
                                       for s, sl in slices.items()})
                      for k, x in cur.items()}
        else:
            out[f] = _put_rows(cur, {s: getattr(sl, f)
                                     for s, sl in slices.items()})
    return type(state)(**out)


class OpenBucketRunner:
    def __init__(self, bucket_id: str, journal: SweepJournal,
                 done: Dict[str, dict], *, capacity: int, window,
                 chunk: int = 64, lint: str = "off",
                 precommit: Optional[Callable[[], None]] = None,
                 telemetry: str = "off", device=None) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        #: the bucket engine's device: the card unless the caller
        #: passes device="cpu" (no CUDA and no device= raises here)
        self.device = resolve_device(device, type(self).__name__)
        self.bucket_id = bucket_id
        self.journal = journal
        self.done = done
        self.capacity = int(capacity)
        self.window = window
        self.chunk = int(chunk)
        self.lint = check_lint(lint, type(self).__name__)
        self.telemetry = telemetry
        #: called (holding no lock) immediately before any journal
        #: commit — the curator wires the lease check here, so a
        #: stolen-from host abandons instead of double-journaling
        self.precommit = precommit
        self.members: List[Optional[RunConfig]] = [None] * capacity
        self.digests = [DIGEST_ZERO] * capacity
        self.supersteps = [0] * capacity
        self.trails: List[list] = [[] for _ in range(capacity)]
        self.emitted = set(done)
        self.engine = None
        self.state = None
        self.chunks = 0
        self.wall_s = 0.0
        self._dirty = False
        #: realized fault pad floor — grows monotonically (a rebuild
        #: must never shrink the in-flight ``restart_done`` width)
        self.min_pad = (0, 0, 0)
        #: pending repack splices: slot -> (state_slice, digest,
        #: supersteps, trail), applied at the next rebuild
        self._splices: Dict[int, tuple] = {}
        #: per-slot COMMITTED speculation decision chains (JSON
        #: records) — the per-world replay/audit surface under masked
        #: rollback (module docstring); [] for non-speculating buckets
        self.spec_chains: List[list] = [[] for _ in range(capacity)]
        #: the bucket's persistent speculation decision source —
        #: survives admissions/rebinds so the ladder's committed-chain
        #: state carries across chunks; rebuilt from checkpointed
        #: decisions on restore
        self._spec_policy = None
        self._util_logged = -1
        #: ``compiles`` stays 0: the port compiles nothing per run
        #: (its kernels build once a process)
        self.util = {"chunks": 0, "world_supersteps": 0,
                     "scan_supersteps": 0, "pad_supersteps": 0,
                     "active_world_chunks": 0,
                     "engine_builds": 0, "compiles": 0}

    # -- membership --------------------------------------------------------

    def free_slots(self) -> List[int]:
        return [i for i, m in enumerate(self.members) if m is None]

    def slot_of(self, run_id: str) -> Optional[int]:
        for i, m in enumerate(self.members):
            if m is not None and m.run_id == run_id:
                return i
        return None

    def admit(self, slot: int, cfg: RunConfig) -> None:
        """Place ``cfg`` into a reserved slot; takes effect (engine
        rebuild) at the next :meth:`step` entry — i.e. between
        chunks, never mid-chunk."""
        if self.members[slot] is not None:
            if self.members[slot].run_id == cfg.run_id:
                return                      # idempotent re-admit
            raise ValueError(
                f"bucket {self.bucket_id!r} slot {slot} already holds "
                f"{self.members[slot].run_id!r}")
        self.members[slot] = cfg
        self._dirty = True

    def splice_in(self, slot: int, cfg: RunConfig, state_slice,
                  digest: str, supersteps: int, trail: list,
                  spec_chain: list = ()) -> None:
        """Repack target side: admit a PARTIALLY-RUN world (its state
        slice and digest bookkeeping move with it) into a free slot."""
        self.admit(slot, cfg)
        self.digests[slot] = digest
        self.supersteps[slot] = int(supersteps)
        self.trails[slot] = list(trail)
        self.spec_chains[slot] = list(spec_chain)
        self._splices[slot] = (state_slice,)

    def world_state_slice(self, b: int):
        """Donor side of a repack: world ``b``'s state slice, copied to
        the host (one read a leaf) — independent of this bucket's
        engine and tensors from here on, so the donor can close."""
        from ..interp.torch_engine.batched import map_state
        return map_state(lambda x: x[b].to("cpu", copy=True), self.state)

    # -- engine (re)build --------------------------------------------------

    def _fault_pad(self, scheds) -> tuple:
        need = (max(len(s.crashes) for s in scheds),
                max(len(s.partitions) for s in scheds),
                max(len(s.link_windows) for s in scheds))
        return tuple(max(a, b) for a, b in zip(need, self.min_pad))

    def _identity_parts(self):
        """``(spec, links, fleet, pad, bucket)`` over the CURRENT
        member table — the bucket's per-world identity, computed
        separately from engine construction so :meth:`_rebuild` can
        try a zero-rebuild ``rebind_identity`` before paying a build.
        Placeholder slots borrow member-0's link with seed 0 and an
        empty fault schedule; they never step, so their identity rows
        are inert."""
        from ..faults.schedule import FaultSchedule
        cfg0 = next(m for m in self.members if m is not None)
        cfgs = tuple(m if m is not None else dataclasses.replace(
            cfg0, run_id=f"{self.bucket_id}:reserved{i}", seed=0,
            faults=None) for i, m in enumerate(self.members))
        scheds = [c.parse_faults() or FaultSchedule(()) for c in cfgs]
        pad = self._fault_pad(scheds)
        bucket = Bucket(self.bucket_id, cfgs, self.window, pad)
        spec, links, fleet = bucket_identity(bucket)
        return spec, links, fleet, pad, bucket

    def _build(self, bucket: Bucket):
        """One batched engine over the bucket's identity, built by the
        sweep's ``build_bucket_engine``; the bucket key guarantees
        every member shares ``speculate`` (and family/params/link
        structure/window), so member-0's mode is the bucket's."""
        return build_bucket_engine(bucket, lint=self.lint,
                                   telemetry=self.telemetry,
                                   device=self.device)

    def _rebuild(self) -> None:
        spec, links, fleet, pad, bucket = self._identity_parts()
        if not (self.engine is not None and pad == self.min_pad
                and self.engine.rebind_identity(spec, faults=fleet)):
            # first build, fault-pad growth, or a structural identity
            # change (fleet presence / static fault gates): the only
            # paths that still construct a new engine. Everything else
            # re-enters the SAME engine with new identity rows.
            self.min_pad = pad
            self.engine = self._build(bucket)
            self.util["engine_builds"] += 1
        init = self.engine.init_state()
        if self.state is None:
            self.state = init
        else:
            self.state = _grow_restart(self.state,
                                       init.restart_done.shape[-1])
        if self._splices:
            new_c = self.state.restart_done.shape[-1]
            self.state = _splice_rows(self.state, {
                slot: _grow_restart(sl, new_c)
                for slot, (sl,) in self._splices.items()})
            self._splices.clear()
        self._dirty = False

    # -- the chunk loop ----------------------------------------------------

    @property
    def budgets(self) -> np.ndarray:
        return np.asarray([m.budget if m else 0
                           for m in self.members], np.int64)

    def _commit(self, rec: dict) -> None:
        if self.precommit is not None:
            self.precommit()    # lease check: raises LeaseLost if stolen
        self.journal.append(rec)

    def checkpoint_path(self) -> str:
        return self.journal.checkpoint_path(self.bucket_id)

    def restore(self) -> None:
        """(Re)load the bucket from its shared-dir checkpoint — what a
        thief does after a stale-lease reclaim, and what resume does
        after a kill. Worlds admitted after the checkpoint was written
        hold pristine (budget-0, never-stepped) state in it, so
        admitting them into the rebuilt engine needs nothing extra."""
        meta = checkpoint_meta(self.checkpoint_path())
        self._rebuild()
        if meta is None:
            return
        from ..utils.checkpoint import load_state
        ck_pad = tuple(meta.get("fault_pad", (0, 0, 0)))
        template = self.engine.init_state()
        ck_c = ck_pad[0]
        cur_c = template.restart_done.shape[-1]
        if ck_c != cur_c:
            # the checkpoint predates a pad-growing admission: shrink
            # the template's restart_done to the checkpointed width,
            # load, then grow back with inert False columns
            template = template._replace(
                restart_done=template.restart_done[..., :ck_c])
        st, meta = load_state(self.checkpoint_path(), template,
                              expect_meta={"bucket": self.bucket_id},
                              scenario=self.engine.scenario)
        self.state = _grow_restart(st, cur_c)
        by_rid = {m.run_id: i for i, m in enumerate(self.members)
                  if m is not None}
        chains = meta.get("spec_chains") \
            or [[] for _ in meta["members"]]
        for rid, d, s, t, sc in zip(meta["members"], meta["digests"],
                                    meta["supersteps"], meta["trail"],
                                    chains):
            if rid and rid in by_rid:
                i = by_rid[rid]
                self.digests[i] = d
                self.supersteps[i] = int(s)
                self.trails[i] = [list(x) for x in t]
                self.spec_chains[i] = [dict(x) for x in sc]
        self.chunks = int(meta.get("chunks", 0))
        if meta.get("spec_decisions") \
                and self.engine.speculate != "off":
            # resume the policy's committed chain where the killed
            # host left it — fresh decisions continue the ladder
            # (chunk numbering included) instead of restarting it
            from ..speculate.policy import SpeculationPolicy
            self._spec_policy = SpeculationPolicy(
                self.engine.speculate, fixed_w=self.engine._spec_w,
                chunk=self.chunk, replay=meta["spec_decisions"])
        self.emitted = set(self.done)

    def step(self) -> str:
        """One chunk: emit newly quiesced worlds' results, run, chain
        digests, checkpoint. Returns ``"running"`` while any admitted
        world is active, else ``"idle"`` (an idle open bucket keeps
        its checkpoint and may be re-claimed when new admissions
        land)."""
        if self.engine is None or self._dirty:
            self._rebuild()
        eng, st = self.engine, self.state
        B = self.capacity
        _, remaining, active = eng.fleet_progress(st, self.budgets)
        host = None
        for b in np.nonzero(~active)[0]:
            cfg = self.members[int(b)]
            if cfg is None or cfg.run_id in self.emitted:
                continue
            if host is None:
                # one device read for every world this chunk emits
                host = result_leaves(st)
            res = world_result(cfg, st, int(b), self.digests[int(b)],
                               self.supersteps[int(b)], host)
            rec = {"ev": "world_done",
                   "bucket": self.bucket_id,
                   "wall_s": round(self.wall_s, 6),
                   "attempts": 1,
                   "chain": self.trails[int(b)],
                   "result": res}
            if eng.speculate != "off":
                # the world's own committed decision chain — a solo
                # verify twin replays exactly this (per-slot chains,
                # module docstring); a sibling of "chain", NOT part of
                # "result", so the survival-law compare surface is
                # untouched
                rec["spec_chain"] = list(self.spec_chains[int(b)])
            self._commit(rec)
            self.done[cfg.run_id] = res
            self.emitted.add(cfg.run_id)
        if not active.any():
            if self.util["chunks"] and self.chunks != self._util_logged:
                # journal utilization at the running->idle edge (the
                # sweep's analogue journals at bucket completion);
                # last-record-wins in the fold, so re-idling after
                # more admissions just refreshes the numbers
                self._commit({"ev": "bucket_util",
                              **self.utilization()})
                self._util_logged = self.chunks
            return "idle"
        vec = np.where(active, np.minimum(remaining, self.chunk), 0)
        import time as _time

        from ..sweep.runner import scan_pad
        t0 = _time.perf_counter()
        if eng.speculate != "off":
            if self._spec_policy is None:
                from ..speculate.policy import SpeculationPolicy
                self._spec_policy = SpeculationPolicy(
                    eng.speculate, fixed_w=eng._spec_w,
                    chunk=self.chunk)
            new_state, traces = eng.run_speculative(
                vec, state=st, chunk=self.chunk,
                policy=self._spec_policy)
            for b, chain in enumerate(
                    eng.last_run_decisions_world or []):
                self.spec_chains[b].extend(d.to_json() for d in chain)
        else:
            new_state, traces = eng.run(vec, state=st)
        self.wall_s += _time.perf_counter() - t0
        for b in range(B):
            if len(traces[b]):
                self.digests[b] = chain_digest(self.digests[b],
                                               traces[b])
                self.supersteps[b] += len(traces[b])
                self.trails[b].append(
                    [self.supersteps[b], self.digests[b]])
        self.state = new_state
        self.chunks += 1
        top = int(vec.max())
        u = self.util
        u["chunks"] += 1
        u["world_supersteps"] += sum(len(traces[b]) for b in range(B))
        u["scan_supersteps"] += scan_pad(top)
        u["pad_supersteps"] += scan_pad(top) - top
        u["active_world_chunks"] += int(active.sum())
        u["compiles"] += int((eng.last_run_stats or {}
                              ).get("compiles", 0))
        from ..utils.checkpoint import save_state
        if self.precommit is not None:
            self.precommit()
        save_state(self.checkpoint_path(), new_state, scenario=eng.scenario,
                   meta={"bucket": self.bucket_id,
                         "members": [m.run_id if m else None
                                     for m in self.members],
                         "digests": list(self.digests),
                         "supersteps": [int(s)
                                        for s in self.supersteps],
                         "trail": [list(t) for t in self.trails],
                         "chunks": self.chunks,
                         "fault_pad": list(self.min_pad),
                         "spec_chains": [list(c)
                                         for c in self.spec_chains],
                         "spec_decisions": (
                             [d.to_json() for d in
                              self._spec_policy.decisions]
                             if self._spec_policy is not None
                             else [])})
        return "running"

    def utilization(self) -> dict:
        """The ``bucket_util`` record (same arithmetic as
        sweep/runner.py — the re-packing pass reads exactly these
        numbers): occupancy here counts ADMITTED active worlds against
        the full slot capacity, so a half-empty open bucket reports
        the under-occupancy repack looks for."""
        u = self.util
        B = self.capacity
        scan_total = u["scan_supersteps"]
        return {
            "bucket": self.bucket_id,
            "worlds": B,
            "chunks": u["chunks"],
            "world_supersteps": u["world_supersteps"],
            "scan_supersteps": scan_total,
            "budget_efficiency": round(
                u["world_supersteps"] / (B * scan_total), 4)
            if scan_total else 1.0,
            "pad_waste_frac": round(
                u["pad_supersteps"] / scan_total, 4)
            if scan_total else 0.0,
            "worlds_active_mean": round(
                u["active_world_chunks"] / (u["chunks"] * B), 4)
            if u["chunks"] else 0.0,
            "engine_builds": u["engine_builds"],
            "compiles": u["compiles"],
            "wall_s": round(self.wall_s, 6),
        }

    # -- repack (docs/serving.md "Re-packing") -----------------------------

    def active_slots(self) -> List[int]:
        """Slots holding admitted worlds that have not finished (from
        this runner's view of ``done``)."""
        return [i for i, m in enumerate(self.members)
                if m is not None and m.run_id not in self.done]

    def occupancy(self) -> float:
        return len(self.active_slots()) / self.capacity

    def merge_from(self, donor: "OpenBucketRunner") -> List[str]:
        """Move every still-active world of ``donor`` into this
        bucket's free slots (caller holds BOTH leases and has driven
        both runners to a chunk boundary). Returns the moved run_ids;
        the caller journals the ``repack`` event and closes the
        donor."""
        moved = []
        free = self.free_slots()
        take = donor.active_slots()
        if len(take) > len(free):
            raise ValueError(
                f"bucket {self.bucket_id!r} has {len(free)} free "
                f"slot(s) for {len(take)} active world(s) of "
                f"{donor.bucket_id!r}")
        # a moved world's state slice carries the DONOR's realized
        # fault-pad columns (restart ledgers at donor.min_pad width).
        # The merged fleet rebuilds at the elementwise max of member
        # needs and OUR min_pad — slices only ever _grow_restart to
        # that width (pad rows are inert; shrinking would drop live
        # ledger columns), so a donor wider than the post-merge pad
        # is refused loudly instead of crashing deep in the engine
        from ..faults.schedule import FaultSchedule
        scheds = [(m.parse_faults() or FaultSchedule(()))
                  for m in self.members if m is not None]
        scheds += [(donor.members[b].parse_faults() or
                    FaultSchedule(())) for b in take]
        post = self._fault_pad(scheds) if scheds else self.min_pad
        if any(d > p for d, p in zip(donor.min_pad, post)):
            raise ValueError(
                f"repack {donor.bucket_id!r} -> {self.bucket_id!r} "
                f"refused: donor's realized fault pad "
                f"{tuple(donor.min_pad)} exceeds the merged fleet's "
                f"pad {tuple(post)} — an in-flight restart ledger "
                "never shrinks (faults/schedule.py); repack the "
                "narrower bucket into the wider one instead")
        if donor.state is None or donor.engine is None:
            donor._rebuild()
        for slot, b in zip(free, take):
            cfg = donor.members[b]
            self.splice_in(slot, cfg, donor.world_state_slice(b),
                           donor.digests[b], donor.supersteps[b],
                           donor.trails[b], donor.spec_chains[b])
            moved.append(cfg.run_id)
        return moved

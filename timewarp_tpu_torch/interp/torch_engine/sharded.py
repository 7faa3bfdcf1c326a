"""The sharded engines on ``torch.distributed`` (port of
``timewarp_tpu/interp/jax_engine/sharded.py``): the same superstep over a
mesh of ranks, one rank per shard (the launcher, parallel/launch.py,
starts them; each builds the engine and runs it, SPMD).

- :class:`ShardedEdgeEngine` — the edge engine with the node axis
  sharded; ring delivery is ``MeshComm.roll``, one boundary slice to the
  next rank a superstep, so the topology must be pure shifts.
- :class:`ShardedEngine` — the general engine with the node axis
  sharded: every rank samples its own senders' messages on the eager
  path, buckets them by destination rank (one stable sort keyed on the
  shard, ranks within a bucket by ``group_rank``) and swaps the buckets in
  ONE ``all_to_all`` a superstep; each rank then sorts and inserts what
  its nodes receive (kernel K1 at ``n = n_local``, batch ``D ·
  bucket_cap``). ``bucket_cap`` defaults to the rank's outbox width
  ``n_local · max_out``, which cannot overflow; below the true fan-in the
  excess is counted in ``overflow``, never silent.
- :class:`ShardedFusedSparseEngine` — :class:`ShardedEngine` whose
  post-exchange insertion is the reference's fused kernel's (K1 on each
  shard: K1′), the batch padded to whole 1024-entry tiles as the
  reference's ``_insertion_plan`` rounds it, on commutative inboxes.
- :class:`ShardedBatchedEngine` — the fleet with the WORLD axis sharded:
  each rank runs ``B / D`` whole worlds (a ``TorchEngine(batch=...)`` of
  its worlds, their identity sliced by rank); its only collective is the
  run loop's liveness, plus gathering each run's trace and plane rows so
  that every rank returns every world's.

A node-sharded run's counters and digests are summed over the ranks each
superstep (one all-reduce; the pop-min is another and the exchange a
third), so every rank holds the global scalars; node-axis leaves hold the
rank's nodes (:meth:`ShardedDriver.gather_state` rebuilds the global
state). The law is the reference's: a sharded run equals the one-device
run bit for bit, trace, every leaf and every counter
(tests/test_torch_sharded.py, against the reference's ``JaxEngine``).

Refused loudly: ``record`` on the node-sharded engines (the reference's
refusal), and ``verify`` on them, whose per-node guard columns and state
digests would need gathering (docs: ROADMAP queue 1); on the world-sharded
engine ``run_verified`` and ``run_stream``, whose drivers digest states or
hand them to per-world callbacks over the whole fleet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...core.scenario import Scenario
from ...net.delays import LinkModel
from ...ops.numeric import group_rank
from ...parallel.mesh import Mesh, MeshComm, ShardedDriver, axis_size
from .batched import BatchSpec, rebind_link
from .common import LocalComm
from .edge_engine import EdgeEngine
from .engine import TorchEngine

__all__ = ["ShardedBatchedEngine", "ShardedEdgeEngine", "ShardedEngine",
           "ShardedFusedSparseEngine"]


def _refuse_record(record: str, who: str) -> str:
    """The node-sharded engines scatter each superstep's events across
    the ranks; the flight recorder's per-superstep event plane is a
    single-device artifact. A one-device run of the same configuration
    records the identical events (the sharding law)."""
    if record != "off":
        raise ValueError(
            f"{who}: record={record!r} is unsupported on the "
            "node-sharded engines (events would be scattered across "
            "shards); run the config on 1 device — bit-identical by "
            "the sharding exactness law — or use ShardedBatchedEngine "
            "for recorded fleets")
    return record


def _refuse_verify(verify: str, who: str) -> None:
    if verify != "off":
        raise ValueError(
            f"{who}: verify={verify!r} is not ported to the node-sharded "
            "engines yet (the guard's per-node columns and the state "
            "digests would be gathered over the ranks); run the config on "
            "1 device — bit-identical by the sharding exactness law")


class ShardedEdgeEngine(ShardedDriver, EdgeEngine):
    """Edge engine over a mesh: node axis sharded, ring delivery by
    ``MeshComm.roll``. Same ``run`` / ``run_quiet`` API as the local
    engine; states hold this rank's nodes."""

    _NODE_LEAVES = ("wake", "q_rel", "q_step", "q_pay")

    def __init__(self, scenario: Scenario, link: LinkModel, mesh: Mesh, *,
                 axis="nodes", seed: int = 0, cap: int = 2,
                 telemetry: str = "off", verify: str = "off",
                 record: str = "off", lint: str = "warn",
                 device=None) -> None:
        who = type(self).__name__
        _refuse_record(record, who)
        _refuse_verify(verify, who)
        self.mesh, self.axis = mesh, axis
        super().__init__(scenario, link, seed=seed, cap=cap,
                         telemetry=telemetry, lint=lint, device=device)
        bad = [e for e, s in enumerate(self.topo.shift) if s is None]
        if bad:
            raise ValueError(
                f"edges {bad} are not pure shifts; the sharded edge "
                "engine delivers by a roll over the mesh only — "
                "irregular topologies need the all_to_all general "
                "sharded engine")


class ShardedEngine(ShardedDriver, TorchEngine):
    """General (dynamic-destination) engine over a mesh: node axis
    sharded, the eager routing path with the destination-shard exchange
    (module docstring). ``route_cap`` slices each rank's received batch,
    as the reference's; the adaptive and lazy regimes are single-device
    and never engage here."""

    _NODE_LEAVES = ("wake", "mb_rel", "mb_src", "mb_payload")

    def __init__(self, scenario: Scenario, link: LinkModel, mesh: Mesh, *,
                 axis="nodes", seed: int = 0,
                 bucket_cap: Optional[int] = None, window=1,
                 route_cap: Optional[int] = None, telemetry: str = "off",
                 verify: str = "off", record: str = "off",
                 lint: str = "warn", device=None) -> None:
        who = type(self).__name__
        _refuse_record(record, who)
        _refuse_verify(verify, who)
        self.mesh, self.axis = mesh, axis
        full = (scenario.n_nodes // axis_size(mesh, axis)) \
            * scenario.max_out
        if bucket_cap is not None and int(bucket_cap) < 1:
            raise ValueError(f"bucket_cap must be >= 1, got {bucket_cap}")
        #: messages one rank may send another per superstep
        self.bucket_cap = full if bucket_cap is None else min(
            int(bucket_cap), full)
        super().__init__(scenario, link, seed=seed, window=window,
                         route_cap=route_cap, telemetry=telemetry,
                         lint=lint, device=device)

    def _exchange_width(self) -> int:
        return self.comm.n_shards * self.bucket_cap

    def _exchange(self, ok, drel, dst_f, smrank, woff, pay_f):
        """Destination-shard bucketing and one ``all_to_all`` (reference
        ``ShardedEngine._exchange``) over the superstep's ``[1, S]``
        batch. Every column travels in one int32 ``[D, bucket_cap, 4 +
        P]`` buffer (deliver time, global destination, sender-major rank,
        window offset, payload), an empty slot's destination -1; the
        sender is ``smrank // max_out`` downstream."""
        comm = self.comm
        D, nl, Bc = comm.n_shards, comm.n_local, self.bucket_cap
        ok, drel, dst_f, smrank, woff = (x[0] for x in (ok, drel, dst_f,
                                                         smrank, woff))
        dshard = torch.where(ok, torch.div(dst_f, nl, rounding_mode="floor"),
                             D)
        order = torch.sort(dshard, stable=True).indices
        sk = dshard[order]
        rank = group_rank(sk)
        live = sk < D
        fits = live & (rank < Bc)
        bucket_ovf = (live & ~fits).sum(dtype=torch.int32)
        # fitting messages scatter to their (shard, rank) slot, the rest
        # to a spare row that is cut off
        slot = torch.where(fits, sk.long() * Bc + rank.long(), D * Bc)
        cols = torch.cat([torch.stack([drel, dst_f, smrank, woff]),
                          pay_f[0]])                              # [C, S]
        C = cols.shape[0]
        buf = torch.zeros((D * Bc + 1, C), dtype=torch.int32,
                          device=ok.device)
        buf[:, 1] = -1
        buf[slot] = cols[:, order].T
        got = comm.all_to_all(buf[:D * Bc].view(D, Bc, C))
        r = got.reshape(D * Bc, C).T                         # [C, D * Bc]
        ok_r = r[1] >= 0
        row_r = r[1] - comm.rank * nl
        return (ok_r[None], r[0][None], row_r[None], r[2][None],
                r[3][None], r[4:][None], bucket_ovf[None])


class ShardedFusedSparseEngine(ShardedEngine):
    """The multi-device windowed path's share of the fused-sparse lever:
    sampling, bucketing and the exchange are :class:`ShardedEngine`'s;
    each rank's post-exchange insertion is K1 over its ``[K, n_local]``
    mailbox, the received batch padded with empty entries to whole
    1024-entry tiles (the reference's ``_insertion_plan`` width ``S2``).
    Commutative inboxes only, as the reference's kernel. Bit-identical to
    :class:`ShardedEngine` (tests/test_torch_sharded.py)."""

    def __init__(self, scenario: Scenario, link: LinkModel, mesh: Mesh, *,
                 axis="nodes", seed: int = 0,
                 bucket_cap: Optional[int] = None, window=1,
                 telemetry: str = "off", verify: str = "off",
                 record: str = "off", lint: str = "warn",
                 device=None) -> None:
        _refuse_record(record, type(self).__name__)
        if not scenario.commutative_inbox:
            raise ValueError(
                "ShardedFusedSparseEngine requires a commutative_inbox "
                "scenario (insertion targets mailbox holes; an ordered "
                "inbox owes the compaction sort — run ShardedEngine)")
        super().__init__(scenario, link, mesh, axis=axis, seed=seed,
                         bucket_cap=bucket_cap, window=window,
                         route_cap=None, telemetry=telemetry,
                         verify=verify, lint=lint, device=device)

    def _exchange_width(self) -> int:
        #: K1′'s batch width: D · bucket_cap in whole 1024-entry tiles
        self.S2 = -(-self.comm.n_shards * self.bucket_cap // 1024) * 1024
        return self.S2

    def _exchange(self, ok, drel, dst_f, smrank, woff, pay_f):
        out = super()._exchange(ok, drel, dst_f, smrank, woff, pay_f)
        pad = self.S2 - out[0].shape[1]
        if not pad:
            return out
        ok_r, drel_r, row_r, smrank_r, woff_r, pay_r, ovf = out

        def ext(x, fill=0):
            return torch.cat([x, x.new_full(x.shape[:-1] + (pad,), fill)],
                             dim=-1)
        return (ext(ok_r, False), ext(drel_r), ext(row_r), ext(smrank_r),
                ext(woff_r), ext(pay_r), ovf)


class ShardedBatchedEngine(ShardedDriver, TorchEngine):
    """The fleet over a mesh: the **world axis** sharded, nodes rank-
    local. Each rank runs ``B / D`` complete worlds, so the superstep
    needs no collective; the run loop's liveness is reduced over the
    ranks, and each traced run gathers its trace and plane rows, so every
    rank returns every world's traces, telemetry frames and flight logs
    (and a controller decides the same on every rank). Per-world budget
    vectors are sliced by rank. It keeps faults, a controller, telemetry,
    the flight recorder and speculation (``run_speculative``'s masked
    rollback re-runs the violating worlds on their ranks), as the
    reference does; its state holds this rank's worlds on every leaf's
    leading axis, and ``on_quiesce(b, state)`` callbacks get that
    rank-local state.

    World b of the gathered state equals the solo run with world b's
    seed, link and schedule (the batch law, tests/test_torch_sharded.py)."""

    def __init__(self, scenario: Scenario, link: LinkModel, mesh: Mesh, *,
                 batch: BatchSpec, axis="worlds", seed: int = 0,
                 window=1, route_cap: Optional[int] = None, faults=None,
                 telemetry: str = "off", controller=None,
                 verify: str = "off", record: str = "off",
                 record_cap=None, speculate: str = "off",
                 lint: str = "warn", device=None) -> None:
        if batch is None:
            raise ValueError(
                "ShardedBatchedEngine shards the world axis; it needs "
                "a BatchSpec (for a single sharded world use "
                "ShardedEngine)")
        self.mesh, self.axis = mesh, axis
        D = axis_size(mesh, axis)
        if batch.B % D:
            raise ValueError(
                f"batch of {batch.B} worlds not divisible over "
                f"{D} devices (worlds are whole — pad the seed list "
                "or shrink the mesh)")
        #: worlds resident per rank
        self.worlds_local = batch.B // D
        super().__init__(scenario, link, seed=seed, window=window,
                         route_cap=route_cap, batch=batch, faults=faults,
                         telemetry=telemetry, controller=controller,
                         verify=verify, record=record,
                         record_cap=record_cap, speculate=speculate,
                         lint=lint, device=device)
        self.shard_comm = MeshComm(mesh, axis, batch.B, self.device)
        self._slice_identity()

    def _make_comm(self, n_global: int, device: torch.device):
        # every world's nodes live on one rank
        return LocalComm(n_global, device)

    def _slice_identity(self) -> None:
        """This rank's worlds' seed words, link parameters and fault
        tables (reference ``_step_all``'s slice by mesh position)."""
        c = self.shard_comm
        sl = slice(c.rank * c.n_local, (c.rank + 1) * c.n_local)
        w = self._world
        link = rebind_link(self.link, {k: v[sl] for k, v in
                                       self._lpv.items()}) \
            if self._lpv else self.link
        ft = None if w.ft is None else type(w.ft)(*(x[sl] for x in w.ft))
        self._world = w._replace(s0=self._s0v[sl], s1=self._s1v[sl],
                                 link=link, ft=ft)

    def rebind_identity(self, batch: BatchSpec, faults=None) -> bool:
        ok = super().rebind_identity(batch, faults)
        if ok:
            self._slice_identity()
        return ok

    # -- the run loop over the ranks ---------------------------------------

    def _local_worlds(self, v: np.ndarray) -> np.ndarray:
        c = self.shard_comm
        return v[c.rank * c.n_local:(c.rank + 1) * c.n_local]

    def _budgets(self, max_steps) -> np.ndarray:
        return self._local_worlds(super()._budgets(max_steps))

    def _any_world(self, flags: np.ndarray) -> np.ndarray:
        got = self.shard_comm.all_max(torch.as_tensor(
            flags.astype(np.int32), device=self.device))
        return got.cpu().numpy().astype(bool)

    def _host_worlds(self, x: torch.Tensor) -> np.ndarray:
        return self.shard_comm.all_gather(x, 0).cpu().numpy()

    def _gather_rows(self, cols, act, planes, steps_at):
        c, dev = self.shard_comm, self.device
        T = cols.shape[0]

        def gather(a):
            if T == 0:
                return np.zeros((0, self.batch.B) + a.shape[2:], a.dtype)
            return c.all_gather(torch.from_numpy(a).to(dev), 1) \
                .cpu().numpy()

        def rows(xs):
            """A list over T of per-iteration values (tensors ``[Bl,
            ...]``, named tuples of them, or None), gathered on axis 1."""
            x0 = xs[0]
            if x0 is None:
                return xs
            if isinstance(x0, tuple):
                fields = [rows([x[i] for x in xs]) for i in range(len(x0))]
                return [type(x0)(*(f[t] for f in fields))
                        for t in range(len(xs))]
            return list(c.all_gather(torch.stack(xs), 1).unbind(0))

        if steps_at is not None:
            steps_at = c.all_gather(torch.from_numpy(steps_at).to(dev),
                                    0).cpu().numpy()
        return (gather(cols), gather(act), rows(planes) if planes
                else planes, steps_at)

    def _drive(self, max_steps, state, with_trace: bool):
        out = super()._drive(max_steps, state, with_trace)
        stats = self.last_run_stats
        stats["supersteps"] = int(self.shard_comm.all_sum(torch.tensor(
            stats["supersteps"], device=self.device)))
        return out

    def _refused(self, what: str):
        raise NotImplementedError(
            f"ShardedBatchedEngine.{what} is not ported yet (its driver "
            "digests states, or hands them to per-world callbacks, over "
            "the whole fleet); run the fleet on one device with "
            "TorchEngine(batch=...) — bit-identical by the sharding law")

    def run_verified(self, *args, **kwargs):
        self._refused("run_verified")

    def run_stream(self, *args, **kwargs):
        self._refused("run_stream")

"""The multi-device layer on ``torch.distributed`` (port of
``timewarp_tpu/parallel/mesh.py``): the collectives the sharded engines
ride, SPMD with one process (rank) per shard where the reference runs one
``shard_map`` program per device.

- :func:`make_mesh` names the ranks of an initialised process group as a
  mesh of one or more axes. Every collective here spans the flattened
  row-major product of the axes it is given, which is the whole group
  (as the reference's collectives over an axis tuple span its product),
  so a mesh is a shape over the default group and needs no sub-group:
  ``torch.distributed.device_mesh`` would build one per axis, which no
  collective here would use.
- :class:`MeshComm` puts the mesh collectives behind the single-device
  ``LocalComm`` interface (interp/torch_engine/common.py), so one
  superstep body serves the solo and the sharded engine. ``roll`` ports
  the reference's boundary-slice ``ppermute`` as an ``all_to_all`` whose
  buckets are empty but the one bound for the neighbour; ``all_to_all``
  swaps ``[D, ...]`` destination buckets with equal splits.
- :class:`ShardedDriver` is the sharded engines' shared harness: a rank's
  shard of a fresh or a global state, the global state rebuilt from every
  rank's shard, and what the integrity plane and the chunked drivers ask
  of a sharded state (each leaf's sharded axis, the gathered state for a
  callback).

Transport: the backend is the process group's, which its caller chose
(``parallel.launch.spawn(..., backend=...)``), never probed. Under
``gloo`` every collective ships host buffers, copying a device tensor to
the CPU and back explicitly in :meth:`MeshComm._ship`; under ``nccl`` it
ships device tensors, and NCCL needs a GPU of its own per rank.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..interp.torch_engine.common import LocalComm
from ..ops.numeric import MASK32

__all__ = ["AxisName", "Mesh", "MeshComm", "ShardedDriver", "axis_size",
           "make_mesh", "check_backend"]

#: a mesh axis: one name, or a tuple of names whose row-major product the
#: collectives flatten over
AxisName = Union[str, Tuple[str, ...]]


class Mesh(NamedTuple):
    """The ranks of the process group laid out as a mesh: ``shape`` maps
    each axis name to its size (the reference ``Mesh.shape``), in
    row-major order; ``backend`` is the group's."""
    shape: dict
    axis_names: Tuple[str, ...]
    backend: str

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))


def check_backend(backend: str, n_ranks: int) -> None:
    """Refuse a backend that cannot run ``n_ranks`` ranks here: NCCL
    puts each rank on a GPU of its own and refuses two ranks on one."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got "
                         f"{backend!r}")
    if backend == "nccl":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_ranks:
            raise RuntimeError(
                f"backend='nccl' needs one GPU per rank: {n_ranks} ranks "
                f"but {have} CUDA device(s) here (NCCL refuses two ranks "
                "on one GPU); run the ranks as backend='gloo' processes "
                "sharing the card, or on a machine with more GPUs")


def make_mesh(n_devices: Optional[int] = None, axis: str = "nodes", *,
              shape: Optional[tuple] = None,
              axes: Optional[tuple] = None) -> Mesh:
    """A 1-D mesh over the ranks of the initialised process group, or —
    with ``shape``/``axes`` — a multi-axis mesh, e.g. ``make_mesh(shape=(2,
    2), axes=("dcn", "ici"))``; an engine given the axis tuple spans its
    flattened product. The mesh covers the whole group: ``n_devices`` (or
    the product of ``shape``) must equal the group's size."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised torch.distributed process "
            "group (one rank per shard): start the ranks with "
            "timewarp_tpu_torch.parallel.launch.spawn")
    world = dist.get_world_size()
    backend = dist.get_backend()
    check_backend(backend, world)
    if shape is not None:
        if axes is None or len(axes) != len(shape):
            raise ValueError("axes must name every mesh dimension")
        n = int(np.prod(shape))
        names, sizes = tuple(axes), tuple(int(s) for s in shape)
    else:
        if axes is not None:
            raise ValueError("axes= requires shape=")
        n = world if n_devices is None else int(n_devices)
        names, sizes = (axis,), (n,)
    if n != world:
        raise ValueError(
            f"a mesh of {n} devices over a process group of {world} "
            "ranks: the mesh spans the whole group (one rank per shard)")
    return Mesh(dict(zip(names, sizes)), names, backend)


def axis_size(mesh: Mesh, axis: AxisName) -> int:
    """Total device count of ``axis`` (a name or a tuple of names)."""
    if isinstance(axis, tuple):
        return int(np.prod([mesh.shape[a] for a in axis]))
    return mesh.shape[axis]


class MeshComm(LocalComm):
    """Mesh collectives behind the LocalComm interface, for the rank that
    builds it: it owns nodes ``[rank·n_local, (rank + 1)·n_local)``."""

    def __init__(self, mesh: Mesh, axis: AxisName, n_global: int,
                 device: torch.device) -> None:
        D = axis_size(mesh, axis)
        if D != mesh.size:
            raise ValueError(
                f"axis {axis!r} spans {D} of the mesh's {mesh.size} "
                "devices; the collectives span the whole group, so the "
                "axis must name every mesh dimension")
        if n_global % D:
            raise ValueError(
                f"n_nodes {n_global} not divisible by {D} shards")
        self.mesh = mesh
        self.n_global = n_global
        self.n_shards = D
        self.n_local = n_global // D
        self.device = device
        self.rank = dist.get_rank()
        self.gloo = mesh.backend == "gloo"

    # -- transport ---------------------------------------------------------

    def _ship(self, x: torch.Tensor) -> torch.Tensor:
        """The buffer a collective sends: a host copy under gloo (the one
        place a device tensor crosses to the CPU), the tensor itself
        under nccl."""
        x = x.contiguous()
        return x.cpu() if self.gloo and x.device.type != "cpu" else x

    def _land(self, y: torch.Tensor) -> torch.Tensor:
        return y.to(self.device)

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        buf = self._ship(x)
        if buf is x:
            buf = x.clone()
        dist.all_reduce(buf, op=op)
        return self._land(buf)

    # -- the LocalComm interface -----------------------------------------------

    def node_ids(self) -> torch.Tensor:
        return self.rank * self.n_local + torch.arange(
            self.n_local, dtype=torch.int32, device=self.device)

    def _extreme(self, x: torch.Tensor, op) -> torch.Tensor:
        # booleans travel as int32 (no bool all-reduce on every backend)
        wide = x.to(torch.int32) if x.dtype == torch.bool else x
        return self._reduce(wide, op).to(x.dtype)

    def all_min(self, x):
        return self._extreme(x, dist.ReduceOp.MIN)

    def all_max(self, x):
        return self._extreme(x, dist.ReduceOp.MAX)

    def all_sum(self, x, u32=()):
        """Sum over the ranks of a tensor, or of a tuple of tensors in ONE
        all-reduce (packed as int64, each returned in its dtype). The
        entries indexed by ``u32`` are digests: wrapping uint32 sums, so
        their int64 totals are masked to 32 bits."""
        single = isinstance(x, torch.Tensor)
        xs = (x,) if single else tuple(x)
        flat = torch.cat([v.reshape(-1).to(torch.int64) for v in xs])
        red = self._reduce(flat, dist.ReduceOp.SUM)
        out, i = [], 0
        for j, v in enumerate(xs):
            r = red[i:i + v.numel()].reshape(v.shape)
            i += v.numel()
            if j in u32:
                r = r & MASK32
            out.append(r.to(v.dtype))
        return out[0] if single else tuple(out)

    def _send_to(self, x: torch.Tensor, k: int) -> torch.Tensor:
        """``x`` of rank ``r - k`` (mod D), this rank's sent to ``r + k``:
        an all_to_all whose buckets are empty but the one for rank
        ``r + k``."""
        D = self.n_shards
        k %= D
        if k == 0:
            return x
        n = x.numel()
        src, dst = (self.rank - k) % D, (self.rank + k) % D
        buf = self._ship(x).reshape(-1)
        out = torch.empty_like(buf)
        dist.all_to_all_single(
            out, buf,
            output_split_sizes=[n if j == src else 0 for j in range(D)],
            input_split_sizes=[n if j == dst else 0 for j in range(D)])
        return self._land(out).reshape(x.shape)

    def roll(self, x: torch.Tensor, s: int) -> torch.Tensor:
        """Global roll by ``s`` along the last (node) axis: whole shards
        move ``s // n_local`` ranks on, then the boundary slice of ``s %
        n_local`` nodes moves to the next rank (the reference's two
        ``ppermute`` branches; one neighbour hop for the ring's s = 1)."""
        s %= self.n_global
        if s == 0:
            return x
        nl = self.n_local
        whole, rem = divmod(s, nl)
        if whole:
            x = self._send_to(x, whole)
        if rem:
            recv = self._send_to(x[..., nl - rem:], 1)
            x = torch.cat([recv, x[..., :nl - rem]], dim=-1)
        return x

    def local_rows(self, table) -> torch.Tensor:
        t = torch.as_tensor(table)
        off = self.rank * self.n_local
        return t[..., off:off + self.n_local].to(self.device)

    # -- beyond LocalComm ----------------------------------------------------------

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``[D, ...]`` buckets, bucket j bound for rank j, swapped with
        equal splits: row j of the result came from rank j."""
        if x.shape[0] != self.n_shards:
            raise ValueError(f"all_to_all takes [D={self.n_shards}, ...] "
                             f"buckets, got {tuple(x.shape)}")
        buf = self._ship(x)
        out = torch.empty_like(buf)
        dist.all_to_all_single(out, buf)
        return self._land(out)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` (equal shapes), concatenated along ``dim``
        in rank order."""
        wide = x.to(torch.int32) if x.dtype == torch.bool else x
        buf = self._ship(wide)
        parts = [torch.empty_like(buf) for _ in range(self.n_shards)]
        dist.all_gather(parts, buf)
        return self._land(torch.cat(parts, dim=dim)).to(x.dtype)


class ShardedDriver:
    """The sharded engines' shared harness (reference ``ShardedDriver``).
    A node-sharded engine's state holds this rank's nodes on every
    node-axis leaf (the ``states`` dict's leading axis, the trailing axis
    of the wake vector and the mailbox or queue planes) and the scalars
    replicated; a world-sharded engine's holds this rank's worlds on the
    leading axis of every leaf. ``run`` and ``run_quiet`` are the local
    engine's, over collectives; :meth:`gather_state` rebuilds the global
    state on every rank, for comparisons, checkpoints and callbacks, and
    :meth:`scatter_state` cuts a global state (a resumed checkpoint) to
    this rank's shard."""

    #: worlds resident on this rank (world-sharded engines only)
    worlds_local = None
    #: the MeshComm over the sharded axis: the engine's node comm, or for
    #: the world-sharded engine one over its B worlds
    shard_comm = None

    def _make_comm(self, n_global: int, device: torch.device):
        self.shard_comm = MeshComm(self.mesh, self.axis, n_global, device)
        return self.shard_comm

    def leaf_axis(self, name: str, x: torch.Tensor) -> Optional[int]:
        """The axis of leaf ``name`` (a field, or ``states.<key>`` as
        integrity/digest.py ``state_leaves`` names it) that is sharded
        over the ranks, or None for a replicated leaf: axis 0 of every
        leaf (world-sharded), else axis 0 of each ``states`` leaf and the
        last of the engine's ``_NODE_LEAVES``."""
        field = name.partition(".")[0]
        if self.worlds_local is not None or field == "states":
            return 0
        if field in self._NODE_LEAVES:
            return x.dim() - 1
        return None

    def _leafwise(self, st, fn):
        """``st`` with ``fn(x, axis)`` applied to each sharded leaf
        (:meth:`leaf_axis`); replicated leaves pass through."""
        out = {}
        for name, x in st._asdict().items():
            if isinstance(x, dict):
                out[name] = {k: fn(v, self.leaf_axis(f"{name}.{k}", v))
                             for k, v in x.items()}
                continue
            axis = self.leaf_axis(name, x)
            out[name] = x if axis is None else fn(x, axis)
        return type(st)(**out)

    def _local_slice(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        c = self.shard_comm
        return x.narrow(axis, c.rank * c.n_local, c.n_local).contiguous()

    def _next_event(self, st):
        """The next event time over every rank's nodes."""
        return self.comm.all_min(super()._next_event(st))

    def global_init_state(self):
        """A fresh global state (every node and world), built on this
        rank without a collective: the template a checkpoint loads into."""
        return super().init_state()

    def init_state(self):
        """This rank's shard of a fresh state (node- or world-axis leaves
        sliced by rank, scalars replicated)."""
        return self.scatter_state(self.global_init_state())

    def scatter_state(self, st):
        """This rank's shard of the global state ``st`` (the inverse of
        :meth:`gather_state`; no collective)."""
        return self._leafwise(st, self._local_slice)

    def gather_state(self, st):
        """The global state, every rank's shard concatenated in rank
        order, on every rank."""
        c = self.shard_comm
        return self._leafwise(st, lambda x, ax: c.all_gather(x, ax))

    # -- the integrity plane's and the chunked drivers' hooks ----------------

    def _sharding(self):
        return self

    def _callback_state(self, state):
        return self.gather_state(state)

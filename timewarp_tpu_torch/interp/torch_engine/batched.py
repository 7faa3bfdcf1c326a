"""Multi-world batching: one superstep, a fleet of worlds (port of
``timewarp_tpu/interp/jax_engine/batched.py``).

The production use of a cheap emulator is *fleets* of runs — seed
sweeps, link-model sweeps, Monte-Carlo fault studies. A leading **world
axis B** on every state leaf lets one launch of each kernel and each
torch op serve B independent worlds.

:class:`BatchSpec` declares the fleet: per-world engine seeds, plus an
optional mapping of per-world link-model parameters (dotted attribute
paths into the link dataclass, e.g. ``{"lo": [...], "hi": [...]}`` for
a ``UniformDelay`` sweep or ``{"inner.lo": [...]}`` through a
``Quantize`` wrapper). Worlds share one scenario (topology, shapes,
step function); the RNG stream and the link model vary per world.

The exactness law: **slicing world b out of any batched run is
bit-identical to the solo run with that world's seed and link**, in the
port as in the reference (tests/test_torch_world_batch.py), and world b
of a port fleet equals world b of the reference's fleet. Per-world
quiescence and step budgets freeze a world exactly where its solo run
stops.

Sweepable parameters are the ones ``LinkModel.sample`` uses
*arithmetically* (delay bounds, medians, sigmas, quanta); inside the
fleet's superstep they are ``[B, 1]`` tensors that broadcast over each
world's ``[B, S]`` messages. Parameters burned into host-side control
flow — ``WithDrop.drop_prob`` or ``SeededHashUniform.salt`` — cannot
vary per world; sweep those with one engine per value.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np

__all__ = ["BatchSpec", "WorldIdentity", "rebind_link", "world_slice",
           "map_state"]


class WorldIdentity(NamedTuple):
    """The fleet's per-world *identity*: seed words, link-parameter
    vectors, and (optional) fault tables, each with a leading world axis
    B, as tensors on the engine's device. ``TorchEngine.rebind_identity``
    swaps it in place (the serving layer's admission path); nothing is
    compiled, so only the shapes it keeps matter."""
    s0v: Any          # int64[B, 1] — per-world seed word 0
    s1v: Any          # int64[B, 1] — per-world seed word 1
    lpv: Any          # dict dotted-path -> [B, 1] link-parameter vectors
    ftv: Any          # FaultTables with leading [B] axis, or None


def _split_params(params: Mapping[str, Any]):
    """Group dotted paths by head attribute: {"inner.lo": v} ->
    ({}, {"inner": {"lo": v}})."""
    direct, nested = {}, {}
    for path, v in params.items():
        head, dot, rest = path.partition(".")
        if dot:
            nested.setdefault(head, {})[rest] = v
        else:
            direct[head] = v
    return direct, nested


def rebind_link(link, params: Mapping[str, Any]):
    """A copy of ``link`` (a frozen dataclass, possibly nested) with
    the dotted-path ``params`` substituted. Values may be Python
    scalars (host-side validation links) or per-world ``[B, 1]`` tensors
    (inside the fleet's superstep). Unknown paths fail with the field
    inventory — a typo'd sweep must not silently sweep nothing."""
    direct, nested = _split_params(params)
    fields = {f.name for f in dataclasses.fields(link)}
    for attr in list(direct) + list(nested):
        if attr not in fields:
            raise ValueError(
                f"link {type(link).__name__} has no parameter "
                f"{attr!r}; sweepable fields: {sorted(fields)}")
    for attr, sub in nested.items():
        direct[attr] = rebind_link(getattr(link, attr), sub)
    return dataclasses.replace(link, **direct)


def map_state(fn, state):
    """``fn`` applied to every tensor leaf of an engine state (a
    NamedTuple whose ``states`` field is a dict of tensors)."""
    return type(state)(**{
        f: ({k: fn(v) for k, v in x.items()} if isinstance(x, dict)
            else fn(x))
        for f, x in zip(state._fields, state)})


def world_slice(state, b: int):
    """World ``b``'s slice of a batched state — the left-hand side of the
    batch exactness law (compare against the solo run's state)."""
    return map_state(lambda x: x[b], state)


@dataclass(frozen=True)
class BatchSpec:
    """A fleet declaration for the world axis (module docstring).

    ``seeds`` — one engine seed per world (world count B = len(seeds);
    replaces the engine's ``seed`` argument). ``link_params`` — optional
    mapping of dotted link-model attribute paths to length-B vectors of
    per-world values (``None``: all worlds share the engine's link).
    """
    seeds: Tuple[int, ...]
    link_params: Optional[Mapping[str, Any]] = None

    def __post_init__(self) -> None:
        seeds = tuple(int(s) for s in self.seeds)
        if not seeds:
            raise ValueError("a batch needs at least one world "
                             "(BatchSpec.seeds is empty)")
        object.__setattr__(self, "seeds", seeds)
        if self.link_params is not None:
            lp = {}
            for path, v in dict(self.link_params).items():
                arr = np.asarray(v)
                if arr.ndim != 1 or arr.shape[0] != len(seeds):
                    raise ValueError(
                        f"link_params[{path!r}] must be one value per "
                        f"world, shape [{len(seeds)}]; got {arr.shape}")
                lp[path] = arr
            object.__setattr__(self, "link_params", lp)

    @property
    def B(self) -> int:
        return len(self.seeds)

    @classmethod
    def of(cls, batch: Optional[int] = None,
           seeds: Optional[Sequence[int]] = None, *,
           base_seed: int = 0,
           link_params: Optional[Mapping[str, Any]] = None
           ) -> "BatchSpec":
        """The CLI constructor: ``--batch B`` -> seeds
        ``base_seed .. base_seed+B-1``; ``--seeds a:b`` -> the explicit
        half-open range. Both given must agree on B."""
        if seeds is not None:
            seeds = tuple(int(s) for s in seeds)
            if batch is not None and batch != len(seeds):
                raise ValueError(
                    f"--batch {batch} disagrees with --seeds "
                    f"({len(seeds)} worlds)")
        elif batch is not None:
            seeds = tuple(base_seed + i for i in range(batch))
        else:
            raise ValueError("BatchSpec.of needs batch= or seeds=")
        return cls(seeds=seeds, link_params=link_params)

    # -- per-world views --------------------------------------------------

    def world_link(self, link, b: int):
        """World ``b``'s concrete (host-level) link model: the engine's
        link with this world's parameters substituted as Python
        scalars. This is the link a solo run must use to reproduce
        world b bit-for-bit, and the object whose ``min_delay_us``
        gates windowed execution for the whole batch (the batched
        engine validates its window against the min over worlds)."""
        if not self.link_params:
            return link
        return rebind_link(link, {
            path: v[b].item() for path, v in self.link_params.items()})

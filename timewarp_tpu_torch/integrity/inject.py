"""Deterministic state corruption: the ``flip:`` chaos grammar (the port
of ``timewarp_tpu/integrity/inject.py``: the same spec picks the same
leaf, element and bit as the reference on the same state carried across
by ``state_io``).

The reference sweep's chaos grammar has a flip form::

    flip:SEED[:CHUNK[:PLANE]]

— a **seeded bit-flip written into a state plane between chunks**,
the lever the detection law is pinned against (tests/test_zzzzintegrity.py,
tests/test_torch_integrity.py): every injected flip must be detected
within the configured verify cadence, and the rolled-back run must be
bit-identical to an uninjected run. ``SEED`` keys the element and bit
choice, ``CHUNK`` (1-based, default 1) picks the chunk boundary the
flip lands on, ``PLANE`` names a state field (``mb_rel``, ``wake``,
``delivered``, ``states.<leaf>``, …; default seed-chosen among the
non-empty planes).

The flip is applied host-side between chunks — exactly the window the
``digest`` verify mode's entry check covers — and each spec fires
once (rollback re-runs the same chunk index; the injector must not
re-corrupt the recovered state, or no recovery could ever converge).

Malformed specs die naming :data:`INJECT_GRAMMAR`, never a raw
traceback — the same loud-grammar contract as LINK_GRAMMAR /
FAULT_GRAMMAR.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

__all__ = ["INJECT_GRAMMAR", "FlipSpec", "parse_flip", "apply_flip",
           "FlipInjector"]

#: the flip form of the sweep --inject grammar (sweep/service.py
#: InjectPlan carries the full four-form grammar string)
INJECT_GRAMMAR = ("flip:SEED[:CHUNK[:PLANE]]  (seeded bit-flip "
                  "written into a state plane before chunk CHUNK "
                  "(1-based, default 1); PLANE = a state field name, "
                  "default seed-chosen)")


@dataclass(frozen=True)
class FlipSpec:
    seed: int
    chunk: int = 1
    plane: Optional[str] = None


def parse_flip(part: str) -> FlipSpec:
    """Parse one ``flip:...`` spec; raises ``ValueError`` naming
    INJECT_GRAMMAR on any malformation (the sweep's InjectPlan
    re-raises it as a SweepConfigError; an embedding caller gets a
    catchable error either way)."""
    bits = part.split(":")
    try:
        if bits[0] != "flip" or not 2 <= len(bits) <= 4:
            raise ValueError(part)
        seed = int(bits[1])
        chunk = int(bits[2]) if len(bits) >= 3 else 1
        plane = bits[3] if len(bits) == 4 else None
        if seed < 0 or chunk < 1 or (plane is not None and not plane):
            raise ValueError(part)
        return FlipSpec(seed=seed, chunk=chunk, plane=plane)
    except (IndexError, ValueError):
        raise ValueError(
            f"malformed flip spec {part!r}; grammar: "
            f"{INJECT_GRAMMAR}") from None


def apply_flip(state, seed: int, plane: Optional[str] = None, u32=(),
               shards=None):
    """Flip one seeded bit (or invert one seeded bool) in one leaf of
    ``state``; returns ``(corrupted_state, description)``. Pure: the input
    state is untouched (the leaf is copied before the flip), so a
    caller's snapshot of the clean state stays clean. Leaves are named
    and ordered as the reference's (``mb_rel``, ``states.cnt``, …;
    digest.py ``state_leaves``); ``u32`` names the scenario's
    ``u32_states``, whose int64 words flip as the reference's uint32
    leaves do. On a sharded state (``shards``: the sharded engine, whose
    ``leaf_axis`` names each leaf's sharded axis) the spec picks the leaf,
    element and bit it picks on the gathered state: the rank that owns
    the element flips it (every rank, for a replicated leaf), the others
    return their state as it was, and every rank returns the same
    description."""
    import torch
    from .digest import state_leaves
    leaves = state_leaves(state)
    names = [n for n, _ in leaves]
    words = {f"states.{k}" for k in u32}
    rng = np.random.default_rng(seed)
    eligible = [i for i, (_, x) in enumerate(leaves) if x.numel() > 0]
    if not eligible:
        raise ValueError("state has no non-empty plane to flip")
    if plane is not None:
        cand = [i for i in eligible
                if names[i] == plane or names[i].endswith("." + plane)]
        if not cand:
            raise ValueError(
                f"flip plane {plane!r} names no non-empty state "
                f"field; available: {[names[i] for i in eligible]}")
        li = cand[0]
    else:
        li = eligible[int(rng.integers(len(eligible)))]
    name, leaf = leaves[li]
    shape = tuple(leaf.shape)
    gshape, axis = list(shape), None
    if shards is not None:
        axis = shards.leaf_axis(name, leaf)
        if axis is not None:
            gshape[axis] *= shards.shard_comm.n_shards
    ei = int(rng.integers(int(np.prod(gshape, dtype=np.int64))))
    local = ei
    if axis is not None:
        at = list(np.unravel_index(ei, gshape))
        owner, at[axis] = divmod(int(at[axis]), shape[axis])
        if owner != shards.shard_comm.rank:
            local = None
        else:
            local = int(np.ravel_multi_index(at, shape))
    if leaf.dtype == torch.bool:
        desc = f"{name}[{ei}] bool inverted (seed {seed})"
    else:
        size = 4 if name in words else leaf.element_size()
        bit = int(rng.integers(size * 8))
        desc = f"{name}[{ei}] bit {bit} flipped (seed {seed})"
    if local is None:
        return state, desc                 # another rank owns the element
    arr = leaf.cpu().numpy().copy()             # a copy — pure
    if name in words:
        arr = arr.astype(np.uint32)
    flat = arr.reshape(-1)
    if arr.dtype == bool:
        flat[local] = not flat[local]
    else:
        view = flat[local:local + 1].view(np.uint8)
        view[bit // 8] ^= np.uint8(1 << (bit % 8))
    if name in words:
        arr = arr.astype(np.int64)
    new = torch.from_numpy(arr).to(leaf.device)
    head, _, key = name.partition(".")
    if key:
        states = dict(getattr(state, head))
        states[key] = new
        return state._replace(**{head: states}), desc
    return state._replace(**{name: new}), desc


class FlipInjector:
    """The engine-level corruption hook ``run_verified(inject=...)``
    takes (runner.py): fires its flip ONCE, at its chunk boundary,
    and records what it did (``fired`` / ``desc``) so tests and the
    in-bench detection gate can assert the flip actually happened."""

    def __init__(self, spec, u32=()) -> None:
        self.spec = parse_flip(spec) if isinstance(spec, str) else spec
        #: the scenario's ``u32_states`` (apply_flip)
        self.u32 = tuple(u32)
        self.fired = False
        self.desc: Optional[str] = None

    def __call__(self, chunk_idx: int, state, shards=None):
        """``shards``: a sharded engine's, for its rank's state
        (:func:`apply_flip`)."""
        if self.fired or chunk_idx != self.spec.chunk - 1:
            return None
        self.fired = True
        new, self.desc = apply_flip(state, self.spec.seed,
                                    self.spec.plane, self.u32, shards)
        return new

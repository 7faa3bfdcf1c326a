"""Rolling state digests on the device and their sha256 chain (the port
of ``timewarp_tpu/integrity/digest.py``).

``tree_digest`` folds a complete engine state (``EngineState``,
``EdgeState``, any NamedTuple of tensors whose ``states`` field is a
dict) into one uint32 word, equal word for word to the reference's for
the same state carried across by ``state_io``: the leaves are folded in
the reference's flattening order (NamedTuple fields in order, the
``states`` dict by sorted key), each leaf as its uint32 words (an int64
leaf as its lo then hi words, a 32-bit leaf bit for bit, a bool or an 8-
or 16-bit leaf widened), every word mixed with its leaf tag ``0xD1D0 +
i``, word index ``j`` and element index by the port's ``mix32``, summed
with a wrapping uint32 sum per word vector, and the word sums folded in
order. A scenario's ``u32_states`` (uint32 in the reference, int64 words
in the port) count as one word per element, as in the reference. Cost:
one elementwise pass over the state, about 40 int64 ops per word.

A sharded state digests to the word its gathered state would, with
no state gathered (``shards``: the sharded engine, whose ``leaf_axis``
names each leaf's sharded axis and whose ``shard_comm`` spans the
ranks). On a node-sharded state each rank sums its own elements' mixed
words under their global flat indices (a replicated leaf on rank 0
alone), the per-word sums of every rank add up in one packed
``all_sum`` masked to 32 bits, and every rank folds the same sums; a
world-sharded fleet digests its own worlds and gathers the ``[B]``
vector.

The host side chains digests as the reference does: ``chain' =
sha256(chain || digest)``, hex in, hex out, so a chunked and resumed run
lands on the chain one uninterrupted run computes.

Detection model: the digest is recomputed at every chunk **entry**
(runner.py) and compared with the value recorded at the previous
chunk's exit; the state did not legitimately change in between, so any
difference is corruption of state at rest.
"""

from __future__ import annotations

import hashlib

import numpy as np

__all__ = ["tree_digest", "fleet_digest", "host_digests",
           "VERIFY_CHAIN_ZERO", "chain_state_digest",
           "first_digest_mismatch", "state_leaves"]

#: the state-digest chain seed (hex of 32 zero bytes)
VERIFY_CHAIN_ZERO = "0" * 64

_SEED = 0x811C9DC5
_MASK = 0xFFFFFFFF


def first_digest_mismatch(got, want):
    """First world index whose digest moved, or None — the one compare
    idiom every digest check site uses. Returns ``(index, got_hex,
    want_hex)``."""
    g = np.asarray(got, np.uint32)
    w = np.asarray(want, np.uint32)
    bad = np.nonzero(g != w)[0]
    if bad.size == 0:
        return None
    b = int(bad[0])
    return b, f"{int(g[b]):08x}", f"{int(w[b]):08x}"


def state_leaves(state):
    """``[(name, tensor)]`` in the reference's flattening order: the
    NamedTuple's fields in order, a dict field by sorted key, each named
    by its dotted path (``mb_rel``, ``states.cnt``) — what a flip's
    ``PLANE`` matches and the digest's leaf tags count."""
    out = []
    for name in state._fields:
        v = getattr(state, name)
        if isinstance(v, dict):
            out.extend((f"{name}.{k}", v[k]) for k in sorted(v))
        else:
            out.append((name, v))
    return out


def _leaf_words(x, word: bool, B: int):
    """A leaf as one or two ``[B, L]`` int64 word tensors (values in
    ``[0, 2**32)``): int64 as its lo and hi words, 32-bit dtypes bit for
    bit, bool and 8/16-bit dtypes widened; ``word`` marks an int64
    carrier of uint32 words (one word per element)."""
    import torch
    f = x.reshape(B, -1)
    if word:
        return (f & _MASK,)
    if f.dtype == torch.bool:
        return (f.to(torch.int64),)
    size = f.element_size()
    if size == 8:
        if f.dtype != torch.int64:
            f = f.view(torch.int64)
        return (f & _MASK, (f >> 32) & _MASK)
    if size == 4:
        if f.dtype != torch.int32:
            f = f.view(torch.int32)
        return (f.to(torch.int64) & _MASK,)
    # 8/16-bit leaves: widen through their bytes (lossless)
    return (f.contiguous().view(torch.uint8).to(torch.int64),)


def _global_index(L: int, x, axis, shards, dev):
    """The global flat element index of each of a rank's ``L`` words of
    leaf ``x`` sharded on ``axis`` (its shard the rank's slice of that
    axis; a leaf widened through its bytes has several words an
    element, innermost)."""
    import torch
    c = shards.shard_comm
    nl = x.shape[axis]
    post = (L // x.numel()) * int(np.prod(x.shape[axis + 1:], dtype=np.int64))
    j = torch.arange(L, dtype=torch.int64, device=dev)
    block = nl * post
    return (j // block) * (c.n_shards * block) + c.rank * block + j % block


def _word_sums(state, u32, batched: bool, shards=None):
    """Each non-empty word vector's wrapping sum of its mixed words, an
    int64 ``[B]`` tensor (values in ``[0, 2**32)``), in the fold order;
    ``shards`` a node-sharded engine (module docstring): this rank's
    elements under their global indices."""
    import torch
    from ..trace.hashing import mix32
    words = {f"states.{k}" for k in u32}
    leaves = state_leaves(state)
    B = leaves[0][1].shape[0] if batched else 1
    dev = leaves[0][1].device
    sums = []
    for i, (name, leaf) in enumerate(leaves):
        x = leaf if batched else leaf.unsqueeze(0)
        axis = None if shards is None else shards.leaf_axis(name, leaf)
        for j, w in enumerate(_leaf_words(x, name in words, B)):
            L = w.shape[1]
            if L == 0:
                continue
            if axis is not None:
                idx = _global_index(L, leaf, axis, shards, dev)
            else:
                idx = torch.arange(L, dtype=torch.int64, device=dev)
            # the leaf tag and word index fold on the host (mix32)
            lh = mix32(0xD1D0 + i, j, idx, w).sum(dim=1) & _MASK
            if shards is not None and axis is None \
                    and shards.shard_comm.rank != 0:
                lh = torch.zeros_like(lh)     # replicated: rank 0's alone
            sums.append(lh)
    return sums


def _digest(state, u32=(), batched: bool = False, shards=None):
    """``[B]`` int64 digests (values in ``[0, 2**32)``); B = 1 solo.
    ``shards`` is a sharded engine (module docstring) or None."""
    import torch
    from ..trace.hashing import mix32
    if shards is not None and shards.worlds_local is not None:
        # a world-sharded fleet: this rank's worlds, gathered
        return shards.shard_comm.all_gather(_digest(state, u32, batched), 0)
    sums = _word_sums(state, u32, batched, shards)
    if shards is not None and sums:
        sums = shards.shard_comm.all_sum(tuple(sums),
                                         u32=tuple(range(len(sums))))
    leaves = state_leaves(state)
    B = leaves[0][1].shape[0] if batched else 1
    h = torch.full((B,), _SEED, dtype=torch.int64,
                   device=leaves[0][1].device)
    for lh in sums:
        h = mix32(h, lh)
    return h


def tree_digest(state, u32=(), shards=None):
    """One uint32 digest of a whole (solo) state, as an int64 0-d tensor
    on its device; ``u32`` names the scenario's ``u32_states``, ``shards``
    the sharded engine of a node-sharded state (module docstring)."""
    return _digest(state, u32, shards=shards)[0]


def fleet_digest(state, u32=(), shards=None):
    """Per-world digests of a fleet's state (a leading world axis on
    every leaf): int64 ``[B]``; ``shards`` the world-sharded engine of a
    rank's worlds (every world's digest on every rank)."""
    return _digest(state, u32, batched=True, shards=shards)


def host_digests(state, batch=None, u32=(), shards=None) -> np.ndarray:
    """The host-side view every verified driver uses: uint32[1] for a
    solo state, uint32[B] for a fleet's (``batch`` is the engine's
    BatchSpec or None; ``shards`` the sharded engine or None)."""
    d = _digest(state, u32, batched=batch is not None, shards=shards)
    return d.cpu().numpy().astype(np.uint32)


def chain_state_digest(prev_hex: str, digest) -> str:
    """Fold one uint32 state digest into a running sha256 chain (hex in,
    hex out) — the incremental form that survives chunking and resume."""
    return hashlib.sha256(
        bytes.fromhex(prev_hex)
        + int(digest).to_bytes(4, "little")).hexdigest()

"""Seeded permutation probe for the ``commutative_inbox`` flag (port of
``timewarp_tpu/analysis/probes.py``).

``commutative_inbox=True`` is the one declaration graph dataflow cannot
validate: whether a step's *result* is invariant to inbox slot order is
a semantic property, not a structural one. The engines lean hard on the
flag — they skip the contract-#2 inbox sort, present delivered slots in
raw mailbox-row order and turn freed slots into unsorted holes — so a
falsely-declared flag produces engine-vs-oracle digest divergence with
no local symptom.

The probe runs the port's *batched* step (core/scenario.py: ``[K, N]``
inbox, node axis minor) concretely on the engines' device (the card
unless the caller passes ``device="cpu"``) over the first few nodes,
whose states alone are built (the scenario's per-node ``init`` where it
has one, else ``init_batched`` at that node count), so the cost does not
grow with ``n_nodes``,
with randomized inboxes whose slots are permuted along ``K`` (the same
permutation for every node of a call), and compares the full result
(states', outbox, wake) bit for bit. Invalid slots carry the canonical
padding every interpreter presents (src 0, time NEVER, payload 0) and
permute *with* the slots. A probe is evidence, not proof — but three
rounds × three permutations catch every first-slot / positional
dependence, which is the realistic bug class.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.rng import fire_bits, seed_words
from ..core.scenario import NEVER, Inbox, Scenario
from .report import ERROR, WARNING, Finding, LintReport

__all__ = ["probe_commutative_inbox"]


def _tree_equal(a, b) -> bool:
    la, ta = torch.utils._pytree.tree_flatten(a)
    lb, tb = torch.utils._pytree.tree_flatten(b)
    if ta != tb:
        return False
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
            if x.dtype != y.dtype or x.shape != y.shape \
                    or not torch.equal(x, y):
                return False
        elif x != y:
            return False
    return True


def probe_commutative_inbox(sc: Scenario, *, seed: int = 0,
                            rounds: int = 3, max_nodes: int = 4,
                            now_us: int = 1_000_000,
                            device=None) -> LintReport:
    """Empty report when the scenario does not declare
    ``commutative_inbox``; otherwise a TW401 error when the step result
    changed under an inbox slot permutation (the first node it changed
    for named). The step runs on ``device``: the card by default, and
    without one an error that names ``device="cpu"``."""
    from ..interp.torch_engine.engine import resolve_device
    rep = LintReport()
    if not sc.commutative_inbox:
        return rep
    dev = resolve_device(device, "probe_commutative_inbox")
    name = sc.name
    K, P, n = sc.mailbox_cap, sc.payload_width, sc.n_nodes
    L = min(n, max_nodes)
    rng = np.random.default_rng(seed)
    s0, s1 = seed_words(seed)
    ids = torch.arange(L, dtype=torch.int32, device=dev)

    try:
        states = _probe_states(sc, L, dev)
    except Exception as e:  # noqa: BLE001 — lint must not crash callers
        rep.add(Finding("TW400", WARNING, name,
                        f"commutative-inbox probe skipped: init "
                        f"failed ({e!r})"))
        return rep

    now = torch.full((L,), now_us, dtype=torch.int64, device=dev)
    bits = fire_bits(s0, s1, ids, now) if sc.needs_key else None
    for r in range(rounds):
        # a partially-filled inbox per node with distinct times/srcs/
        # payloads — distinctness maximizes the chance an order
        # dependence shows (K == 1 still probes: the one valid slot
        # moves among padding)
        n_valid = 1 if K == 1 else int(rng.integers(2, K + 1))
        valid = np.zeros((K, L), bool)
        valid[:n_valid] = True
        times = np.full((K, L), NEVER, np.int64)
        srcs = np.zeros((K, L), np.int32)
        pay = np.zeros((K, P, L), np.int32)
        for j in range(L):
            times[:n_valid, j] = np.sort(
                rng.choice(np.arange(1, now_us, dtype=np.int64),
                           size=n_valid, replace=False))
            srcs[:n_valid, j] = rng.integers(0, n, size=n_valid)
            pay[:n_valid, :, j] = rng.integers(0, 8, size=(n_valid, P))
        if not sc.inbox_src:
            srcs[:] = 0         # the engines elide src for this flag
        perms = [np.arange(K)] + [rng.permutation(K) for _ in range(2)]
        ref = None
        for p_i, perm in enumerate(perms):
            inbox = Inbox(*(torch.from_numpy(a[perm]).to(dev)
                            for a in (valid, srcs, times, pay)))
            try:
                got = sc.step(dict(states), inbox, now, ids, bits)
            except Exception as e:  # noqa: BLE001
                rep.add(Finding(
                    "TW400", WARNING, name,
                    f"commutative-inbox probe skipped: step failed on a "
                    f"probe inbox ({e!r})"))
                return rep
            if ref is None:
                ref = got
            elif not _tree_equal(ref, got):
                node = _first_diff_node(ref, got, L)
                rep.add(Finding(
                    "TW401", ERROR, name,
                    "commutative_inbox=True but the step result "
                    f"depends on inbox slot order (node {node}, probe "
                    f"round {r}, permutation {p_i}, seed {seed}): "
                    "engines skip the contract-#2 inbox sort for this "
                    "flag, so this diverges from the oracle. Declare "
                    "commutative_inbox=False or make the step a "
                    "commutative reduction"))
                return rep
    return rep


def _probe_states(sc: Scenario, L: int, dev: torch.device) -> dict:
    """The first ``L`` nodes' initial states on ``dev``: stacked from
    the per-node ``init`` (the reference's), else ``init_batched(L)``."""
    if sc.init is not None:
        per = [sc.init(i)[0] for i in range(L)]
        return {k: torch.stack([p[k] for p in per]).to(dev)
                for k in per[0]}
    states, _ = sc.init_batched(L, dev)
    return states


def _first_diff_node(a, b, L: int) -> int:
    """The lowest node whose results differ (states ``[N, ...]``, the
    outbox and wake with the node axis last)."""
    try:
        (sa, oa, wa), (sb, ob, wb) = a, b
        pairs = [(sa[k], sb[k], 0) for k in sa] + [
            (x, y, -1) for x, y in zip(list(oa) + [wa], list(ob) + [wb])]
        for j in range(L):
            for x, y, ax in pairs:
                if not torch.equal(x.select(ax, j), y.select(ax, j)):
                    return j
    except Exception:  # noqa: BLE001 — the node is a hint only
        pass
    return 0

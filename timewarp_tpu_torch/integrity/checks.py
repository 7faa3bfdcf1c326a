"""Guard invariants on the device and their host-side decode (the port of
``timewarp_tpu/integrity/checks.py``: the rows are built from torch
tensors, one per superstep and world, and decoded with numpy).

An :class:`IntegrityRow` is the fixed-shape per-superstep violation
plane an engine builds in its traced driver when ``verify != "off"`` —
the integrity analogue of obs/telemetry.py's ``TelemetryRow``; with
``verify="off"`` no code here runs. Every field is a *violation count*
derived only from values the superstep already computes, so a clean run
carries an all-zero plane and the checks can never perturb the
emulation.

The checks are chosen for what a silent data corruption (a flipped
bit in HBM, a miscompiled kernel on one chip) actually does to this
state layout:

- ``time_regress`` — the superstep's instant ``t`` fell below the
  carried epoch ``state.time`` (a flip anywhere in the int64 time, or
  a wake/mailbox flip *downward*, drags the pop-min into the past);
- ``neg_counter`` — a never-silent cumulative counter (overflow,
  drop counts, ``delivered``, ``steps``, ``time``) went negative: the
  counters only ever accumulate non-negative deltas, so a negative
  value is a corrupted sign/high bit, not arithmetic;
- ``wake_past`` — a node's post-step wake is at or before ``t``
  (contract #5 forces every wake strictly past the node's firing
  instant; unfaulted runs only — crash deferral legitimately leaves a
  down node's wake behind the global clock);
- ``mb_neg`` — a mailbox deliver-time went negative relative to the
  epoch (kept entries are always strictly future after the rebase;
  unfaulted runs only, for the same deferral reason);
- ``restart_regress`` — the ``restart_done`` ledger un-consumed a
  restart row (it is monotone against the fault tables by
  construction).

Guard is deliberately *incomplete* — a payload-word flip changes no
invariant. The ``digest`` and ``shadow`` rungs of the ladder
(digest.py, runner.py) are the complete detectors; guard is the one
that localizes a violation to the exact superstep and field, in the
pinned TraceMismatch-style diagnostic format
(:class:`IntegrityViolation`; tests/test_zzzzintegrity.py pins it the
way tests/test_zzdiag.py pins TraceMismatch).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np

__all__ = ["VERIFY_MODES", "IntegrityRow", "IntegrityViolation",
           "validate_verify", "make_guard_row",
           "first_guard_violation", "guard_violation_error",
           "final_state_guard"]

#: the engine knob's legal values, in increasing cost order
VERIFY_MODES = ("off", "guard", "digest", "shadow")


def validate_verify(mode: str, who: str = "engine") -> str:
    """Loud knob validation — a typo'd mode must not silently run
    unverified (mirrors obs.telemetry.validate_mode)."""
    if mode not in VERIFY_MODES:
        raise ValueError(
            f"{who}: verify must be one of {VERIFY_MODES}, got "
            f"{mode!r} ('off' = zero overhead, 'guard' = on-device "
            "invariant checks, 'digest' = + per-chunk state digest, "
            "'shadow' = + sampled re-execution cross-check — "
            "docs/integrity.md)")
    return mode


class IntegrityViolation(RuntimeError):
    """A run-time state-integrity violation: a guard invariant fired,
    a state digest failed its chain, or a shadow re-execution
    disagreed. By the pinned exactness laws this is corruption or a
    real bug — never raised for a legitimate state. The message is
    held to the TraceMismatch diagnostic contract: one line naming
    the first violating superstep/chunk and field with scalar values,
    never an array dump."""


class IntegrityRow(NamedTuple):
    """One superstep's violation plane (device scalars; [B] per world
    under the batch vmap). All int32 counts — zero everywhere on a
    clean superstep."""
    time_regress: Any      # int32 — t < carried state.time
    neg_counter: Any       # int32 — negative cumulative counters
    wake_past: Any         # int32 — wake <= t (< NEVER); unfaulted only
    mb_neg: Any            # int32 — negative mailbox rel-times; unfaulted
    restart_regress: Any   # int32 — restart_done un-consumed


#: what each guard field means — rides the diagnostic so the error is
#: debuggable from its text alone
FIELD_MEANING = {
    "time_regress": "virtual time regressed below the carried epoch",
    "neg_counter": "a cumulative never-silent counter went negative",
    "wake_past": "a node wake landed at or before the superstep instant",
    "mb_neg": "a mailbox deliver-time went negative vs the epoch",
    "restart_regress": "the restart_done ledger un-consumed a row",
}


def make_guard_row(comm, t, prev_time, counters, wake, never,
                   rel_planes, prev_restart, new_restart,
                   faulted: bool) -> IntegrityRow:
    """One superstep's :class:`IntegrityRow`, every field an int32
    ``[B]`` tensor (one per world), from values the superstep already
    computed — the ONE implementation every torch engine calls.
    ``t``/``prev_time`` are ``[B]``, ``counters`` the engine's
    cumulative-counter ``[B]`` tensors (int32 and int64 mixed), ``wake``
    ``[B, N]``, ``rel_planes`` its epoch-relative int32 mailbox/queue
    planes ``[B, ...]``, the restart ledgers ``[B, C]``. ``faulted``
    disables the two checks that crash deferral legitimately violates
    (module docstring). The per-node fields are summed over ``comm``
    (the engine's node comm: the identity on one device; a node-sharded
    engine's ranks then all hold the global row), both in one
    reduction."""
    import torch
    B = t.shape[0]
    neg = torch.zeros((B,), dtype=torch.int32, device=t.device)
    # the counters of one dtype in one stack: a few launches, not three a
    # counter (the guard row is paid every superstep)
    for dt in sorted({c.dtype for c in counters}, key=str):
        same = torch.stack([c for c in counters if c.dtype == dt])
        neg = neg + (same < 0).sum(dim=0, dtype=torch.int32)
    wake_past = torch.zeros_like(neg)
    mb_neg = torch.zeros_like(neg)
    if not faulted:
        wake_past = ((wake <= t[:, None]) & (wake < never)).sum(
            dim=1, dtype=torch.int32)
        for plane in rel_planes:
            mb_neg = mb_neg + (plane < 0).reshape(B, -1).sum(
                dim=1, dtype=torch.int32)
        wake_past, mb_neg = comm.all_sum((wake_past, mb_neg))
    return IntegrityRow(
        time_regress=(t < prev_time).to(torch.int32),
        neg_counter=neg,
        wake_past=wake_past,
        mb_neg=mb_neg,
        restart_regress=(prev_restart & ~new_restart).sum(
            dim=1, dtype=torch.int32),
    )


def first_guard_violation(integ, valid, t_us,
                          n_worlds: Optional[int] = None
                          ) -> Optional[dict]:
    """Host-side decode of a traced run's stacked guard rows ([T]
    leaves; [T, B] batched): the FIRST violating superstep — earliest
    superstep index, then field order, then world — or None when the
    whole run is clean. The padded-scan tail and quiesced supersteps
    arrive zeroed (the drivers' valid mask), so they can never flag."""
    valid = np.asarray(valid)
    t_us = np.asarray(t_us)
    cols = {f: np.asarray(getattr(integ, f))
            for f in IntegrityRow._fields}

    def scan_world(world: Optional[int]):
        # vectorized: the clean-run (overwhelmingly common) case is
        # one numpy pass, not a Python loop per superstep × field —
        # this decode runs after EVERY guard-mode traced run
        m = valid if world is None else valid[:, world]
        idxs = np.nonzero(m)[0]
        if idxs.size == 0:
            return None
        sub = np.stack([cols[f][m] if world is None
                        else cols[f][m, world]
                        for f in IntegrityRow._fields])      # [F, S]
        hits = sub != 0
        step_any = hits.any(axis=0)
        if not step_any.any():
            return None
        si = int(np.argmax(step_any))       # first violating superstep
        fi = int(np.argmax(hits[:, si]))    # first field, schema order
        i = int(idxs[si])
        return {"superstep": i,
                "t": int(t_us[i] if world is None else t_us[i, world]),
                "world": world,
                "field": IntegrityRow._fields[fi],
                "value": int(sub[fi, si])}

    if n_worlds is None:
        return scan_world(None)
    hits = [h for h in (scan_world(b) for b in range(n_worlds)) if h]
    if not hits:
        return None
    return min(hits, key=lambda h: (h["superstep"],
                                    IntegrityRow._fields.index(
                                        h["field"]), h["world"]))


def final_state_guard(state, who: str, comm=None) -> None:
    """The traceless driver's (``run_quiet``) guard: no per-superstep
    rows exist there, so only state-local invariants are checkable —
    every cumulative integer scalar (and every integer leaf of at most
    one axis) must be non-negative, checked in one host read. This keeps
    a ``verify != "off"`` engine from ever running *silently*
    unverified through the quiet path; per-superstep localization and
    the full invariant set need the traced drivers. On a sharded state
    ``comm`` (the sharded axis' comm) takes each minimum over the ranks,
    so that every rank judges the global state alike."""
    import torch
    names, mins = [], []
    for name in state._fields:
        if name == "states":
            continue    # the scenario state may legitimately hold
        #               # negative user values (e.g. gossip hop = -1)
        v = getattr(state, name)
        # counters/wake/time scalars (the dimension grows by one per
        # world axis); the [K, N]-class planes have their own sentinels
        # and are the traced guard's business
        if v.dim() <= 1 and v.numel() and not v.dtype.is_floating_point \
                and v.dtype != torch.bool:
            names.append(name)
            mins.append(v.min().to(torch.int64))
    if not mins:
        return
    lows = torch.stack(mins)
    if comm is not None:
        lows = comm.all_min(lows)
    lows = lows.cpu().tolist()
    for name, low in zip(names, lows):
        if low < 0:
            raise IntegrityViolation(
                f"final state ({who}, run_quiet): verify=guard "
                f"invariant violated — {name}: {low} "
                "(negative cumulative counter; run the traced driver "
                "for per-superstep localization)")


def guard_violation_error(hit: dict, who: str) -> IntegrityViolation:
    """The pinned diagnostic (module docstring): superstep row + field
    + scalar value + meaning, one line, both names, never an array."""
    w = "" if hit["world"] is None else f", world {hit['world']}"
    return IntegrityViolation(
        f"superstep {hit['superstep']} (t={hit['t']}{w}): {who} "
        f"verify=guard invariant violated — {hit['field']}: "
        f"{hit['value']} ({FIELD_MEANING[hit['field']]})")

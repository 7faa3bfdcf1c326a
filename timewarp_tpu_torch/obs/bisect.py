"""Divergence bisection: find WHERE two runs part ways, exactly (port of
``timewarp_tpu/obs/bisect.py`` over the torch engines).

The repo can *detect* divergence — TraceMismatch, digest chains, the
integrity detection law — but detection alone answers "something
differs", not "what happened at t". This module turns the existing
replay machinery (runs are pure functions of config + seed, so any
prefix is re-runnable bit-for-bit) into a localizer:

1. **Chain phase** — run both sides chunk by chunk, folding a digest
   per chunk into a sha256 chain (state digests for same-engine
   comparisons — they see payload-only corruption the trace digests
   cannot; trace-row chains for cross-engine comparisons, where state
   layouts legitimately differ). The chains are *prefix-consistent*
   (``chain[i]`` equal ⇒ all earlier entries equal), so the first
   diverging chunk falls to a **binary search** over the chain —
   :func:`chain_bisect`.
2. **Replay phase** — re-run both sides to that chunk's entry (pure
   replay; injected ``flip:`` corruption re-fires deterministically),
   then run the one diverging chunk again with the flight recorder
   on (``record=``, obs/flight.py) and traces enabled.
3. **Diff phase** — the chunk's trace rows give the first diverging
   superstep and field; the two flight logs give the specific message
   events that differ.

The result is ONE pinned diagnostic line — chunk, superstep, field,
event delta — extending the TraceMismatch format (trace/events.py),
never an array dump (tests/test_zzzzzflight.py pins it the way
tests/test_zzdiag.py pins TraceMismatch; tests/test_torch_bisect.py
holds the port's lines to the reference's).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np

__all__ = ["DivergenceReport", "chain_bisect", "bisect_engines",
           "first_trail_divergence"]


@dataclass
class DivergenceReport:
    """Where two runs first part ways. ``line()`` is the pinned
    one-line diagnostic; everything else is the structured view the
    CLI emits as JSON."""
    a_name: str
    b_name: str
    chunk: int                       # first diverging chunk (0-based)
    chunk_steps: Tuple[int, int]     # that chunk's superstep span
    superstep: Optional[int] = None  # run-global first diverging row
    t_us: Optional[int] = None
    fields: Optional[str] = None     # "recv_hash: 1 != 2" style
    only_a: int = 0                  # events only the A log holds
    only_b: int = 0
    first_delta: Optional[str] = None
    basis: str = "state"             # what the chains digested
    rows_compared: bool = False      # did the re-run diff trace rows?

    def line(self) -> str:
        """The pinned diagnostic: one line, both names, scalar values
        only — the TraceMismatch contract extended with the chunk and
        the event delta."""
        lo, hi = self.chunk_steps
        where = f"chunk {self.chunk} (supersteps {lo}..{hi})"
        if self.superstep is not None:
            where += f", superstep {self.superstep}"
            if self.t_us is not None:
                where += f" (t={self.t_us})"
        msg = f"{where}: {self.a_name} != {self.b_name}"
        if self.fields:
            msg += f" — {self.fields}"
        elif self.basis == "state" and self.rows_compared:
            msg += " — state digests diverge with identical trace " \
                   "rows (a non-observable plane, e.g. a payload word)"
        else:
            msg += f" — the {self.basis} digest chains diverge " \
                   "(the chunk re-run yielded no trace rows to diff)"
        if self.only_a or self.only_b:
            msg += (f"; events: {self.only_a} only-in-{self.a_name}, "
                    f"{self.only_b} only-in-{self.b_name}")
            if self.first_delta:
                msg += f", first: {self.first_delta}"
        return msg

    def to_json(self) -> dict:
        return {"a": self.a_name, "b": self.b_name,
                "basis": self.basis,
                "chunk": self.chunk,
                "chunk_steps": list(self.chunk_steps),
                "superstep": self.superstep, "t_us": self.t_us,
                "fields": self.fields, "only_a": self.only_a,
                "only_b": self.only_b, "first_delta": self.first_delta,
                "line": self.line()}


def chain_bisect(chain_a, chain_b) -> Optional[int]:
    """First index where two prefix-consistent digest chains differ —
    O(log n) compares (each chain entry folds everything before it,
    so equality at i implies prefix equality). Returns None when the
    chains agree entry-for-entry AND have equal length; a shorter
    chain that is a prefix of the longer diverges at its end (one
    side kept running — that IS the divergence)."""
    n = min(len(chain_a), len(chain_b))
    lo, hi = 0, n
    while lo < hi:
        mid = (lo + hi) // 2
        if chain_a[mid] == chain_b[mid]:
            lo = mid + 1
        else:
            hi = mid
    if lo < n:
        return lo
    if len(chain_a) != len(chain_b):
        return n
    return None


def _fresh(inject):
    """Each phase needs a FRESH injector (FlipInjector fires once);
    ``inject`` is a zero-arg factory, or None."""
    return None if inject is None else inject()


def _chain_run(engine, budget: int, chunk: int, inject, basis: str,
               stop_before: Optional[int] = None):
    """Run ``engine`` (fresh state) chunk by chunk. Returns
    ``(chain_per_chunk, steps_after_chunk, state, next_inject_applied)``
    where ``chain_per_chunk[i]`` is the sha256 chain value AFTER chunk
    i and ``steps_after_chunk[i]`` the cumulative superstep count.
    With ``stop_before=c`` the loop exits at chunk c's ENTRY — with
    c's injection (if any) already applied to the returned state,
    exactly as the full run would have."""
    from ..integrity.digest import (VERIFY_CHAIN_ZERO,
                                    chain_state_digest, host_digests)
    from ..sweep.spec import DIGEST_ZERO, chain_digest
    st = engine.init_state()
    chain = []
    steps = []
    cur = VERIFY_CHAIN_ZERO if basis == "state" else DIGEST_ZERO
    done = 0
    ci = 0
    while True:
        remaining = budget - done
        active = bool(np.asarray(
            _get(engine.world_active(st))).any()) and remaining > 0
        if inject is not None and (active or stop_before == ci):
            mut = inject(ci, st)
            if mut is not None:
                st = mut
        if stop_before == ci:
            return chain, steps, st, True
        if not active:
            return chain, steps, st, False
        st, tr = engine.run(int(min(remaining, chunk)), state=st)
        done += len(tr)
        if basis == "state":
            cur = chain_state_digest(
                cur, host_digests(st, getattr(engine, "batch", None),
                                  engine.scenario.u32_states)[0])
        else:
            cur = chain_digest(cur, tr)
        chain.append(cur)
        steps.append(done)
        ci += 1


def bisect_engines(make_a: Callable, make_b: Callable, budget: int,
                   *, chunk: int = 64, names=("a", "b"),
                   inject_a=None, inject_b=None, basis: str = "state",
                   record: str = "full"
                   ) -> Optional[DivergenceReport]:
    """Bisect two runs to their first divergence (module docstring).

    ``make_a`` / ``make_b`` build a FRESH engine, accepting a
    ``record=`` keyword (the chain phase runs ``record="off"`` — the
    zero-overhead law makes it free; the diverging chunk re-runs with
    ``record=record``). ``inject_a`` / ``inject_b`` are zero-arg
    factories of deterministic corruption hooks (``FlipInjector``
    factories — each phase needs a fresh one; the flip re-fires at
    the same chunk on replay, which is what makes the corrupted run
    re-runnable evidence). ``basis="state"`` chains full state
    digests (same-engine comparisons — sees payload-only divergence);
    ``"trace"`` chains trace rows (cross-engine comparisons, where
    state layouts legitimately differ). Returns None when the runs
    are bit-identical at every chunk boundary."""
    if basis not in ("state", "trace"):
        raise ValueError(f"basis must be 'state' or 'trace', "
                         f"got {basis!r}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    a_name, b_name = names
    # ONE off-mode engine per side serves the guard, the chain phase,
    # and the replay-to-entry below — runs are pure functions of
    # config + state, and construction (sanitize, fault lowering,
    # topology) is the expensive part
    eng_a, eng_b = make_a(record="off"), make_b(record="off")
    for eng in (eng_a, eng_b):
        if getattr(eng, "batch", None) is not None:
            raise ValueError(
                "bisect_engines localizes one run's divergence; "
                "batched fleets bisect per world (slice the config "
                "solo — bit-identical by the batch exactness law)")
    ch_a, steps_a, _, _ = _chain_run(eng_a, budget, chunk,
                                     _fresh(inject_a), basis)
    ch_b, steps_b, _, _ = _chain_run(eng_b, budget, chunk,
                                     _fresh(inject_b), basis)
    c = chain_bisect(ch_a, ch_b)
    if c is None:
        return None
    lo = steps_a[c - 1] if c > 0 else 0
    hi = steps_a[c] if c < len(steps_a) else (
        steps_b[c] if c < len(steps_b) else lo)

    # replay to the diverging chunk's entry (pure replay — chunks
    # before c are bit-identical by the chain), then run THAT chunk
    # with the flight recorder + traces on
    def chunk_rerun(off_eng, make, inject):
        _, _, st, _ = _chain_run(off_eng, budget, chunk,
                                 _fresh(inject), basis, stop_before=c)
        eng = make(record=record)
        remaining = max(budget - lo, 0)
        tr = log = None
        if remaining and bool(np.asarray(
                _get(eng.world_active(st))).any()):
            try:
                _, tr = eng.run(int(min(remaining, chunk)), state=st)
            finally:
                log = eng.last_run_flight
        return tr, log
    tr_a, log_a = chunk_rerun(eng_a, make_a, inject_a)
    tr_b, log_b = chunk_rerun(eng_b, make_b, inject_b)

    rep = DivergenceReport(a_name=a_name, b_name=b_name, chunk=c,
                           chunk_steps=(lo, hi), basis=basis)
    from ..trace.events import _FIELDS
    if (tr_a is None) != (tr_b is None):
        # one side had already quiesced at this chunk's entry — that
        # asymmetry IS the divergence (the strict-prefix chain case)
        quiet, ran = ((a_name, b_name) if tr_a is None
                      else (b_name, a_name))
        rep.fields = (f"{quiet} had already quiesced at this "
                      f"chunk's entry while {ran} kept running")
    elif tr_a is not None and tr_b is not None:
        rep.rows_compared = True
        m = min(len(tr_a), len(tr_b))
        for i in range(m):
            ra, rb = tr_a.row(i), tr_b.row(i)
            if ra != rb:
                rep.superstep = lo + i
                rep.t_us = int(ra[0])
                rep.fields = ", ".join(
                    f"{f}: {x} != {y}" for f, x, y in
                    zip(_FIELDS, ra, rb) if x != y)
                break
        else:
            if len(tr_a) != len(tr_b):
                rep.superstep = lo + m
                rep.fields = (f"trace length: {a_name} ran "
                              f"{len(tr_a)} supersteps, {b_name} "
                              f"{len(tr_b)}")
    if log_a is not None and log_b is not None:
        ka, kb = log_a.keyset(), log_b.keyset()
        rep.only_a, rep.only_b = len(ka - kb), len(kb - ka)
        delta = sorted((ka - kb) | (kb - ka),
                       key=lambda e: (e[4], e[0], e[1], e[2]))
        if delta:
            from .flight import ACTION_NAMES, EV_FAULT, KIND_NAMES
            k, src, dst, send_t, t, tag = delta[0]
            name = KIND_NAMES.get(k, str(k))
            if k == EV_FAULT:
                name += f"/{ACTION_NAMES.get(tag, tag)}"
            rep.first_delta = (f"{name} src={src} dst={dst} "
                               f"send_t={send_t} t={t}")
    return rep


def first_trail_divergence(trail, solo_trace) -> Optional[dict]:
    """The sweep ``--verify`` auto-bisect: compare a
    world's journaled per-chunk digest trail (``[[supersteps,
    chain_hex], ...]`` — the prefix values of the row chain at the
    bucket's chunk boundaries) against the solo twin's trace,
    re-chained to the same row counts. Returns the first diverging
    chunk (index, superstep span, both chain values), or None when
    the trail agrees everywhere (the divergence then lies past the
    journaled chunks — e.g. in the counters)."""
    from ..sweep.spec import DIGEST_ZERO, chain_digest

    class _Slice:
        # chain_digest folds rows [0, n) of a trace-like view
        def __init__(self, tr, a, b):
            self.tr, self.a, self.b = tr, a, b

        def __len__(self):
            return self.b - self.a

        def row(self, i):
            return self.tr.row(self.a + i)

    cur = DIGEST_ZERO
    prev_steps = 0
    for k, (steps, want) in enumerate(trail):
        steps = int(steps)
        if steps > len(solo_trace):
            return {"chunk": k, "supersteps": [prev_steps, steps],
                    "streamed": want,
                    "solo": f"(solo ran only {len(solo_trace)} "
                            "supersteps)"}
        cur = chain_digest(cur, _Slice(solo_trace, prev_steps, steps))
        if cur != want:
            return {"chunk": k, "supersteps": [prev_steps, steps],
                    "streamed": want, "solo": cur}
        prev_steps = steps
    return None


def _get(x):
    """A device tensor's value on the host."""
    return x.cpu()

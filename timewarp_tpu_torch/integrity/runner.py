"""The verified chunked driver: detect, roll back, re-run, bit-exact (the
port of ``timewarp_tpu/integrity/runner.py``, on every torch engine).

``run_verified`` is ``run_stream``/``run_controlled``'s self-checking
sibling: the run executes one ``run`` chunk at a time, and around every
chunk the engine's ``verify`` mode is enforced —

1. **entry digest** (``digest``/``shadow``, every chunk): the state
   digest is recomputed and compared with the value recorded at the
   previous chunk's exit, so corruption of state at rest is caught
   before the corrupt state runs a superstep. Not cadence-gated: a flip
   at an unchecked boundary would otherwise be absorbed into the next
   recorded digest.
2. **guard** (every non-off mode): the chunk's traced run carries the
   invariant plane (checks.py); ``run`` raises
   :class:`~timewarp_tpu_torch.integrity.checks.IntegrityViolation`
   naming the first violating superstep and field.
3. **shadow** (``shadow``, every ``cadence``-th chunk): the chunk
   re-executes from its pre-state and the two post-states' digests must
   agree. The reference's twin is a *different compiled executable* (its
   scan at twice the pad); an eager PyTorch engine has no executable, so
   the port's twin re-runs the chunk through the same traced driver —
   the same kernels, on the card the same launches — into fresh tensors.
   It catches a transient fault in one execution (a flipped bit in a
   kernel's registers or in memory it wrote); it cannot catch a
   deterministic error, which both executions repeat, since no compiler
   stands between the two runs.

On a sharded engine every check is global: the guard rows are summed
over the ranks, the digests are the gathered state's (digest.py), a flip
lands on the rank that owns its element (inject.py), and every rank
takes the same decision from the same numbers, so the ranks roll back
together and issue their collectives in one order.

On any detection the driver **rolls back deterministically**: restore
the last verified snapshot (state and trace-row high-water marks),
discard the tainted rows, and re-run; the recovered run is bit-identical
to a run that was never corrupted (the detection law). A violation that
survives ``max_rollbacks`` consecutive rollbacks of the same chunk is
persistent and re-raises loudly. A fleet rolls back the whole fleet's
snapshot.

``verify="off"`` still runs the plain chunked loop (no checks, no
digests) — the baseline the overhead fractions divide by.
"""

from __future__ import annotations

import numpy as np

__all__ = ["VerifiedRunMixin"]


class VerifiedRunMixin:
    """``verify=`` wiring + the self-verifying chunked driver (module
    docstring). Host state only: an engine with ``verify="off"`` builds
    no guard row."""

    #: the engine's verify mode ("off" | "guard" | "digest" | "shadow")
    verify = "off"
    #: the last run_verified call's integrity record (dict)
    last_run_integrity = None

    def _bind_verify(self, verify: str) -> None:
        from .checks import validate_verify
        self.verify = validate_verify(verify, type(self).__name__)

    def _capture_integrity(self, integ, valid, t_us) -> None:
        """Host-side decode of a traced run's guard plane (an
        ``IntegrityRow`` of numpy ``[T, B]`` columns, or None): raise the
        pinned :class:`IntegrityViolation` on the FIRST violating
        superstep + field — loud in any non-off mode (``run_verified``
        catches it and rolls back; a plain ``run`` surfaces it)."""
        if self.verify == "off" or integ is None:
            return
        from .checks import first_guard_violation, guard_violation_error
        batch = getattr(self, "batch", None)
        hit = first_guard_violation(integ, valid, t_us,
                                    None if batch is None else batch.B)
        if hit is not None:
            raise guard_violation_error(hit, type(self).__name__)

    # -- the sharded engines' hooks ------------------------------------------

    def _sharding(self):
        """The sharded engine whose rank holds this engine's states (its
        ``leaf_axis`` and ``shard_comm``), or None on one device."""
        return None

    def _callback_state(self, state):
        """The state a driver's callback sees: ``state`` on one device,
        the gathered global state on a sharded engine."""
        return state

    def _inject(self, inject, chunk_idx: int, state):
        """Call the corruption hook on this rank's state: a sharded
        engine's hook is called with ``shards=`` the engine."""
        sh = self._sharding()
        if sh is None:
            return inject(chunk_idx, state)
        return inject(chunk_idx, state, shards=sh)

    # -- digests ---------------------------------------------------------

    def _state_digests(self, state) -> np.ndarray:
        """uint32[1] (solo) / uint32[B] (batched) digest view, of the
        global state on a sharded engine."""
        from .digest import host_digests
        return host_digests(state, getattr(self, "batch", None),
                            self.scenario.u32_states, self._sharding())

    def _shadow_rerun(self, budget, pre_state):
        """Re-execute one chunk from ``pre_state`` through the traced
        driver into fresh tensors; returns the twin's final state. The
        primary chunk's host-side artifacts (stats, telemetry, metrics
        stream, flight log) are shielded — the shadow is a check, not a
        run."""
        saved = (self.last_run_stats, self.last_run_telemetry,
                 getattr(self, "metrics", None),
                 getattr(self, "last_run_flight", None),
                 getattr(self, "flight_out", None))
        self.metrics = None
        self.flight_out = None
        try:
            fin, _ = self.run(budget, state=pre_state)
        finally:
            (self.last_run_stats, self.last_run_telemetry,
             self.metrics, self.last_run_flight,
             self.flight_out) = saved
        return fin

    # -- the driver ------------------------------------------------------

    def run_verified(self, budgets, state=None, *, chunk: int = 64,
                     cadence: int = 1, inject=None,
                     max_rollbacks: int = 3, on_quiesce=None):
        """Run to quiescence/budget under the engine's ``verify``
        mode, chunk by chunk, rolling back to the last verified
        snapshot on any detection (module docstring). Accepts the
        same budget forms as ``run`` (int; batched engines also a
        per-world vector) and returns ``(final_state, trace)`` —
        batched engines a per-world trace list — exactly like
        ``run``. ``inject`` is the deterministic-corruption test hook
        (integrity/inject.py ``FlipInjector``): called as
        ``inject(chunk_idx, state)`` between chunks (on a sharded engine
        with ``shards=`` the engine, on the rank's state), it may return
        a corrupted replacement state. ``on_quiesce(b, state)`` fires
        exactly once per world (``b=0`` solo), the moment the world
        has quiesced or exhausted its budget at a VERIFIED boundary —
        evaluated on committed states only and before the injection
        hook, so a rolled-back chunk can never fire (or double-fire)
        it: the rollback × streaming contract
        (tests/test_zzzzzzspec.py); a sharded engine hands it the
        gathered state. The integrity record lands on
        ``last_run_integrity`` (and the digest chain on
        ``last_run_stats['digest_chain']``)."""
        from ..interp.torch_engine.common import stats_merge
        from ..trace.events import SuperstepTrace
        from .checks import IntegrityViolation
        from .digest import VERIFY_CHAIN_ZERO, chain_state_digest
        mode = self.verify
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if cadence < 1:
            raise ValueError(f"cadence must be >= 1, got {cadence}")
        batch = getattr(self, "batch", None)
        nworld = 1 if batch is None else batch.B
        if batch is not None:
            budgets = np.broadcast_to(
                np.asarray(budgets, np.int64), (batch.B,)).copy()
        else:
            budgets = int(budgets)
        if np.min(budgets) < 0:
            raise ValueError("step budgets must be >= 0")
        st = state if state is not None else self.init_state()
        start = self._host_worlds(st.steps).astype(np.int64)
        rows = [[] for _ in range(nworld)]
        chunk_stats, frame_chunks, flight_chunks = [], [], []
        self.last_run_telemetry = None
        self.last_run_flight = None
        # cleared at entry: a run that RAISES (persistent corruption)
        # must not leave a previous run's record for callers to
        # misattribute
        self.last_run_integrity = None
        digest_on = mode in ("digest", "shadow")
        vdig = self._state_digests(st) if digest_on else None
        chain = [VERIFY_CHAIN_ZERO] * nworld
        #: last verified point: (state, per-world row counts)
        snap = (st, [0] * nworld)
        violations: list = []
        rollbacks = checks = 0
        consecutive = 0
        metrics = getattr(self, "metrics", None)

        def record(v: dict):
            violations.append(v)
            if metrics is not None:
                # "kind" would collide with the metrics line's own
                # kind field — the violation's kind rides as "check"
                metrics.event("integrity_violation",
                              label=self.metrics_label, **{
                                  ("check" if k == "kind" else k): val
                                  for k, val in v.items()
                                  if isinstance(val, (int, str))})

        def rollback(v: dict):
            nonlocal st, rollbacks, consecutive
            record(v)
            rollbacks += 1
            consecutive += 1
            if consecutive > max_rollbacks:
                raise IntegrityViolation(
                    f"{self.metrics_label}: chunk {v['chunk']} failed "
                    f"verification {consecutive} consecutive times "
                    f"({v.get('kind', 'guard')}) — the corruption is "
                    "persistent (bad memory / real bug), rollback "
                    "cannot converge (docs/integrity.md)")
            st = snap[0]
            for b in range(nworld):
                del rows[b][snap[1][b]:]
            if digest_on:
                # the restored snapshot must still MATCH the recorded
                # verified digest — never re-anchor the baseline from
                # it: an in-place corruption (HBM bit rot) hits the
                # live state and the snapshot's shared buffers alike,
                # and re-deriving vdig from the corrupt snapshot
                # would silently adopt the corruption as truth. A
                # snapshot that fails its own record is unrecoverable
                # in-memory — escalate to an on-disk checkpoint.
                from .digest import first_digest_mismatch
                hit = first_digest_mismatch(self._state_digests(st),
                                            vdig)
                if hit is not None:
                    bad, got_h, want_h = hit
                    raise IntegrityViolation(
                        f"{self.metrics_label}: chunk {v['chunk']} "
                        f"world {bad}: the last verified in-memory "
                        f"snapshot fails its recorded digest "
                        f"({got_h} != {want_h}) — resident state "
                        "corrupted in place; restore from an on-disk "
                        "checkpoint whose digest verifies "
                        "(docs/integrity.md)")
            if metrics is not None:
                metrics.emit("integrity", label=self.metrics_label,
                             mode=mode, chunk=int(v["chunk"]),
                             event="rollback")

        emitted = np.zeros(nworld, bool)
        ci = 0
        while True:
            _, remaining, active = self._controlled_progress(
                st, budgets, start)
            act = np.atleast_1d(np.asarray(active))
            newly = ~act & ~emitted
            if newly.any() and digest_on:
                # the emission below promises a VERIFIED state: an
                # in-place corruption since the last commit (the
                # digest mode's whole threat model — e.g. a corrupted
                # wake flipping world_active) must not fire the
                # exactly-once callback with a corrupt state, so the
                # entry digest check runs FIRST on quiesce
                # transitions (rare — once per world; the regular
                # every-chunk entry check below is untouched)
                from .digest import first_digest_mismatch
                hit = first_digest_mismatch(self._state_digests(st),
                                            vdig)
                if hit is not None:
                    bad, got_h, want_h = hit
                    rollback({
                        "chunk": ci, "kind": "entry_digest",
                        "world": bad if batch is not None else None,
                        "expected": want_h, "got": got_h})
                    continue
            seen = self._callback_state(st) \
                if newly.any() and on_quiesce is not None else None
            for b in np.nonzero(newly)[0]:
                # `st` here is the last VERIFIED state (rollback
                # restores it before the loop re-enters, and the
                # digest guard above re-checks it at rest), so a
                # tainted chunk can never quiesce a world — and the
                # emitted ledger makes the callback exactly-once even
                # across rollbacks of later chunks
                emitted[int(b)] = True
                if on_quiesce is not None:
                    on_quiesce(int(b), seen)
            if not np.any(active):
                break
            if inject is not None:
                mut = self._inject(inject, ci, st)
                if mut is not None:
                    st = mut
            due = (ci % cadence == 0)
            if digest_on:
                checks += 1
                from .digest import first_digest_mismatch
                hit = first_digest_mismatch(self._state_digests(st),
                                            vdig)
                if hit is not None:
                    bad, got_h, want_h = hit
                    rollback({
                        "chunk": ci, "kind": "entry_digest",
                        "world": bad if batch is not None else None,
                        "expected": want_h, "got": got_h})
                    continue
            pre = st
            if batch is not None:
                budget = np.where(active,
                                  np.minimum(remaining, chunk), 0)
            else:
                budget = int(min(int(remaining), chunk))
            # shield the metrics stream AND the flight-event log
            # while the chunk runs: run() flushes its `supersteps`
            # lines (and drains recorded events) internally, but THIS
            # chunk is unverified — a chunk that fails the guard or
            # the shadow compare would leave tainted (and, after the
            # re-run, duplicated) lines behind. The flush happens at
            # commit below, once the chunk is verified.
            self.metrics = None
            fout, self.flight_out = getattr(self, "flight_out",
                                            None), None
            try:
                st, tr = self.run(budget, state=st)
            except IntegrityViolation as e:
                rollback({"chunk": ci, "kind": "guard",
                          "detail": str(e)})
                continue
            finally:
                self.metrics = metrics
                self.flight_out = fout
            pstats, ptele = self.last_run_stats, self.last_run_telemetry
            pflight = self.last_run_flight
            dp = None   # post-chunk digest, reused at commit when the
            #           # shadow compare already paid for it
            if mode == "shadow" and due:
                checks += 1
                try:
                    twin = self._shadow_rerun(budget, pre)
                    ds, dp = (self._state_digests(twin),
                              self._state_digests(st))
                except IntegrityViolation as e:
                    rollback({"chunk": ci, "kind": "shadow_guard",
                              "detail": str(e)})
                    continue
                from .digest import first_digest_mismatch
                hit = first_digest_mismatch(ds, dp)
                if hit is not None:
                    bad, shadow_h, primary_h = hit
                    rollback({
                        "chunk": ci, "kind": "shadow",
                        "world": bad if batch is not None else None,
                        "primary": primary_h, "shadow": shadow_h})
                    continue
            # commit: the chunk is verified — advance the snapshot
            # (and only now flush its telemetry to the metrics
            # stream, exactly the lines run() would have flushed)
            chunk_stats.append(pstats)
            frame_chunks.append(ptele)
            flight_chunks.append(pflight)
            if metrics is not None and ptele is not None:
                metrics.superstep_chunk(self.metrics_label, ptele)
            if fout is not None and pflight is not None:
                # drain the VERIFIED chunk's events only — a rolled-
                # back chunk's events never reach the log
                if isinstance(pflight, list):
                    for b, lg in enumerate(pflight):
                        fout.write(lg, world=b)
                else:
                    fout.write(pflight)
            if batch is not None:
                for b in range(nworld):
                    rows[b].extend(tr[b].row(i)
                                   for i in range(len(tr[b])))
            else:
                rows[0].extend(tr.row(i) for i in range(len(tr)))
            if digest_on:
                vdig = dp if dp is not None \
                    else self._state_digests(st)
                chain = [chain_state_digest(chain[b], vdig[b])
                         for b in range(nworld)]
            snap = (st, [len(r) for r in rows])
            consecutive = 0
            if metrics is not None and self.verify != "off":
                # one line per chunk a check actually ran on — the
                # guard plane and the digest entry check both run
                # every chunk (only the shadow sampling is cadenced),
                # so gating this on `due` would undercount verified
                # epochs for a metrics consumer
                metrics.emit("integrity", label=self.metrics_label,
                             mode=mode, chunk=ci, event="verified")
            ci += 1

        if chunk_stats:
            self.last_run_stats = stats_merge(chunk_stats)
        else:
            # a zero-chunk run (already quiesced, or budget 0) must
            # not leave a PREVIOUS run's stats behind for the digest
            # fields below to graft onto — that record would be a
            # chimera of old wall/superstep numbers and this run's
            # digests
            self.last_run_stats = {"supersteps": 0,
                                   "wall_seconds": 0.0, "compiles": 0,
                                   "chunks": 0,
                                   "per_chunk_compiles": []}
        if self.telemetry != "off":
            from ..obs.telemetry import concat_frames
            self.last_run_telemetry = concat_frames(frame_chunks)
        if getattr(self, "record", "off") != "off":
            from ..obs.flight import concat_flight
            self.last_run_flight = concat_flight(flight_chunks)
        self.last_run_integrity = {
            "mode": mode, "chunks": ci, "checks": checks,
            "rollbacks": rollbacks, "violations": violations,
            "state_digest": ([int(d) for d in vdig]
                             if digest_on else None),
            "digest_chain": list(chain) if digest_on else None,
        }
        if digest_on and self.last_run_stats is not None:
            # the rolling digest chains through last_run_stats — the
            # uniform place run-level facts live (obs/, RunStatsMixin)
            self.last_run_stats["state_digest"] = [int(d)
                                                   for d in vdig]
            self.last_run_stats["digest_chain"] = list(chain)
        if batch is not None:
            return st, [SuperstepTrace.from_rows(r) for r in rows]
        return st, SuperstepTrace.from_rows(rows[0])


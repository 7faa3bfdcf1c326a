"""Structured-concurrency job lifecycle — the L2 layer
(the port's copy of ``timewarp_tpu/manage/jobs.py``).

TPU-native re-design of the reference's ``JobCurator``
(`/root/reference/src/Control/TimeWarp/Manager/Job.hs`): track a set of
jobs, interrupt them all at once (politely, forcibly, or politely with
a forced deadline), and await their completion. The transport layer
hangs every socket's worker threads and every server's accept loop off
a curator (Transfer.hs:124-129), so graceful teardown is one
``stop_all_jobs``.

Where the reference blocks on STM ``TVar`` retries (Job.hs:48-49,
158-161), this build blocks on the Park/Unpark effect pair — so the
same curator works identically under the pure emulator and the real
asyncio interpreter, and state mutation between yields is atomic under
both (single host thread / single event loop).

Semantics map (file:line = reference):

- ``InterruptType`` Plain / Force / WithTimeout — Job.hs:84-91.
- ``add_job`` on a closed curator: the job is not registered and its
  interrupter runs immediately — Job.hs:111-134.
- ``interrupt_all_jobs`` is idempotent; ``WithTimeout`` forks a
  watchdog that Force-clears stragglers at the deadline (running the
  user callback first) — Job.hs:138-154.
- ``await_all_jobs`` blocks until closed ∧ no jobs — Job.hs:158-161.
- ``stop_all_jobs`` = interrupt + await — Job.hs:164-165.
- ``add_manager_as_job`` nests curators — Job.hs:168-173.
- ``add_thread_job`` forks a thread whose interrupter is
  ``kill_thread``; the thread finally-marks its job done —
  Job.hs:176-184.
- ``add_safe_thread_job`` forks a thread with a no-op interrupter: the
  job self-terminates, checking :attr:`JobCurator.is_interrupted` /
  :meth:`JobCurator.unless_interrupted` — Job.hs:189-199.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

from ..core.effects import Fork, MyTid, Program, ProgramFn, ThrowTo, Wait
from ..core.errors import ThreadKilled
from ..core.time import Microsecond
from .sync import _Waitable

__all__ = ["JobCurator", "InterruptType", "Plain", "Force", "WithTimeout"]


class InterruptType:
    """How to interrupt (≙ ``InterruptType``, Job.hs:84-91)."""
    __slots__ = ()


@dataclass(frozen=True)
class _Plain(InterruptType):
    """Run every job's interrupter; completion still awaited."""


@dataclass(frozen=True)
class _Force(InterruptType):
    """Interrupt and *consider every job done* immediately."""


@dataclass(frozen=True)
class WithTimeout(InterruptType):
    """Plain now; at ``timeout_us``, run ``on_timeout`` (if any) and
    Force-clear whatever is still registered."""
    timeout_us: Microsecond
    on_timeout: Optional[ProgramFn] = None


Plain = _Plain()
Force = _Force()


class JobCurator(_Waitable):
    """≙ ``JobCurator`` (Job.hs:65-81). All methods are programs
    (generators) — run them with ``yield from`` inside any timed
    program, under either interpreter."""

    def __init__(self) -> None:
        super().__init__()
        self._closed = False
        self._jobs: Dict[int, ProgramFn] = {}
        self._counter = 0

    # -- state -----------------------------------------------------------

    @property
    def is_closed(self) -> bool:
        return self._closed

    @property
    def is_interrupted(self) -> bool:
        """≙ ``isInterrupted`` (Job.hs:195-196): closed ⇒ interrupted."""
        return self._closed

    @property
    def job_count(self) -> int:
        return len(self._jobs)

    def unless_interrupted(self, program: ProgramFn) -> Program:
        """Run ``program`` only when not interrupted (≙ Job.hs:198-199)."""
        if not self._closed:
            return (yield from program())
        return None

    # -- registration ----------------------------------------------------

    def add_job(self, interrupter: ProgramFn) -> Program:
        """Register a job; returns its id, or ``None`` after running the
        interrupter immediately when the curator is already closed
        (≙ Job.hs:111-134)."""
        if self._closed:
            yield from interrupter()
            return None
        jid = self._counter
        self._counter += 1
        self._jobs[jid] = interrupter
        return jid

    def mark_done(self, jid: Optional[int]) -> Program:
        if jid is not None:
            self._jobs.pop(jid, None)
        yield from self._notify()

    def _thread_job(self, program: ProgramFn, *, safe: bool) -> Program:
        holder: Dict[str, Any] = {}

        def interrupter() -> Program:
            tid = holder.get("tid")
            if tid is not None and not safe:
                yield ThrowTo(tid, ThreadKilled())

        def wrapped() -> Program:
            holder["tid"] = yield MyTid()
            jid = yield from self.add_job(interrupter)
            if jid is None:
                # ≙ addJob on a closed curator (Job.hs:111-134): the
                # interrupter ran; the action never starts.
                return
            try:
                yield from program()
            finally:
                yield from self.mark_done(jid)

        return (yield Fork(wrapped))

    def add_thread_job(self, program: ProgramFn) -> Program:
        """Fork ``program`` as a tracked thread whose interrupter is
        ``kill_thread`` (≙ ``addThreadJob``, Job.hs:176-184). Returns
        the thread id."""
        return (yield from self._thread_job(program, safe=False))

    def add_safe_thread_job(self, program: ProgramFn) -> Program:
        """Fork ``program`` as a tracked thread that interruption does
        *not* kill — it self-terminates, typically polling
        :attr:`is_interrupted` (≙ ``addSafeThreadJob``, Job.hs:189-193)."""
        return (yield from self._thread_job(program, safe=True))

    def add_manager_as_job(self, child: "JobCurator",
                           itype: InterruptType = Plain) -> Program:
        """Nest ``child``: interrupting this curator interrupts it (with
        ``itype`` — the transport uses ``WithTimeout`` so a stuck
        listener is Force-cleared at the deadline, Transfer.hs:301-305),
        and it counts as one job until all its own jobs finish
        (≙ ``addManagerAsJob``, Job.hs:168-173)."""
        def interrupter() -> Program:
            yield from child.interrupt_all_jobs(itype)

        jid = yield from self.add_job(interrupter)
        if jid is None:
            return

        def waiter() -> Program:
            yield from child.await_all_jobs()
            yield from self.mark_done(jid)

        yield Fork(waiter)

    # -- interruption ----------------------------------------------------

    def interrupt_all_jobs(self, itype: InterruptType = Plain) -> Program:
        """≙ ``interruptAllJobs`` (Job.hs:136-152). The Plain pass runs
        interrupters once (second call is a no-op); Force additionally
        clears the job table; WithTimeout arms its Force watchdog even
        when the Plain pass was a no-op (the reference forks it
        unconditionally, Job.hs:147-152 — so a supervisor can impose a
        forced deadline on an already-interrupted curator)."""
        if not self._closed:
            self._closed = True
            jobs = dict(self._jobs)
            yield from self._notify()
            for fn in jobs.values():
                yield from fn()
        if isinstance(itype, _Force):
            # ≙ Force: consider every remaining job done (Job.hs:144-146)
            self._jobs.clear()
            yield from self._notify()
        elif isinstance(itype, WithTimeout):
            deadline, callback = itype.timeout_us, itype.on_timeout

            def watchdog() -> Program:
                yield Wait(int(deadline))
                if self._jobs:
                    if callback is not None:
                        yield from callback()
                    yield from self.interrupt_all_jobs(Force)

            yield Fork(watchdog)

    def await_all_jobs(self) -> Program:
        """Block until closed ∧ all jobs done (≙ Job.hs:158-161)."""
        while not (self._closed and not self._jobs):
            yield from self._await_change()

    def stop_all_jobs(self, itype: InterruptType = Plain) -> Program:
        """≙ ``stopAllJobs`` (Job.hs:164-165)."""
        yield from self.interrupt_all_jobs(itype)
        yield from self.await_all_jobs()

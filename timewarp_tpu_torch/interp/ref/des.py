"""Pure deterministic discrete-event emulation — the framework's oracle
(the port's copy of ``timewarp_tpu/interp/ref/des.py``).

TPU-native re-design of the reference's ``TimedT``
(`/root/reference/src/Control/TimeWarp/Timed/TimedT.hs`). The whole
multi-thread scenario executes on one host thread; ``wait`` costs zero
wall-clock; every action between waits is 0-cost in virtual time
(TimedT.hs:139-145). This interpreter is the *semantic reference* that
the batched JAX engine must match trace-for-trace (SURVEY.md §7).

Where the reference captures continuations with ``ContT`` (TimedT.hs:
146-151, 343-355), we use Python generators: a suspended thread *is* its
generator frame, and the event queue holds resume thunks. Exception
handler stacks with re-arming after each wait (the reference's
``catchesSeq``/``ContException`` machinery, TimedT.hs:178-204, 259-284)
are subsumed by the language: throwing into a generator at its
suspension point runs the program's own ``try/except`` blocks with
exactly the scoping the reference had to build by hand.

Determinism contract (explicit where the reference leaned on heap
internals, TimedT.hs:100-104; SURVEY.md §5.2): events are totally
ordered by ``(virtual_time, seq)`` where ``seq`` is a monotone insertion
counter. Equal-time events therefore run in the order they were
scheduled, and a ``throw_to`` wake-up reschedules the target with a
fresh ``seq`` (it runs after events already queued at `now`).
"""

from __future__ import annotations

import heapq
import logging
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ...core.effects import (AwaitIO, Fork, ForkSlave, GetLogName,
                             GetTime, MyTid, Park, Program, ProgramFn,
                             SetLogName, ThrowTo, Unpark, Wait)
from ...core.errors import DeadlockError, ThreadKilled, TimedError
from ..common import NO_TOKEN as _NO_TOKEN
from ..common import log_thread_death
from ...core.time import Microsecond, resolve

__all__ = ["PureEmulation", "PureThreadId", "run_emulation"]

_log = logging.getLogger("timewarp.emulation")


@dataclass(frozen=True)
class PureThreadId:
    """≙ ``PureThreadId`` (TimedT.hs:72-76)."""
    n: int

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"PureThreadId({self.n})"


@dataclass
class _Thread:
    tid: PureThreadId
    gen: Optional[Program]       # None until the start event fires
    program: Optional[ProgramFn]
    is_main: bool
    log_name: str
    alive: bool = True
    started: bool = False
    resume_entry: Optional[list] = None  # live queue entry, for wake-ups
    parked: bool = False
    park_token: Any = _NO_TOKEN           # pending unpark value
    #: linked-lifetime bookkeeping (ForkSlave): tids of this thread's
    #: slaves (killed when it finishes) and the master to forward
    #: uncaught exceptions to (None for plain forks)
    slaves: Optional[List["PureThreadId"]] = None
    master: Optional["PureThreadId"] = None


# Queue entry layout: [time, seq, tid, send_value, cancelled]
_TIME, _SEQ, _TID, _VALUE, _CANCELLED = range(5)


class PureEmulation:
    """Deterministic emulation interpreter (≙ ``runTimedT``, TimedT.hs:293-304).

    ``run(program_fn)`` executes the scenario to quiescence (event queue
    empty, TimedT.hs:266-267) and returns the main program's result; an
    exception escaping the *main* thread propagates to the caller, while
    uncaught exceptions in forked threads are logged — ``ThreadKilled``
    at DEBUG, others at WARNING (TimedT.hs:153-158, 306-316).
    """

    def __init__(self, *, default_log_name: str = "emulation") -> None:
        # ≙ defaultLoggerName (TimedT.hs:380-381)
        self._default_log_name = default_log_name
        self._queue: List[list] = []
        self._threads: Dict[PureThreadId, _Thread] = {}
        self._pending_exc: Dict[PureThreadId, BaseException] = {}
        self._time: Microsecond = 0
        self._seq = 0
        self._tid_counter = 0  # ≙ threadsCounter (TimedT.hs:114-115)

    # -- public ----------------------------------------------------------

    @property
    def virtual_time(self) -> Microsecond:
        return self._time

    def run(self, program_fn: ProgramFn) -> Any:
        # fresh scenario per run (≙ evalStateT emptyScenario, TimedT.hs:227)
        self._queue = []
        self._threads = {}
        self._pending_exc = {}
        self._time = 0
        self._seq = 0
        self._tid_counter = 0
        main = self._spawn(program_fn, self._default_log_name, is_main=True)
        self._push(main, self._time, None)
        main_result: List[Any] = []
        main_error: List[BaseException] = []
        deadlock_served: set = set()

        # Event loop ≙ launchTimedT (TimedT.hs:234-286).
        while True:
            while self._queue:
                entry = heapq.heappop(self._queue)
                if entry[_CANCELLED]:
                    continue
                th = self._threads[entry[_TID]]
                th.resume_entry = None
                if not th.alive:
                    continue
                # Rewind the clock to the event's instant (TimedT.hs:247).
                self._time = entry[_TIME]
                # Deliver a pending async exception (TimedT.hs:252-257).
                exc = self._pending_exc.pop(th.tid, None)
                self._step(th, entry[_VALUE], exc, main_result, main_error)
            # Queue drained. Parked survivors can never be woken again —
            # deliver DeadlockError into each (≙ GHC's
            # BlockedIndefinitelyOnMVar; handlers/finally still run) and
            # keep looping until true quiescence. At most one delivery
            # per thread: a handler that catches the error and parks
            # again would otherwise be re-woken forever at frozen
            # virtual time (GHC spins the same way, once per GC; we
            # terminate instead).
            parked = [th for th in self._threads.values()
                      if th.alive and th.parked
                      and th.tid not in deadlock_served]
            if not parked:
                break
            for th in parked:
                deadlock_served.add(th.tid)
                th.parked = False
                self._push(th, self._time, None)
                self._pending_exc.setdefault(th.tid, DeadlockError(
                    f"thread {th.tid} parked with no runnable events "
                    "left — blocked indefinitely"))

        if main_error:
            raise main_error[0]
        return main_result[0] if main_result else None

    # -- scheduling ------------------------------------------------------

    def _next_tid(self) -> PureThreadId:
        tid = PureThreadId(self._tid_counter)
        self._tid_counter += 1
        return tid

    def _spawn(self, program_fn: ProgramFn, log_name: str, *,
               is_main: bool) -> _Thread:
        th = _Thread(tid=self._next_tid(), gen=None, program=program_fn,
                     is_main=is_main, log_name=log_name)
        self._threads[th.tid] = th
        return th

    def _push(self, th: _Thread, time: Microsecond, value: Any) -> None:
        entry = [time, self._seq, th.tid, value, False]
        self._seq += 1
        th.resume_entry = entry
        heapq.heappush(self._queue, entry)

    # -- effect handling -------------------------------------------------

    def _step(self, th: _Thread, value: Any, exc: Optional[BaseException],
              main_result: list, main_error: list) -> None:
        """Drive one thread from its resume point to its next suspension."""
        if not th.started:
            th.started = True
            prog_fn, th.program = th.program, None
            assert prog_fn is not None
            if exc is not None:
                # Exception delivered before the body ran: no user handler
                # can be installed yet, so the thread dies immediately
                # (matches the top-level-catch placement, TimedT.hs:332-338).
                self._finish(th, exc, main_result, main_error)
                return
            try:
                g = prog_fn()  # create the frame lazily
            except BaseException as e:  # noqa: BLE001
                self._finish(th, e, main_result, main_error)
                return
            if not hasattr(g, "send"):
                # A yield-free program is a plain function: it already ran
                # to completion at frame-creation time.
                self._finish(th, None, main_result, main_error, result=g)
                return
            th.gen = g
        gen = th.gen
        assert gen is not None
        try:
            while True:
                if exc is not None:
                    e, exc, value = exc, None, None
                    eff = gen.throw(e)
                else:
                    eff, value = gen.send(value), None

                if type(eff) is Wait:
                    # ≙ wait: capture continuation, enqueue at
                    # max(now, spec(now)) (TimedT.hs:343-355).
                    self._push(th, resolve(eff.spec, self._time), None)
                    return
                elif type(eff) is GetTime:
                    value = self._time  # ≙ virtualTime (TimedT.hs:322)
                elif type(eff) is MyTid:
                    value = th.tid
                elif type(eff) is Fork or type(eff) is ForkSlave:
                    # ≙ fork (TimedT.hs:326-342): child enqueued at `now`
                    # (inheriting the logger name), parent yields 1 µs and
                    # then receives the child tid. ForkSlave additionally
                    # links the lifetimes (core/effects.py ForkSlave).
                    child = self._spawn(eff.program, th.log_name,
                                        is_main=False)
                    if type(eff) is ForkSlave:
                        child.master = th.tid
                        if th.slaves is None:
                            th.slaves = []
                        th.slaves.append(child.tid)
                    self._push(child, self._time, None)
                    self._push(th, self._time + 1, child.tid)
                    return
                elif type(eff) is ThrowTo:
                    self._throw_to(eff.tid, eff.exc)
                elif type(eff) is GetLogName:
                    value = th.log_name
                elif type(eff) is SetLogName:
                    th.log_name = eff.name
                elif type(eff) is Park:
                    if th.park_token is not _NO_TOKEN:
                        # pending token: consume, continue instantly
                        value, th.park_token = th.park_token, _NO_TOKEN
                    else:
                        th.parked = True
                        return  # no queue entry until unparked/thrown-to
                elif type(eff) is Unpark:
                    self._unpark(eff.tid, eff.value)
                elif type(eff) is AwaitIO:
                    # thrown *into* the program (catchable), not out of
                    # the interpreter
                    exc = TimedError(
                        "AwaitIO (real host IO) has no meaning under pure "
                        "emulation; use the real-IO interpreter or the "
                        "emulated transport")
                else:
                    raise TypeError(f"unknown effect: {eff!r}")
        except StopIteration as stop:
            self._finish(th, None, main_result, main_error,
                         result=stop.value)
        except BaseException as e:  # noqa: BLE001 — interpreter boundary
            self._finish(th, e, main_result, main_error)

    def _unpark(self, tid: PureThreadId, value: Any) -> None:
        th = self._threads.get(tid)
        if th is None or not th.alive:
            return
        if th.parked:
            th.parked = False
            self._push(th, self._time, value)
        else:
            th.park_token = value  # consumed by the next Park

    def _throw_to(self, tid: PureThreadId, exc: BaseException) -> None:
        """≙ throwTo (TimedT.hs:357-368): wake the target to `now`, then
        store the exception — first thrower wins (TimedT.hs:359)."""
        th = self._threads.get(tid)
        if th is None or not th.alive:
            return
        if th.parked:
            th.parked = False
            self._push(th, self._time, None)
        elif (th.resume_entry is not None
              and th.resume_entry[_TIME] > self._time):
            th.resume_entry[_CANCELLED] = True
            self._push(th, self._time, th.resume_entry[_VALUE])
        self._pending_exc.setdefault(tid, exc)

    def _finish(self, th: _Thread, exc: Optional[BaseException],
                main_result: list, main_error: list, *,
                result: Any = None) -> None:
        th.alive = False
        th.gen = None
        self._pending_exc.pop(th.tid, None)
        # evict: memory stays O(live threads), not O(total forks);
        # _throw_to treats a missing tid exactly like a dead one
        self._threads.pop(th.tid, None)
        # ForkSlave contract: a terminating master kills its live slaves
        # (in creation order — deterministic event seq); their own
        # _finish cascades through slave subtrees. A finishing slave
        # prunes itself from its master's list first, keeping the list
        # O(live slaves) — the O(live threads) memory invariant above.
        if th.master is not None:
            master = self._threads.get(th.master)
            if master is not None and master.slaves:
                try:
                    master.slaves.remove(th.tid)
                except ValueError:
                    pass
        if th.slaves:
            for stid in th.slaves:
                self._throw_to(stid, ThreadKilled())
        if th.is_main:
            if exc is not None:
                main_error.append(exc)
            else:
                main_result.append(result)
        elif exc is not None:
            # ForkSlave contract: a slave's uncaught exception (other
            # than ThreadKilled) is forwarded to its master instead of
            # logged-and-dropped (≙ slave-thread's exception redirect).
            if (th.master is not None
                    and not isinstance(exc, ThreadKilled)
                    and th.master in self._threads):
                self._throw_to(th.master, exc)
            else:
                log_thread_death(_log, th.log_name, exc)


def run_emulation(program_fn: ProgramFn, **kw: Any) -> Any:
    """One-shot convenience ≙ ``runTimedT`` (TimedT.hs:293-304)."""
    return PureEmulation(**kw).run(program_fn)

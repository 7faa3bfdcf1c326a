"""Real wall-clock interpreter over asyncio — the framework's "IO mode"
(the port's copy of ``timewarp_tpu/interp/aio/timed.py``).

TPU-native re-design of the reference's ``TimedIO``
(`/root/reference/src/Control/TimeWarp/Timed/TimedIO.hs`): the *same*
generator programs that run under the pure emulator
(:class:`timewarp_tpu_torch.interp.ref.des.PureEmulation`) run here against
real time — ``virtualTime = now − origin`` (TimedIO.hs:60), ``wait`` is
a real sleep (:64-66), ``fork`` a real concurrent task (:68),
``throwTo`` delivers a real async exception (:72).

Where the reference maps onto GHC's runtime threads, we map onto
asyncio: one task per timed thread, with the interpreter driving the
program generator and translating effects. The reference's semantics
are kept:

- **Interruption only at suspension points.** GHC delivers async
  exceptions at safe points; our unit of uninterruptible execution is
  the straight-line code between two ``yield``\\ s, exactly as in the
  pure emulator (TimedT.hs:324-325) — so programs are interrupt-safe in
  the same places under both interpreters.
- **First thrower wins** when exceptions race to one thread
  (TimedT.hs:359).
- **Forked failures don't kill the scenario**: uncaught exceptions in
  child threads are logged — ``ThreadKilled`` at DEBUG, others at
  WARNING (TimedT.hs:153-158, 306-316) — never propagated to main.
- **Main return ends the run**: like ``runTimedIO`` returning while
  daemon threads still run, ``run`` cancels all surviving threads once
  the main program finishes (GHC kills daemons at process exit; we do
  it at scenario exit so runs compose inside one process).

Beyond the reference, this interpreter honors the :class:`AwaitIO`
effect — awaiting an arbitrary asyncio awaitable with throw-to
cancellation — which is what the real TCP transport layer is built on.
"""

from __future__ import annotations

import asyncio
import logging
import time as _time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ...core.effects import (AwaitIO, Fork, ForkSlave, GetLogName, GetTime,
                             MyTid, Park, ProgramFn, SetLogName, ThrowTo,
                             Unpark, Wait)
from ...core.errors import ThreadKilled
from ...core.time import Microsecond, resolve
from ..common import NO_TOKEN as _NO_TOKEN
from ..common import log_thread_death

__all__ = ["RealTime", "AioThreadId", "run_real_time"]

_log = logging.getLogger("timewarp.realtime")


@dataclass(frozen=True)
class AioThreadId:
    """Thread id under the real-IO interpreter (≙ ``ThreadId TimedIO`` =
    a GHC ThreadId, TimedIO.hs:50)."""
    n: int

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"AioThreadId({self.n})"


@dataclass
class _Thread:
    tid: AioThreadId
    log_name: str
    task: Optional["asyncio.Task"] = None
    #: set while the thread sits at an interruptible suspension
    wake: Optional["asyncio.Future"] = None
    pending_exc: Optional[BaseException] = None
    park_token: Any = _NO_TOKEN
    parked: bool = False
    done: "asyncio.Event" = field(default_factory=asyncio.Event)
    #: linked-lifetime bookkeeping (ForkSlave): slaves killed when this
    #: thread terminates; master receives forwarded uncaught exceptions
    slaves: Optional[List["AioThreadId"]] = None
    master: Optional["AioThreadId"] = None


class RealTime:
    """Real wall-clock interpreter (≙ ``runTimedIO``, TimedIO.hs:81-85).

    ``run(program_fn)`` blocks until the main program returns, then
    cancels surviving forked threads. ``run_async`` is the same as a
    coroutine, for embedding in an existing event loop.
    """

    def __init__(self, *, default_log_name: str = "real") -> None:
        self._default_log_name = default_log_name
        self._origin: float = 0.0
        self._threads: Dict[AioThreadId, _Thread] = {}
        self._tid_counter = 0

    # -- clock -----------------------------------------------------------

    @property
    def virtual_time(self) -> Microsecond:
        """µs since ``run`` started (≙ TimedIO.hs:60, 84-85)."""
        return int((_time.monotonic() - self._origin) * 1_000_000)

    # -- public ----------------------------------------------------------

    def run(self, program_fn: ProgramFn) -> Any:
        return asyncio.run(self.run_async(program_fn))

    async def run_async(self, program_fn: ProgramFn) -> Any:
        # stamp the origin (≙ curTime in runTimedIO, TimedIO.hs:84-85)
        self._origin = _time.monotonic()
        self._threads = {}
        self._tid_counter = 0
        main = self._spawn(program_fn, self._default_log_name)
        try:
            return await main.task
        finally:
            await self._cancel_survivors(except_tid=main.tid)

    async def _cancel_survivors(self, except_tid: AioThreadId) -> None:
        live = [t for t in self._threads.values()
                if t.tid != except_tid and t.task is not None
                and not t.task.done()]
        for t in live:
            t.task.cancel()
        for t in live:
            try:
                await t.task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass

    # -- thread machinery ------------------------------------------------

    def _spawn(self, program_fn: ProgramFn, log_name: str) -> _Thread:
        tid = AioThreadId(self._tid_counter)
        self._tid_counter += 1
        th = _Thread(tid=tid, log_name=log_name)
        self._threads[tid] = th
        th.task = asyncio.ensure_future(self._drive(th, program_fn))
        return th

    def _pop_exc(self, th: _Thread) -> Optional[BaseException]:
        exc, th.pending_exc = th.pending_exc, None
        return exc

    async def _drive(self, th: _Thread, program_fn: ProgramFn) -> Any:
        is_main = th.tid.n == 0
        try:
            result = await self._run_program(th, program_fn)
            return result
        except asyncio.CancelledError:
            raise
        except BaseException as e:  # noqa: BLE001 — interpreter boundary
            if is_main:
                raise
            # ForkSlave contract: forward a slave's uncaught exception
            # (other than ThreadKilled) to its master (core/effects.py)
            if (th.master is not None
                    and not isinstance(e, ThreadKilled)
                    and th.master in self._threads):
                self._throw_to(th.master, e)
            else:
                log_thread_death(_log, th.log_name, e)
            return None
        finally:
            th.done.set()
            self._threads.pop(th.tid, None)
            # ForkSlave contract: a terminating slave prunes itself from
            # its master's list (keeps the list O(live slaves)); a
            # terminating master kills its live slaves, cascading
            # through slave subtrees via their own _drive finallys
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

    async def _run_program(self, th: _Thread, program_fn: ProgramFn) -> Any:
        # Pre-start throw_to parity with the emulator (des.py _step): an
        # exception stored before the body first runs kills the thread
        # without creating the frame — no user handler exists yet.
        if th.pending_exc is not None:
            raise self._pop_exc(th)
        gen = program_fn()
        if not hasattr(gen, "send"):
            return gen  # yield-free program: already ran at call time
        try:
            return await self._drive_gen(th, gen)
        finally:
            # Runs the program's finally blocks even when the *task* is
            # cancelled out of a suspension point (e.g. scenario-exit
            # survivor cleanup) — GeneratorExit at the yield, exactly
            # like GHC killing a thread blocked in threadDelay. Cleanup
            # code may still yield *instantaneous* effects (Unpark to
            # release waiters, ThrowTo, time/tid reads); a suspension
            # during cleanup aborts it.
            self._close_gen(th, gen)

    _INSTANT = (GetTime, MyTid, GetLogName, SetLogName, Unpark, ThrowTo)

    def _close_gen(self, th: _Thread, gen: Any) -> None:
        try:
            eff = gen.throw(GeneratorExit)
        except (StopIteration, GeneratorExit):
            return
        while True:
            if type(eff) in self._INSTANT:
                value: Any = None
                if type(eff) is GetTime:
                    value = self.virtual_time
                elif type(eff) is MyTid:
                    value = th.tid
                elif type(eff) is GetLogName:
                    value = th.log_name
                elif type(eff) is SetLogName:
                    th.log_name = eff.name
                elif type(eff) is Unpark:
                    self._unpark(eff.tid, eff.value)
                elif type(eff) is ThrowTo:
                    self._throw_to(eff.tid, eff.exc)
                try:
                    eff = gen.send(value)
                except (StopIteration, GeneratorExit):
                    return
            else:
                # tried to suspend during cleanup: hard stop. Close an
                # abandoned AwaitIO coroutine so it neither warns nor
                # holds resources.
                if type(eff) is AwaitIO and hasattr(eff.awaitable,
                                                    "close"):
                    eff.awaitable.close()
                gen.close()
                return

    async def _drive_gen(self, th: _Thread, gen: Any) -> Any:
        value: Any = None
        exc: Optional[BaseException] = None
        while True:
            try:
                if exc is not None:
                    e, exc, value = exc, None, None
                    eff = gen.throw(e)
                else:
                    eff, value = gen.send(value), None
            except StopIteration as stop:
                return stop.value

            if type(eff) is Wait:
                target = resolve(eff.spec, self.virtual_time)
                exc = await self._sleep_until(th, target)
            elif type(eff) is GetTime:
                value = self.virtual_time
            elif type(eff) is MyTid:
                value = th.tid
            elif type(eff) is Fork or type(eff) is ForkSlave:
                child = self._spawn(eff.program, th.log_name)
                if type(eff) is ForkSlave:
                    child.master = th.tid
                    if th.slaves is None:
                        th.slaves = []
                    th.slaves.append(child.tid)
                # forkIO-handoff parity with the emulator (des.py Fork:
                # child enqueued at `now`, parent resumes at now+1, so
                # the child reaches its first suspension first): yield
                # the loop once so the child task runs to its first
                # await. Fork is thereby a suspension point, and a
                # stored async exception is deliverable here — exactly
                # where the emulator's parent-resume event delivers it.
                await asyncio.sleep(0)
                exc = self._pop_exc(th)
                value = child.tid
            elif type(eff) is ThrowTo:
                # self-throw parity with the emulator: the exception is
                # *stored* and delivered at the next suspension point
                # (core/effects.py ThrowTo docstring)
                self._throw_to(eff.tid, eff.exc)
            elif type(eff) is GetLogName:
                value = th.log_name
            elif type(eff) is SetLogName:
                th.log_name = eff.name
            elif type(eff) is Park:
                if th.park_token is not _NO_TOKEN:
                    value, th.park_token = th.park_token, _NO_TOKEN
                else:
                    value, exc = await self._park(th)
            elif type(eff) is Unpark:
                self._unpark(eff.tid, eff.value)
            elif type(eff) is AwaitIO:
                value, exc = await self._await_io(th, eff.awaitable)
            else:
                raise TypeError(f"unknown effect: {eff!r}")

    # -- suspension points -----------------------------------------------

    def _make_wake(self, th: _Thread) -> "asyncio.Future":
        assert th.wake is None, "thread suspended twice"
        th.wake = asyncio.get_running_loop().create_future()
        return th.wake

    async def _sleep_until(self, th: _Thread,
                           target: Microsecond) -> Optional[BaseException]:
        """Interruptible sleep (≙ ``wait``→``threadDelay``, TimedIO.hs:64-66;
        interruption ≙ GHC async exception delivery)."""
        if th.pending_exc:  # stored self-throw: deliver at this point
            return self._pop_exc(th)
        wake = self._make_wake(th)
        try:
            delay = max(target - self.virtual_time, 0) / 1_000_000
            await asyncio.wait_for(asyncio.shield(wake), timeout=delay)
        except asyncio.TimeoutError:
            pass  # timer fired normally
        finally:
            th.wake = None
        return self._pop_exc(th)

    async def _park(self, th: _Thread):
        if th.pending_exc:
            return None, self._pop_exc(th)
        wake = self._make_wake(th)
        th.parked = True
        try:
            value = await wake
        finally:
            th.parked = False
            th.wake = None
        return value, self._pop_exc(th)

    async def _await_io(self, th: _Thread, awaitable: Any):
        """Await real IO; a throw_to cancels the awaitable and delivers
        the exception here (the AwaitIO cancellation contract)."""
        if th.pending_exc:
            return None, self._pop_exc(th)
        fut = asyncio.ensure_future(awaitable)
        wake = self._make_wake(th)
        try:
            await asyncio.wait({fut, wake},
                               return_when=asyncio.FIRST_COMPLETED)
        except BaseException:
            # Outer cancellation (task killed mid-await): don't leak the
            # inner future — cancel it, reap it, then re-raise so
            # _run_program's finally closes the program.
            fut.cancel()
            try:
                await fut
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            raise
        finally:
            th.wake = None
            if not wake.done():
                wake.cancel()
        if th.pending_exc is not None:
            fut.cancel()
            try:
                await fut
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            return None, self._pop_exc(th)
        try:
            return fut.result(), None
        except BaseException as e:  # noqa: BLE001 — surface in program
            return None, e

    # -- cross-thread signals --------------------------------------------

    def _throw_to(self, tid: AioThreadId, exc: BaseException) -> None:
        """≙ throwTo → Control.Exception.throwTo (TimedIO.hs:72), with
        the emulator's first-thrower-wins contract (TimedT.hs:359)."""
        th = self._threads.get(tid)
        if th is None:
            return
        if th.pending_exc is None:
            th.pending_exc = exc
        if th.wake is not None and not th.wake.done():
            th.wake.set_result(None)

    def _unpark(self, tid: AioThreadId, value: Any) -> None:
        th = self._threads.get(tid)
        if th is None:
            return
        if th.parked and th.wake is not None and not th.wake.done():
            th.wake.set_result(value)
        else:
            th.park_token = value


def run_real_time(program_fn: ProgramFn, **kw: Any) -> Any:
    """One-shot convenience ≙ ``runTimedIO`` (TimedIO.hs:81-82)."""
    return RealTime(**kw).run(program_fn)

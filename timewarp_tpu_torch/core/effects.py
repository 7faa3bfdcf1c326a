"""The timed-program effect interface
(the port's copy of ``timewarp_tpu/core/effects.py``).

This is the TPU-native re-design of the reference's ``MonadTimed``
typeclass (`/root/reference/src/Control/TimeWarp/Timed/MonadTimed.hs:107-141`).
Instead of a monad transformer stack, a *timed program* is a Python
generator that ``yield``s effect objects and receives results back; the
same program text runs under any interpreter:

- :class:`timewarp_tpu_torch.interp.ref.des.PureEmulation` — deterministic
  discrete-event emulation (≙ ``TimedT``); ``wait`` costs zero wall-clock.
- :class:`timewarp_tpu_torch.interp.aio.timed.RealTime` — real wall-clock over
  asyncio (≙ ``TimedIO``).

Sub-programs compose with ``yield from`` (which is what the reference's
``do``-notation bought it), and *exception handling is plain Python
``try/except``* — the interpreter delivers async exceptions by throwing
into the generator at its suspension point, which makes handler scoping
across waits (the reference's hardest machinery, TimedT.hs:183-204,
259-284) fall out of the language for free.

Effect vocabulary ≙ the class methods at MonadTimed.hs:107-141:

=============  =====================================================
``Wait``       ``wait`` (:125)
``Fork``       ``fork`` (:128) — returns the new ThreadId
``GetTime``    ``virtualTime``/``currentTime`` (:109-112)
``MyTid``      ``myThreadId`` (:131)
``ThrowTo``    ``throwTo`` (:134)
=============  =====================================================

Derived combinators (schedule/invoke/work/kill_thread/start_timer/
timeout) mirror MonadTimed.hs:162-206, 315-318 and TimedT.hs:370-376.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Generator, Union

from .errors import ThreadKilled, TimeoutExpired
from .time import Microsecond, RelativeToNow, after, mcs, till

#: A timed program: a generator yielding effects.
Program = Generator["Effect", Any, Any]
#: A zero-arg factory producing a timed program (used by Fork so the
#: child's frame is created inside the interpreter).
ProgramFn = Callable[[], Program]


class Effect:
    """Base class of all yieldable effects."""
    __slots__ = ()


@dataclass(frozen=True)
class Wait(Effect):
    """Suspend until the time spec fires (≙ ``wait``, MonadTimed.hs:125).

    ``spec`` is a :data:`RelativeToNow` or a bare relative duration in µs.
    Target time clamps to ``max(now, spec(now))`` (TimedT.hs:349).
    """
    spec: Union[RelativeToNow, Microsecond]


@dataclass(frozen=True)
class Fork(Effect):
    """Start a new thread running ``program()`` (≙ ``fork``, MonadTimed.hs:128).

    Yields back the child's ThreadId. Reference semantics preserved
    (TimedT.hs:326-342): the child is enqueued at the current instant and
    the parent *yields for 1 µs* (emulating the forkIO handoff), so the
    child runs first. Uncaught child exceptions are logged, not
    propagated (TimedT.hs:153-158, 306-316).
    """
    program: ProgramFn


@dataclass(frozen=True)
class ForkSlave(Effect):
    """Start a *linked* child thread (≙ ``forkSlave``,
    MonadTimed.hs:140-141, bound to the slave-thread library in real
    mode, TimedIO.hs:78; the reference's emulator leaves it
    ``undefined`` — TimedT.hs:377 — this framework implements it under
    BOTH interpreters). Handoff semantics are :class:`Fork`'s; the
    linked lifetime adds:

    - when the parent terminates (returns *or* dies), every live slave
      receives ``ThreadKilled`` at its next suspension point — and a
      dying slave kills its own slaves, so whole slave subtrees unwind;
    - an uncaught exception in a slave (other than ``ThreadKilled``) is
      *forwarded to the parent* as an async exception instead of being
      logged-and-dropped like a plain fork's.
    """
    program: ProgramFn


@dataclass(frozen=True)
class GetTime(Effect):
    """Yields back the current virtual time in µs (≙ ``virtualTime``)."""


@dataclass(frozen=True)
class MyTid(Effect):
    """Yields back the current thread id (≙ ``myThreadId``)."""


@dataclass(frozen=True)
class GetLogName(Effect):
    """Yields back this thread's hierarchical logger name (≙
    ``getLoggerName`` of the ``HasLoggerName`` instance, TimedT.hs:171-174).
    Children inherit the name at fork time (TimedT.hs:331-338)."""


@dataclass(frozen=True)
class SetLogName(Effect):
    """Replace this thread's logger name for the rest of its life (the
    scoped form is :func:`modify_log_name`)."""
    name: str


@dataclass(frozen=True)
class ThrowTo(Effect):
    """Raise ``exc`` inside thread ``tid`` (≙ ``throwTo``, MonadTimed.hs:134).

    Reference delivery contract (TimedT.hs:357-368): the target is woken
    — its pending resume event is pulled to *now* — and the exception is
    raised at that resume point. If several exceptions race to one
    thread, the first one wins (TimedT.hs:359 keeps the existing entry).
    A thread may only be interrupted at a suspension point; straight-line
    code between waits is uninterruptible (TimedT.hs:324-325).

    Self-throw contract (also inherited from the reference): throwing at
    the *currently running* thread stores the exception but cannot wake
    a resume event that does not exist yet — it is delivered when the
    thread's next suspension fires (at that suspension's own time), and
    silently evaporates if the thread finishes without suspending again.
    """
    tid: Any
    exc: BaseException


@dataclass(frozen=True)
class Park(Effect):
    """Suspend this thread until some other thread :class:`Unpark`\\ s it;
    yields back the value the unparker sent.

    This effect pair plays the role STM plays under the reference (its
    JobCurator blocks on ``TVar`` retries, Job.hs:48-49, 158-161; its
    Transfer blocks on ``TBMChan``, Transfer.hs:236-242): the one
    blocking primitive from which MVar/Channel/Flag are built
    (:mod:`timewarp_tpu_torch.manage.sync`). If an unpark token is already
    pending, ``Park`` consumes it and continues immediately — no virtual
    time passes — so the park/unpark race is benign.
    """


@dataclass(frozen=True)
class Unpark(Effect):
    """Wake a :class:`Park`\\ ed thread ``tid`` at the current instant,
    sending it ``value``. If the target is not parked, the value is
    stored as a token consumed by its next ``Park`` (last token wins).
    No-op on dead/unknown threads."""
    tid: Any
    value: Any = None


@dataclass(frozen=True)
class AwaitIO(Effect):
    """Await a real awaitable (coroutine/future) — **real-IO interpreter
    only**; the pure emulator rejects it, because arbitrary host IO has
    no deterministic virtual-time meaning. The TCP transport layer is
    built on this; the emulated transport uses only timed effects and
    therefore runs under both interpreters.

    Cancellation contract: if the thread receives an async exception
    (``throw_to``) while awaiting, the awaitable is cancelled and the
    exception is raised at this yield point.
    """
    awaitable: Any


# ----------------------------------------------------------------------
# Derived combinators (generator helpers)
# ----------------------------------------------------------------------

def wait(spec: Union[RelativeToNow, Microsecond]) -> Program:
    """``yield from wait(for_(sec(1)))``."""
    yield Wait(spec)


def virtual_time() -> Program:
    """Returns current virtual time."""
    return (yield GetTime())


def my_thread_id() -> Program:
    return (yield MyTid())


def fork(program: ProgramFn) -> Program:
    """Fork; returns child ThreadId."""
    return (yield Fork(program))


def park() -> Program:
    """Suspend until unparked; returns the unparker's value."""
    return (yield Park())


def unpark(tid: Any, value: Any = None) -> Program:
    yield Unpark(tid, value)


def await_io(awaitable: Any) -> Program:
    """Await real IO (real-IO interpreter only); returns its result."""
    # the combinator's definition site — the pure-context lint (TW302)
    # applies to *uses*, not to this wrapper
    return (yield AwaitIO(awaitable))  # tw-lint: ignore[TW302]


def fork_(program: ProgramFn) -> Program:
    """``fork`` discarding the tid (≙ ``fork_``, MonadTimed.hs:194-195)."""
    yield Fork(program)


def fork_slave(program: ProgramFn) -> Program:
    """Fork a linked (slave) thread; returns the child ThreadId
    (≙ ``forkSlave``, MonadTimed.hs:141)."""
    return (yield ForkSlave(program))


def invoke(spec: Union[RelativeToNow, Microsecond], program: ProgramFn) -> Program:
    """Wait, then run ``program`` in *this* thread; returns its result
    (≙ ``invoke time action = wait time >> action``, MonadTimed.hs:182-183)."""
    yield Wait(spec)
    return (yield from program())


def schedule(spec: Union[RelativeToNow, Microsecond], program: ProgramFn) -> Program:
    """Run ``program`` at a future instant in a *new* thread
    (≙ ``schedule time action = fork_ $ invoke time action``,
    MonadTimed.hs:162-163)."""
    yield Fork(lambda: invoke(spec, program))


def kill_thread(tid: Any) -> Program:
    """≙ ``killThread = flip throwTo ThreadKilled`` (MonadTimed.hs:204-206)."""
    yield ThrowTo(tid, ThreadKilled())


def work(spec: Union[RelativeToNow, Microsecond], program: ProgramFn) -> Program:
    """Run ``program`` in a thread and kill it when the spec fires
    (≙ ``work``, MonadTimed.hs:201-202)."""
    tid = yield Fork(program)
    yield from schedule(spec, lambda: kill_thread(tid))


def start_timer() -> Program:
    """Returns a program measuring time since this call
    (≙ ``startTimer``, MonadTimed.hs:315-318)."""
    start = yield GetTime()

    def elapsed() -> Program:
        cur = yield GetTime()
        return cur - start

    return elapsed


def timeout(t: Microsecond, program: ProgramFn) -> Program:
    """Run ``program``; raise :class:`TimeoutExpired` in this thread if it
    overruns ``t`` µs.

    Same construction as the reference (TimedT.hs:370-376): schedule a
    killer thread that checks a done-flag and, when unset, ``throwTo``s
    the parent; the body runs under ``finally done=True``. The deadline
    is measured from where the *body* starts (one µs after this call,
    because of the fork handoff), and is inclusive: a body that finishes
    exactly at the deadline is timed out.
    """
    pid = yield MyTid()
    start = yield GetTime()
    done = [False]

    def killer() -> Program:
        # till(start + 1 + t): anchor the deadline to the body's actual
        # start instant so the fork handoff doesn't shave a µs off ``t``.
        yield Wait(till(start + 1 + int(t)))
        if not done[0]:
            yield ThrowTo(pid, TimeoutExpired("Timeout exceeded"))

    yield Fork(killer)
    try:
        return (yield from program())
    finally:
        done[0] = True


def modify_log_name(suffix: str, program: ProgramFn) -> Program:
    """Run ``program`` with ``suffix`` appended to the hierarchical logger
    name, restoring it afterwards (≙ ``modifyLoggerName (<> suffix)``,
    used throughout the reference examples, e.g. token-ring Main.hs:109-116)."""
    old = yield GetLogName()
    yield SetLogName(f"{old}.{suffix}" if old else suffix)
    try:
        return (yield from program())
    finally:
        yield SetLogName(old)


def sleep_forever() -> Program:
    """Sleep until killed (≙ ``sleepForever``, Misc.hs:50-51 — the
    reference loops 100500-minute waits; we loop long waits the same way)."""
    while True:
        yield Wait(after(mcs(100500 * 60_000_000)))


def repeat_forever(period: Microsecond,
                   handler: Callable[[BaseException], Microsecond],
                   program: ProgramFn) -> Program:
    """Run ``program`` every ``period`` µs; on failure ask ``handler`` for
    the retry delay (≙ ``repeatForever``, Misc.hs:21-45).

    The reference polls a TVar with the next-start time every 10 ms; the
    rewrite keeps the observable contract (action at start of each
    period, handler-controlled backoff) without the polling loop.
    """
    while True:
        start = yield GetTime()
        try:
            yield from program()
            nxt = start + int(period)
        except ThreadKilled:
            raise
        except BaseException as e:  # noqa: BLE001 — mirrors catchAll
            nxt = (yield GetTime()) + int(handler(e))
        cur = yield GetTime()
        if nxt > cur:
            yield Wait(nxt - cur)

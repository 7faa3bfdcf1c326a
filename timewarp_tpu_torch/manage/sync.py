"""Blocking synchronization primitives over the timed effect API
(the port's copy of ``timewarp_tpu/manage/sync.py``).

The reference gets blocking coordination from STM — ``TVar`` retries in
the job manager (`/root/reference/src/Control/TimeWarp/Manager/Job.hs:48-49,
158-161`), bounded ``TBMChan`` queues in the transport
(`/root/reference/src/Control/TimeWarp/Rpc/Transfer.hs:236-242`). The
TPU build has no STM; it has the :class:`~timewarp_tpu_torch.core.effects.Park`
/ :class:`~timewarp_tpu_torch.core.effects.Unpark` effect pair, from which the
same vocabulary is built here — and because these are *effects*, every
primitive works identically under the pure emulator (deterministically)
and the real asyncio interpreter.

Robustness model: wake-ups are advisory ("state changed, re-check") and
waiters re-check conditions in a loop, so spurious unparks — e.g. a
token left by a wake that raced with an async exception — are harmless,
and there are no lost wake-ups. State mutation between yields is atomic
under both interpreters (single host thread / single event loop).

Vocabulary:

- :class:`Flag` — one-shot broadcast event (≙ the closed ``TVar`` in
  JobCurator, Job.hs:69-71).
- :class:`MVar` — one-slot synchronized cell (≙
  ``Control.Concurrent.MVar`` used by the reference examples, e.g.
  ping-pong's implicit coordination).
- :class:`Channel` — bounded, closeable FIFO (≙ ``TBMChan``,
  Transfer.hs:236-242): ``get`` on a closed+drained channel returns
  :data:`CLOSED`; ``put`` on a closed channel returns ``False``
  (the reference warns and drops, Transfer.hs:281-288).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Deque, List

from ..core.effects import MyTid, Park, Program, Unpark

__all__ = ["Flag", "MVar", "Channel", "CLOSED", "wait_until"]


class _Waitable:
    """Shared waiter-set machinery: park in ``_await_change``, wake all
    in ``_notify`` (advisory; waiters re-check)."""

    def __init__(self) -> None:
        self._waiters: Deque[Any] = deque()

    def _await_change(self) -> Program:
        tid = yield MyTid()
        self._waiters.append(tid)
        try:
            yield Park()
        finally:
            try:
                self._waiters.remove(tid)
            except ValueError:
                pass

    def _notify(self) -> Program:
        woken: List[Any] = list(self._waiters)
        for tid in woken:
            yield Unpark(tid, None)


class Flag(_Waitable):
    """One-shot broadcast event."""

    def __init__(self) -> None:
        super().__init__()
        self._set = False

    @property
    def is_set(self) -> bool:
        return self._set

    def set(self) -> Program:
        self._set = True
        yield from self._notify()

    def wait(self) -> Program:
        while not self._set:
            yield from self._await_change()


class MVar(_Waitable):
    """One-slot cell: ``take`` blocks while empty, ``put`` while full."""

    _EMPTY = object()

    def __init__(self) -> None:
        super().__init__()
        self._value: Any = MVar._EMPTY

    @property
    def is_empty(self) -> bool:
        return self._value is MVar._EMPTY

    def put(self, value: Any) -> Program:
        while self._value is not MVar._EMPTY:
            yield from self._await_change()
        self._value = value
        yield from self._notify()

    def take(self) -> Program:
        while self._value is MVar._EMPTY:
            yield from self._await_change()
        value, self._value = self._value, MVar._EMPTY
        yield from self._notify()
        return value

    def read(self) -> Program:
        """Blocking read without emptying."""
        while self._value is MVar._EMPTY:
            yield from self._await_change()
        return self._value


#: Returned by :meth:`Channel.get` once the channel is closed and drained
#: (≙ ``readTBMChan`` yielding ``Nothing``).
CLOSED = object()


class Channel(_Waitable):
    """Bounded, closeable FIFO (≙ ``TBMChan``, Transfer.hs:236-242)."""

    def __init__(self, capacity: int) -> None:
        super().__init__()
        assert capacity >= 1
        self._cap = capacity
        self._items: Deque[Any] = deque()
        self._closed = False

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def full(self) -> bool:
        return len(self._items) >= self._cap

    def __len__(self) -> int:
        return len(self._items)

    def put(self, item: Any) -> Program:
        """Blocking put. Returns True if enqueued, False if the channel
        is (or becomes, while blocked) closed."""
        while True:
            if self._closed:
                return False
            if len(self._items) < self._cap:
                self._items.append(item)
                yield from self._notify()
                return True
            yield from self._await_change()

    def try_put(self, item: Any) -> Program:
        """Non-blocking put: 'ok' | 'full' | 'closed' (≙ the
        ``tryWriteTBMChan`` three-way used at Transfer.hs:281-288)."""
        if self._closed:
            return "closed"
        if len(self._items) >= self._cap:
            return "full"
        self._items.append(item)
        yield from self._notify()
        return "ok"

    def get(self) -> Program:
        """Blocking get; :data:`CLOSED` once closed and drained."""
        while True:
            if self._items:
                item = self._items.popleft()
                yield from self._notify()
                return item
            if self._closed:
                return CLOSED
            yield from self._await_change()

    def unget(self, item: Any) -> Program:
        """Prepend ``item``, ignoring capacity (≙ ``unGetTBMChan`` — the
        transport's send worker pushes a chunk back on socket error,
        Transfer.hs:387-388)."""
        self._items.appendleft(item)
        yield from self._notify()

    def close(self) -> Program:
        """Close: pending items remain readable; blocked ops re-check
        (≙ ``closeTBMChan``)."""
        self._closed = True
        yield from self._notify()

    def drain(self) -> None:
        """Discard all pending items (≙ the ``clearInChan`` loop in
        ``sfClose``, Transfer.hs:328-330)."""
        self._items.clear()


def wait_until(pred: Callable[[], bool], *waitables: _Waitable) -> Program:
    """Block until ``pred()`` holds, re-checking whenever any of the
    ``waitables`` notifies — the analogue of an STM transaction retrying
    over several ``TVar``\\ s (e.g. ``sfSend`` blocks on "sent-notifier
    fired ∨ socket closed", Transfer.hs:266-271)."""
    while not pred():
        tid = yield MyTid()
        for w in waitables:
            w._waiters.append(tid)
        try:
            yield Park()
        finally:
            for w in waitables:
                try:
                    w._waiters.remove(tid)
                except ValueError:
                    pass

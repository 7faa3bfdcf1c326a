"""Virtual-time types and the time-specification DSL
(the port's copy of ``timewarp_tpu/core/time.py``).

TPU-native re-design of the reference's time layer
(`/root/reference/src/Control/TimeWarp/Timed/MonadTimed.hs:252-299`).

All virtual time is **int64 microseconds since origin** — never floats —
so the pure oracle, the JAX engine, and the real-IO interpreter agree
bit-for-bit (SURVEY.md §7 "hard parts" #2: fixed-point time).

A *time spec* (`RelativeToNow` in the reference, MonadTimed.hs:66) is a
function from the current virtual time to an absolute target time:

- ``for_(t)`` / ``after(t)``   -> now + t      (MonadTimed.hs:286-292)
- ``till(t)`` / ``at(t)``      -> t            (MonadTimed.hs:278-284)
- ``now``                      -> now          (MonadTimed.hs:298-299)

Unit helpers mirror MonadTimed.hs:253-266 but return plain ints.
"""

from __future__ import annotations

from typing import Callable, Union

# Type aliases -----------------------------------------------------------

#: Virtual time in microseconds since origin (int64 range).
Microsecond = int

#: A time spec: maps current virtual time -> absolute target time.
RelativeToNow = Callable[[Microsecond], Microsecond]

#: Anything accepted where a duration is expected.
Duration = Union[int, float]

#: Sentinel for "never" — far enough that sums never overflow int64.
FOREVER: Microsecond = (1 << 62) - 1


# Units ------------------------------------------------------------------
# MonadTimed.hs:253-258 (integral) and :261-266 (fractional, rounded).

def mcs(n: Duration) -> Microsecond:
    return int(round(n))


def ms(n: Duration) -> Microsecond:
    return int(round(n * 1_000))


def sec(n: Duration) -> Microsecond:
    return int(round(n * 1_000_000))


def minute(n: Duration) -> Microsecond:
    return int(round(n * 60_000_000))


def hour(n: Duration) -> Microsecond:
    return int(round(n * 3_600_000_000))


# Time specs -------------------------------------------------------------

def for_(t: Microsecond, *ts: Microsecond) -> RelativeToNow:
    """Relative spec: fire ``t + sum(ts)`` microseconds after now
    (MonadTimed.hs:286-290). Variadic like the reference's time
    accumulators (``for 1 minute 30 sec`` — MonadTimed.hs:351-376):
    ``for_(minute(1), sec(30))``. At least one duration is required —
    a zero-argument call is a bug, not a zero wait."""
    total = int(t) + sum(int(x) for x in ts)
    return lambda cur: cur + total


def after(t: Microsecond, *ts: Microsecond) -> RelativeToNow:
    """Synonym of :func:`for_`, reads better with schedule/invoke
    (MonadTimed.hs:291-292)."""
    return for_(t, *ts)


def till(t: Microsecond, *ts: Microsecond) -> RelativeToNow:
    """Absolute spec: fire at virtual time ``t + sum(ts)``
    (MonadTimed.hs:278-282; variadic accumulator like :func:`for_`)."""
    total = int(t) + sum(int(x) for x in ts)
    return lambda _cur: total


def at(t: Microsecond, *ts: Microsecond) -> RelativeToNow:
    """Synonym of :func:`till` (MonadTimed.hs:283-284)."""
    return till(t, *ts)


def now(cur: Microsecond) -> Microsecond:
    """The identity spec (MonadTimed.hs:298-299)."""
    return cur


def resolve(spec: Union[RelativeToNow, Microsecond], cur: Microsecond) -> Microsecond:
    """Resolve a spec (or a bare relative duration) against the clock,
    clamped to never travel back in time — the reference clamps with
    ``max cur (relativeToNow cur)`` (TimedT.hs:349)."""
    target = spec(cur) if callable(spec) else cur + int(spec)
    return max(cur, int(target))

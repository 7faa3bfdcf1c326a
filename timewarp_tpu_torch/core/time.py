"""Virtual-time units (port of ``timewarp_tpu/core/time.py``).

All virtual time is int64 microseconds since origin — never floats — so
the port, the JAX engine and the host oracle agree bit-for-bit.
"""

from __future__ import annotations

from typing import Union

#: Virtual time in microseconds since origin (int64 range).
Microsecond = int

#: Anything accepted where a duration is expected.
Duration = Union[int, float]

#: Sentinel for "never" — far enough that sums never overflow int64.
FOREVER: Microsecond = (1 << 62) - 1


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

"""Superstep trace container and the parity checker (port of
``timewarp_tpu/trace/events.py``).

A trace is one fixed-width record per superstep that fired:

  (time, fired_count, fired_hash, recv_count, recv_hash,
   sent_count, sent_hash, overflow_count)

with the hashes order-independent digests of every fired node,
delivered message and routed message (trace/hashing.py). Host-side
numpy, the same dtypes as the reference, so the two compare directly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

__all__ = ["SuperstepTrace", "TraceMismatch", "assert_traces_equal"]

_FIELDS = ("times", "fired_count", "fired_hash", "recv_count", "recv_hash",
           "sent_count", "sent_hash", "overflow")
_DTYPES = (np.int64, np.int32, np.uint32, np.int32, np.uint32,
           np.int32, np.uint32, np.int32)


@dataclass
class SuperstepTrace:
    """Columnar trace; one row per superstep that actually fired."""
    times: np.ndarray        # int64[S]
    fired_count: np.ndarray  # int32[S]
    fired_hash: np.ndarray   # uint32[S]
    recv_count: np.ndarray   # int32[S]
    recv_hash: np.ndarray    # uint32[S]
    sent_count: np.ndarray   # int32[S]
    sent_hash: np.ndarray    # uint32[S]
    overflow: np.ndarray     # int32[S]

    def __len__(self) -> int:
        return len(self.times)

    @staticmethod
    def from_columns(cols) -> "SuperstepTrace":
        """Build from eight equal-length integer columns in field order
        (hash columns may arrive as int64 words in ``[0, 2**32)``)."""
        return SuperstepTrace(*(np.asarray(c).astype(d)
                                for c, d in zip(cols, _DTYPES)))

    @staticmethod
    def from_rows(rows) -> "SuperstepTrace":
        """Build from a list of 8-tuples in field order."""
        cols = list(zip(*rows)) if rows else [[]] * 8
        return SuperstepTrace.from_columns(cols)

    def row(self, i: int) -> tuple:
        return tuple(int(getattr(self, f)[i]) for f in _FIELDS)


class TraceMismatch(AssertionError):
    """Raised by the parity checker with the first diverging superstep."""


def assert_traces_equal(a: SuperstepTrace, b: SuperstepTrace,
                        a_name: str = "a", b_name: str = "b",
                        limit: Optional[int] = None) -> None:
    """Bit-for-bit comparison, reporting the first divergence precisely."""
    n = min(len(a), len(b)) if limit is None else min(len(a), len(b), limit)
    for i in range(n):
        ra, rb = a.row(i), b.row(i)
        if ra != rb:
            diffs = ", ".join(f"{f}: {x} != {y}"
                              for f, x, y in zip(_FIELDS, ra, rb) if x != y)
            raise TraceMismatch(
                f"superstep {i} (t={ra[0]} vs {rb[0]}): {a_name} != {b_name}"
                f" — {diffs}")
    if limit is None and len(a) != len(b):
        raise TraceMismatch(
            f"trace lengths differ: {a_name}={len(a)} {b_name}={len(b)}"
            f" (first {n} supersteps agree)")

"""The speculation equivalence law's compare surface, made executable (the
port of ``timewarp_tpu/speculate/equiv.py``).

A committed speculative run and the conservative run of the same config
are **event-identical**: same firings at the same instants, same messages
with the same sampled delays and payloads, same final scenario state.
What legitimately differs is superstep *granularity* — a wide window
coalesces many conservative supersteps into one — so ``steps``/``time``
bookkeeping and the per-ROW trace shapes cannot be compared literally.
This module defines the canonical granularity-invariant surface both runs
must match **bit-for-bit**:

- the scenario-visible final state: every ``states`` leaf and ``wake``,
  hashed (sha256 over dtype/shape-framed bytes, framed as the reference
  frames its numpy leaves, so a port row and a reference row of the same
  state carry the same sha);
- every never-silent counter (overflow, bad_dst, bad_delay, short_delay,
  route_drop, fault_dropped) and ``delivered``;
- the trace aggregates: total fired/recv/sent counts and the uint32
  **sums** of the fired/recv/sent row hashes. The row hashes are
  themselves wrap-around uint32 sums of per-event ``mix32`` words keyed
  by absolute times (trace/hashing.py), so a wide superstep's row hash
  IS the sum of the conservative rows it coalesces — the aggregate is
  granularity-invariant by construction, and any event-level divergence
  (a reordered delivery, a different sampled delay, a changed payload)
  moves it.

The surface is defined at quiescence (both runs drained): a
budget-truncated speculative run has advanced *further in virtual time*
at the same superstep count, so mid-flight mailboxes legitimately differ.
docs/speculation.md states the law in full.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional

import numpy as np

__all__ = ["canonical_rows", "write_canon_csv", "assert_spec_equiv",
           "CANON_FIELDS"]

#: the compare surface, in file-column order
CANON_FIELDS = ("fired", "fired_hash", "recv", "recv_hash", "sent",
                "sent_hash", "overflow_rows", "delivered", "overflow",
                "bad_dst", "bad_delay", "short_delay", "route_drop",
                "fault_dropped", "state_sha")

_COUNTERS = ("delivered", "overflow", "bad_dst", "bad_delay",
             "short_delay", "route_drop", "fault_dropped")


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _state_sha(state, b: Optional[int], u32=()) -> str:
    """sha256 over the scenario-visible state: every ``states`` leaf
    (sorted by name) plus ``wake``, dtype/shape-framed so layout
    ambiguity cannot collide two different states. The leaves named in
    ``u32`` (a scenario's ``u32_states``: int64 words in the port, uint32
    in the reference) are framed as uint32."""
    h = hashlib.sha256()
    leaves = [(k, state.states[k]) for k in sorted(state.states)]
    for k, leaf in leaves + [(None, state.wake)]:
        a = _host(leaf)
        if k in u32:
            a = a.astype(np.uint32)
        if b is not None:
            a = a[b]
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def canonical_rows(state, trace, B: Optional[int] = None,
                   scenario=None) -> List[dict]:
    """One canonical-surface dict per world from a run's final state +
    trace (``B=None``: solo — ``trace`` is one SuperstepTrace; else
    ``trace`` is the per-world list every fleet driver returns).
    ``scenario`` names the ``u32_states`` to frame as uint32."""
    u32 = () if scenario is None else tuple(scenario.u32_states)
    traces = [trace] if B is None else list(trace)
    out = []
    for b, tr in enumerate(traces):
        wb = None if B is None else b
        agg = {"fired": 0, "fired_hash": 0, "recv": 0, "recv_hash": 0,
               "sent": 0, "sent_hash": 0, "overflow_rows": 0}
        for i in range(len(tr)):
            _, fired, fh, recv, rh, sent, sh, ovf = tr.row(i)
            agg["fired"] += int(fired)
            agg["recv"] += int(recv)
            agg["sent"] += int(sent)
            agg["overflow_rows"] += int(ovf)
            agg["fired_hash"] = (agg["fired_hash"] + int(fh)) & 0xFFFFFFFF
            agg["recv_hash"] = (agg["recv_hash"] + int(rh)) & 0xFFFFFFFF
            agg["sent_hash"] = (agg["sent_hash"] + int(sh)) & 0xFFFFFFFF
        row = {"world": b, **agg}
        for c in _COUNTERS:
            v = _host(getattr(state, c))
            row[c] = int(v if wb is None else v[wb])
        row["state_sha"] = _state_sha(state, wb, u32)
        out.append(row)
    return out


def write_canon_csv(path: str, rows: List[dict]) -> str:
    """The canonical surface as a byte-deterministic CSV, to ``cmp``
    between the conservative and the speculative run of one config."""
    import csv
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(("world",) + CANON_FIELDS)
        for r in rows:
            w.writerow([r["world"]] + [r[k] for k in CANON_FIELDS])
    return path


def assert_spec_equiv(a: List[dict], b: List[dict],
                      tag: str = "") -> None:
    """Bit-for-bit equality on the canonical surface — the speculation
    equivalence law as one reusable assertion. Raises naming the first
    differing world + field with both scalar values, one line, never an
    array dump."""
    suffix = f" ({tag})" if tag else ""
    if len(a) != len(b):
        raise AssertionError(
            f"speculation equivalence law{suffix}: {len(a)} worlds "
            f"vs {len(b)}")
    for ra, rb in zip(a, b):
        for k in CANON_FIELDS:
            if ra[k] != rb[k]:
                raise AssertionError(
                    f"speculation equivalence law{suffix}: world "
                    f"{ra['world']} field {k!r} diverged — "
                    f"{ra[k]!r} != {rb[k]!r}")

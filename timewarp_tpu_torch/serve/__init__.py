"""Emulation as a service: multi-host work-stealing curators + a
streaming RunConfig frontend (the port's copy of
``timewarp_tpu/serve/``, on ``TorchEngine`` fleets).

The serving layer is **host-side composition only** — zero state
inside any engine, no engine change — built from pieces the repo
already pins laws for:

- the crash-safe fsync'd sweep journal (sweep/journal.py), grown a
  per-host file mode so N cooperating processes share one directory;
- shape-bucketed batched engines with per-world budgets and inert
  padding (sweep/bucket.py — a pow2-padded bucket holds *reserved*
  world slots: a slot with budget 0 never steps, so its state stays
  the pristine shared init state until a config is admitted into it);
- per-bucket **leases** (lease.py): atomic lease files with heartbeat
  renewal and stale-lease reclaim, so per-host curators (curator.py)
  cooperate and *steal* the buckets of a dead host;
- the ``net/`` real-IO RPC fabric (frontend.py): a serving process
  accepts RunConfigs over the wire continuously, admits them into
  open buckets between chunks, and streams each ``world_done`` back
  to the submitting client as its world quiesces.

The **extended survival law** (docs/serving.md): every result
streamed over the wire is bit-identical to the solo run of that
config — across multi-host leases, a stolen bucket after a host
kill, mid-bucket admission, re-packing, and resume
(tests/test_torch_serve.py, against the reference's results).
"""

from .hosts import HOST_GRAMMAR, HostSpec, parse_host, parse_hosts, \
    parse_listen
from .lease import Lease, LeaseDir, LeaseLost

__all__ = [
    "HOST_GRAMMAR", "HostSpec", "parse_host", "parse_hosts",
    "parse_listen", "Lease", "LeaseDir", "LeaseLost",
]

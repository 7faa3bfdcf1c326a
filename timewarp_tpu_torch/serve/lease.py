"""Per-bucket leases over a shared journal directory
(the port's copy of ``timewarp_tpu/serve/lease.py``).

The coordination primitive of multi-host serving (docs/serving.md
"The lease protocol"): one lease file per bucket under
``<journal>/leases/``, holding ``{host, gen, ts}``. All writes are
atomic (temp + ``os.link`` for creation — fails if the file exists —
or temp + ``os.replace`` for renewal/steal), so a reader never sees a
torn lease.

- **acquire**: create the file with generation 1; creation races
  between hosts are arbitrated by ``os.link`` (exactly one wins).
- **heartbeat renewal**: the holder atomically rewrites its lease
  with a fresh ``ts`` (same host, same gen) and re-reads — if the
  file is no longer its own content, the lease was stolen and
  :class:`LeaseLost` is raised.
- **stale reclaim (work-stealing)**: a lease whose ``ts`` is older
  than the TTL may be stolen. Stealers race on an ``O_EXCL`` claim
  file named by the NEXT generation, so exactly one claims each
  generation; the winner atomically replaces the lease.

What the protocol guarantees — and what it deliberately does not:
with renewal interval ≪ TTL (every curator chunk renews; TTL
defaults to many chunks), a live holder is never stolen from, and a
dead host's buckets are reclaimed within one TTL. If a host is
paused longer than the TTL (not dead — a VM freeze), holder and
thief can briefly overlap; execution being bit-deterministic, the
overlap degrades to *identical duplicate* ``world_done`` records,
which the journal fold tolerates with a warning — while two
DIFFERENT results for one world remain the loud
``SweepJournalError`` refusal. Commits additionally verify the lease
first (:meth:`Lease.check`), so the overlap window is one chunk.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Dict, Optional

__all__ = ["Lease", "LeaseDir", "LeaseLost"]


class LeaseLost(RuntimeError):
    """The lease file no longer carries our (host, gen): a peer stole
    the bucket (we must have missed heartbeats past the TTL). The
    holder abandons the bucket without committing — the thief owns it
    now."""


@dataclass
class Lease:
    bucket: str
    host: str
    gen: int
    path: str
    #: the previous holder when this lease was acquired by stale
    #: reclaim (None for a free acquisition) — journaled so steals
    #: are visible in `sweep status` / the ledger
    stolen_from: Optional[str] = None


class LeaseDir:
    def __init__(self, root: str, host: str, *,
                 ttl_s: float = 10.0) -> None:
        if not host:
            raise ValueError("a LeaseDir needs a host name")
        if ttl_s <= 0:
            raise ValueError(f"lease ttl must be > 0 s, got {ttl_s}")
        self.root = os.path.join(root, "leases")
        self.host = host
        self.ttl_s = float(ttl_s)

    def path(self, bucket: str) -> str:
        return os.path.join(self.root, f"{bucket}.lease")

    # -- reading ----------------------------------------------------------

    def read(self, bucket: str) -> Optional[dict]:
        """The current lease record, or None when the bucket is free.
        Writes are atomic, so a parse failure means external damage —
        treated as a stale gen-0 lease (reclaimable), never a crash."""
        try:
            with open(self.path(bucket)) as f:
                rec = json.load(f)
            if not isinstance(rec, dict):
                raise ValueError
            return rec
        except FileNotFoundError:
            return None
        except (json.JSONDecodeError, ValueError, OSError):
            return {"host": "?", "gen": 0, "ts": 0.0}

    def stale(self, rec: dict) -> bool:
        return (time.time() - float(rec.get("ts", 0.0))) > self.ttl_s

    def table(self) -> Dict[str, dict]:
        """bucket -> lease record for every lease file on disk (the
        curators' claim-scan view; `sweep status` reads the journaled
        lease events instead, so status needs no lease-dir access)."""
        out: Dict[str, dict] = {}
        if not os.path.isdir(self.root):
            return out
        for fn in sorted(os.listdir(self.root)):
            if fn.endswith(".lease"):
                rec = self.read(fn[:-len(".lease")])
                if rec is not None:
                    out[fn[:-len(".lease")]] = rec
        return out

    # -- writing ----------------------------------------------------------

    def _write_atomic(self, path: str, rec: dict, *,
                      create: bool) -> bool:
        os.makedirs(self.root, exist_ok=True)
        tmp = f"{path}.w.{self.host}.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(rec, f)
            f.flush()
            os.fsync(f.fileno())
        try:
            if create:
                try:
                    os.link(tmp, path)  # atomic, fails if path exists
                except FileExistsError:
                    return False
                return True
            os.replace(tmp, path)
            return True
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def try_acquire(self, bucket: str) -> Optional[Lease]:
        """One non-blocking claim attempt: a free bucket is acquired
        at generation 1; a stale lease (dead holder, or our own
        previous incarnation) is stolen at the next generation; a
        fresh peer lease returns None."""
        cur = self.read(bucket)
        path = self.path(bucket)
        if cur is None:
            rec = {"host": self.host, "gen": 1, "ts": time.time()}
            if self._write_atomic(path, rec, create=True):
                return Lease(bucket, self.host, 1, path)
            cur = self.read(bucket)
            if cur is None:
                return None       # creation race resolved oddly; retry later
        own = cur.get("host") == self.host
        if not own and not self.stale(cur):
            return None
        # steal (or re-acquire after our own crash — a same-host lease
        # is always ours to bump: the previous holder under this name
        # was a prior incarnation of this very process identity)
        gen = int(cur.get("gen", 0)) + 1
        claim = f"{path}.claim{gen}"
        try:
            fd = os.open(claim, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            # a peer is stealing this generation — OR a peer DIED
            # between claiming and replacing the lease (the lease
            # then keeps its old gen forever and every stealer keeps
            # computing the same claim name). A claim older than the
            # TTL is that crash's residue: remove it so the next
            # attempt can claim; never act on it this round (the
            # unlink itself may race a live claimant — one lost poll
            # round is the safe price)
            try:
                if time.time() - os.stat(claim).st_mtime > self.ttl_s:
                    os.unlink(claim)
            except OSError:
                pass
            return None
        os.close(fd)
        try:
            rec = {"host": self.host, "gen": gen, "ts": time.time()}
            self._write_atomic(path, rec, create=False)
        finally:
            try:
                os.unlink(claim)
            except OSError:
                pass
        got = self.read(bucket)
        if not (got and got.get("host") == self.host
                and int(got.get("gen", -1)) == gen):
            return None           # lost a replace race; not ours
        return Lease(bucket, self.host, gen, path,
                     stolen_from=None if own else cur.get("host"))

    def renew(self, lease: Lease) -> None:
        """Heartbeat: refresh ``ts`` and verify the file is still our
        content afterwards; raises :class:`LeaseLost` otherwise."""
        self.check(lease)
        self._write_atomic(lease.path,
                           {"host": lease.host, "gen": lease.gen,
                            "ts": time.time()}, create=False)
        self.check(lease)

    def check(self, lease: Lease) -> None:
        got = self.read(lease.bucket)
        if not (got and got.get("host") == lease.host
                and int(got.get("gen", -1)) == lease.gen):
            raise LeaseLost(
                f"bucket {lease.bucket!r}: lease (host {lease.host}, "
                f"gen {lease.gen}) was reclaimed by "
                f"{got.get('host') if got else 'nobody — released'}; "
                "abandoning without commit (docs/serving.md)")

    def release(self, lease: Lease) -> None:
        """Drop the lease iff it is still ours (a stolen lease belongs
        to the thief — never unlink someone else's)."""
        try:
            self.check(lease)
        except LeaseLost:
            return
        try:
            os.unlink(lease.path)
        except OSError:
            pass

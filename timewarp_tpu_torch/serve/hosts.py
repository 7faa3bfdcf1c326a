"""The ``--hosts``/``--listen`` address-spec grammar — ONE parser for
every serving surface (the port's copy of ``timewarp_tpu/serve/hosts.py``).

Same discipline as ``net/links.py`` (LINK_GRAMMAR) and
``faults/schedule.py`` (FAULT_GRAMMAR): malformed specs die with a
``SystemExit`` naming :data:`HOST_GRAMMAR`, never a raw
IndexError/ValueError traceback (the loud-grammar contract,
tests/test_zgrammar.py BAD_HOSTS). Library callers that want an
exception catch the SystemExit and rewrap.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional, Tuple

__all__ = ["HOST_GRAMMAR", "HostSpec", "parse_host", "parse_hosts",
           "parse_listen"]

#: the --hosts / --listen grammar, named in every parse error
HOST_GRAMMAR = (
    "--hosts NAME[@HOST:PORT][,NAME[@HOST:PORT]...] — first NAME is "
    "THIS host's identity, the rest are expected peers; "
    "--listen HOST:PORT  "
    "(NAME = [A-Za-z0-9_.-]+, unique within a list; HOST nonempty, "
    "no ':'/'@'/','; PORT integer 1..65535)")

_NAME_RE = re.compile(r"^[A-Za-z0-9_.\-]+$")


def _die(spec: str, why: str, who: str) -> "SystemExit":
    return SystemExit(f"malformed {who} spec {spec!r} ({why}); "
                      f"grammar: {HOST_GRAMMAR}")


@dataclass(frozen=True)
class HostSpec:
    """One host of a serving fleet: a stable NAME (the lease/journal
    identity) and an optional frontend address (only hosts that run
    ``--listen`` have one)."""
    name: str
    addr: Optional[Tuple[str, int]] = None


def parse_listen(spec: str, who: str = "--listen") -> Tuple[str, int]:
    """``HOST:PORT`` — the frontend bind (or ``submit --connect``)
    address. Dies naming :data:`HOST_GRAMMAR` on malformation."""
    if not isinstance(spec, str) or not spec.strip():
        raise _die(spec, "empty spec", who)
    host, sep, port_s = spec.rpartition(":")
    if not sep or not host:
        raise _die(spec, "expected HOST:PORT", who)
    if any(c in ":@," or c.isspace() for c in host):
        raise _die(spec, f"bad host {host!r}", who)
    try:
        port = int(port_s)
    except ValueError:
        raise _die(spec, f"non-integer port {port_s!r}", who) from None
    if not 1 <= port <= 65535:
        raise _die(spec, f"port {port} outside 1..65535", who)
    return host, port


def parse_host(spec: str, who: str = "--hosts") -> HostSpec:
    """One ``NAME[@HOST:PORT]`` entry."""
    if not isinstance(spec, str) or not spec.strip():
        raise _die(spec, "empty host entry", who)
    name, sep, addr_s = spec.partition("@")
    if not _NAME_RE.match(name or ""):
        raise _die(spec, f"bad NAME {name!r}", who)
    if not sep:
        return HostSpec(name)
    if not addr_s:
        raise _die(spec, "'@' without HOST:PORT", who)
    try:
        return HostSpec(name, parse_listen(addr_s, who))
    except SystemExit as e:
        # re-raise naming the WHOLE entry, not just the address tail
        raise _die(spec, str(e).split(" (")[0]
                   if " (" in str(e) else str(e), who) from None


def parse_hosts(spec: str, who: str = "--hosts") -> Tuple[HostSpec, ...]:
    """A ','-joined host list; the FIRST entry names this process's
    own identity (the lease and per-host-journal key), the rest are
    expected peers. Duplicate names are refused — two curators under
    one name would share a lease identity and defeat the steal
    protocol's at-most-one-holder intent."""
    if not isinstance(spec, str) or not spec.strip():
        raise _die(spec, "empty spec", who)
    parts = spec.split(",")
    if any(not p.strip() for p in parts):
        raise _die(spec, "empty list entry", who)
    out = tuple(parse_host(p.strip(), who) for p in parts)
    names = [h.name for h in out]
    dups = sorted({n for n in names if names.count(n) > 1})
    if dups:
        raise _die(spec, f"duplicate host name(s) {dups}", who)
    return out

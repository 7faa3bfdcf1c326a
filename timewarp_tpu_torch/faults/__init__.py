"""Deterministic chaos: scheduled fault injection inside the superstep
(port of ``timewarp_tpu/faults/``: the schedule and property modules are
copies, ``apply.py`` the masks in torch).

The reference promised "manually controlled network nastiness"
(``Delays`` / ``ConnectionOutcome``, examples/token-ring/Main.hs:73-77);
:mod:`timewarp_tpu_torch.net.delays` revives its *stationary* half — per-
message laws that never change over emulated time. This package adds
the **time-varying** half: crash/restart a node with state loss,
partition the network for a window, degrade a set of links for a
burst, skew a node's clock — all as a static, declarative
:class:`FaultSchedule` applied as elementwise masks inside every
superstep, so the same schedule runs bit-for-bit under the reference's
engines and the port's, solo or as a multi-world fleet
(:class:`FaultFleet`: B worlds, B schedules, one card — the Monte-Carlo
chaos study).

Semantics are the reference's (docs/faults.md), held by the same laws:
engine ≡ reference trace parity, and chaos-fleet world-slice exactness
(tests/test_torch_faults.py).
"""

from .properties import (TraceRow, converged, eventually_delivered,
                         no_fire_while_down)
from .schedule import (FAULT_GRAMMAR, ClockSkew, FaultFleet,
                       FaultSchedule, FaultTables, LinkWindow, NodeCrash,
                       Partition, as_fleet, parse_faults)

__all__ = [
    "NodeCrash", "Partition", "LinkWindow", "ClockSkew",
    "FaultSchedule", "FaultFleet", "FaultTables",
    "parse_faults", "FAULT_GRAMMAR", "as_fleet",
    "eventually_delivered", "converged", "no_fire_while_down",
    "TraceRow",
]

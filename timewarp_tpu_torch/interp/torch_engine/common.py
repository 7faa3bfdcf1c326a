"""Shared machinery of the torch engines (port of the single-device part
of ``timewarp_tpu/interp/jax_engine/common.py``): the node-ownership
object, the scenario's initial state, and host-side run accounting."""

from __future__ import annotations

import time

import torch

__all__ = ["LocalComm", "init_states_wake", "refuse_unported", "run_stats",
           "stats_merge"]


class LocalComm:
    """Single-device node ownership: this device holds every node. (The
    reference's collectives are identities here; a sharded engine will
    bring ``torch.distributed`` ones.)"""

    def __init__(self, n_global: int, device: torch.device) -> None:
        self.n_global = n_global
        self.n_local = n_global
        self.device = device

    def node_ids(self) -> torch.Tensor:
        """Global ids of the nodes this device owns, int32."""
        return torch.arange(self.n_local, dtype=torch.int32,
                            device=self.device)


def init_states_wake(scenario, device: torch.device):
    """The scenario's stacked initial ``(states, wake)`` on ``device``."""
    states, wake = scenario.init_batched(scenario.n_nodes, device)
    return states, wake.to(torch.int64)


def refuse_unported(who: str, unported: dict, off: dict, ref: str) -> None:
    """Refuse, by name, a reference option the port does not carry:
    ``off`` maps each such option to the value that means "off"; any
    other value raises ValueError, an unknown name TypeError."""
    for k, v in unported.items():
        if k not in off:
            raise TypeError(f"{who} got an unexpected keyword argument {k!r}")
        if v != off[k]:
            raise ValueError(f"{who}: {k}={v!r} is not yet ported "
                             f"(run {ref})")


def run_stats(t0: float, steps_before: int, steps_after: int) -> dict:
    """A run call's ``last_run_stats``: supersteps executed, host wall
    seconds since ``t0`` (``time.perf_counter``), and compiles — always
    0, an eager run loop compiles nothing (the kernels' one-time build is
    not part of a run). The reference engine's keys."""
    return {"supersteps": steps_after - steps_before,
            "wall_seconds": time.perf_counter() - t0,
            "compiles": 0}


def stats_merge(chunks) -> dict:
    """One run-level ``last_run_stats`` from a chunked driver's per-chunk
    records (``run_stream``, ``run_controlled``, ``run_verified``): the
    reference's keys (``chunks``, ``per_chunk_compiles``) plus the summed
    ``fleet_supersteps``."""
    return {
        "supersteps": sum(c["supersteps"] for c in chunks),
        "wall_seconds": sum(c["wall_seconds"] for c in chunks),
        "compiles": sum(c["compiles"] for c in chunks),
        "chunks": len(chunks),
        "per_chunk_compiles": [c["compiles"] for c in chunks],
        "fleet_supersteps": sum(c.get("fleet_supersteps", c["supersteps"])
                                for c in chunks),
    }

"""Shared machinery of the torch engines (port of the single-device part
of ``timewarp_tpu/interp/jax_engine/common.py``): the node-ownership
object, the scenario's initial state, the dynamic dispatch values and
host-side run accounting."""

from __future__ import annotations

import time
from typing import Any, NamedTuple

import torch

__all__ = ["LocalComm", "init_states_wake", "DynDispatch", "run_stats",
           "stats_merge"]


class DynDispatch(NamedTuple):
    """A chunk's dispatch values (dispatch/, speculate/), handed to
    ``TorchEngine.run`` as tensors on the engine's device, made once per
    chunk: new values between chunks cost no host sync inside the run.

    ``window`` — the requested superstep window, int64 µs (0-d), clamped
    on the device to ``[1, engine.window]`` and, under a fault schedule,
    to each world's degraded link floor of the superstep
    (``faults.apply.window_floor``). ``rung_pin`` — the reference's floor
    on its adaptive routing ladder's rung, int32 (-1 = unpinned); the
    port routes at one static width and has no ladder, so it stays -1."""
    window: Any     # int64[] requested window µs
    rung_pin: Any   # int32[] ladder index floor, -1 = unpinned


class LocalComm:
    """Single-device node ownership: this device holds every node, and
    the collectives are identities (the reference's ``LocalComm``). The
    sharded engines swap in ``parallel.mesh.MeshComm``, whose collectives
    run over ``torch.distributed``, so one superstep body serves both."""

    def __init__(self, n_global: int, device: torch.device) -> None:
        self.n_global = n_global
        self.n_local = n_global
        self.device = device

    def node_ids(self) -> torch.Tensor:
        """Global ids of the nodes this device owns, int32."""
        return torch.arange(self.n_local, dtype=torch.int32,
                            device=self.device)

    def all_min(self, x):
        """Elementwise minimum over the devices of ``x`` (a tensor)."""
        return x

    def all_sum(self, x, u32=()):
        """Elementwise sum over the devices of ``x``: a tensor, or a
        tuple of tensors reduced together (each keeps its dtype; the
        entries indexed by ``u32`` are wrapping uint32 digests)."""
        return x

    def all_max(self, x):
        """Elementwise maximum over the devices of ``x`` (a tensor)."""
        return x

    def roll(self, x: torch.Tensor, s: int) -> torch.Tensor:
        """Global roll by ``s`` along the last (node) axis."""
        return torch.roll(x, s, dims=-1)

    def local_rows(self, table) -> torch.Tensor:
        """This device's slice of a global per-node table along its last
        axis (numpy or tensor), on the device."""
        return torch.as_tensor(table).to(self.device)


def init_states_wake(scenario, device: torch.device):
    """The scenario's stacked initial ``(states, wake)`` on ``device``."""
    states, wake = scenario.init_batched(scenario.n_nodes, device)
    return states, wake.to(torch.int64)


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

"""Counterfactual forking: spend chips only on the suffix that differs
(the port of ``timewarp_tpu/search/fork.py``: the fork fleet is one
batched ``TorchEngine`` on ``device``, the card unless the caller passes
``device="cpu"``, and the snapshot's reads are host copies of its
tensors).

A campaign evaluating K variations of one promising schedule from
t=0 re-executes the shared prefix K times. The repo already has
everything needed to skip that: per-world, digest-verified state
snapshots (utils/checkpoint.py — every leaf sha256'd at save,
re-verified at load) and a batched engine whose worlds differ only
by their fault tables. So: snapshot the base world at superstep t,
load ONE world's slice (:func:`~timewarp_tpu_torch.utils.checkpoint.
load_world_state`), broadcast it across a fresh K-world fleet
(:func:`~timewarp_tpu_torch.sweep.bucket.tile_world_state`), and hand each
world a *divergent fault suffix* — the base schedule's events plus
appended events whose windows open at or after the snapshot's
EXECUTED horizon, fork instant + resolved window
(:func:`validate_fork_suffix` explains the ``+ window``).

The fork exactness argument (pinned by tests): every fork world runs
the base seed (identical entropy streams — entropy is a pure function
of seed/instant/node, core/rng.py), the base window (the domain's
slow-down-only rule keeps the resolved window candidate-invariant),
and a fault table whose rows agree with the base schedule for all
past time — appended rows are windows that have not opened yet, and
until a window opens its row is indistinguishable from padding
(faults/schedule.py FaultTables). Therefore world b's continuation ≡
a from-scratch solo run of (snapshot prefix schedule + suffix b),
and the world whose suffix is EMPTY is bit-identical to the
uninterrupted base run — the fork law.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..faults.schedule import (ClockSkew, FaultSchedule, LinkWindow,
                               NodeCrash, Partition)
from ..sweep.bucket import Bucket, build_bucket_engine, tile_world_state
from ..sweep.spec import RunConfig, resolve_window
from .domain import candidate_config

__all__ = ["validate_fork_suffix", "fork_bucket", "load_fork_state",
           "run_fork", "ForkRun"]


def validate_fork_suffix(base: FaultSchedule, sched: FaultSchedule,
                         t_fork: int, window: int = 1) -> None:
    """A fork schedule must be ``base``'s events plus appended events
    whose windows open at or after ``t_fork + window`` — anything
    else could rewrite the snapshot's past, silently breaking the
    fork law. The ``+ window`` is not pedantry: a windowed superstep
    at virtual time t executes EVERY instant in ``[t, t + W)`` and
    leaves ``state.time == t``, so the snapshot's last superstep
    already fired the whole band ``[t_fork, t_fork + W)`` without
    the suffix fault — an event opening inside it would produce a
    continuation matching NO from-scratch schedule run. Skews are
    refused outright: a skew shifts a node's *view* of all time,
    past included."""
    evs = tuple(sched.events)
    horizon = t_fork + max(int(window), 1)
    if evs[:len(base.events)] != tuple(base.events):
        raise ValueError(
            "a fork schedule must carry the snapshot's base events "
            "as an unmodified prefix (suffix-append only); got "
            f"{evs[:len(base.events)]!r} vs base {base.events!r}")
    for e in evs[len(base.events):]:
        if isinstance(e, ClockSkew):
            raise ValueError(
                "a ClockSkew cannot be a fork suffix event: it "
                "shifts the node's view of ALL time, the snapshot's "
                "past included (docs/search.md)")
        opens = e.t_down if isinstance(e, NodeCrash) else e.t_start
        if opens < horizon:
            raise ValueError(
                f"fork suffix event {e!r} opens at {opens} µs, "
                f"inside the snapshot's executed horizon "
                f"{horizon} µs (fork instant {t_fork} + window "
                f"{window}: the last superstep already fired that "
                "band) — it would rewrite the snapshot's past")
        if isinstance(e, LinkWindow) and (e._num < e._den):
            raise ValueError(
                f"fork suffix degrade {e!r} shrinks delays "
                "(scale < 1): it could undercut the base run's "
                "resolved window (docs/search.md)")
        if not isinstance(e, (NodeCrash, Partition, LinkWindow)):
            raise ValueError(f"unknown fork suffix event {e!r}")


def fork_bucket(base_cfg: RunConfig,
                schedules: Sequence[FaultSchedule], t_fork: int, *,
                fault_pad: Optional[Tuple[int, int, int]] = None,
                lint: str = "off", device=None):
    """Build the K-world continuation fleet: one batched engine whose
    world b runs ``schedules[b]`` — each validated as a suffix-append
    of the base config's own schedule — at the base seed and the base
    config's resolved window. ``fault_pad`` (the snapshot engine's
    realized pad, or the search domain's caps) pins the fault-table
    rows so the loaded ``restart_done`` columns line up. The fleet
    runs on ``device`` (the card by default). Returns ``(engine,
    configs)``."""
    from ..interp.torch_engine.engine import resolve_device
    device = resolve_device(device, "fork_bucket")
    base_sched = base_cfg.parse_faults() or FaultSchedule(())
    window = resolve_window(base_cfg)
    cfgs: List[RunConfig] = []
    for k, s in enumerate(schedules):
        validate_fork_suffix(base_sched, s, t_fork, window)
        cfgs.append(candidate_config(base_cfg, s, f"fork{k}"))
    bucket = Bucket("fork", tuple(cfgs), window,
                    fault_pad=tuple(fault_pad) if fault_pad else None)
    return build_bucket_engine(bucket, lint=lint, device=device), cfgs


def load_fork_state(engine, ckpt_path: str, world: int):
    """Admit one snapshot world into the fork fleet: load world
    ``world``'s digest-verified slice at the fork engine's solo shape
    (``restart_done`` growing False rows for appended crashes —
    utils/checkpoint.py), then broadcast it across the fleet on the
    engine's device. Returns ``(state, t_fork, meta)``."""
    from ..interp.torch_engine.batched import world_slice
    from ..utils.checkpoint import load_world_state
    solo_template = world_slice(engine.init_state(), 0)
    solo, meta = load_world_state(ckpt_path, solo_template, world,
                                  scenario=engine.scenario)
    t_fork = int(solo.time)
    return tile_world_state(engine, solo), t_fork, meta


class ForkRun(NamedTuple):
    """One fork fleet's outcome: per-world suffix traces (virtual
    time starts at the fork instant), per-world suffix superstep
    counts, the shared prefix superstep count, and the chip saving —
    ``1 - (prefix + suffix)/(K*prefix + suffix)``. HONEST
    accounting: the numerator charges the snapshot run's own prefix
    (executed once, purely to create the fork point) as well as the
    suffixes, against what K from-scratch re-runs would have cost;
    K=1 therefore saves exactly nothing, by construction."""
    final: object
    traces: list
    prefix_supersteps: int
    suffix_supersteps: List[int]
    quiesced: List[bool]

    @property
    def saving_frac(self) -> float:
        K = len(self.suffix_supersteps)
        suffix = sum(self.suffix_supersteps)
        full = K * self.prefix_supersteps + suffix
        spent = self.prefix_supersteps + suffix
        return round(1.0 - spent / full, 4) if full else 0.0


def run_fork(engine, state, budget: int, *,
             chunk: int = 64) -> ForkRun:
    """Drive the fork fleet to quiescence (or the base config's
    remaining budget) with the chunked fleet driver. ``budget`` is
    the base config's TOTAL superstep budget; each world continues
    from the snapshot's executed count, so prefix + suffix never
    exceeds what the from-scratch run would have spent. The fleet
    runs where its engine runs (:func:`load_fork_state` puts the
    state there)."""
    prefix = int(state.steps[0])
    remaining = max(int(budget) - prefix, 0)
    B = engine.batch.B
    final, traces = engine.run_stream(
        np.full(B, remaining, np.int64), state=state, chunk=chunk)
    steps = final.steps.cpu().numpy().astype(np.int64)
    live = engine.world_active(final).cpu().numpy()
    return ForkRun(
        final=final, traces=traces, prefix_supersteps=prefix,
        suffix_supersteps=[int(s - prefix) for s in steps],
        quiesced=[not bool(a) for a in live])

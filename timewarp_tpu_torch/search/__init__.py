"""Adversarial chaos search: schedule-space fuzzing over the emulator
(the port of ``timewarp_tpu/search/``, its CLI aside: every fleet is a
batched ``TorchEngine`` on the card unless the caller passes
``device="cpu"``).

The repo's existing pieces — deterministic fault schedules (faults/),
the shape-bucketed batched evaluator (sweep/), per-world protocol
properties (faults/properties.py), digest-verified per-world
snapshots (utils/checkpoint.py) — compose into a search harness:
treat :class:`~timewarp_tpu_torch.faults.schedule.FaultSchedule` space as a
search domain and drive batched fleets as the evaluator, evolving
schedules toward property violations. Found counterexamples are
delta-minimized and emitted as replayable repro artifacts (config +
seed + ``--faults`` grammar string) that re-fail the property
bit-for-bit solo.

Everything here is host-side composition over the existing engines:
zero search-subsystem state lives inside any engine, so the exactness
laws are untouched by construction, and the whole campaign is a pure
function of its (base config, knobs, seed) inputs — docs/search.md
"The determinism law".
"""

from .campaign import CampaignResult, ChaosSearch
from .domain import ScheduleDomain, candidate_config, domain_for
from .fork import fork_bucket, load_fork_state, run_fork
from .minimize import minimize_counterexample
from .mutate import crossover, mutate, suffix_mutate
from .objectives import (Objective, WorldEval, evaluate_configs,
                         parse_objective)

__all__ = [
    "ChaosSearch", "CampaignResult",
    "ScheduleDomain", "domain_for", "candidate_config",
    "Objective", "WorldEval", "parse_objective", "evaluate_configs",
    "mutate", "suffix_mutate", "crossover",
    "fork_bucket", "load_fork_state", "run_fork",
    "minimize_counterexample",
]

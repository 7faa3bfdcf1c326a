"""Scenario sanitizer: static analysis for both authoring styles (port
of ``timewarp_tpu/analysis/``; the TW1xx and TW7xx rules read aten
graphs traced with ``make_fx`` where the reference reads jaxprs).

The framework's determinism contract (core/scenario.py:28-47) is
checkable *before* any engine run:

- :mod:`.jaxpr_lint` — fake-traces ``Scenario.step`` into an aten
  graph and checks host escapes, time-dtype discipline, outbox
  conformance and the declared-flag dataflow (TW1xx).
- :mod:`.capacity` — static mailbox-capacity proofs over
  ``static_dst`` topologies; reported bounds for dynamic ones (TW2xx).
- :mod:`.program_lint` — AST lints for generator effect programs:
  dropped combinator calls, host IO in pure contexts, swallowed
  ``ThreadKilled`` (TW3xx).
- :mod:`.probes` — seeded permutation probe for ``commutative_inbox``,
  the one flag dataflow cannot verify (TW4xx).
- :mod:`.plan_lint` — fleet-scale pre-flight verification of sweep
  packs / serve submissions: predicted bucket plans, engine-refusal
  mirrors, pad-growth rebuild warnings (TW6xx).
- :mod:`.determinism` — graph-level bit-exactness threats (unordered
  float reductions, platform-dependent transcendentals, non-threefry
  randomness, host reads in the engines' superstep bodies) and the
  generic off-mode neutrality proof (TW7xx).

Every engine runs :func:`check_scenario` at construction under its
``lint="error"|"warn"|"off"`` knob (default ``"warn"``), as do the
sweep service (the whole pack, pre-build) and the serve frontend (each
admission) under theirs. See docs/authoring.md "Lint rules" for the
full rule table and suppression mechanics.
"""

from __future__ import annotations

import logging

from ..core.scenario import Scenario
from .capacity import (lint_capacity, lint_capacity_faulted,
                       max_delay_us, worst_case_fan_in)
from .determinism import (lint_engine_jaxpr, lint_step_determinism,
                          prove_mode_neutrality,
                          scan_jaxpr_determinism)
from .fault_lint import check_faults, lint_fault_schedule
from .jaxpr_lint import HOST_ESCAPE_PRIMITIVES, lint_step_jaxpr
from .plan_lint import (lint_pack, lint_pack_json, lint_pack_path,
                        lint_run_config)
from .probes import probe_commutative_inbox
from .program_lint import (GENERATOR_COMBINATORS, lint_module_programs,
                           lint_program, lint_source)
from .report import (ERROR, INFO, WARNING, Finding, LintError,
                     LintReport)

__all__ = [
    "Finding", "LintReport", "LintError",
    "ERROR", "WARNING", "INFO",
    "lint_scenario", "check_scenario", "LINT_MODES",
    "lint_fault_schedule", "check_faults",
    "lint_step_jaxpr", "lint_capacity", "worst_case_fan_in",
    "lint_capacity_faulted", "max_delay_us",
    "lint_pack", "lint_pack_json", "lint_pack_path",
    "lint_run_config",
    "lint_step_determinism", "lint_engine_jaxpr",
    "prove_mode_neutrality", "scan_jaxpr_determinism",
    "probe_commutative_inbox",
    "lint_program", "lint_source", "lint_module_programs",
    "HOST_ESCAPE_PRIMITIVES", "GENERATOR_COMBINATORS",
]

log = logging.getLogger("timewarp_tpu_torch.analysis")

#: valid values of the engines' construction-lint knob
LINT_MODES = ("error", "warn", "off")


def lint_scenario(scenario: Scenario, *, probe: bool = False,
                  seed: int = 0, device=None) -> LintReport:
    """Run every scenario-level checker. ``probe=True`` adds the
    concrete ``commutative_inbox`` permutation probe (executes the step
    a handful of times on ``device``, the card unless the caller passes
    ``device="cpu"`` — engines skip it at construction).

    Findings whose code appears in ``scenario.meta["lint_ignore"]``
    are suppressed (the documented opt-out, docs/authoring.md)."""
    rep = LintReport()
    rep.extend(lint_step_jaxpr(scenario))
    rep.extend(lint_step_determinism(scenario))
    rep.extend(lint_capacity(scenario))
    if probe:
        rep.extend(probe_commutative_inbox(scenario, seed=seed,
                                           device=device))
    ignore = ()
    if isinstance(scenario.meta, dict):
        ignore = tuple(scenario.meta.get("lint_ignore", ()))
    return rep.filtered(ignore) if ignore else rep


def check_scenario(scenario: Scenario, mode: str, *,
                   who: str = "engine"):
    """Construction-time hook shared by every engine.

    ``mode="off"`` returns None without looking at the scenario (the
    bit-for-bit compatibility path). ``"error"`` raises
    :class:`LintError` on any error-severity finding. ``"warn"`` (the
    default everywhere) logs errors at WARNING and perf findings at
    INFO, then lets construction proceed. The (probe-free) report is
    cached on the scenario object — engines are constructed far more
    often than scenarios are built."""
    if mode == "off":
        return None
    if mode not in LINT_MODES:
        raise ValueError(
            f"lint must be one of {LINT_MODES}, got {mode!r}")
    report = getattr(scenario, "_lint_cache", None)
    if report is None:
        report = lint_scenario(scenario, probe=False)
        try:
            scenario._lint_cache = report
        except Exception:  # noqa: BLE001 — cache is best-effort
            pass
    if mode == "error" and not report.ok:
        raise LintError(report, who=who)
    for f in report.errors:
        log.warning("%s: %s", who, f.render())
    for f in report.warnings:
        log.info("%s: %s", who, f.render())
    return report

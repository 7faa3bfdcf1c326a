"""Fault-schedule lint rules (TW5xx) — the sanitizer's chaos arm (copy
of ``timewarp_tpu/analysis/fault_lint.py`` over the port's
``faults/schedule.py``).

A :class:`~timewarp_tpu_torch.faults.schedule.FaultSchedule` is validated
for well-formedness at construction (types, ranges); the checks that
need the *scenario* — node ranges, window sanity against the engine's
single-pass deferral, reset-template cost — live here, surfaced
through the same severity-ranked :class:`~timewarp_tpu_torch.analysis.
report.LintReport` and the same engine ``lint="error"|"warn"|"off"``
knob as the TW1xx–TW4xx scenario rules.

Rules:

- **TW501** (error): an event names a node ``>= n_nodes`` — it can
  never match a live node, so the intended fault silently does
  nothing.
- **TW502** (error): two crash windows for one node overlap **or
  touch** — the engines' single-pass deferral (faults/apply.py)
  defines suppression only for windows separated by a gap: an event
  deferred to window A's ``t_up`` lands exactly on an adjacent
  window B's ``t_down`` and fires inside B. Merge them into one
  window.
- **TW503** (error): a fault window with ``t_end <= t_start`` (crash,
  partition, or degradation) — an empty window is inert, which is
  never what the author scheduled.
- **TW504** (warning): ``reset_state`` on a scenario without
  ``init_batched`` — the reboot template is stacked per node on the
  host (the same loop ``init_state`` pays, but now twice); declare
  ``init_batched`` before running reset chaos at millions of nodes.
  The port's scenarios always carry ``init_batched`` (the engines build
  the reboot template with it), so TW504 stands for a hand-built
  scenario object without one.
"""

from __future__ import annotations

from ..core.scenario import Scenario
from .report import ERROR, WARNING, Finding, LintReport

__all__ = ["lint_fault_schedule", "check_faults"]


def lint_fault_schedule(faults, scenario: Scenario) -> LintReport:
    """Run the TW5xx rules for one schedule (or every world of a
    :class:`~timewarp_tpu_torch.faults.schedule.FaultFleet`) against
    ``scenario``."""
    from ..faults.schedule import FaultFleet
    if isinstance(faults, FaultFleet):
        rep = LintReport()
        for b, sched in enumerate(faults.schedules):
            world = lint_fault_schedule(sched, scenario)
            for f in world.findings:
                rep.add(Finding(f.code, f.severity,
                                f"{f.subject}[world {b}]", f.message,
                                f.location))
        return rep

    rep = LintReport()
    sub = scenario.name
    n = scenario.n_nodes

    def bad_node(i: int, what: str) -> None:
        if i >= n:
            rep.add(Finding(
                "TW501", ERROR, sub,
                f"{what} names node {i} but the scenario has "
                f"n_nodes={n} — the fault can never bite "
                f"(nodes are 0..{n - 1})"))

    def bad_window(lo: int, hi: int, what: str) -> None:
        if hi <= lo:
            rep.add(Finding(
                "TW503", ERROR, sub,
                f"{what} window [{lo}, {hi}) is empty "
                f"(t_end <= t_start) — an inert fault is never what "
                "was scheduled"))

    crashes = faults.crashes
    for c in crashes:
        bad_node(c.node, "crash")
        bad_window(c.t_down, c.t_up, "crash")
    by_node: dict = {}
    for c in crashes:
        if c.t_up > c.t_down:
            by_node.setdefault(c.node, []).append((c.t_down, c.t_up))
    for node, wins in by_node.items():
        wins.sort()
        for (d0, u0), (d1, u1) in zip(wins, wins[1:]):
            if d1 <= u0:
                rep.add(Finding(
                    "TW502", ERROR, sub,
                    f"crash windows [{d0}, {u0}) and [{d1}, {u1}) for "
                    f"node {node} overlap or touch — deferral is "
                    "single-pass (faults/apply.py): an event deferred "
                    f"to {u0} would fire inside the next window; "
                    "merge them into one window"))

    for p in faults.partitions:
        for g in p.groups:
            for i in g:
                bad_node(i, "partition group")
        bad_window(p.t_start, p.t_end, "partition")

    for lw in faults.link_windows:
        for side_name in ("src", "dst"):
            side = getattr(lw, side_name)
            if side:
                for i in side:
                    bad_node(i, f"degradation {side_name}")
        bad_window(lw.t_start, lw.t_end, "degradation")

    for s in faults.skews:
        bad_node(s.node, "clock skew")

    if any(c.reset_state for c in crashes) \
            and getattr(scenario, "init_batched", None) is None:
        rep.add(Finding(
            "TW504", WARNING, sub,
            "reset_state crash on a scenario without init_batched: "
            "the reboot template is built by a per-node host loop "
            "(fine at test scale; declare init_batched before "
            "running reset chaos at large n_nodes)"))
    return rep


def check_faults(faults, scenario: Scenario, mode: str, *,
                 who: str = "engine"):
    """Construction-time hook for fault-capable engines — the TW5xx
    twin of :func:`~timewarp_tpu_torch.analysis.check_scenario`, under the
    same ``lint`` knob contract ("off" skips, "error" raises
    :class:`~timewarp_tpu_torch.analysis.report.LintError`, "warn" logs)."""
    import logging

    from . import LINT_MODES
    from .report import LintError
    if mode == "off":
        return None
    if mode not in LINT_MODES:
        raise ValueError(
            f"lint must be one of {LINT_MODES}, got {mode!r}")
    report = lint_fault_schedule(faults, scenario)
    if mode == "error" and not report.ok:
        raise LintError(report, who=who)
    log = logging.getLogger("timewarp_tpu_torch.analysis")
    for f in report.errors:
        log.warning("%s: %s", who, f.render())
    for f in report.warnings:
        log.info("%s: %s", who, f.render())
    return report

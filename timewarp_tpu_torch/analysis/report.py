"""Lint findings and the severity-ranked report (copy of
``timewarp_tpu/analysis/report.py``).

The scenario sanitizer's output surface: every checker in this package
(`jaxpr_lint` — over aten graphs here —, `capacity`, `program_lint`, `probes`, `plan_lint`,
`determinism`) returns :class:`Finding`\\ s collected into one
:class:`LintReport`. Severity is three-valued:

- ``error``   — a determinism-contract violation the engines would only
  surface dynamically (digest mismatch, silent mailbox drop, trace-time
  crash). Engines built with ``lint="error"`` refuse to construct.
- ``warning`` — legal but wasteful or fragile (a conservative flag the
  engine pays for every superstep; a broad ``except`` that can swallow
  ``ThreadKilled``).
- ``info``    — a reported bound or note, never actionable by itself.

Suppression: scenario-level via ``Scenario.meta["lint_ignore"] =
["TW110", ...]``; source-level (AST linter) via a ``# tw-lint: ignore``
or ``# tw-lint: ignore[TW301]`` comment on the offending line
(docs/authoring.md "Lint rules").
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Tuple

from ..core.errors import TimeWarpError

__all__ = ["Finding", "LintReport", "LintError",
           "ERROR", "WARNING", "INFO"]

ERROR, WARNING, INFO = "error", "warning", "info"
_RANK = {ERROR: 0, WARNING: 1, INFO: 2}


@dataclass(frozen=True)
class Finding:
    """One lint finding.

    ``code`` is stable (``TW1xx`` jaxpr contract lints, ``TW2xx``
    capacity proofs, ``TW3xx`` effect-program AST lints, ``TW4xx``
    probes, ``TW5xx`` fault-schedule lints, ``TW6xx`` sweep-pack plan
    lints, ``TW7xx`` graph determinism sanitizer; in the port the TW1xx and
    TW7xx rules read aten graphs); messages may be
    reworded freely.
    """
    code: str
    severity: str
    subject: str          # scenario / program the finding is about
    message: str
    #: optional (filename, line) for AST findings
    location: Optional[Tuple[str, int]] = None

    def __post_init__(self):
        if self.severity not in _RANK:
            raise ValueError(f"unknown severity {self.severity!r}")

    def render(self) -> str:
        loc = ""
        if self.location is not None:
            loc = f" ({self.location[0]}:{self.location[1]})"
        return (f"[{self.severity.upper():7s}] {self.code} "
                f"{self.subject}{loc}: {self.message}")


@dataclass
class LintReport:
    """Severity-ranked collection of findings."""
    findings: List[Finding] = field(default_factory=list)

    def add(self, finding: Finding) -> None:
        self.findings.append(finding)

    def extend(self, other: "LintReport") -> "LintReport":
        self.findings.extend(other.findings)
        return self

    # -- views -----------------------------------------------------------

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == WARNING]

    @property
    def infos(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == INFO]

    @property
    def ok(self) -> bool:
        """True when no error-severity finding is present."""
        return not self.errors

    def ranked(self) -> List[Finding]:
        """Findings most-severe first (stable within a severity)."""
        return sorted(self.findings, key=lambda f: _RANK[f.severity])

    def codes(self) -> List[str]:
        return [f.code for f in self.findings]

    def filtered(self, ignore: Iterable[str]) -> "LintReport":
        """A new report without the findings whose code is in ``ignore``
        (the ``meta["lint_ignore"]`` suppression path)."""
        ig = set(ignore)
        return LintReport([f for f in self.findings if f.code not in ig])

    # -- rendering -------------------------------------------------------

    def render(self) -> str:
        if not self.findings:
            return "lint: clean (0 findings)"
        lines = [f.render() for f in self.ranked()]
        lines.append(
            f"lint: {len(self.errors)} error(s), "
            f"{len(self.warnings)} warning(s), {len(self.infos)} info")
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {
            "errors": len(self.errors),
            "warnings": len(self.warnings),
            "infos": len(self.infos),
            "findings": [
                {"code": f.code, "severity": f.severity,
                 "subject": f.subject, "message": f.message,
                 **({"file": f.location[0], "line": f.location[1]}
                    if f.location else {})}
                for f in self.ranked()],
        }


class LintError(TimeWarpError):
    """Raised by ``lint="error"`` engine construction (and the CLI lint
    gate) when a report carries error-severity findings. Carries the
    full report as ``.report``."""

    def __init__(self, report: LintReport, who: str = "lint") -> None:
        self.report = report
        super().__init__(f"{who}: failed lint\n{report.render()}")

"""Optimistic time-warp execution on the torch engines (the port of
``timewarp_tpu/speculate/``; docs/speculation.md).

``speculate="off"|"auto"|"fixed:W"`` on ``TorchEngine`` runs supersteps
with a window WIDER than the provable link floor — the Jefferson optimism
the repo is named for — detecting straggler deliveries through a
per-superstep causality-violation plane (plane.py) and rolling back to
the last committed snapshot on violation (runner.py ``run_speculative``).
The window choice per chunk is a journaled dispatch decision (policy.py),
so the replay law governs speculative runs unchanged.
"""

from .equiv import (CANON_FIELDS, assert_spec_equiv, canonical_rows,
                    write_canon_csv)
from .plane import (SPECULATE_GRAMMAR, SPECULATE_MODES, SpecRow,
                    SpeculationViolation, first_spec_violation,
                    hit_scalars, parse_speculate,
                    spec_violation_error)
from .policy import SpeculationPolicy
from .runner import SpeculativeRunMixin

__all__ = [
    "SPECULATE_GRAMMAR", "SPECULATE_MODES", "SpecRow",
    "SpeculationViolation", "SpeculationPolicy",
    "SpeculativeRunMixin", "parse_speculate", "first_spec_violation",
    "spec_violation_error", "hit_scalars", "canonical_rows",
    "write_canon_csv", "assert_spec_equiv", "CANON_FIELDS",
]

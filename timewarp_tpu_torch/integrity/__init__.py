"""Self-verifying execution on the torch engines (the port of
``timewarp_tpu/integrity/``): every torch engine but ``FusedRingEngine``
takes ``verify="off" | "guard" | "digest" | "shadow"``, an escalating
ladder with the telemetry plane's contract (off runs no code of it):

- ``"guard"`` — per-superstep invariant checks on the device
  (checks.py), the first violating superstep and field surfaced as the
  reference's pinned diagnostic (:class:`IntegrityViolation`);
- ``"digest"`` — guard, plus the state digest (digest.py) recomputed at
  every chunk entry of ``run_verified``, chained by sha256;
- ``"shadow"`` — digest, plus a sampled re-execution of the chunk whose
  post-state digest must agree (runner.py says what the port's twin can
  and cannot catch).

On detection, ``run_verified`` rolls back to the last verified snapshot
and re-runs, bit-identical to an uncorrupted run (the detection law).
``flip:SEED[:CHUNK[:PLANE]]`` (inject.py) writes a seeded bit flip into
a state leaf between chunks — the same leaf, element and bit the
reference's flip picks.
"""

from .checks import (VERIFY_MODES, IntegrityRow, IntegrityViolation,
                     first_guard_violation, make_guard_row,
                     validate_verify)
from .digest import (VERIFY_CHAIN_ZERO, chain_state_digest,
                     fleet_digest, host_digests, tree_digest)
from .inject import (INJECT_GRAMMAR, FlipInjector, FlipSpec,
                     apply_flip, parse_flip)
from .runner import VerifiedRunMixin

__all__ = [
    "VERIFY_MODES", "IntegrityRow", "IntegrityViolation",
    "first_guard_violation", "make_guard_row", "validate_verify",
    "VERIFY_CHAIN_ZERO", "chain_state_digest", "fleet_digest",
    "host_digests", "tree_digest",
    "INJECT_GRAMMAR", "FlipInjector", "FlipSpec", "apply_flip",
    "parse_flip",
    "VerifiedRunMixin",
]

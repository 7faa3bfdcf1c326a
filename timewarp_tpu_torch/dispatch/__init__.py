"""Online adaptive dispatch for the torch engines (the port's copy of
``timewarp_tpu/dispatch/``): a host-side controller that picks each
chunk's length from the telemetry the previous chunk streamed, and a
recorded decision trace whose replay is bit-identical (the replay law).
On the torch engines the window and the rung are pinned."""

from .controller import (CONTROLLER_GRAMMAR, DispatchController,
                         parse_controller)
from .trace import (DISPATCH_SCHEMA, Decision, DecisionTrace,
                    DispatchTraceError)

__all__ = [
    "CONTROLLER_GRAMMAR", "DISPATCH_SCHEMA", "Decision",
    "DecisionTrace", "DispatchController", "DispatchTraceError",
    "parse_controller",
]

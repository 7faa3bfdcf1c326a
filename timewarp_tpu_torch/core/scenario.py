"""State-machine scenario IR (port of ``timewarp_tpu/core/scenario.py``).

The reference authors a per-node step and ``vmap``s it; here the step is
written batched over the node axis, the batch dimension spelled out:

    step(states, inbox, now, node_ids, bits) -> (states', outbox, wake)

with ``states`` a dict of ``[N, ...]`` tensors, ``inbox`` an
:class:`Inbox` of ``[K, N]`` leaves (payload ``[K, P, N]``), ``now``
int64 ``[N]``, ``node_ids`` int32 ``[N]``, ``bits`` the ``fire_bits``
pair (or None) and the outbox an :class:`Outbox` of ``[M, N]`` leaves
(payload ``[M, P, N]``) — the node axis minor, exactly the layout the
JAX engine's ``vmap(in_axes=-1, out_axes=-1)`` presents.

The six-point determinism contract of the reference holds unchanged:
fire-all-at-min supersteps, inbox order ``(deliver_time, arrival)``,
sender-major arrival order, flight ``>= 1 µs``, wake clamped past
``now``, bounded mailboxes with counted overflow.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np

from .time import FOREVER, Microsecond

__all__ = ["NEVER", "Inbox", "Outbox", "Scenario", "StepFn",
           "InitBatchedFn", "InitFn"]

#: next_wake sentinel: the node has no timer armed.
NEVER: Microsecond = FOREVER


class Inbox(NamedTuple):
    """Messages visible to the firing nodes: ``[K, N]`` leaves, slot
    order ``(deliver_time, arrival)``, invalid slots padded."""
    valid: Any    # bool[K, N]
    src: Any      # int32[K, N]
    time: Any     # int64[K, N] — deliver time in µs
    payload: Any  # int32[K, P, N]


class Outbox(NamedTuple):
    """Messages the nodes emit from one firing: ``[M, N]`` leaves."""
    valid: Any    # bool[M, N]
    dst: Any      # int32[M, N]
    payload: Any  # int32[M, P, N]


#: step(states, inbox, now, node_ids, bits) -> (states', outbox, wake)
StepFn = Callable[[Any, Inbox, Any, Any, Any], tuple]

#: init_batched(n, device) -> (states dict of [N, ...], wake int64[N])
InitBatchedFn = Callable[[int, Any], tuple]

#: init(node_id) -> (states dict of 0-d tensors, first wake µs)
InitFn = Callable[[int], tuple]


@dataclass
class Scenario:
    """A complete batched scenario: ``step`` and ``init_batched`` are
    plain functions on tensors (no host control flow on their values)."""
    name: str
    n_nodes: int
    step: StepFn
    init_batched: InitBatchedFn
    payload_width: int = 2
    max_out: int = 1
    mailbox_cap: int = 8
    #: whether ``step`` consumes its entropy argument
    needs_key: bool = False
    #: True when ``step`` is insensitive to inbox slot order
    commutative_inbox: bool = False
    #: False when ``step`` never reads ``inbox.src`` (engines then skip
    #: the mailbox src field and hash src as 0)
    inbox_src: bool = True
    #: ``states`` leaves that the reference holds as uint32 and the port
    #: as int64 words in ``[0, 2**32)`` (torch's uint32 has no compare
    #: or arithmetic on the CPU); state_io.py maps them at the boundary
    u32_states: Tuple[str, ...] = ()
    #: init(node_id) -> (dict of 0-d tensors, first wake µs): one node's
    #: initial state on the CPU, the reference's per-node ``init``
    init: Optional[InitFn] = None
    #: static communication graph: int32 numpy ``[N, M]``, the destination
    #: of each outbox slot (-1 = slot never used), for scenarios that only
    #: ever send along fixed edges; it enables the edge engine
    #: (interp/torch_engine/edge_engine.py)
    static_dst: Optional[np.ndarray] = None
    meta: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        for attr in ("n_nodes", "mailbox_cap", "max_out", "payload_width"):
            v = getattr(self, attr)
            if isinstance(v, bool) or not isinstance(v, int) or v < 1:
                raise ValueError(
                    f"scenario {self.name!r}: {attr} must be an int >= 1, "
                    f"got {v!r}")
        if self.static_dst is not None:
            shape = tuple(np.shape(self.static_dst))
            want = (self.n_nodes, self.max_out)
            if shape != want:
                raise ValueError(
                    f"scenario {self.name!r}: static_dst shape {shape} "
                    f"must be [n_nodes, max_out] = {list(want)} — one "
                    "destination per outbox slot per node (-1 = slot "
                    "never used)")

"""Carry an engine state across packages: the reference ``EngineState``
as numpy leaves to and from the port's :class:`EngineState`.

``state_from_numpy`` takes the leaves of a ``JaxEngine`` state (as
``np.asarray`` of each field, the ``states`` field a dict of arrays) and
places them on ``device``; ``state_to_numpy`` goes back. Names and dtypes
are checked, never coerced: a leaf of another dtype is refused.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .engine import EngineState

__all__ = ["state_from_numpy", "state_to_numpy", "LEAF_DTYPES"]

#: the dtype of every non-``states`` leaf, as in the reference
LEAF_DTYPES = {
    "wake": np.int64, "mb_rel": np.int32, "mb_src": np.int32,
    "mb_payload": np.int32, "overflow": np.int32, "bad_dst": np.int32,
    "bad_delay": np.int32, "short_delay": np.int32, "route_drop": np.int32,
    "delivered": np.int64, "steps": np.int64, "time": np.int64,
    "ev_time": np.int64, "ev_meta": np.int32, "ev_count": np.int64,
    "fault_dropped": np.int32, "restart_done": np.bool_,
}


def _tensor(name: str, a, device) -> torch.Tensor:
    arr = np.array(a)          # a writable, contiguous copy
    want = LEAF_DTYPES.get(name)
    if want is not None and arr.dtype != want:
        raise ValueError(f"leaf {name!r} has dtype {arr.dtype}, expected "
                         f"{np.dtype(want)}")
    return torch.from_numpy(arr).to(device)


def state_from_numpy(leaves: Dict[str, object], device) -> EngineState:
    """The port's state from a reference state's numpy leaves."""
    names = set(EngineState._fields)
    if set(leaves) != names:
        raise ValueError(
            f"state leaves differ from EngineState's: missing "
            f"{sorted(names - set(leaves))}, extra "
            f"{sorted(set(leaves) - names)}")
    device = torch.device(device)
    return EngineState(**{
        name: ({k: _tensor(f"states.{k}", v, device)
                for k, v in leaves[name].items()} if name == "states"
               else _tensor(name, leaves[name], device))
        for name in EngineState._fields})


def state_to_numpy(state: EngineState) -> Dict[str, object]:
    """The port's state as numpy leaves (``states`` a dict)."""
    return {name: ({k: v.cpu().numpy() for k, v in state.states.items()}
                   if name == "states" else getattr(state, name).cpu().numpy())
            for name in EngineState._fields}

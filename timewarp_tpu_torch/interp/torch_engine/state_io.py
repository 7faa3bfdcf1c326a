"""Carry an engine state across packages: the reference ``EngineState``
as numpy leaves to and from the port's :class:`EngineState`.

``state_from_numpy`` takes the leaves of a ``JaxEngine`` state (as
``np.asarray`` of each field, the ``states`` field a dict of arrays) and
places them on ``device``; ``state_to_numpy`` goes back. Names and dtypes
are checked, never coerced: a leaf of another dtype is refused. The one
mapping is the scenario's ``u32_states`` (e.g. Praos' ``thr``): uint32 in
the reference, int64 words in the port, converted both ways without loss.
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


def _u32_names(scenario) -> tuple:
    return () if scenario is None else tuple(scenario.u32_states)


def _tensor(name: str, a, device, word: bool = False) -> torch.Tensor:
    arr = np.array(a)          # a writable, contiguous copy
    want = np.uint32 if word else LEAF_DTYPES.get(name)
    if want is None and arr.dtype == np.uint32:
        raise ValueError(f"leaf {name!r} is uint32 but the scenario does "
                         "not declare it in u32_states")
    if want is not None and arr.dtype != want:
        raise ValueError(f"leaf {name!r} has dtype {arr.dtype}, expected "
                         f"{np.dtype(want)}")
    if word:
        arr = arr.astype(np.int64)
    return torch.from_numpy(arr).to(device)


def state_from_numpy(leaves: Dict[str, object], device,
                     scenario=None) -> EngineState:
    """The port's state from a reference state's numpy leaves. The
    ``scenario``'s ``u32_states`` leaves must be uint32; they become
    int64 words."""
    names = set(EngineState._fields)
    if set(leaves) != names:
        raise ValueError(
            f"state leaves differ from EngineState's: missing "
            f"{sorted(names - set(leaves))}, extra "
            f"{sorted(set(leaves) - names)}")
    device = torch.device(device)
    words = _u32_names(scenario)
    return EngineState(**{
        name: ({k: _tensor(f"states.{k}", v, device, k in words)
                for k, v in leaves[name].items()} if name == "states"
               else _tensor(name, leaves[name], device))
        for name in EngineState._fields})


def _word_array(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.cpu().numpy()
    if a.dtype != np.int64 or (a.size and (a.min() < 0 or a.max() >= 2**32)):
        raise ValueError(f"leaf {name!r} is not an int64 word in "
                         "[0, 2**32)")
    return a.astype(np.uint32)


def state_to_numpy(state: EngineState, scenario=None) -> Dict[str, object]:
    """The port's state as numpy leaves (``states`` a dict); the
    ``scenario``'s ``u32_states`` leaves go back to uint32."""
    words = _u32_names(scenario)
    return {name: ({k: (_word_array(f"states.{k}", v) if k in words
                        else v.cpu().numpy())
                    for k, v in state.states.items()}
                   if name == "states" else getattr(state, name).cpu().numpy())
            for name in EngineState._fields}

"""Carry an engine state across packages: a reference state as numpy
leaves to and from the port's state.

``state_from_numpy`` takes the leaves of a ``JaxEngine`` state (as
``np.asarray`` of each field, the ``states`` field a dict of arrays) and
places them on ``device`` as an :class:`EngineState`; ``state_to_numpy``
goes back. A fleet's state crosses the same way, its leading world axis
on every leaf. ``edge_state_from_numpy`` / ``edge_state_to_numpy`` do the
same for the edge engine's :class:`EdgeState` (a fused-ring state crosses
through ``FusedRingEngine.to_edge_state``). Names and dtypes are checked,
never coerced: a leaf of another dtype is refused. The one mapping is the
scenario's ``u32_states`` (e.g. Praos' ``thr``): uint32 in the reference,
int64 words in the port, converted both ways without loss.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .edge_engine import EdgeState
from .engine import EngineState

__all__ = ["state_from_numpy", "state_to_numpy", "edge_state_from_numpy",
           "edge_state_to_numpy", "LEAF_DTYPES", "EDGE_LEAF_DTYPES"]

#: the dtype of every non-``states`` leaf of ``EngineState``, as in the
#: reference
LEAF_DTYPES = {
    "wake": np.int64, "mb_rel": np.int32, "mb_src": np.int32,
    "mb_payload": np.int32, "overflow": np.int32, "bad_dst": np.int32,
    "bad_delay": np.int32, "short_delay": np.int32, "route_drop": np.int32,
    "delivered": np.int64, "steps": np.int64, "time": np.int64,
    "ev_time": np.int64, "ev_meta": np.int32, "ev_count": np.int64,
    "fault_dropped": np.int32, "restart_done": np.bool_,
}

#: the same for ``EdgeState``
EDGE_LEAF_DTYPES = {
    "wake": np.int64, "q_rel": np.int32, "q_step": np.int32,
    "q_pay": np.int32, "overflow": np.int32, "unrouted": np.int32,
    "misrouted": np.int32, "bad_delay": np.int32, "delivered": np.int64,
    "steps": np.int64, "time": np.int64, "fault_dropped": np.int32,
    "restart_done": np.bool_,
}


def _u32_names(scenario) -> tuple:
    return () if scenario is None else tuple(scenario.u32_states)


def _tensor(name: str, a, device, want) -> torch.Tensor:
    """``want`` is the leaf's dtype, np.uint32 for a word leaf, or None
    for a ``states`` leaf that is not one."""
    arr = np.array(a)          # a writable, contiguous copy
    if want is None and arr.dtype == np.uint32:
        raise ValueError(f"leaf {name!r} is uint32 but the scenario does "
                         "not declare it in u32_states")
    if want is not None and arr.dtype != want:
        raise ValueError(f"leaf {name!r} has dtype {arr.dtype}, expected "
                         f"{np.dtype(want)}")
    if want is np.uint32:
        arr = arr.astype(np.int64)
    return torch.from_numpy(arr).to(device)


def _from_numpy(cls, dtypes, leaves, device, scenario):
    names = set(cls._fields)
    if set(leaves) != names:
        raise ValueError(
            f"state leaves differ from {cls.__name__}'s: missing "
            f"{sorted(names - set(leaves))}, extra "
            f"{sorted(set(leaves) - names)}")
    device = torch.device(device)
    words = _u32_names(scenario)
    return cls(**{
        name: ({k: _tensor(f"states.{k}", v, device,
                           np.uint32 if k in words else None)
                for k, v in leaves[name].items()} if name == "states"
               else _tensor(name, leaves[name], device, dtypes[name]))
        for name in cls._fields})


def _word_array(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.cpu().numpy()
    if a.dtype != np.int64 or (a.size and (a.min() < 0 or a.max() >= 2**32)):
        raise ValueError(f"leaf {name!r} is not an int64 word in "
                         "[0, 2**32)")
    return a.astype(np.uint32)


def _to_numpy(state, scenario) -> Dict[str, object]:
    words = _u32_names(scenario)
    return {name: ({k: (_word_array(f"states.{k}", v) if k in words
                        else v.cpu().numpy())
                    for k, v in state.states.items()}
                   if name == "states" else getattr(state, name).cpu().numpy())
            for name in state._fields}


def state_from_numpy(leaves: Dict[str, object], device,
                     scenario=None) -> EngineState:
    """The port's state from a reference ``EngineState``'s numpy leaves,
    solo or a fleet's (a leading world axis B on every leaf). The
    ``scenario``'s ``u32_states`` leaves must be uint32; they become int64
    words. The event ring carries across at any capacity E (``ev_time``
    ``[(B,) E]``, ``ev_meta`` ``[(B,) 4, E]``)."""
    st = _from_numpy(EngineState, LEAF_DTYPES, leaves, device, scenario)
    lead = tuple(st.ev_count.shape)
    E = st.ev_time.shape[-1] if st.ev_time.dim() == len(lead) + 1 else -1
    if tuple(st.ev_meta.shape) != lead + (4, E) or len(lead) > 1:
        raise ValueError(
            f"event ring leaves disagree: ev_time {tuple(st.ev_time.shape)}"
            f", ev_meta {tuple(st.ev_meta.shape)}, ev_count "
            f"{tuple(st.ev_count.shape)} (want [(B,) E], [(B,) 4, E], "
            "[(B,)])")
    return st


def state_to_numpy(state: EngineState, scenario=None) -> Dict[str, object]:
    """The port's state as numpy leaves (``states`` a dict); the
    ``scenario``'s ``u32_states`` leaves go back to uint32."""
    return _to_numpy(state, scenario)


def edge_state_from_numpy(leaves: Dict[str, object], device,
                          scenario=None) -> EdgeState:
    """The port's edge state from a reference ``EdgeState``'s numpy
    leaves, checked as :func:`state_from_numpy` checks."""
    return _from_numpy(EdgeState, EDGE_LEAF_DTYPES, leaves, device, scenario)


def edge_state_to_numpy(state: EdgeState,
                        scenario=None) -> Dict[str, object]:
    """The port's edge state as numpy leaves (``states`` a dict)."""
    return _to_numpy(state, scenario)

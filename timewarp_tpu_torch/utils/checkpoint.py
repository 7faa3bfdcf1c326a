"""Checkpoint/resume to disk (port of ``timewarp_tpu/utils/checkpoint.py``).

An engine's complete simulation state (``EngineState`` or ``EdgeState``,
solo or a fleet's) is written as the reference's ``.npz`` layout, so a
checkpoint written by either package resumes bit-identically under the
other: the arrays ``leaf_0 .. leaf_{n-1}`` in the reference's flattening
order (the state's fields in order, the ``states`` dict by sorted key),
``__leafsha__`` (the sha256 of each leaf's bytes, checked at load),
``__treedef__`` (the string the reference's ``jax.tree.flatten`` prints
for the state, written here without JAX), ``__meta__`` (JSON) and
``__n__``.

A scenario's ``u32_states`` (Praos' ``thr``) are uint32 on disk, as the
reference holds them, and int64 words in the port: pass ``scenario=`` to
map them both ways (state_io.py's mapping). The one sanctioned dtype
conversion at load is the reference's lossless int32 → int64 widening of
a same-shape leaf; :func:`load_world_state` also grows a world's
``restart_done`` ledger to a template with more fault rows. Anything else
that differs from the template — leaf count, tree, shape, dtype, a leaf's
digest — is refused loudly.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import zipfile
from typing import Any, List, Tuple

import numpy as np
import torch

__all__ = ["save_state", "load_state", "load_world_state", "atomic_write",
           "treedef_string"]

#: the layout every actionable corrupt-load error names
_LAYOUT = ("an .npz holding leaf_0..leaf_{n-1} state arrays plus "
           "__treedef__/__meta__/__n__/__leafsha__ headers, written "
           "by save_state")


def atomic_write(path: str, write_fn, mode: str = "wb") -> None:
    """Crash- and race-safe file replacement: ``write_fn(f)`` writes into
    a unique same-directory temp file, which is fsync'd then
    ``os.replace``-d over ``path``. A reader or a crash sees the previous
    file or the new one, never a torn one."""
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(os.path.abspath(path)),
        prefix=os.path.basename(path) + ".tmp.")
    try:
        with os.fdopen(fd, mode) as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _leaves(state) -> List[Tuple[str, torch.Tensor]]:
    """``(name, tensor)`` of every leaf in the reference's flattening
    order: fields in order, the ``states`` dict by sorted key."""
    out = []
    for f, x in zip(state._fields, state):
        if isinstance(x, dict):
            out += [(f"{f}.{k}", x[k]) for k in sorted(x)]
        else:
            out.append((f, x))
    return out


def treedef_string(state) -> str:
    """The reference's ``str(treedef)`` of ``state``'s type and states
    keys, e.g. ``PyTreeDef(CustomNode(namedtuple[EngineState],
    [{'hop': *, ...}, *, ...]))``."""
    parts = []
    for x in state:
        if isinstance(x, dict):
            parts.append("{" + ", ".join(f"{k!r}: *" for k in sorted(x))
                         + "}")
        else:
            parts.append("*")
    return (f"PyTreeDef(CustomNode(namedtuple[{type(state).__name__}], "
            f"[{', '.join(parts)}]))")


def _u32(scenario) -> set:
    return set() if scenario is None else \
        {f"states.{k}" for k in scenario.u32_states}


def _to_disk(name: str, x: torch.Tensor, words: set) -> np.ndarray:
    a = x.detach().cpu().numpy()
    if name not in words:
        return a
    if a.dtype != np.int64 or (a.size and (a.min() < 0 or a.max() >= 2**32)):
        raise ValueError(f"leaf {name!r} is not an int64 word in "
                         "[0, 2**32)")
    return a.astype(np.uint32)


def save_state(path: str, state: Any, *, meta: dict = None,
               scenario=None) -> None:
    """Write ``state`` to ``path`` (.npz, the reference's layout), its
    ``scenario``'s ``u32_states`` as uint32. ``meta`` (JSON-able) rides
    along. The write is atomic (:func:`atomic_write`)."""
    words = _u32(scenario)
    leaves = _leaves(state)
    arrays = {f"leaf_{i}": _to_disk(name, x, words)
              for i, (name, x) in enumerate(leaves)}
    arrays["__leafsha__"] = np.frombuffer(json.dumps(
        [hashlib.sha256(arrays[f"leaf_{i}"].tobytes()).hexdigest()
         for i in range(len(leaves))]).encode(), dtype=np.uint8)
    arrays["__treedef__"] = np.frombuffer(
        treedef_string(state).encode(), dtype=np.uint8)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    arrays["__n__"] = np.asarray(len(leaves))
    atomic_write(path, lambda f: np.savez(f, **arrays))


def _read_verified(path: str):
    """The shared raw read behind :func:`load_state` and
    :func:`load_world_state`: parse the layout, verify every leaf's
    recorded sha256, and return ``(leaves, saved_treedef, meta)``."""
    try:
        with np.load(path) as z:
            n = int(z["__n__"])
            meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
            saved_treedef = bytes(z["__treedef__"].tobytes()).decode()
            leaves = [z[f"leaf_{i}"] for i in range(n)]
            leaf_sha = (json.loads(bytes(
                z["__leafsha__"].tobytes()).decode())
                if "__leafsha__" in z.files else None)
    except (FileNotFoundError, PermissionError, IsADirectoryError):
        raise
    except (KeyError, ValueError, OSError, EOFError,
            zipfile.BadZipFile, json.JSONDecodeError) as e:
        raise ValueError(
            f"checkpoint {path!r} is truncated or corrupt "
            f"({type(e).__name__}: {e}); expected layout: {_LAYOUT}. "
            f"Delete the file and resume from an earlier checkpoint "
            f"or re-run from the scenario start.") from e
    if leaf_sha is not None:
        if len(leaf_sha) != n:
            raise ValueError(
                f"checkpoint {path!r} records {len(leaf_sha)} leaf "
                f"digests for {n} leaves; expected layout: {_LAYOUT}")
        for i, got in enumerate(leaves):
            actual = hashlib.sha256(
                np.ascontiguousarray(got).tobytes()).hexdigest()
            if actual != leaf_sha[i]:
                raise ValueError(
                    f"checkpoint {path!r} leaf {i} failed its "
                    f"recorded sha256 digest (expected "
                    f"{leaf_sha[i][:16]}…, actual {actual[:16]}…): "
                    "the state bytes were corrupted on disk — delete "
                    "the file and resume from an earlier verified "
                    "checkpoint")
    return leaves, saved_treedef, meta


def _template(like, leaves, saved_treedef, words: set):
    """The template's leaves as ``(shape, disk dtype)``, after the count
    and tree checks."""
    t_leaves = _leaves(like)
    if len(t_leaves) != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, template "
                         f"has {len(t_leaves)}")
    want = treedef_string(like)
    if saved_treedef != want:
        # same leaf count and shapes under another tree would resume with
        # fields silently swapped
        raise ValueError(
            f"checkpoint tree structure does not match template:\n"
            f"  saved:    {saved_treedef}\n  template: {want}")
    return [(tuple(x.shape), np.dtype(np.uint32) if name in words else
             torch.empty((), dtype=x.dtype).numpy().dtype)
            for name, x in t_leaves]


def _rebuild(like, arrays: List[np.ndarray], words: set):
    """A state of ``like``'s type and device from disk arrays in leaf
    order (uint32 words back to int64)."""
    by_name = dict(zip((name for name, _ in _leaves(like)), arrays))

    def tensor(name, dev):
        a = by_name[name]
        if name in words:
            a = a.astype(np.int64)
        return torch.from_numpy(np.array(a)).to(dev)
    return type(like)(**{
        f: ({k: tensor(f"{f}.{k}", v.device) for k, v in x.items()}
            if isinstance(x, dict) else tensor(f, x.device))
        for f, x in zip(like._fields, like)})


def load_state(path: str, like: Any, *, expect_meta: dict = None,
               scenario=None):
    """Read a state saved by :func:`save_state` (or by the reference's).
    ``like`` is a template of the same structure (e.g.
    ``engine.init_state()``), whose shapes and dtypes the leaves are
    checked against; the state lands on its devices. Returns ``(state,
    meta)``."""
    words = _u32(scenario)
    leaves, saved_treedef, meta = _read_verified(path)
    tmpl = _template(like, leaves, saved_treedef, words)
    for i, (got, (shape, dt)) in enumerate(zip(leaves, tmpl)):
        if got.shape == shape and got.dtype == np.int32 and dt == np.int64:
            # the sanctioned lossless widening (module docstring)
            leaves[i] = got.astype(np.int64)
            continue
        if got.shape != shape or got.dtype != dt:
            raise ValueError(
                f"checkpoint leaf {i}: {got.shape}/{got.dtype} does not "
                f"match template {shape}/{dt}")
    if expect_meta:
        for k, v in expect_meta.items():
            if meta.get(k) != v:
                raise ValueError(
                    f"checkpoint meta mismatch: {k}={meta.get(k)!r}, "
                    f"expected {v!r}")
    return _rebuild(like, leaves, words), meta


def load_world_state(path: str, like: Any, world: int, *, scenario=None):
    """Read ONE world's slice of a fleet's checkpoint: ``like`` is a
    solo-shaped template, and every saved leaf must carry its shape
    behind one shared leading world axis. Two sanctioned conversions,
    both exact: the int32 → int64 widening, and fault-row growth — a 1-D
    bool leaf (the ``restart_done`` ledger) whose template has more rows
    than the checkpoint pads with False (new crash rows start with their
    restart unconsumed). Returns ``(state, meta)``, the state solo-shaped
    — the reference's counterfactual-forking loader."""
    words = _u32(scenario)
    leaves, saved_treedef, meta = _read_verified(path)
    tmpl = _template(like, leaves, saved_treedef, words)
    if not leaves:
        raise ValueError(f"checkpoint {path!r} holds no state leaves")
    B = int(leaves[0].shape[0]) if leaves[0].ndim else 0
    if B < 1:
        raise ValueError(
            f"checkpoint {path!r} is not a batched state (leaf 0 has "
            f"no leading world axis) — load_world_state slices a "
            "world axis; solo checkpoints load via load_state")
    w = int(world)
    if not 0 <= w < B:
        raise ValueError(
            f"world {w} out of range for a {B}-world checkpoint {path!r}")
    out = []
    for i, (got, (shape, dt)) in enumerate(zip(leaves, tmpl)):
        if got.ndim != len(shape) + 1 or got.shape[0] != B:
            raise ValueError(
                f"checkpoint leaf {i}: {got.shape}/{got.dtype} is not "
                f"a [{B}, ...] world-stacked form of the solo "
                f"template {shape}/{dt}")
        sl = got[w]
        if sl.shape == shape and sl.dtype == np.int32 and dt == np.int64:
            sl = sl.astype(np.int64)    # the sanctioned widening
        elif sl.dtype == np.bool_ and dt == np.bool_ and sl.ndim == 1 \
                and len(shape) == 1 and sl.shape[0] < shape[0]:
            grown = np.zeros(shape, np.bool_)
            grown[:sl.shape[0]] = sl
            sl = grown
        if sl.shape != shape or sl.dtype != dt:
            raise ValueError(
                f"checkpoint leaf {i} world {w}: {sl.shape}/{sl.dtype}"
                f" does not match template {shape}/{dt}")
        out.append(sl)
    return _rebuild(like, out, words), meta

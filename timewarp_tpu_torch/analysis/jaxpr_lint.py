"""Graph contract lints: check a scenario's step function *before* any
engine run (port of ``timewarp_tpu/analysis/jaxpr_lint.py``; the graph
here is an aten graph, not a jaxpr — the module keeps the reference's
name and entry points).

A host read or an int32 time truncation inside a user step function
otherwise surfaces as a parity digest mismatch thousands of supersteps
into a million-node run. This module traces ``Scenario.step`` with
``torch.fx.experimental.proxy_tensor.make_fx(tracing_mode="fake")``
under the engines' batched layout (core/scenario.py) at a fixed tiny
node count :data:`LINT_NODES` — inbox leaves ``[K, L]`` (payload
``[K, P, L]``), int64 ``now [L]``, int32 node ids ``[L]``, the
``fire_bits`` pair of int64 words ``[L]`` — so the cost does not grow
with ``n_nodes`` and nothing runs on any device. It checks:

- **TW101** host escapes: ``aten._local_scalar_dense`` nodes — a value
  read back to the host as data (``.item()``, ``.tolist()``,
  ``int(t)`` feeding arithmetic), the aten counterpart of the
  reference's ``pure_callback``/``io_callback``/``debug_callback``. A
  Python *branch* on a value cannot be traced at all (the fake trace
  raises a data-dependent guard error) and is TW100, as an untraceable
  step is in the reference; so is ``.numpy()`` on a traced value.
- **TW102/TW103** time-dtype discipline: the time inputs (``now``,
  ``inbox.time`` and the int64 state leaves, the ``u32_states`` words
  excepted) are tainted, and the taint flows through every node whose
  output stays a 64-bit integer (index outputs — ``argmin``,
  ``searchsorted``, a sort's permutation — drop it, as comparisons do).
  A tainted node with a narrower integer output is a truncation
  (TW102), one with a float output a promotion (TW103, true division
  and float scalars included). The port's steps carry more int64 than
  time (the ``u32_states`` words, the ``fire_bits`` pair, LCG words),
  which is why the taint starts at the time inputs instead of marking
  every int64 value as the reference's per-node jaxpr can.
- **TW104** ``wake`` must be int64 ``[L]`` (the engine compares it
  against ``NEVER = 2^62-1``).
- **TW105** outbox conformance: ``valid`` bool ``[M, L]``, ``dst``
  integer ``[M, L]``, ``payload`` int32 ``[M, P, L]``.
- **TW106** state stability: the step returns the state dict it was
  given, key for key, each leaf's shape and dtype kept.
- **TW107–TW110** declared-flag dataflow: ``needs_key=False`` ⇔ the
  ``bits`` placeholders have no users in the graph, ``inbox_src=False``
  ⇔ ``inbox.src`` has none. A false ``False`` is an error, a
  conservative ``True`` over an unused input a perf warning.

The trace is made once per scenario object and shared with the TW7xx
step scan (determinism.py). All checks are abstract — nothing is
executed, so ``lint="warn"`` engine construction cannot change run
behavior.
"""

from __future__ import annotations

import logging
from contextlib import contextmanager
from typing import Any, Dict, List, NamedTuple, Optional, Set

import torch

from ..core.scenario import Inbox, Scenario
from .report import ERROR, INFO, WARNING, Finding, LintReport

__all__ = ["lint_step_jaxpr", "HOST_ESCAPE_PRIMITIVES", "LINT_NODES",
           "op_name", "trace_graph", "step_graph"]

#: aten ops whose presence in a traced graph is a host escape: a value
#: read back to the host (``.item()``, ``.tolist()``, ``int(t)``)
HOST_ESCAPE_PRIMITIVES = frozenset({"aten._local_scalar_dense",
                                    "aten.item"})

#: the node count the step is traced at
LINT_NODES = 4

#: ops whose outputs are positions or read only their input's shape,
#: not its values: they drop the time taint
INDEX_OPS = frozenset({
    "aten.argmin", "aten.argmax", "aten.argsort", "aten.searchsorted",
    "aten.bucketize", "aten.nonzero", "aten.nonzero_static",
    "aten.sym_size", "aten.sym_numel", "aten.full_like",
    "aten.zeros_like", "aten.ones_like", "aten.empty_like",
    "aten.new_full", "aten.new_zeros", "aten.new_ones",
    "aten.new_empty"})

#: multi-output ops whose second output is an index (sort's permutation,
#: topk's and the reductions' positions)
VALUE_INDEX_OPS = frozenset({
    "aten.sort", "aten.topk", "aten.max", "aten.min", "aten.kthvalue",
    "aten.mode", "aten.cummax", "aten.cummin", "aten.median",
    "aten.nanmedian"})

_CPU = torch.device("cpu")


def op_name(node) -> str:
    """``"aten.add"``-style name of a graph node's target (namespace and
    op, no overload); the Python name for other callables."""
    t = node.target
    pkt = getattr(t, "_overloadpacket", None)
    if pkt is not None:
        return f"{t.namespace}.{pkt.__name__}"
    return getattr(t, "__name__", str(t))


@contextmanager
def _quiet_fake_errors():
    """The fake-tensor machinery logs every failing op at ERROR before
    raising; a lint that expects (and reports) such failures keeps the
    log clean."""
    names = ("torch._subclasses.fake_tensor", "torch.fx.experimental."
             "symbolic_shapes", "torch.fx.experimental.recording")
    loggers = [logging.getLogger(n) for n in names]
    levels = [lg.level for lg in loggers]
    for lg in loggers:
        lg.setLevel(logging.CRITICAL)
    try:
        yield
    finally:
        for lg, lv in zip(loggers, levels):
            lg.setLevel(lv)


def trace_graph(fn, args):
    """``fn(*args)`` traced into an aten ``GraphModule`` under fake
    tensors (never executed); real tensors ``fn`` closes over become
    graph constants."""
    from torch.fx.experimental.proxy_tensor import make_fx
    with _quiet_fake_errors():
        return make_fx(fn, tracing_mode="fake",
                       _allow_non_fake_inputs=True)(*args)


def _val(node):
    return node.meta.get("val") if hasattr(node, "meta") else None


def _dtype(node) -> Optional[torch.dtype]:
    v = _val(node)
    return v.dtype if isinstance(v, torch.Tensor) else None


def _is_int(dt) -> bool:
    return dt is not None and dt != torch.bool \
        and not dt.is_floating_point and not dt.is_complex


def _in_nodes(node) -> List[Any]:
    out: List[Any] = []
    torch.fx.node.map_arg((node.args, node.kwargs), out.append)
    return out


# ----------------------------------------------------------------------
# the step's trace (shared with determinism.py)
# ----------------------------------------------------------------------

class StepGraph(NamedTuple):
    """One trace of ``Scenario.step``: the graph, its placeholders by
    role, the example inputs' state leaves and the traced outputs."""
    gm: Any
    keys: tuple               # the state dict's keys, in order
    states: Dict[str, torch.Tensor]
    ph: Dict[str, Any]        # role -> placeholder node(s)
    out: Any                  # (states', outbox, wake) of fake tensors
    key_traced: bool


def _lint_states(sc: Scenario, L: int):
    """The initial states' dtypes and trailing shapes at ``L`` nodes:
    read off ``init_batched`` under fake tensors (nothing allocated at
    ``n_nodes``), or from a real call when the builder cannot run
    fake."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    try:
        with _quiet_fake_errors(), \
                FakeTensorMode(allow_non_fake_inputs=True):
            states, _ = sc.init_batched(sc.n_nodes, _CPU)
            meta = {k: (v.dtype, tuple(v.shape[1:]))
                    for k, v in states.items()}
    except Exception:  # noqa: BLE001 — fall back to a real call
        states, _ = sc.init_batched(sc.n_nodes, _CPU)
        meta = {k: (v.dtype, tuple(v.shape[1:]))
                for k, v in states.items()}
    return {k: torch.zeros((L,) + shp, dtype=dt)
            for k, (dt, shp) in meta.items()}


def _trace_step(sc: Scenario, with_key: bool) -> StepGraph:
    L = min(sc.n_nodes, LINT_NODES)
    K, P = sc.mailbox_cap, sc.payload_width
    states = _lint_states(sc, L)
    keys = tuple(states)
    ns = len(keys)
    inbox = Inbox(valid=torch.zeros((K, L), dtype=torch.bool),
                  src=torch.zeros((K, L), dtype=torch.int32),
                  time=torch.zeros((K, L), dtype=torch.int64),
                  payload=torch.zeros((K, P, L), dtype=torch.int32))
    flat = [states[k] for k in keys] + list(inbox) + [
        torch.zeros(L, dtype=torch.int64),
        torch.arange(L, dtype=torch.int32)]
    if with_key:
        flat += [torch.zeros(L, dtype=torch.int64),
                 torch.zeros(L, dtype=torch.int64)]
    box: Dict[str, Any] = {}

    def f(*xs):
        st = dict(zip(keys, xs[:ns]))
        bits = (xs[ns + 6], xs[ns + 7]) if with_key else None
        out = sc.step(st, Inbox(*xs[ns:ns + 4]), xs[ns + 4], xs[ns + 5],
                      bits)
        box["out"] = out
        leaves = torch.utils._pytree.tree_leaves(out)
        return [x for x in leaves if isinstance(x, torch.Tensor)]

    gm = trace_graph(f, flat)
    phs = [n for n in gm.graph.nodes if n.op == "placeholder"]
    ph = {"states": phs[:ns], "valid": phs[ns], "src": phs[ns + 1],
          "time": phs[ns + 2], "payload": phs[ns + 3], "now": phs[ns + 4],
          "ids": phs[ns + 5], "bits": phs[ns + 6:ns + 8]}
    return StepGraph(gm, keys, states, ph, box.get("out"), with_key)


def step_graph(sc: Scenario) -> StepGraph:
    """The step's trace under the engines' conventions, made once per
    scenario object (cached on it). Raises what the trace raised; a
    ``needs_key=False`` step that needs ``bits=None`` is traced so, as
    the engines call it."""
    got = getattr(sc, "_lint_step_graph", None)
    if got is not None:
        if isinstance(got, Exception):
            raise got
        return got
    try:
        try:
            got = _trace_step(sc, True)
        except Exception:
            if sc.needs_key:
                raise
            got = _trace_step(sc, False)
    except Exception as e:  # noqa: BLE001 — cached, re-raised per caller
        got = e
    try:
        sc._lint_step_graph = got
    except Exception:  # noqa: BLE001 — cache is best-effort
        pass
    if isinstance(got, Exception):
        raise got
    return got


# ----------------------------------------------------------------------
# time-dtype taint
# ----------------------------------------------------------------------

def _taint(gm, seeds: Set[Any]) -> Dict[str, int]:
    """Propagate the time taint through ``gm`` in graph order; count
    the truncating and float-promoting nodes."""
    tainted = set(seeds)
    hits = {"truncate": 0, "float": 0}
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        ins = [a for a in _in_nodes(node) if a in tainted]
        if not ins:
            continue
        name = op_name(node)
        if name == "getitem":
            parent, idx = node.args[0], node.args[1]
            if op_name(parent) in VALUE_INDEX_OPS and idx != 0:
                continue
        elif name in INDEX_OPS:
            continue
        dt = _dtype(node)
        if dt is None:
            # a multi-output node: its getitems read the taint off it
            if isinstance(_val(node), (tuple, list)):
                tainted.add(node)
            continue
        if dt.is_floating_point:
            hits["float"] += 1
        elif _is_int(dt) and dt.itemsize < 8:
            hits["truncate"] += 1
        elif _is_int(dt):
            tainted.add(node)
    return hits


# ----------------------------------------------------------------------
# entry point
# ----------------------------------------------------------------------

def lint_step_jaxpr(sc: Scenario) -> LintReport:
    """Trace ``sc.step`` abstractly and run every graph contract lint.
    Never executes the step; never raises on untraceable steps (the
    engine's own run produces the authoritative error — TW100 marks the
    lint as unable to look inside)."""
    rep = LintReport()
    name = sc.name
    M, P = sc.max_out, sc.payload_width
    L = min(sc.n_nodes, LINT_NODES)
    try:
        g = step_graph(sc)
    except Exception as e:  # noqa: BLE001 — lint must not crash callers
        rep.add(Finding("TW100", WARNING, name,
                        "step is not traceable under the engine "
                        f"conventions ({e!r:.300}); graph lints skipped"))
        return rep
    gm = g.gm

    # -- TW101: host escapes ---------------------------------------------
    escapes: Dict[str, int] = {}
    for node in gm.graph.nodes:
        if node.op == "call_function":
            nm = op_name(node)
            if nm in HOST_ESCAPE_PRIMITIVES:
                escapes[nm] = escapes.get(nm, 0) + 1
    for prim, cnt in sorted(escapes.items()):
        rep.add(Finding(
            "TW101", ERROR, name,
            f"step contains host-escape op {prim!r} (x{cnt}): a value "
            "read back to the host has no deterministic virtual-time "
            "meaning, breaks oracle/engine parity and stalls the "
            "device queue — compute inside the step or precompute "
            "into state"))

    # -- TW107..TW110: declared-flag dataflow ----------------------------
    if g.key_traced:
        key_used = any(len(p.users) for p in g.ph["bits"])
        if key_used and not sc.needs_key:
            rep.add(Finding(
                "TW107", ERROR, name,
                "needs_key=False but the step consumes its bits input; "
                "engines pass bits=None for this flag, so the run would "
                "crash (or silently use garbage). Declare "
                "needs_key=True"))
        elif not key_used and sc.needs_key:
            rep.add(Finding(
                "TW108", WARNING, name,
                "needs_key=True but the bits input has no consumers in "
                "the graph: engines derive per-(node, instant) threefry "
                "entropy every superstep for nothing. Declare "
                "needs_key=False"))
    src_used = len(g.ph["src"].users) > 0
    if src_used and not sc.inbox_src:
        rep.add(Finding(
            "TW109", ERROR, name,
            "inbox_src=False but the step reads inbox.src; engines "
            "elide the src mailbox plane for this flag and present "
            "zeros — sender identity would silently diverge between "
            "interpreters. Declare inbox_src=True"))
    elif not src_used and sc.inbox_src:
        rep.add(Finding(
            "TW110", WARNING, name,
            "inbox.src has no consumers in the graph but "
            "inbox_src=True: the engines carry and insert the mailbox "
            "src plane for a field the step never reads. Declare "
            "inbox_src=False"))

    # -- TW102/TW103: time-dtype taint -----------------------------------
    u32 = set(getattr(sc, "u32_states", ()) or ())
    seeds = {g.ph["now"], g.ph["time"]}
    for k, p in zip(g.keys, g.ph["states"]):
        if g.states[k].dtype == torch.int64 and k not in u32:
            seeds.add(p)
    hits = _taint(gm, seeds)
    if hits["truncate"]:
        rep.add(Finding(
            "TW102", ERROR, name,
            f"int64 time value truncated to a narrower integer dtype "
            f"({hits['truncate']} node(s) in the step graph): virtual "
            "time exceeds int32 after ~35 minutes; keep wake/inbox.time "
            "arithmetic in int64"))
    if hits["float"]:
        rep.add(Finding(
            "TW103", ERROR, name,
            f"int64 time value promoted to float ({hits['float']} "
            "node(s) in the step graph): float time breaks the "
            "bit-exact cross-backend contract (core/time.py — int64 µs "
            "only). Check for float literals or true division in time "
            "arithmetic"))

    # -- output conformance ----------------------------------------------
    out = g.out
    try:
        state_out, ob, wake = out
    except (TypeError, ValueError):
        rep.add(Finding(
            "TW105", ERROR, name,
            "step must return (states', outbox, wake); got "
            f"{type(out).__name__}"))
        return rep

    # TW104: wake int64 [L]
    wdt = getattr(wake, "dtype", None)
    wshape = tuple(getattr(wake, "shape", ()))
    if wshape != (L,) or wdt != torch.int64:
        rep.add(Finding(
            "TW104", ERROR, name,
            f"wake must be int64 [n] (got shape {wshape} at n={L}, "
            f"dtype {wdt}): the engine clamps it against NEVER = "
            "2^62-1, which no narrower dtype can represent"))

    # TW105: outbox conformance
    if not (hasattr(ob, "valid") and hasattr(ob, "dst")
            and hasattr(ob, "payload")):
        rep.add(Finding(
            "TW105", ERROR, name,
            "second return value must be an Outbox(valid, dst, "
            f"payload); got {type(ob).__name__}"))
    else:
        int_dts = (torch.int32, torch.int64, torch.int16, torch.int8)
        checks = [("valid", ob.valid, (M, L), (torch.bool,)),
                  ("dst", ob.dst, (M, L), int_dts),
                  ("payload", ob.payload, (M, P, L), (torch.int32,))]
        for fname, leaf, want_shape, want_dts in checks:
            shape = tuple(getattr(leaf, "shape", ()))
            dt = getattr(leaf, "dtype", None)
            if shape != want_shape:
                rep.add(Finding(
                    "TW105", ERROR, name,
                    f"outbox.{fname} shape {shape} != {want_shape} "
                    f"(max_out={M}, payload_width={P}, n={L}): the "
                    "routing sorts and mailbox inserts are built for "
                    "the declared widths"))
            elif dt not in want_dts:
                rep.add(Finding(
                    "TW105", ERROR, name,
                    f"outbox.{fname} dtype {dt} is not "
                    f"{'/'.join(str(d) for d in want_dts)}: engines "
                    "insert payloads into int32 mailbox planes and "
                    "read dst as an integer index"))
            elif fname == "dst" and dt != torch.int32:
                rep.add(Finding(
                    "TW105", INFO, name,
                    f"outbox.dst dtype {dt}; engines convert to int32 "
                    "every superstep — emit int32 directly"))

    # TW106: state stability
    if not isinstance(state_out, dict) \
            or set(state_out) != set(g.keys):
        got_keys = tuple(state_out) if isinstance(state_out, dict) \
            else type(state_out).__name__
        rep.add(Finding(
            "TW106", ERROR, name,
            f"state structure changes across step ({g.keys} -> "
            f"{got_keys}); the engines carry the state dict leaf for "
            "leaf"))
    else:
        for i, k in enumerate(g.keys):
            a, b = g.states[k], state_out[k]
            bshape = tuple(getattr(b, "shape", ()))
            if tuple(a.shape) != bshape \
                    or a.dtype != getattr(b, "dtype", None):
                rep.add(Finding(
                    "TW106", ERROR, name,
                    f"state leaf #{i} ({k!r}) changes shape/dtype "
                    f"across step ({tuple(a.shape)}/{a.dtype} -> "
                    f"{bshape}/{getattr(b, 'dtype', None)}); the "
                    "engines carry shape/dtype-stable states"))
    return rep

"""Determinism sanitizer (TW7xx): graph-level bit-exactness threats (port
of ``timewarp_tpu/analysis/determinism.py`` over aten graphs).

Runs must be bit-identical across engines, fleets, checkpoints and
devices (core/scenario.py's contract; every law test compares digests).
Four op families are known to break that silently. Their aten
counterparts of the reference's jaxpr primitives:

- **TW701** (error) — unordered float reductions: ``index_add``,
  ``scatter_add``, ``scatter_reduce`` (sum/prod/mean), ``index_reduce``
  and ``index_put`` with ``accumulate=True`` over a floating operand
  (duplicate indices accumulate in an implementation-defined order;
  CUDA's atomics in a run-dependent one), and a float
  ``all_reduce`` (the reference's ``scatter-add``/``scatter-mul``/
  ``psum``). Integer accumulation is exact and commutative: not
  flagged.
- **TW702** (warning) — platform-dependent transcendentals over floats
  (``exp``, ``log``, ``sin``, ``cos``, ``tanh``, ``erf``, ``pow``,
  ``sigmoid``, ``softmax``, ...): each library rounds the last ulp its
  own way. The shipped heavy-tail samplers (net/delays.py) use them
  and re-quantize to int64 µs, the documented discipline.
- **TW703** (error) — randomness that is not the port's counter-based
  threefry2x32 (core/rng.py): ``rand``/``randn``/``randint``/
  ``randperm``, ``bernoulli``, ``normal``, ``multinomial``,
  ``uniform_``, ``exponential_`` and the other stateful generators
  (the reference's ``rng_bit_generator``, ``rng_uniform`` and
  non-``fry`` typed keys): their streams depend on the device and the
  generator state.
- **TW704** (error) — host escapes reachable from traced engine code:
  ``aten._local_scalar_dense`` (a value read back, as jaxpr_lint.py's
  TW101) and copies from the card to the host.

Two scan surfaces share the checks: :func:`lint_step_determinism` scans
a scenario's step graph (the trace jaxpr_lint.py made, so it rides
every engine construction), and :func:`lint_engine_jaxpr` scans a built
engine's superstep body — everything the engine adds around the step.
The body is what one superstep of the run loop executes after the
pop-min's one host read (``engine._lint_body``: ``TorchEngine``'s
``_pop`` + ``_superstep``, ``EdgeEngine``'s ``_superstep`` with the
read left out, ``FusedRingEngine``'s K4 launch), the counterpart of the
reference's ``_step_all``; the kernels appear as their opaque ``tw.*``
nodes (interp/torch_engine/traced_ops.py), on the card and on the CPU
alike.

:func:`prove_mode_neutrality` (TW705) re-proves the off-mode pins: for
every observability/execution knob, an engine built with the knob
explicitly ``"off"`` must trace the same body graph as the baseline
engine, node for node.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core.scenario import Scenario
from .jaxpr_lint import (HOST_ESCAPE_PRIMITIVES, _dtype, _in_nodes,
                         _val, op_name, step_graph, trace_graph)
from .report import ERROR, INFO, WARNING, Finding, LintReport

__all__ = ["lint_step_determinism", "lint_engine_jaxpr",
           "prove_mode_neutrality", "scan_jaxpr_determinism",
           "UNORDERED_FLOAT_REDUCTIONS", "TRANSCENDENTALS",
           "NON_THREEFRY_RNG", "NEUTRAL_KNOBS"]

#: ops whose float accumulation order is implementation-defined
UNORDERED_FLOAT_REDUCTIONS = frozenset({
    "aten.index_add", "aten.scatter_add", "aten.scatter_reduce",
    "aten.index_reduce", "aten.index_put", "aten._index_put_impl",
    "aten.embedding_bag", "_c10d_functional.all_reduce",
    "c10d_functional.all_reduce", "c10d.allreduce"})

#: library-backed ops whose last-ulp behavior differs per platform
TRANSCENDENTALS = frozenset(f"aten.{n}" for n in (
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "sigmoid",
    "logit", "sin", "cos", "tan", "asin", "acos", "atan", "atan2",
    "sinh", "cosh", "tanh", "asinh", "acosh", "atanh", "erf", "erfc",
    "erfinv", "lgamma", "digamma", "polygamma", "pow", "float_power",
    "_softmax", "_log_softmax", "logsumexp", "logaddexp",
    "special_erfcx", "special_ndtri", "special_i0e", "special_i1e"))

#: random ops that are NOT the counter-based threefry of core/rng.py
NON_THREEFRY_RNG = frozenset(f"aten.{n}" for n in (
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "bernoulli", "normal", "multinomial", "uniform",
    "exponential", "geometric", "cauchy", "log_normal", "random",
    "poisson", "binomial", "_standard_gamma", "_sample_dirichlet",
    "native_dropout", "rrelu_with_noise"))


def _base(name: str) -> str:
    """An op's out-of-place name: ``aten.index_add_`` -> ``aten.index_add``
    (a leading underscore is part of the name)."""
    return name[:-1] if name.endswith("_") and not name.endswith("__") \
        else name


def _floating(node) -> bool:
    dt = _dtype(node)
    return dt is not None and dt.is_floating_point


def _accumulates(node, name: str) -> bool:
    """Does this reduction-family node accumulate (duplicate indices
    summed/multiplied, not overwritten or max/min-reduced)?"""
    if name in ("aten.index_put", "aten._index_put_impl"):
        acc = node.kwargs.get("accumulate",
                              node.args[3] if len(node.args) > 3 else False)
        return bool(acc)
    if name in ("aten.scatter_reduce", "aten.index_reduce"):
        red = node.kwargs.get("reduce",
                              node.args[4] if len(node.args) > 4 else "")
        return red in ("sum", "prod", "mean")
    return True


def _host_copy(node) -> bool:
    """A copy from the card to the host (``.cpu()``, ``.to("cpu")``)."""
    if op_name(node) not in ("aten._to_copy", "aten.copy"):
        return False
    out = _val(node)
    src = [a for a in _in_nodes(node) if isinstance(_val(a), torch.Tensor)]
    return isinstance(out, torch.Tensor) and out.device.type == "cpu" \
        and any(_val(a).device.type != "cpu" for a in src)


def scan_jaxpr_determinism(graph, subject: str, *,
                           host_escapes: bool = True) -> LintReport:
    """Scan one traced graph (a ``GraphModule`` or its ``Graph``) for the
    TW7xx op families. ``host_escapes=False`` skips TW704 (the step-level
    caller already reports TW101 for the same nodes)."""
    g = getattr(graph, "graph", graph)
    rep = LintReport()
    unordered: Dict[str, int] = {}
    transcend: Dict[str, int] = {}
    rng: Dict[str, int] = {}
    escapes: Dict[str, int] = {}
    for node in g.nodes:
        if node.op != "call_function":
            continue
        name = _base(op_name(node))
        if name in UNORDERED_FLOAT_REDUCTIONS:
            if _accumulates(node, name) and (
                    _floating(node) or any(_floating(a)
                                           for a in _in_nodes(node))):
                unordered[name] = unordered.get(name, 0) + 1
        elif name in TRANSCENDENTALS:
            if _floating(node):
                transcend[name] = transcend.get(name, 0) + 1
        elif name in NON_THREEFRY_RNG:
            rng[name] = rng.get(name, 0) + 1
        elif host_escapes and (name in HOST_ESCAPE_PRIMITIVES
                               or _host_copy(node)):
            key = name if name in HOST_ESCAPE_PRIMITIVES \
                else f"{name}(device -> host)"
            escapes[key] = escapes.get(key, 0) + 1
    for name, n in sorted(unordered.items()):
        rep.add(Finding(
            "TW701", ERROR, subject,
            f"unordered float reduction {name!r} (x{n}): float "
            "accumulation order is implementation-defined, so "
            "duplicate-index accumulations / cross-device sums produce "
            "different bits per device and run and break every digest "
            "law. Accumulate in integers (fixed-point) or pre-sort a "
            "unique-index scatter"))
    for name, n in sorted(transcend.items()):
        rep.add(Finding(
            "TW702", WARNING, subject,
            f"platform-dependent transcendental {name!r} (x{n}): "
            "library results differ in the last ulp across devices — "
            "deterministic per platform, not bit-stable across them. "
            "Quantize the result to integer µs before it re-enters "
            "virtual time (the shipped heavy-tail samplers' "
            "discipline, net/delays.py)"))
    for name, n in sorted(rng.items()):
        rep.add(Finding(
            "TW703", ERROR, subject,
            f"non-threefry randomness {name!r} (x{n}): its stream "
            "depends on the device and the generator's state; the "
            "framework's entropy is counter-based threefry2x32 "
            "(core/rng.py) so every device draws identical words — use "
            "the engine-provided bits"))
    for name, n in sorted(escapes.items()):
        rep.add(Finding(
            "TW704", ERROR, subject,
            f"host escape {name!r} (x{n}) reachable from traced engine "
            "code: a value read back to the host has no deterministic "
            "virtual-time meaning, escapes the replay/digest contract "
            "and stalls the device queue"))
    return rep


def lint_step_determinism(sc: Scenario) -> LintReport:
    """TW701-703 over a scenario's step graph (TW101 owns host escapes
    at this level). Untraceable steps are skipped silently — TW100
    (jaxpr_lint.py) already reports the trace failure."""
    try:
        g = step_graph(sc)
    except Exception:  # noqa: BLE001 — TW100 reported it
        return LintReport()
    return scan_jaxpr_determinism(g.gm, sc.name, host_escapes=False)


def _driver_graph(engine):
    """The engine's superstep body (``engine._lint_body``) traced from
    its initial state, with the trace plane on."""
    return trace_graph(lambda st: engine._lint_body(st),
                       [engine.init_state()])


def lint_engine_jaxpr(engine, subject: Optional[str] = None
                      ) -> LintReport:
    """TW701-704 over a built engine's superstep body — the step PLUS
    everything the engine wraps around it (routing, kernels, fault
    masks, observability planes)."""
    name = subject or type(engine).__name__
    try:
        gm = _driver_graph(engine)
    except Exception as e:  # noqa: BLE001 — report, never crash
        rep = LintReport()
        rep.add(Finding(
            "TW700", WARNING, name,
            f"engine body is not traceable under the sanitizer "
            f"({e!r:.300}); determinism scan skipped"))
        return rep
    return scan_jaxpr_determinism(gm, name)


#: the engine knobs whose "off" must trace the baseline body
NEUTRAL_KNOBS = ("telemetry", "record", "verify", "speculate")


def prove_mode_neutrality(build_engine, subject: str,
                          knobs: Tuple[str, ...] = NEUTRAL_KNOBS
                          ) -> LintReport:
    """TW705: ``build_engine(**kw)`` constructs one engine; for every
    knob, the engine built with the knob explicitly ``"off"`` must trace
    the same superstep body as the baseline (no-argument) build, node
    for node — the zero-overhead-off contract. One INFO proof on
    success; an ERROR naming the knob on any divergence."""
    rep = LintReport()
    try:
        base = _driver_graph(build_engine()).code
    except Exception as e:  # noqa: BLE001
        rep.add(Finding(
            "TW700", WARNING, subject,
            f"baseline engine failed to build/trace under the "
            f"neutrality proof ({e!r:.300}); TW705 skipped"))
        return rep
    bad = []
    for knob in knobs:
        try:
            off = _driver_graph(build_engine(**{knob: "off"})).code
        except TypeError:
            continue        # engine family without this knob
        except Exception as e:  # noqa: BLE001
            rep.add(Finding(
                "TW705", ERROR, subject,
                f"{knob}='off' engine failed to build/trace ({e!r:.300})"
                " — explicit off must be indistinguishable from the "
                "default"))
            bad.append(knob)
            continue
        if off != base:
            rep.add(Finding(
                "TW705", ERROR, subject,
                f"{knob}='off' traces a DIFFERENT superstep body than "
                "the baseline engine: the zero-overhead-off contract "
                "(docs/observability.md) requires the off mode to be "
                "graph-neutral — the plane is leaking into the "
                "superstep"))
            bad.append(knob)
    if not bad:
        rep.add(Finding(
            "TW705", INFO, subject,
            f"off-mode neutrality proof: {'/'.join(knobs)} off all "
            "trace node-for-node identical superstep bodies to the "
            "baseline (zero overhead off, generically re-proven)"))
    return rep

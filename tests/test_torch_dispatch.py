"""Controlled runs on the port (``timewarp_tpu_torch/dispatch/``,
``interp/torch_engine/controlled.py``) against the JAX package, mirroring
tests/test_zzzdispatch.py:

- ``TorchEngine`` threads the dynamic window (``_dyn_ok``): its decision
  trace equals ``JaxEngine(insert="xla", controller=...)``'s, decision
  for decision (knobs and the telemetry the controller read), solo, on a
  faulted fleet, and solo under a degradation window with the mailbox
  pressure that makes the controller narrow and re-widen the window; the
  reference ``EdgeEngine``'s likewise;
- the replay law: a fresh engine replaying the decision trace gives the
  same states, traces and checkpoint bytes;
- a faulted engine with a controller keeps the undegraded floor as its
  bound and takes the degraded floor per superstep (the clamp
  ``faults.apply.window_floor``); a static one takes it schedule-wide;
- ``FusedSparseEngine`` and ``EdgeEngine`` pin their knobs (window and
  rung recorded pinned; chunk boundaries change nothing);
- an auto controller without telemetry is refused; decision-trace
  validation is loud; decisions stream to the metrics registry as the
  reference's lines.

Tolerance: exact.
"""

import numpy as np
import pytest

import timewarp_tpu.dispatch as jdisp
import timewarp_tpu.faults as jf
from timewarp_tpu.interp.jax_engine.batched import BatchSpec as JSpec
from timewarp_tpu.interp.jax_engine.edge_engine import EdgeEngine as JEdge
from timewarp_tpu.interp.jax_engine.engine import JaxEngine
from timewarp_tpu.interp.jax_engine.fused_sparse import \
    FusedSparseEngine as JFused
from timewarp_tpu.models import gossip as jg
from timewarp_tpu.models import token_ring as jr
from timewarp_tpu.net import delays as jd
from timewarp_tpu.obs.metrics import MetricsRegistry as JRegistry
from timewarp_tpu.trace.events import assert_traces_equal
import timewarp_tpu_torch.dispatch as tdisp
import timewarp_tpu_torch.faults as tf
from timewarp_tpu_torch.dispatch import (Decision, DecisionTrace,
                                         DispatchController,
                                         DispatchTraceError)
from timewarp_tpu_torch.interp.torch_engine.batched import BatchSpec
from timewarp_tpu_torch.interp.torch_engine.edge_engine import EdgeEngine
from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
from timewarp_tpu_torch.interp.torch_engine.fused_sparse import \
    FusedSparseEngine
from timewarp_tpu_torch.interp.torch_engine.state_io import state_to_numpy
from timewarp_tpu_torch.models import gossip as tg
from timewarp_tpu_torch.models import token_ring as tr
from timewarp_tpu_torch.net import delays as td
from timewarp_tpu_torch.obs.metrics import (MetricsRegistry,
                                            validate_metrics_file)
from timewarp_tpu_torch.utils.checkpoint import save_state
import torch

# one intra-op thread per test process: the test session's workers
# share the host's cores (a process of the default width each
# oversubscribes them several times over)
torch.set_num_threads(1)

BUDGET = 1 << 14


def _wave(G, D, n=1024, end_us=80_000, mailbox_cap=16):
    return (G.gossip(n, fanout=4, think_us=2_000, burst=True, end_us=end_us,
                     mailbox_cap=mailbox_cap),
            D.Quantize(D.UniformDelay(8_000, 30_000), 1_000))


def _shrink(F):
    """A degradation window that undercuts the link's 8 ms floor (2 ms
    inside [40 ms, 90 ms))."""
    return F.FaultSchedule((F.LinkWindow(None, None, 40_000, 90_000,
                                         scale=0.25),))


def _ring(R, D):
    return (R.token_ring(24, n_tokens=3, think_us=2_000, bootstrap_us=1000,
                         end_us=80_000, with_observer=False, mailbox_cap=8),
            D.UniformDelay(500, 2_000))


def _pressed(G, D):
    """The wave with mailboxes of 6: full enough that the controller
    halves its window under pressure (``telemetry="full"``'s ``mb_peak``)
    and widens it again."""
    sc, link = _wave(G, D, mailbox_cap=6)
    return sc, link


#: name -> (jax?) -> engine with an auto controller (chunk 8, and up to 16
#: where the reference's scan is cheap to compile twice)
CASES = {
    "solo": lambda j: (JaxEngine(*_wave(jg, jd), insert="xla",
                                 lint="off", **_kw(j, jdisp, chunk_max=8))
                       if j else TorchEngine(*_wave(tg, td), device="cpu",
                                             **_kw(j, tdisp, chunk_max=8))),
    "window-adapt": lambda j: (
        JaxEngine(*_pressed(jg, jd), insert="xla", lint="off",
                  faults=_shrink(jf),
                  **_kw(j, jdisp, chunk_max=8, telemetry="full"))
        if j else TorchEngine(*_pressed(tg, td), device="cpu",
                              faults=_shrink(tf),
                              **_kw(j, tdisp, chunk_max=8,
                                    telemetry="full"))),
    "faulted-fleet": lambda j: (
        JaxEngine(*_wave(jg, jd), insert="xla",
                  lint="off", batch=JSpec(seeds=(0, 3)), faults=jf.FaultFleet(
                      (_shrink(jf), jf.FaultSchedule(()))),
                  **_kw(j, jdisp, chunk_max=8))
        if j else TorchEngine(*_wave(tg, td), device="cpu",
                              batch=BatchSpec(seeds=(0, 3)),
                              faults=tf.FaultFleet((_shrink(tf),
                                                    tf.FaultSchedule(()))),
                              **_kw(j, tdisp, chunk_max=8))),
    "fused": lambda j: (JFused(*_wave(jg, jd), max_batch=2048, lint="off",
                               **_kw(j, jdisp))
                        if j else FusedSparseEngine(*_wave(tg, td),
                                                    max_batch=2048,
                                                    device="cpu",
                                                    **_kw(j, tdisp))),
    "edge": lambda j: (JEdge(*_ring(jr, jd), lint="off",
                             **_kw(j, jdisp, window=None))
                       if j else EdgeEngine(*_ring(tr, td), device="cpu",
                                            **_kw(j, tdisp, window=None))),
}


def _kw(j, disp, window="auto", chunk_max=16, telemetry="counters"):
    kw = dict(telemetry=telemetry,
              controller=disp.DispatchController(chunk=8,
                                                 chunk_max=chunk_max))
    if window is not None:
        kw["window"] = window
    return kw


def _leaves(st):
    if hasattr(st.wake, "cpu"):
        return state_to_numpy(st) if hasattr(st, "mb_rel") else {
            k: ({s: x.cpu().numpy() for s, x in v.items()}
                if k == "states" else v.cpu().numpy())
            for k, v in st._asdict().items()}
    return {k: ({s: np.asarray(x) for s, x in v.items()} if k == "states"
                else np.asarray(v)) for k, v in st._asdict().items()}


def _states_equal(a, b, what):
    sa, sb = _leaves(a), _leaves(b)
    for k in sa:
        if k == "states":
            for s in sa[k]:
                assert np.array_equal(sa[k][s], sb[k][s]), (what, s)
        else:
            assert np.array_equal(sa[k], sb[k]), (what, k)


def _traces(ta, tb, what):
    for b, (x, y) in enumerate(zip(*(t if isinstance(t, list) else [t]
                                     for t in (ta, tb)))):
        assert_traces_equal(x, y, f"{what} w{b}", "other")


def _as_json(decisions):
    return [d.to_json() for d in decisions]


#: the cases held against the reference's decision traces (the fused
#: engine's pins are held port-side: test_chunk_boundaries_change_nothing)
REFERENCE = ("solo", "window-adapt", "faulted-fleet", "edge")


@pytest.fixture(scope="module")
def reference():
    """Each case's controlled run through the reference: final state,
    traces and the decision trace as JSON."""
    out = {}
    for case in REFERENCE:
        eng = CASES[case](True)
        eng.metrics, eng.metrics_label = JRegistry(run="r"), case
        fin, trace = eng.run_controlled(BUDGET)
        out[case] = (fin, trace, _as_json(eng.last_run_decisions),
                     eng.metrics.lines)
    return out


@pytest.mark.parametrize("case", REFERENCE)
def test_decision_trace_and_replay_law(case, reference, tmp_path):
    jfin, jtrace, jdecisions, jlines = reference[case]
    eng = CASES[case](False)
    assert eng._dyn_ok == (case != "edge")
    eng.metrics, eng.metrics_label = MetricsRegistry(run="r"), case
    fin, trace = eng.run_controlled(BUDGET)
    # the `decision` and `supersteps` metrics lines equal the reference's
    assert eng.metrics.lines == jlines
    assert {ln["kind"] for ln in jlines} == {"decision", "supersteps"}
    decisions = eng.last_run_decisions
    assert _as_json(decisions) == jdecisions, case
    _traces(jtrace, trace, f"{case} reference vs port")
    _states_equal(jfin, fin, f"{case} reference vs port")
    window = 1 if case == "edge" else eng.window
    assert all(d.rung_pin == -1 for d in decisions)
    if case == "window-adapt":
        # under pressure the window halves, then widens back to the bound
        windows = [d.window_us for d in decisions]
        assert min(windows) < window == max(windows), windows
        assert int(fin.short_delay) == 0
    else:
        assert all(d.window_us == window for d in decisions)
    if case == "edge":      # the other cases hold their chunk at 8
        assert len({d.chunk_len for d in decisions}) > 1, \
            "the controller never adapted the chunk length"
    # the replay law, through a trace file
    path = str(tmp_path / "decisions.jsonl")
    DecisionTrace.of(decisions).save(path)
    replay = CASES[case](False)
    replay.controller = DispatchController(mode="replay",
                                           replay=DecisionTrace.load(path))
    rfin, rtrace = replay.run_controlled(BUDGET)
    _traces(trace, rtrace, f"{case} replay")
    _states_equal(fin, rfin, f"{case} replay")
    assert _as_json(replay.last_run_decisions) == jdecisions
    if hasattr(fin, "mb_rel"):
        a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
        save_state(a, fin)
        save_state(b, rfin)
        assert open(a, "rb").read() == open(b, "rb").read()


def test_chunk_boundaries_change_nothing():
    """A controlled run equals the one-shot run of the same engine, and
    the fused engine's and the edge engine's knobs ride the trace pinned
    (window and rung), as the reference's do."""
    for case in ("edge", "fused"):
        eng = CASES[case](False)
        assert not eng._dyn_ok
        fin, trace = eng.run_controlled(BUDGET)
        ref = CASES[case](False)
        rfin, rtrace = ref.run(BUDGET)
        _traces(rtrace, trace, f"{case} one-shot vs controlled")
        _states_equal(rfin, fin, case)
        window = 1 if case == "edge" else eng.window
        decisions = eng.last_run_decisions
        assert all(d.window_us == window and d.rung_pin == -1
                   and d.obs.get("window") == "static" for d in decisions)
        assert len(decisions) > 1
    assert JFused(*_wave(jg, jd), max_batch=2048, lint="off",
                  **_kw(True, jdisp))._dyn_ok is False


def test_faulted_engine_takes_the_degraded_floor():
    """A faulted engine with a controller keeps the undegraded floor as
    its bound and takes the degraded floor per superstep, inside the
    degradation window only (the clamp, equal in both packages); without
    a controller it takes the degraded floor schedule-wide. The reference's
    kernel path keeps the degraded floor with a controller too."""
    import torch
    from jax import numpy as jnp
    from timewarp_tpu.faults.apply import window_floor as jfloor
    from timewarp_tpu_torch.faults.apply import device_tables
    from timewarp_tpu_torch.faults.apply import window_floor as tfloor
    for P, F, disp, extra in ((jg, jf, jdisp, dict(insert="xla",
                                                    lint="off")),
                              (tg, tf, tdisp, dict(device="cpu"))):
        cls = JaxEngine if P is jg else TorchEngine
        sc, link = _wave(P, jd if P is jg else td, end_us=60_000)
        eng = cls(sc, link, window="auto", faults=_shrink(F),
                  telemetry="counters",
                  controller=disp.DispatchController(chunk=8), **extra)
        assert eng._dyn_ok
        assert eng.window == 8_000 == link.min_delay_us
        static = cls(sc, link, window="auto", faults=_shrink(F), **extra)
        assert static.window == 2_000 == _shrink(F).min_delay_floor(
            link.min_delay_us)
    kernel = JaxEngine(*_wave(jg, jd, end_us=60_000), window="auto",
                       faults=_shrink(jf), telemetry="counters",
                       insert="interpret", lint="off",
                       controller=jdisp.DispatchController(chunk=8))
    assert not kernel._dyn_ok and kernel.window == 2_000
    # the clamp: 8 ms requested, 2 ms wherever [t, t + 8 ms) meets the
    # degradation window [40 ms, 90 ms)
    jft = _shrink(jf).tables(1024)
    tft = device_tables(_shrink(tf).tables(1024), torch.device("cpu"))
    ts = (0, 31_999, 32_001, 60_000, 89_999, 90_000, 120_000)
    want = [8_000, 8_000, 2_000, 2_000, 2_000, 8_000, 8_000]
    assert [int(jfloor(jft, jnp.int64(t), jnp.int64(8_000), 8_000))
            for t in ts] == want
    assert tfloor(tft, torch.tensor(ts), 8_000, 8_000).tolist() == want


def test_auto_controller_needs_telemetry():
    sc, link = _wave(tg, td, n=64)
    with pytest.raises(ValueError, match="telemetry"):
        TorchEngine(sc, link, window="auto", device="cpu",
                    controller=DispatchController())
    with pytest.raises(ValueError, match="telemetry"):
        EdgeEngine(*_ring(tr, td), device="cpu",
                   controller=DispatchController())
    with pytest.raises(ValueError, match="DispatchController"):
        TorchEngine(sc, link, window="auto", device="cpu",
                    controller=object())
    # replay mode reads nothing: telemetry may stay off
    TorchEngine(sc, link, window="auto", device="cpu",
                controller=DispatchController(
                    mode="replay",
                    replay=DecisionTrace.of([Decision(0, 8_000, -1, 8)])))
    with pytest.raises(ValueError, match="needs a dispatch controller"):
        TorchEngine(sc, link, window="auto", device="cpu").run_controlled(8)


def test_decision_trace_validation_is_loud(tmp_path):
    with pytest.raises(DispatchTraceError, match="gapless"):
        DecisionTrace.of([Decision(1, 8, -1, 4)])
    with pytest.raises(DispatchTraceError, match="window_us"):
        Decision(0, 0, -1, 4)
    p = tmp_path / "bad.jsonl"
    p.write_text('{"schema": 1, "kind": "decision", "chunk": 0}\n')
    with pytest.raises(DispatchTraceError, match="missing field"):
        DecisionTrace.load(str(p))
    p.write_text("not json\n")
    with pytest.raises(DispatchTraceError, match="not JSON"):
        DecisionTrace.load(str(p))
    sc, link = _wave(tg, td, n=64)
    short = DecisionTrace.of([Decision(0, 8_000, -1, 2)])
    eng = TorchEngine(sc, link, window="auto", device="cpu",
                      controller=DispatchController(mode="replay",
                                                    replay=short))
    with pytest.raises(DispatchTraceError, match="exhausted"):
        eng.run_controlled(BUDGET)
    wide = DecisionTrace.of([Decision(0, 1 << 20, -1, 8)])
    eng = TorchEngine(sc, link, window="auto", device="cpu",
                      controller=DispatchController(mode="replay",
                                                    replay=wide))
    with pytest.raises(DispatchTraceError, match="bound"):
        eng.run_controlled(BUDGET)
    pinned = DecisionTrace.of([Decision(0, 8_000, 2, 8)])
    eng = TorchEngine(sc, link, window="auto", device="cpu",
                      controller=DispatchController(mode="replay",
                                                    replay=pinned))
    with pytest.raises(DispatchTraceError, match="pinnable rungs"):
        eng.run_controlled(BUDGET)


def test_decision_lines_validate(tmp_path, reference):
    """The reference's ``decision`` and ``supersteps`` lines, re-emitted
    through the port's registry, validate as a file."""
    lines = reference["edge"][3]
    path = tmp_path / "m.jsonl"
    reg = MetricsRegistry(str(path))
    for ln in lines:
        reg.emit(ln["kind"], **{k: v for k, v in ln.items()
                                if k not in ("schema", "kind")})
    reg.close()
    assert validate_metrics_file(str(path)) == len(lines)

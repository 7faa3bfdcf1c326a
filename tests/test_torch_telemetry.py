"""The telemetry plane of the port (``timewarp_tpu_torch/obs/telemetry.py``,
``obs/metrics.py`` and the engines' ``telemetry=`` knob) against the JAX
package, mirroring tests/test_zztelemetry.py:

- ``"counters"`` and ``"full"`` give the same states and traces as
  ``"off"`` on every engine and in every routing regime;
- the frames equal the reference's column for column, with the ``rung``
  column by the kernel path's convention (the compacted batch's sender
  width on the adaptive path; the reference ``FusedSparseEngine``'s
  batch ``A``, whose frames tests/test_torch_flight.py holds; -1 on the
  eager and lazy paths). The reference runs
  ``insert="xla"``: at 1024 nodes its ladder has the one rung n, which
  is the kernel path's width (``JaxEngine(insert="interpret")``'s
  ``PallasInsertStage.A``, checked here), so every column equals the
  kernel path's;
- a fleet's world b equals its solo run's frames;
- the ``MetricsRegistry`` lines equal the reference's, and validation
  stays loud;
- bad modes and ``FusedRingEngine`` are refused with the reference's
  guidance;
- off is free: with every plane off, each engine runs to its end while
  the plane modules' entry points raise.

Tolerance: exact (everything is integer).
"""

from types import SimpleNamespace

import numpy as np
import pytest

import timewarp_tpu.faults as jf
from timewarp_tpu.interp.jax_engine.batched import BatchSpec as JSpec
from timewarp_tpu.interp.jax_engine.edge_engine import EdgeEngine as JEdge
from timewarp_tpu.interp.jax_engine.engine import JaxEngine
from timewarp_tpu.interp.jax_engine.fused_sparse import \
    FusedSparseEngine as JFused
from timewarp_tpu.models import gossip as jg
from timewarp_tpu.models import token_ring as jr
from timewarp_tpu.net import delays as jd
from timewarp_tpu.net.links import parse_link as jlink
from timewarp_tpu.obs.metrics import MetricsRegistry as JRegistry
from timewarp_tpu.trace.events import assert_traces_equal
import timewarp_tpu_torch.faults as tf
from timewarp_tpu_torch.interp.torch_engine.batched import (BatchSpec,
                                                            world_slice)
from timewarp_tpu_torch.interp.torch_engine.edge_engine import EdgeEngine
from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
from timewarp_tpu_torch.interp.torch_engine.fused_ring import \
    FusedRingEngine
from timewarp_tpu_torch.interp.torch_engine.fused_sparse import \
    FusedSparseEngine
from timewarp_tpu_torch.interp.torch_engine.state_io import (
    edge_state_to_numpy, state_to_numpy)
from timewarp_tpu_torch.models import gossip as tg
from timewarp_tpu_torch.models import token_ring as tr
from timewarp_tpu_torch.net import delays as td
from timewarp_tpu_torch.net.links import parse_link as tlink
from timewarp_tpu_torch.obs.metrics import (MetricsRegistry,
                                            validate_metrics_file)
import torch

# one intra-op thread per test process: the test session's workers
# share the host's cores (a process of the default width each
# oversubscribes them several times over)
torch.set_num_threads(1)

J = SimpleNamespace(jax=True, engine=JaxEngine, edge=JEdge, fused=JFused,
                    spec=JSpec, F=jf, g=jg, r=jr, d=jd, link=jlink)
T = SimpleNamespace(jax=False, engine=TorchEngine, edge=EdgeEngine,
                    fused=FusedSparseEngine, spec=BatchSpec, F=tf, g=tg,
                    r=tr, d=td, link=tlink)


def _fleet(P, n=1024):
    half = n // 2
    return P.F.FaultFleet(tuple(P.F.FaultSchedule((
        P.F.NodeCrash((7 * b + 3) % n, 8_000, 30_000 + 4_000 * b,
                      reset_state=True),
        P.F.NodeCrash(half + 5 + b, 10_000, 26_000),
        P.F.Partition((tuple(range(half)), tuple(range(half, n))), 9_000,
                      28_000 + 2_000 * b),
        P.F.LinkWindow(None, None, 30_000, 40_000, scale=1.5 + 0.5 * b),
    )) for b in range(3)))


#: name -> (P -> (engine class, scenario, link, kwargs, adaptive), steps)
CASES = {
    "adaptive": (lambda P: (
        P.engine, P.g.gossip(1024, fanout=4, think_us=2_000, burst=True,
                             end_us=150_000, mailbox_cap=16),
        P.d.Quantize(P.d.UniformDelay(8_000, 30_000), 1_000),
        dict(window="auto"), True), 40),
    "eager": (lambda P: (
        P.engine, P.g.gossip(256, fanout=1, think_us=1_000,
                             gossip_interval=1_000, end_us=40_000,
                             steady=True, mailbox_cap=8),
        P.link("drop:0.1:quantize:1000:uniform:500:4500"), {}, False), 40),
    "lazy": (lambda P: (
        P.engine, P.g.gossip(256, fanout=4, think_us=700, burst=True,
                             end_us=150_000, mailbox_cap=16),
        P.link("quantize:1000:uniform:3000:9000"),
        dict(window=3_000, route_cap=64), False), 40),
    "fleet": (lambda P: (
        P.engine, P.g.gossip(1024, fanout=1, think_us=1_000,
                             gossip_interval=1_000, end_us=50_000,
                             steady=True, mailbox_cap=8),
        P.d.Quantize(P.d.UniformDelay(500, 4_500), 1_000),
        dict(window="auto", batch=P.spec(seeds=(3, 4, 9)),
             faults=_fleet(P)), True), 36),
    "fused": (lambda P: (
        P.fused, P.g.gossip(1024, fanout=4, think_us=2_000, burst=True,
                            end_us=150_000, mailbox_cap=16),
        P.d.Quantize(P.d.UniformDelay(8_000, 30_000), 1_000),
        dict(window="auto", max_batch=2048), False), 40),
    "edge": (lambda P: (
        P.edge, P.r.token_ring(16, n_tokens=4, think_us=2_000,
                               bootstrap_us=1_000, end_us=120_000,
                               with_observer=False, mailbox_cap=8),
        P.d.FixedDelay(500), {}, False), 60),
}


def make(P, case, **planes):
    build, _ = CASES[case]
    cls, sc, link, kw, _ = build(P)
    kw = dict(kw, **planes)
    if P.jax:
        kw["lint"] = "off"
    else:
        kw["device"] = "cpu"
    return cls(sc, link, **kw)


def _numpy(st):
    to = edge_state_to_numpy if hasattr(st, "q_rel") else state_to_numpy
    return to(st)


def _same_states(a, b, what):
    sa, sb = _numpy(a), _numpy(b)
    for k in sa:
        if k == "states":
            for s in sa[k]:
                assert np.array_equal(sa[k][s], sb[k][s]), (what, k, s)
        else:
            assert np.array_equal(sa[k], sb[k]), (what, k)


def _traces(tra, trb, what):
    if isinstance(tra, list):
        for b, (x, y) in enumerate(zip(tra, trb)):
            assert_traces_equal(x, y, f"{what} w{b}", "other")
    else:
        assert_traces_equal(tra, trb, what, "other")


def _frames_equal(want, got, what):
    if isinstance(want, list):
        assert len(want) == len(got)
        for b, (w, g) in enumerate(zip(want, got)):
            _frames_equal(w, g, f"{what} world {b}")
        return
    assert np.array_equal(want.t_us, got.t_us), what
    assert sorted(want.data) == sorted(got.data), what
    for k, w in want.data.items():
        g = got.data[k]
        assert g.dtype == w.dtype, (what, k)
        assert np.array_equal(w, g), (what, k)


#: the cases whose frames are held here against the reference's (the
#: fused engine's frames are held in tests/test_torch_flight.py, which
#: runs the reference FusedSparseEngine with every plane on)
REFERENCE = ("adaptive", "eager", "lazy", "fleet", "edge")


@pytest.fixture(scope="module")
def reference():
    """Each case's reference run with ``telemetry="full"`` (frames and
    metrics lines), computed once."""
    out = {}
    for case in REFERENCE:
        steps = CASES[case][1]
        eng = make(J, case, telemetry="full")
        eng.metrics, eng.metrics_label = JRegistry(run="r"), case
        _, trace = eng.run(steps)
        out[case] = (eng.last_run_telemetry, trace, eng.metrics.lines)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_modes_exact_and_frames_equal_reference(case, reference):
    """``counters`` and ``full`` give the states and traces of ``off``;
    the ``full`` frames and metrics lines equal the reference's."""
    steps = CASES[case][1]
    f0, t0 = make(T, case).run(steps)
    for mode in ("counters", "full"):
        eng = make(T, case, telemetry=mode)
        if mode == "full":
            eng.metrics, eng.metrics_label = MetricsRegistry(run="r"), case
        f1, t1 = eng.run(steps)
        _traces(t0, t1, f"{case} off vs {mode}")
        _same_states(f0, f1, f"{case} telemetry={mode}")
        frames = eng.last_run_telemetry
        one = frames[0] if isinstance(frames, list) else frames
        assert ("mb_fill" in one.data) == (mode == "full")
    if case == "fused":
        # the static batch slice, in senders (max_batch // max_out)
        assert set(one.data["rung"].tolist()) == {512}
        return
    want, jtrace, jlines = reference[case]
    trace = t1
    _traces(jtrace, trace, f"{case} jax")
    _frames_equal(want, eng.last_run_telemetry, case)
    assert eng.metrics.lines == jlines, case
    one = want[0] if isinstance(want, list) else want
    if case in ("adaptive", "fleet"):
        # the kernel path's rung: the compacted batch's sender width,
        # which the reference's ladder equals at 1024 nodes
        _, sc, link, kw, _ = CASES[case][0](J)
        stage = JaxEngine(sc, link, insert="interpret", lint="off",
                          **kw)._pallas_stage
        assert set(one.data["rung"].tolist()) == {stage.A} == {1024}
    else:
        assert set(one.data["rung"].tolist()) == {-1}
    if case == "fleet":
        assert all(int(f.data["fault_dropped"].sum()) > 0 for f in want)


def test_fleet_world_equals_solo():
    """World b of the faulted fleet's frames equals the solo run with
    world b's seed and schedule (frozen worlds' rows are masked)."""
    eng = make(T, "fleet", telemetry="full")
    # per-world budgets: world 1 stops early and its rows end there
    fin, _ = eng.run(np.asarray([30, 12, 30]))
    _, sc, link, kw, _ = CASES["fleet"][0](T)
    for b in (0, 1, 2):
        solo = TorchEngine(sc, link, window="auto",
                           seed=kw["batch"].seeds[b],
                           faults=kw["faults"].world_schedule(b),
                           telemetry="full", device="cpu")
        sfin, _ = solo.run(12 if b == 1 else 30)
        _frames_equal(solo.last_run_telemetry, eng.last_run_telemetry[b],
                      f"world {b} vs solo")
        _same_states(sfin, world_slice(fin, b), f"world {b}")
    assert len(eng.last_run_telemetry[1]) == 12


def test_run_stream_carries_frames_and_metrics(tmp_path):
    """``run_stream`` concatenates the chunks' frames and flushes one
    metrics line per world and chunk; the whole run's frames equal one
    uninterrupted run's."""
    eng = make(T, "fleet", telemetry="counters")
    path = tmp_path / "m.jsonl"
    eng.metrics = MetricsRegistry(str(path))
    eng.run_stream(30, chunk=8)
    streamed = eng.last_run_telemetry
    eng.metrics.close()
    one = make(T, "fleet", telemetry="counters")
    one.run(30)
    _frames_equal(one.last_run_telemetry, streamed, "run_stream")
    assert validate_metrics_file(str(path)) == 4 * 3


def test_metrics_validation_is_loud(tmp_path):
    reg = MetricsRegistry()
    with pytest.raises(ValueError, match="unknown metrics kind"):
        reg.emit("bogus")
    with pytest.raises(ValueError, match="supersteps"):
        reg.emit("supersteps", label="x")
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"schema": 1, "kind": "span", "name": "x"}\n')
    with pytest.raises(ValueError, match="wall_s"):
        validate_metrics_file(str(bad))
    empty = tmp_path / "empty.jsonl"
    empty.write_text("\n")
    with pytest.raises(ValueError, match="no metrics records"):
        validate_metrics_file(str(empty))


def test_bad_modes_and_fused_ring_refused():
    """A bad mode is refused with the reference's guidance, word for word
    but the engine's name; ``FusedRingEngine`` refuses the planes and
    names ``EdgeEngine``, as the reference's does."""
    for knob, bad in (("telemetry", "Counters"), ("verify", "digests"),
                      ("record", "all")):
        msgs = []
        for P, extra in ((J, {"lint": "off"}), (T, {"device": "cpu"})):
            _, sc, link, kw, _ = CASES["adaptive"][0](P)
            with pytest.raises(ValueError) as err:
                P.engine(sc, link, window="auto", **{knob: bad}, **extra)
            msgs.append(str(err.value))
        assert msgs[1].replace("TorchEngine", "JaxEngine") == msgs[0]
    ring = tr.token_ring(64, n_tokens=64, think_us=0, bootstrap_us=1_000,
                         end_us=20_000, with_observer=False, mailbox_cap=4)
    with pytest.raises(ValueError, match="run EdgeEngine"):
        FusedRingEngine(ring, td.FixedDelay(500), telemetry="counters",
                        device="cpu")
    with pytest.raises(ValueError, match="run EdgeEngine"):
        FusedRingEngine(ring, td.FixedDelay(500), verify="guard",
                        device="cpu")
    with pytest.raises(TypeError):
        FusedRingEngine(ring, td.FixedDelay(500), record="full",
                        device="cpu")


def test_off_is_free(monkeypatch):
    """With every plane off, no plane code runs: each engine runs to its
    end (the traced, quiet, streamed and controlled-free drivers) while
    the plane modules' entry points raise."""
    from timewarp_tpu_torch.integrity import checks, digest, inject
    from timewarp_tpu_torch.obs import flight, metrics, telemetry

    def boom(*a, **k):
        raise AssertionError("plane code ran with every plane off")
    for mod, names in (
            (telemetry, ("decode_frames", "summarize_frames",
                         "concat_frames", "TelemetryRow")),
            (flight, ("record_masked", "record_deliveries", "compact",
                      "record_compacted", "empty_row", "decode_flight",
                      "concat_flight")),
            (checks, ("make_guard_row", "first_guard_violation",
                      "final_state_guard")),
            (digest, ("tree_digest", "fleet_digest", "host_digests")),
            (inject, ("apply_flip",)),
            (metrics, ("validate_line",))):
        for name in names:
            monkeypatch.setattr(mod, name, boom)
    engines = {case: make(T, case) for case in CASES}
    for name in ("_telemetry_row", "_record_row", "_capture_planes",
                 "_rec_fault", "_rec_cut", "_rec_sends", "_plane_rows"):
        for eng in engines.values():
            monkeypatch.setattr(eng, name, boom, raising=False)
    for case, eng in engines.items():
        steps = CASES[case][1]
        st, _ = eng.run(steps)
        eng.run_quiet(8, st)
    engines["fleet"].run_stream(12, chunk=4)

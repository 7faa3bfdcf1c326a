"""The flight recorder of the port (``timewarp_tpu_torch/obs/flight.py`` and
the engines' ``record=``/``record_cap=`` knobs) against the JAX package,
mirroring tests/test_zzzzzflight.py:

- ``"deliveries"`` and ``"full"`` give the same states and traces as
  ``"off"``;
- the ``FlightLog``s equal the reference's event for event (superstep,
  instant, kind, src, dst, send and deliver times, tag) under a schedule
  with every fault action: the adaptive path against ``JaxEngine(insert=
  "interpret")`` (its sends are captured in the compacted batch's order),
  the eager and lazy paths against ``insert="xla"``, ``EdgeEngine``,
  ``FusedSparseEngine``; ``restart`` and ``purge`` also from a state whose
  mailbox holds an entry older than a reset crash (an entry no run could
  leave there: every delivery into a down window is dropped at its send);
- with telemetry on too, ``FusedSparseEngine``'s frames equal the
  reference's (its ``rung`` the batch ``A``);
- a fleet's world b equals its solo run's log;
- cap overflow is counted, never silent, as the reference counts it;
- the device builders (``compact``, ``record_masked``,
  ``record_compacted``, ``record_deliveries``) equal the reference's on
  the same masks and columns, world by world, at a cap that drops;
- the ``FlightWriter`` lines equal the reference writer's, and load back;
- ``run_verified`` carries the record plane.

Tolerance: exact.
"""

import numpy as np
import pytest

from timewarp_tpu.interp.jax_engine.edge_engine import EdgeEngine as JEdge
from timewarp_tpu.interp.jax_engine.edge_engine import EdgeState as JEState
from timewarp_tpu.interp.jax_engine.engine import EngineState as JState
from timewarp_tpu.interp.jax_engine.engine import JaxEngine
from timewarp_tpu.interp.jax_engine.fused_sparse import \
    FusedSparseEngine as JFused
from timewarp_tpu.models import gossip as jg
from timewarp_tpu.models import token_ring as jr
from timewarp_tpu.net import delays as jd
from timewarp_tpu.net.links import parse_link as jlink
from timewarp_tpu.obs.flight import FlightWriter as JWriter
from timewarp_tpu.trace.events import assert_traces_equal
import timewarp_tpu.faults as jf
import timewarp_tpu_torch.faults as tf
from timewarp_tpu_torch.interp.torch_engine.batched import BatchSpec
from timewarp_tpu_torch.interp.torch_engine.edge_engine import EdgeEngine
from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
from timewarp_tpu_torch.interp.torch_engine.fused_sparse import \
    FusedSparseEngine
from timewarp_tpu_torch.interp.torch_engine.state_io import (
    edge_state_from_numpy, edge_state_to_numpy, state_from_numpy,
    state_to_numpy)
from timewarp_tpu_torch.models import gossip as tg
from timewarp_tpu_torch.models import token_ring as tr
from timewarp_tpu_torch.net import delays as td
from timewarp_tpu_torch.net.links import parse_link as tlink
from timewarp_tpu_torch.obs.flight import (ACTION_NAMES, EV_DELIVER,
                                           EV_FAULT, TAG_PURGE, TAG_RESTART,
                                           FlightWriter, load_flight_jsonl)
from timewarp_tpu_torch.obs.metrics import validate_metrics_file
import torch

# one intra-op thread per test process: the test session's workers
# share the host's cores (a process of the default width each
# oversubscribes them several times over)
torch.set_num_threads(1)

COLS = ("superstep", "t_sup", "kind", "src", "dst", "send_t", "t", "tag")


def _sched(F, n):
    half = n // 2
    return F.FaultSchedule((
        F.NodeCrash(3, 15_000, 30_000, reset_state=True),
        F.NodeCrash(half + 5, 16_000, 32_000),
        F.Partition((tuple(range(half)), tuple(range(half, n))), 25_000,
                    34_000),
        F.LinkWindow(None, None, 35_000, 45_000, scale=2.0),
    ))


def _steady(G, n):
    return G.gossip(n, fanout=1, think_us=1_000, gossip_interval=1_000,
                    end_us=50_000, steady=True, mailbox_cap=8)


def _ring_sched(F):
    return F.FaultSchedule((
        F.NodeCrash(3, 30_000, 60_000, reset_state=True),
        F.NodeCrash(5, 10_000, 25_000),
        F.Partition(((0, 1, 2, 3, 4, 5, 6, 7),
                     (8, 9, 10, 11, 12, 13, 14, 15)), 5_000, 200_000),
        F.LinkWindow(None, None, 40_000, 60_000, scale=2.5, extra_us=500),
    ))


#: name -> (jax?, package modules) -> (engine class, scenario, link, kw);
#: the steps; whether the reference is the Pallas interpreter
CASES = {
    "adaptive-faulted": (lambda j, G, D, F, L: (
        JaxEngine if j else TorchEngine, _steady(G, 1024),
        D.Quantize(D.UniformDelay(500, 4_500), 1_000),
        dict(window="auto", faults=_sched(F, 1024))), 40, True),
    "eager-faulted": (lambda j, G, D, F, L: (
        JaxEngine if j else TorchEngine, _steady(G, 256),
        L("drop:0.1:quantize:1000:uniform:500:4500"),
        dict(faults=_sched(F, 256))), 40, False),
    "lazy": (lambda j, G, D, F, L: (
        JaxEngine if j else TorchEngine,
        G.gossip(256, fanout=4, think_us=700, burst=True, end_us=150_000,
                 mailbox_cap=16),
        L("quantize:1000:uniform:3000:9000"),
        dict(window=3_000, route_cap=64)), 40, False),
    "edge-faulted": (lambda j, G, D, F, L: (
        JEdge if j else EdgeEngine,
        (jr if j else tr).token_ring(16, n_tokens=8, think_us=2_000,
                                     bootstrap_us=1_000, end_us=200_000,
                                     with_observer=False, mailbox_cap=8),
        D.UniformDelay(500, 2_000), dict(faults=_ring_sched(F))), 120,
        False),
    "fused": (lambda j, G, D, F, L: (
        JFused if j else FusedSparseEngine,
        G.gossip(1024, fanout=4, think_us=2_000, burst=True,
                 end_us=150_000, mailbox_cap=16),
        D.Quantize(D.UniformDelay(8_000, 30_000), 1_000),
        dict(window="auto", max_batch=2048)), 30, False),
}


#: the fault actions each case's schedule leaves in its log (steady
#: gossip's idle nodes have no pending event to defer: every delivery into
#: a down window is dropped at its send)
ACTIONS = {"adaptive-faulted": {"cut", "down", "restart"},
           "eager-faulted": {"defer", "cut", "down", "restart"},
           "edge-faulted": {"defer", "cut", "down", "restart"}}


#: each case's record_cap: room for every event of a superstep (the
#: reference logs drop nothing), and no more — the buffers' width is what
#: a recorded superstep costs
CAP = {"adaptive-faulted": 4096, "eager-faulted": 1024, "lazy": 1024,
       "edge-faulted": 64, "fused": 4096}


def make(case, jax, **planes):
    build, _, kernel = CASES[case]
    mods = (True, jg, jd, jf, jlink) if jax else (False, tg, td, tf, tlink)
    cls, sc, link, kw = build(*mods)
    kw = dict(kw, **planes)
    if jax:
        kw["lint"] = "off"
        if kernel:
            kw["insert"] = "interpret"
    else:
        kw["device"] = "cpu"
    return cls(sc, link, **kw)


def _logs_equal(want, got, what):
    if isinstance(want, list):
        for b, (w, g) in enumerate(zip(want, got)):
            _logs_equal(w, g, f"{what} world {b}")
        return
    assert len(want) == len(got) and want.dropped == got.dropped, what
    for c in COLS:
        w, g = getattr(want, c), getattr(got, c)
        assert w.dtype == g.dtype, (what, c)
        assert np.array_equal(w, g), (what, c)


def _only_deliveries(log):
    """The deliveries-mode view of a full-mode log that dropped nothing."""
    from timewarp_tpu.obs.flight import FlightLog
    m = log.kind == EV_DELIVER
    return FlightLog(*(getattr(log, c)[m] for c in COLS), dropped=0)


def _numpy(st):
    return (edge_state_to_numpy if hasattr(st, "q_rel")
            else state_to_numpy)(st)


def _same_states(a, b, what):
    sa, sb = _numpy(a), _numpy(b)
    for k in sa:
        if k == "states":
            for s in sa[k]:
                assert np.array_equal(sa[k][s], sb[k][s]), (what, s)
        else:
            assert np.array_equal(sa[k], sb[k]), (what, k)


@pytest.fixture(scope="module")
def reference():
    """Each case's reference run in full mode (``CAP``); the deliveries
    mode's log is the full log's deliveries when nothing drops (the
    reference's slim row itself is held at a cap that drops:
    test_cap_overflow_counted_as_reference)."""
    out = {}
    for case, (_, steps, _) in CASES.items():
        extra = dict(telemetry="full") if case == "fused" else {}
        eng = make(case, True, record="full", record_cap=CAP[case], **extra)
        _, trace = eng.run(steps)
        out[case] = (eng.last_run_flight, trace, eng.last_run_telemetry)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_logs_equal_reference_and_modes_exact(case, reference):
    steps = CASES[case][1]
    want, jtrace, jframes = reference[case]
    assert want.dropped == 0
    f0, t0 = make(case, False).run(steps)
    assert_traces_equal(jtrace, t0, "reference", "port off")
    logs = {}
    for mode in ("deliveries", "full"):
        extra = dict(telemetry="full") if jframes is not None \
            and mode == "full" else {}
        eng = make(case, False, record=mode, record_cap=CAP[case], **extra)
        f1, t1 = eng.run(steps)
        assert_traces_equal(t0, t1, "off", mode)
        _same_states(f0, f1, f"{case} record={mode}")
        logs[mode] = eng.last_run_flight
        assert int((logs[mode].kind == EV_DELIVER).sum()) \
            == int(t1.recv_count.sum())
    _logs_equal(want, logs["full"], f"{case} full")
    if jframes is not None:
        # the fused engine's frames, its rung the batch A (max_batch // M)
        frames = eng.last_run_telemetry
        assert np.array_equal(jframes.t_us, frames.t_us)
        assert sorted(jframes.data) == sorted(frames.data)
        for k, v in jframes.data.items():
            assert v.dtype == frames.data[k].dtype, k
            assert np.array_equal(v, frames.data[k]), k
        assert set(frames.data["rung"].tolist()) == {512}
    _logs_equal(_only_deliveries(want), logs["deliveries"],
                f"{case} deliveries")
    tags = {ACTION_NAMES[t] for t in
            logs["full"].tag[logs["full"].kind == EV_FAULT].tolist()}
    assert tags == ACTIONS.get(case, set()), tags


@pytest.mark.parametrize("edge", [False, True], ids=["general", "edge"])
def test_restart_and_purge_captured_as_reference(edge):
    """A state whose crashed node holds an entry older than its reset
    crash (deliver time 7 ms, crash 10-20 ms, its event deferred by a
    second crash 5-20 ms): the reboot at 20 ms purges it. The restart and
    purge events equal the reference's."""
    def sched(F):
        return F.FaultSchedule((F.NodeCrash(3, 10_000, 20_000,
                                            reset_state=True),
                                F.NodeCrash(3, 5_000, 20_000)))
    if edge:
        build = (lambda R, D, F: (R.token_ring(
            16, n_tokens=4, think_us=2_000, bootstrap_us=1_000,
            end_us=60_000, with_observer=False, mailbox_cap=8),
            D.UniformDelay(500, 2_000), dict(faults=sched(F))))
        jeng = JEdge(*build(jr, jd, jf)[:2], lint="off", record="full",
                     record_cap=512, **build(jr, jd, jf)[2])
        teng = EdgeEngine(*build(tr, td, tf)[:2], device="cpu",
                          record="full", record_cap=512,
                          **build(tr, td, tf)[2])
    else:
        def build(G, D, F):
            return (_steady(G, 64), D.Quantize(D.UniformDelay(500, 4_500),
                                               1_000))
        jeng = JaxEngine(*build(jg, jd, jf), faults=sched(jf), lint="off",
                         record="full", record_cap=512)
        teng = TorchEngine(*build(tg, td, tf), faults=sched(tf),
                           device="cpu", record="full", record_cap=512)
    jst = jeng.init_state()
    leaves = {k: (dict(v) if k == "states" else np.array(v))
              for k, v in jst._asdict().items()}
    plane = "q_rel" if edge else "mb_rel"
    # node 3's last slot: an entry due at 7 ms (the epoch is 0)
    leaves[plane][..., -1, 3] = 7_000
    st = (edge_state_from_numpy if edge else state_from_numpy)(leaves, "cpu")
    jstate = (JEState if edge else JState)(**leaves)
    _, jtr = jeng.run(32, jstate)
    _, ttr = teng.run(32, st)
    assert_traces_equal(jtr, ttr, "reference", "port")
    want, got = jeng.last_run_flight, teng.last_run_flight
    _logs_equal(want, got, "purge")
    fault = got.tag[got.kind == EV_FAULT].tolist()
    assert TAG_RESTART in fault and TAG_PURGE in fault


def test_fleet_world_equals_solo():
    sc = _steady(tg, 256)
    link = td.Quantize(td.UniformDelay(500, 4_500), 1_000)
    fleet = tf.FaultFleet(tuple(_sched(tf, 256) for _ in range(2))
                          + (tf.FaultSchedule(()),))
    eng = TorchEngine(sc, link, window="auto", batch=BatchSpec(
        seeds=(1, 2, 3)), faults=fleet, record="full", record_cap=1024,
        device="cpu")
    eng.run(np.asarray([30, 14, 30]))
    logs = eng.last_run_flight
    for b in range(3):
        solo = TorchEngine(sc, link, window="auto", seed=b + 1,
                           faults=fleet.world_schedule(b), record="full",
                           record_cap=1024, device="cpu")
        solo.run(14 if b == 1 else 30)
        _logs_equal(solo.last_run_flight, logs[b], f"world {b}")


@pytest.mark.parametrize("mode", ["deliveries", "full"])
def test_cap_overflow_counted_as_reference(mode):
    # the slim deliveries row on burst gossip (many deliveries a
    # superstep), the full row on the faulted ring
    case, cap = ("lazy", 4) if mode == "deliveries" else ("edge-faulted", 2)
    want = make(case, True, record=mode, record_cap=cap)
    _, jt = want.run(60)
    got = make(case, False, record=mode, record_cap=cap)
    _, tt = got.run(60)
    assert got.last_run_flight.dropped > 0
    assert len(got.last_run_flight) <= cap * len(tt)
    _logs_equal(want.last_run_flight, got.last_run_flight, f"cap {mode}")
    with pytest.raises(ValueError, match="record_cap"):
        make("lazy", False, record="full", record_cap=0)
    with pytest.raises(ValueError, match="record must be one of"):
        make("lazy", False, record="Deliveries")


def test_device_builders_equal_reference():
    import jax.numpy as jnp
    import torch
    import timewarp_tpu.obs.flight as jfl
    import timewarp_tpu_torch.obs.flight as tfl
    rng = np.random.default_rng(5)
    B, shape, cap = 3, (5, 7), 12
    masks = [rng.random((B,) + shape) < p for p in (0.3, 0.5, 0.2)]
    src = rng.integers(0, 100, (B,) + shape).astype(np.int32)
    dst = rng.integers(0, 100, shape).astype(np.int32)       # shared
    rel = rng.integers(0, 10_000, (B,) + shape).astype(np.int32)
    sendt = rng.integers(0, 1 << 40, (B,) + shape)
    off = np.asarray([5, 1 << 33, 70], np.int64)
    T = torch.from_numpy
    ports = [
        tfl.record_deliveries(cap, T(masks[0]), T(src), T(dst), T(rel),
                              t_off=T(off))]
    row = tfl.compact(cap, tfl.EV_DELIVER, T(masks[0]), T(src), T(dst), -1,
                      T(rel), 0, t_off=T(off))
    row = tfl.record_compacted(row, tfl.compact(
        cap, tfl.EV_FAULT, T(masks[1]), 7, T(dst), T(sendt), T(sendt),
        tfl.TAG_CUT))
    ports.append(tfl.record_masked(row, tfl.EV_SEND, T(masks[2]), T(src), 3,
                                   T(sendt), T(rel), 0, t_off=T(off)))
    for b in range(B):
        J = jnp.asarray
        want = [jfl.record_deliveries(cap, J(masks[0][b]), J(src[b]),
                                      J(dst), J(rel[b]), t_off=J(off[b]))]
        jrow = jfl.compact(cap, jfl.EV_DELIVER, J(masks[0][b]), J(src[b]),
                           J(dst), J(-1, jnp.int64), J(rel[b]), 0,
                           t_off=J(off[b]))
        jrow = jfl.record_compacted(jrow, jfl.compact(
            cap, jfl.EV_FAULT, J(masks[1][b]), 7, J(dst), J(sendt[b]),
            J(sendt[b]), jfl.TAG_CUT))
        want.append(jfl.record_masked(jrow, jfl.EV_SEND, J(masks[2][b]),
                                      J(src[b]), 3, J(sendt[b]), J(rel[b]),
                                      0, t_off=J(off[b])))
        for w, g in zip(want, ports):
            for f in w._fields:
                wv, gv = getattr(w, f), getattr(g, f)
                assert (wv is None) == (gv is None), f
                if wv is not None:
                    assert np.array_equal(np.asarray(wv), gv[b].numpy()), \
                        (b, f)
    assert int(ports[1].n_ev.max()) > cap          # the cap drops


def test_writer_lines_equal_reference_and_round_trip(tmp_path, reference):
    want = reference["edge-faulted"][0]
    eng = make("edge-faulted", False, record="full",
               record_cap=CAP["edge-faulted"])
    eng.run(CASES["edge-faulted"][1])
    log = eng.last_run_flight
    jpath, tpath = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    jw, tw = JWriter(jpath, run="unit"), FlightWriter(tpath, run="unit")
    assert jw.write(want) == tw.write(log) == len(log)
    jw.close()
    tw.close()
    assert open(tpath).read() == open(jpath).read()
    assert validate_metrics_file(tpath) == len(log)
    back = load_flight_jsonl(tpath)
    assert back.keyset() == log.keyset()
    with pytest.raises(ValueError, match="holds no flight events"):
        load_flight_jsonl(tpath, run_id="nope")


def test_run_verified_and_run_stream_carry_the_record_plane():
    eng = make("eager-faulted", False, verify="digest",
               record="deliveries", record_cap=4096)
    _, tr_ = eng.run_verified(40, chunk=8)
    log = eng.last_run_flight
    assert int((log.kind == EV_DELIVER).sum()) == int(tr_.recv_count.sum())
    assert eng.last_run_integrity["rollbacks"] == 0
    one = make("eager-faulted", False, record="deliveries",
               record_cap=4096)
    one.run(40)
    _logs_equal(one.last_run_flight, log, "run_verified vs run")
    sc = _steady(tg, 256)
    link = td.Quantize(td.UniformDelay(500, 4_500), 1_000)
    fl = TorchEngine(sc, link, window="auto", batch=BatchSpec(seeds=(1, 2)),
                     record="full", record_cap=1024, device="cpu")
    fl.run_stream(24, chunk=5)
    whole = TorchEngine(sc, link, window="auto", batch=BatchSpec(
        seeds=(1, 2)), record="full", record_cap=1024, device="cpu")
    whole.run(24)
    _logs_equal(whole.last_run_flight, fl.last_run_flight, "run_stream")

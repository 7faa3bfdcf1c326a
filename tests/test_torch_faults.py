"""Fault injection in the port (``timewarp_tpu_torch/faults/``, the
``faults=`` of ``TorchEngine`` and ``EdgeEngine``) against the JAX package,
mirroring tests/test_zfault_parity.py and tests/test_zfault_schedule.py.

- the token ring's mixed schedule (reset crash, crash, partition,
  degradation, clock skew) on the eager path, and burst gossip's mixed
  schedule under a 3 ms window on the adaptive path (cuts before K2,
  down-window drops after the draw): traces, every ``EngineState`` leaf
  and ``fault_dropped > 0`` equal ``JaxEngine``'s;
- the edge engine's mixed schedule against the JAX ``EdgeEngine``;
- the 3-world chaos fleet: world b equals the JAX fleet's world b and the
  port's solo run with ``fleet.world_schedule(b)``; the unpadded solo run
  trace-equals it (padding rows are inert);
- the 2-world faulted steady-gossip fleet of
  ``test_insert_faulted_batched_world_axis`` against
  ``JaxEngine(insert="interpret")`` (the Pallas kernels over the world
  axis);
- faulted resume; the engines' fault guards;
- the port's copies of the schedule tables, the fleet padding, the
  grammar and the properties equal the reference's on the reference
  tests' schedules, and the torch masks equal ``faults/apply.py``'s.

Tolerance: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import timewarp_tpu.faults as jf
from timewarp_tpu.faults import apply as japply
from timewarp_tpu.interp.jax_engine.batched import BatchSpec as JSpec
from timewarp_tpu.interp.jax_engine.batched import world_slice as jslice
from timewarp_tpu.interp.jax_engine.edge_engine import EdgeEngine as JEdge
from timewarp_tpu.interp.jax_engine.edge_engine import EdgeState as JEState
from timewarp_tpu.interp.jax_engine.engine import EngineState as JState
from timewarp_tpu.interp.jax_engine.engine import JaxEngine
from timewarp_tpu.models import gossip as jg
from timewarp_tpu.models import token_ring as jr
from timewarp_tpu.net import delays as jd
from timewarp_tpu.trace.events import (assert_states_equal,
                                       assert_traces_equal)
import timewarp_tpu_torch.faults as tf
from timewarp_tpu_torch.faults import apply as tapply
from timewarp_tpu_torch.interp.torch_engine.batched import (BatchSpec,
                                                            world_slice)
from timewarp_tpu_torch.interp.torch_engine.edge_engine import EdgeEngine
from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
from timewarp_tpu_torch.interp.torch_engine.state_io import (
    edge_state_to_numpy, state_to_numpy)
from timewarp_tpu_torch.models import gossip as tg
from timewarp_tpu_torch.models import token_ring as tr
from timewarp_tpu_torch.net import delays as td


def _np(st):
    return JState(**state_to_numpy(st))


def _ring_sched(F):
    return F.FaultSchedule((
        F.NodeCrash(3, 40_000, 90_000, reset_state=True),
        F.NodeCrash(5, 20_000, 50_000),
        F.Partition(((0, 1, 2, 3, 4, 5, 6, 7),
                     (8, 9, 10, 11, 12, 13, 14, 15)), 60_000, 120_000),
        F.LinkWindow(None, None, 150_000, 180_000, scale=2.5,
                     extra_us=500),
        F.ClockSkew(2, 250),
    ))


def _gossip_sched(F):
    return F.FaultSchedule((
        F.NodeCrash(3, 10_000, 60_000, reset_state=True),
        F.NodeCrash(17, 5_000, 30_000),
        F.Partition((tuple(range(32)), tuple(range(32, 64))),
                    20_000, 80_000),
        F.LinkWindow(tuple(range(16)), None, 90_000, 140_000,
                     scale=2.0, extra_us=1_000),
    ))


def _ring16(mod):
    return (mod.token_ring(16, n_tokens=6, think_us=5_000,
                           bootstrap_us=1_000, end_us=400_000),
            mod.token_ring_links(16))


def _gossip64(gmod, dmod):
    return (gmod.gossip(64, fanout=4, think_us=700, burst=True,
                        end_us=400_000, mailbox_cap=16),
            dmod.Quantize(dmod.UniformDelay(3_000, 9_000), 1_000))


def test_token_ring_mixed_schedule_eager():
    """Eager routing (observer hub, ``FnDelay`` can-drop link) under the
    full fault mix: traces, state and counters equal the reference's."""
    jsc, jl = _ring16(jr)
    tsc, tl = _ring16(tr)
    js, jt = JaxEngine(jsc, jl, insert="xla",
                       faults=_ring_sched(jf)).run(400)
    eng = TorchEngine(tsc, tl, faults=_ring_sched(tf), device="cpu")
    assert not eng.adaptive
    ts, tt = eng.run(400)
    assert_traces_equal(jt, tt, "jax", "port")
    assert_states_equal(js, _np(ts), "ring mixed schedule")
    assert int(ts.fault_dropped) > 0
    assert ts.restart_done.tolist() == [True, False]   # the reset row


def test_gossip_windowed_mixed_schedule_adaptive():
    """The adaptive path under a 3 ms window: partition cuts before K2,
    the faulted tail sampled before the sort, down-window drops."""
    jsc, jl = _gossip64(jg, jd)
    tsc, tl = _gossip64(tg, td)
    js, jt = JaxEngine(jsc, jl, insert="xla", window=3_000,
                       faults=_gossip_sched(jf)).run(600)
    eng = TorchEngine(tsc, tl, window=3_000, faults=_gossip_sched(tf),
                      device="cpu")
    assert eng.adaptive
    ts, tt = eng.run(600)
    assert_traces_equal(jt, tt, "jax", "port")
    assert_states_equal(js, _np(ts), "gossip mixed schedule")
    assert int(ts.fault_dropped) > 0


def test_edge_engine_mixed_schedule():
    """The static-topology ring on the edge engine, classic W = 1: the
    same masks, per-edge queues, parity in the no-overflow regime."""
    def case(mod, dmod, F):
        sc = mod.token_ring(24, n_tokens=8, think_us=4_000,
                            bootstrap_us=1_000, end_us=400_000,
                            with_observer=False, mailbox_cap=8)
        sched = F.FaultSchedule((
            F.NodeCrash(3, 30_000, 80_000, reset_state=True),
            F.NodeCrash(10, 50_000, 120_000),
            F.Partition((tuple(range(12)), tuple(range(12, 24))),
                        60_000, 100_000),
            F.LinkWindow(None, None, 150_000, 200_000, scale=3.0),
        ))
        return sc, dmod.UniformDelay(1_000, 5_000), sched
    jsc, jl, jsched = case(jr, jd, jf)
    tsc, tl, tsched = case(tr, td, tf)
    js, jt = JEdge(jsc, jl, cap=4, faults=jsched).run(800)
    ts, tt = EdgeEngine(tsc, tl, cap=4, faults=tsched,
                        device="cpu").run(800)
    assert_traces_equal(jt, tt, "jax", "port")
    assert_states_equal(js, JEState(**edge_state_to_numpy(ts)), "edge")
    assert int(ts.overflow) == 0
    assert int(ts.fault_dropped) > 0


def _chaos_scheds(F):
    return tuple(F.FaultSchedule((
        F.NodeCrash(b + 1, 10_000 + 1_000 * b, 50_000,
                    reset_state=(b % 2 == 0)),
        F.Partition((tuple(range(32)), tuple(range(32, 64))),
                    20_000, 60_000 + 5_000 * b),
    )) for b in range(3))


def test_chaos_fleet_slice_exactness():
    """World b of a FaultFleet run ≡ world b of the JAX fleet ≡ the port's
    solo run with ``fleet.world_schedule(b)`` (padded); the unpadded solo
    run trace-equals it and counts the same ``fault_dropped``."""
    seeds = (0, 1, 5)
    jsc, jl = _gossip64(jg, jd)
    tsc, tl = _gossip64(tg, td)
    jfin, jtr = JaxEngine(jsc, jl, insert="xla", window=3_000,
                          batch=JSpec(seeds=seeds),
                          faults=jf.FaultFleet(_chaos_scheds(jf))).run(300)
    scheds = _chaos_scheds(tf)
    fleet = tf.FaultFleet(scheds)
    eng = TorchEngine(tsc, tl, window=3_000, batch=BatchSpec(seeds=seeds),
                      faults=fleet, device="cpu")
    bf, btr = eng.run(300)
    assert tuple(bf.restart_done.shape) == (3, 1)
    for b in range(3):
        assert_traces_equal(jtr[b], btr[b], f"jax world{b}", "port")
        assert_states_equal(jslice(jfin, b), _np(world_slice(bf, b)),
                            f"world {b}")
        sf, strc = TorchEngine(tsc, tl, window=3_000, seed=seeds[b],
                               faults=fleet.world_schedule(b),
                               device="cpu").run(300)
        assert_traces_equal(strc, btr[b], "solo", f"world{b}")
        assert_states_equal(_np(sf), _np(world_slice(bf, b)), f"solo {b}")
    uf, utr = TorchEngine(tsc, tl, window=3_000, seed=5, faults=scheds[2],
                          device="cpu").run(300)
    assert_traces_equal(utr, btr[2], "unpadded-solo", "world2")
    assert int(uf.fault_dropped) == int(bf.fault_dropped[2]) > 0


def test_faulted_fleet_equals_pallas_interpret():
    """``test_insert_faulted_batched_world_axis``'s fleet (steady gossip
    at 1024 nodes, per-world reset crashes and partitions) against the
    JAX engine with its Pallas kernels under the interpreter: K2 and K1
    across the world axis in the port, every mask point around them."""
    def case(gmod, dmod, F, Spec):
        N, half = 1024, 512
        fleet = F.FaultFleet(tuple(F.FaultSchedule((
            F.NodeCrash((7 * b + 3) % N, 20_000, 60_000 + 5_000 * b,
                        reset_state=True),
            F.Partition((tuple(range(half)), tuple(range(half, N))),
                        25_000, 70_000 + 2_000 * b),
        )) for b in range(2)))
        sc = gmod.gossip(N, fanout=1, think_us=1_000, gossip_interval=1_000,
                         end_us=200_000, steady=True, mailbox_cap=8)
        link = dmod.Quantize(dmod.UniformDelay(500, 4_500), 1_000)
        return sc, link, dict(window="auto", batch=Spec(seeds=(0, 1)),
                              faults=fleet)
    jsc, jl, jkw = case(jg, jd, jf, JSpec)
    tsc, tl, tkw = case(tg, td, tf, BatchSpec)
    pal = JaxEngine(jsc, jl, insert="interpret", **jkw)
    eng = TorchEngine(tsc, tl, device="cpu", **tkw)
    assert eng.adaptive and eng.window == 1_000
    ps, ts = pal.init_state(), eng.init_state()
    for k in (5, 24):
        ps, ts = pal.run_quiet(k, ps), eng.run_quiet(k, ts)
        assert_states_equal(ps, _np(ts), f"faulted fleet +{k}")
    _, jtr = pal.run(6, ps)
    _, ttr = eng.run(6, ts)
    for b in range(2):
        assert_traces_equal(jtr[b], ttr[b], f"w{b}-pallas", f"w{b}-port")
    assert (ts.fault_dropped > 0).all()


def test_faulted_resume():
    """The restart ledger is state: run(100) + run(140) ≡ run(240)."""
    tsc, tl = _ring16(tr)
    e = TorchEngine(tsc, tl, faults=_ring_sched(tf), device="cpu")
    full_st, full_tr = e.run(240)
    mid, tr1 = e.run(100)
    st2, tr2 = e.run(140, state=mid)
    assert len(tr1) + len(tr2) == len(full_tr)
    assert np.array_equal(np.concatenate([tr1.recv_hash, tr2.recv_hash]),
                          full_tr.recv_hash)
    assert_states_equal(_np(full_st), _np(st2), "faulted resume")


def test_engine_fault_guards():
    sc = tr.token_ring(8, n_tokens=8, think_us=3_000, bootstrap_us=1_000,
                       end_us=200_000, with_observer=False, mailbox_cap=8)
    link = td.FixedDelay(500)
    sched = tf.FaultSchedule((tf.NodeCrash(1, 0, 10),))
    with pytest.raises(ValueError, match="route_cap"):
        TorchEngine(sc, link, faults=sched, route_cap=64, device="cpu")
    with pytest.raises(ValueError, match="FaultSchedule"):
        TorchEngine(sc, link, faults="crash:1:0:10", device="cpu")
    with pytest.raises(ValueError, match="batch=BatchSpec"):
        TorchEngine(sc, link, faults=tf.FaultFleet((sched,)), device="cpu")
    with pytest.raises(ValueError, match="world schedules"):
        TorchEngine(sc, link, batch=BatchSpec(seeds=(0, 1, 2)),
                    faults=tf.FaultFleet((sched, sched)), device="cpu")
    shrink = tf.FaultSchedule((
        tf.LinkWindow(None, None, 0, 10_000, scale=0.1),))
    wlink = td.Quantize(td.UniformDelay(3_000, 9_000), 1_000)
    with pytest.raises(ValueError, match="min_delay_us"):
        TorchEngine(sc, wlink, window=3_000, faults=shrink, device="cpu")
    # auto resolves to the degraded floor: 3000 µs * 1/10 = 300 µs
    assert TorchEngine(sc, wlink, window="auto", faults=shrink,
                       device="cpu").window == 300
    with pytest.raises(ValueError, match="one world"):
        EdgeEngine(sc, link, faults=tf.FaultFleet((sched,)), device="cpu")


# -- the schedule copy and the masks -----------------------------------------

_SCHEDULES = {
    "ring": _ring_sched, "gossip": _gossip_sched,
    "edge": lambda F: F.FaultSchedule((
        F.NodeCrash(3, 30_000, 80_000, reset_state=True),
        F.Partition((tuple(range(12)), tuple(range(12, 24))),
                    60_000, 100_000),
        F.LinkWindow(None, None, 150_000, 200_000, scale=3.0))),
    "padding": lambda F: F.FaultSchedule((
        F.NodeCrash(2, 30, 40, reset_state=True), F.NodeCrash(3, 50, 60),
        F.LinkWindow((0,), (1,), 5, 9, scale=2.0),
        F.ClockSkew(1, -7), F.ClockSkew(1, 3)), pad=(1, 2, 1)),
}


@pytest.mark.parametrize("name", sorted(_SCHEDULES))
def test_schedule_tables_equal_reference(name):
    """Tables, fleet stacking and padding, the degraded floors and the
    grammar round trip of the port's copy equal the reference's."""
    js, ts = _SCHEDULES[name](jf), _SCHEDULES[name](tf)
    for n in (16, 64):
        for a, b in zip(js.tables(n), ts.tables(n)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for floor in (1, 1_000, 3_000):
        assert js.min_delay_floor(floor) == ts.min_delay_floor(floor)
        assert js.min_delay_floor_in(floor, 0, 100_000) == \
            ts.min_delay_floor_in(floor, 0, 100_000)
    assert (js.has_skew, js.has_reset, js.n_restarts) == \
        (ts.has_skew, ts.has_reset, ts.n_restarts)
    jfl = jf.FaultFleet((js, _SCHEDULES["padding"](jf)))
    tfl = tf.FaultFleet((ts, _SCHEDULES["padding"](tf)))
    for a, b in zip(jfl.tables(64), tfl.tables(64)):
        assert np.array_equal(a, b)
    for b in range(2):
        for x, y in zip(jfl.world_schedule(b).tables(64),
                        tfl.world_schedule(b).tables(64)):
            assert np.array_equal(x, y)
    text = jf.schedule.format_faults(js)
    assert tf.schedule.format_faults(ts) == text
    assert tf.parse_faults(text).events == ts.events


@pytest.mark.parametrize("spec", [
    "crash:3:10ms:20ms:reset; partition:0-3|4-7:5ms:1s",
    "degrade:all:0+2:0:500:1.5:10; skew:4:-250us",
    "crash:1:0:10; crash:2:5:6; degrade:0-1:all:1:2:0.5"])
def test_parse_faults_equals_reference(spec):
    assert tf.parse_faults(spec).events == tuple(
        _same(e) for e in jf.parse_faults(spec).events)
    with pytest.raises(SystemExit, match="grammar"):
        tf.parse_faults(spec.replace(":", "/", 1))


def _same(e):
    """A reference event as the port's class, field for field."""
    return getattr(tf, type(e).__name__)(*(
        getattr(e, f) for f in type(e).__dataclass_fields__))


def test_properties_equal_reference():
    from timewarp_tpu.trace.events import SuperstepTrace as JTrace
    from timewarp_tpu_torch.trace.events import SuperstepTrace as TTrace
    rows = [(t, 1, 0, r, 0, 0, 0, 0)
            for t, r in ((10, 1), (20, 0), (30, 2), (40, 0))]
    jt, tt = JTrace.from_rows(rows), TTrace.from_rows(rows)
    for after in (0, 25, 35):
        assert jf.eventually_delivered(jt, after) == \
            tf.eventually_delivered(tt, after)
    for pred in (lambda r: r.recv_count >= 1, lambda r: r.recv_count <= 2,
                 lambda r: r.recv_count == 0):
        assert jf.converged(jt, pred) == tf.converged(tt, pred)
    sched = tf.FaultSchedule((tf.NodeCrash(2, 20_000, 70_000),))
    assert tf.no_fire_while_down([("fire", 70_000, 2)], sched)
    assert not tf.no_fire_while_down([("fire", 30_000, 2)], sched)


def test_masks_equal_reference_apply():
    """Every torch mask of faults/apply.py, over a world axis and solo,
    equals the reference's (``vmap``-ed over the worlds) on random
    operands — ``window_floor`` too, which only the reference's dispatch
    controller calls."""
    rng = np.random.default_rng(7)
    n, B, S = 64, 3, 100
    scheds = [_SCHEDULES[k] for k in ("gossip", "padding", "edge")]
    jt = jf.FaultFleet(tuple(s(jf) for s in scheds)).tables(n)
    tt = tapply.device_tables(
        tf.FaultFleet(tuple(s(tf) for s in scheds)).tables(n), "cpu")
    ids = np.arange(n, dtype=np.int32)
    jids, tids = jnp.asarray(ids), torch.as_tensor(ids)
    src = rng.integers(0, n, (B, S)).astype(np.int32)
    dst = rng.integers(0, n, (B, S)).astype(np.int32)
    tms = rng.integers(0, 220_000, (B, S)).astype(np.int64)
    delay = rng.integers(1, 20_000, (B, S)).astype(np.int64)
    nn = rng.integers(0, 200_000, (B, n)).astype(np.int64)
    done = rng.random((B, jt.crash_node.shape[1])) < 0.5
    fire = rng.random((B, n)) < 0.5

    def check(jfn, tfn, *args):
        """World form against the vmapped reference, then world 1 solo."""
        def flat(x):
            return x if isinstance(x, tuple) else (x,)
        want = jax.jit(jax.vmap(jfn))(jt, *args)
        got = tfn(tt, *(torch.as_tensor(a) for a in args))
        for w, g in zip(flat(want), flat(got)):
            assert np.array_equal(np.asarray(w), g.numpy()), jfn
        want = jax.jit(jfn)(type(jt)(*(x[1] for x in jt)),
                            *(a[1] for a in args))
        got = tfn(type(tt)(*(x[1] for x in tt)),
                  *(torch.as_tensor(a[1]) for a in args))
        for w, g in zip(flat(want), flat(got)):
            assert np.array_equal(np.asarray(w), g.numpy()), jfn
    check(japply.cut_mask, tapply.cut_mask, src, dst, tms)
    check(japply.down_mask, tapply.down_mask, dst, tms)
    check(japply.degrade, tapply.degrade, delay, src, dst, tms)
    check(lambda ft, x, d: japply.defer_next(ft, jids, x, d),
          lambda ft, x, d: tapply.defer_next(ft, tids, x, d), nn, done)
    check(lambda ft, f, x, d: japply.restart_fire(ft, f, x, jids, d),
          lambda ft, f, x, d: tapply.restart_fire(ft, f, x, tids, d),
          fire, nn, done)
    check(lambda ft, f, x, d: japply.consume_restarts(ft, f, x, jids, d),
          lambda ft, f, x, d: tapply.consume_restarts(ft, f, x, tids, d),
          fire, nn, done)
    for t in (85_000, 139_999):
        tv = np.full((B,), t, np.int64)
        check(lambda ft, x: japply.window_floor(ft, x, jnp.int64(3_000),
                                                3_000),
              lambda ft, x: tapply.window_floor(ft, x, 3_000, 3_000), tv)

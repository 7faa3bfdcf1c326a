"""The port's oracle (``timewarp_tpu_torch/interp/ref/superstep.py``)
against the JAX package's, and the port's ``TorchEngine`` against both:
the configurations of tests/test_parity.py, tests/test_windowed.py and
tests/test_zfault_parity.py, each run through the reference's
``SuperstepOracle``, the port's and ``TorchEngine`` on the CPU — equal
traces (digests included), equal final states and wake times, equal
never-silent counters (overflow, bad destinations, short delays, fault
drops); and the port oracle's per-event debug log equals the
reference's, event for event. Also: the oracle refuses a window past the
link floor and a fleet, takes the engines' ``lint`` knob, and runs on the
card by default (``device="cpu"`` here).

Tolerance: exact (every observable is integer).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from timewarp_tpu import faults as jf
from timewarp_tpu.interp.ref.superstep import SuperstepOracle as JOracle
from timewarp_tpu.models import gossip as jg
from timewarp_tpu.models import ping_pong as jpp
from timewarp_tpu.models import praos as jpr
from timewarp_tpu.models import token_ring as jtr
from timewarp_tpu.net import delays as jd
from timewarp_tpu_torch import faults as tf
from timewarp_tpu_torch.interp.ref.superstep import SuperstepOracle
from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
from timewarp_tpu_torch.models import gossip as tg
from timewarp_tpu_torch.models import ping_pong as tpp
from timewarp_tpu_torch.models import praos as tpr
from timewarp_tpu_torch.models import token_ring as ttr
from timewarp_tpu_torch.net import delays as td

# one intra-op thread per test process: the test session's workers
# share the host's cores (a process of the default width each
# oversubscribes them several times over)
torch.set_num_threads(1)

CPU = "cpu"
J = {"g": jg, "pp": jpp, "pr": jpr, "tr": jtr, "d": jd, "f": jf}
T = {"g": tg, "pp": tpp, "pr": tpr, "tr": ttr, "d": td, "f": tf}
_FIELDS = ("times", "fired_count", "fired_hash", "recv_count", "recv_hash",
           "sent_count", "sent_hash", "overflow")


def _rows(tr):
    return np.stack([np.asarray(getattr(tr, f)).astype(np.int64)
                     for f in _FIELDS], axis=1)


def _hub(m, sc):
    """tests/test_parity.py's overflow hub: every send to node 0."""
    base = sc.step

    def hub_step(state, inbox, now, i, key):
        st, out, wake = base(state, inbox, now, i, key)
        zeros = jnp.zeros_like if m is J else torch.zeros_like
        return st, out._replace(dst=zeros(out.dst)), wake
    sc.step = hub_step
    return sc


def _bad_dst(m, sc):
    """tests/test_parity.py's out-of-range destinations."""
    base = sc.step

    def bad_step(state, inbox, now, i, key):
        st, out, wake = base(state, inbox, now, i, key)
        return st, out._replace(dst=out.dst + 1000), wake
    sc.step = bad_step
    return sc


def _ring_sched(m):
    f = m["f"]
    return f.FaultSchedule((
        f.NodeCrash(3, 40_000, 90_000, reset_state=True),
        f.NodeCrash(5, 20_000, 50_000),
        f.Partition(((0, 1, 2, 3, 4, 5, 6, 7),
                     (8, 9, 10, 11, 12, 13, 14, 15)), 60_000, 120_000),
        f.LinkWindow(None, None, 150_000, 180_000, scale=2.5,
                     extra_us=500),
        f.ClockSkew(2, 250)))


def _gossip_sched(m):
    f = m["f"]
    return f.FaultSchedule((
        f.NodeCrash(3, 10_000, 60_000, reset_state=True),
        f.NodeCrash(17, 5_000, 30_000),
        f.Partition((tuple(range(32)), tuple(range(32, 64))),
                    20_000, 80_000),
        f.LinkWindow(tuple(range(16)), None, 90_000, 140_000,
                     scale=2.0, extra_us=1_000)))


def _edge_sched(m):
    f = m["f"]
    return f.FaultSchedule((
        f.NodeCrash(3, 30_000, 80_000, reset_state=True),
        f.NodeCrash(10, 50_000, 120_000),
        f.Partition((tuple(range(12)), tuple(range(12, 24))),
                    60_000, 100_000),
        f.LinkWindow(None, None, 150_000, 200_000, scale=3.0)))


def _wlink(m):
    return m["d"].Quantize(m["d"].UniformDelay(3_000, 9_000), 1_000)


#: name -> (scenario(m), link(m), steps, oracle kw(m), what must happen)
CONFIGS = {
    # tests/test_parity.py
    "ping-pong": (lambda m: m["pp"].ping_pong(rounds=20),
                  lambda m: m["d"].FixedDelay(500), 200, None, "delivered"),
    "ring-64-observer": (
        lambda m: m["tr"].token_ring(64, think_us=10_000,
                                     bootstrap_us=1_000, end_us=1_000_000),
        lambda m: m["tr"].token_ring_links(64), 400, None, "delivered"),
    "ring-uniform": (
        lambda m: m["tr"].token_ring(16, think_us=5_000, bootstrap_us=1_000,
                                     end_us=500_000, with_observer=False),
        lambda m: m["d"].UniformDelay(1000, 5000), 300, None, "delivered"),
    "ring-drop": (
        lambda m: m["tr"].token_ring(8, n_tokens=4, think_us=2_000,
                                     bootstrap_us=500, end_us=300_000,
                                     with_observer=False),
        lambda m: m["d"].WithDrop(m["d"].UniformDelay(500, 1500), 0.3),
        300, None, "delivered"),
    "dense-ring": (
        lambda m: m["tr"].token_ring(32, n_tokens=32, think_us=1,
                                     bootstrap_us=10, end_us=50_000,
                                     with_observer=False, mailbox_cap=8),
        lambda m: m["d"].FixedDelay(100), 600, None, "delivered"),
    "overflow-hub": (
        lambda m: _hub(m, m["tr"].token_ring(
            8, n_tokens=8, think_us=1, bootstrap_us=10, end_us=20_000,
            with_observer=False, mailbox_cap=2)),
        lambda m: m["d"].FixedDelay(50), 200, None, "overflow"),
    "bad-dst": (
        lambda m: _bad_dst(m, m["tr"].token_ring(
            8, think_us=10, bootstrap_us=10, end_us=5_000,
            with_observer=False)),
        lambda m: m["d"].FixedDelay(5), 50, None, "bad_dst"),
    # tests/test_windowed.py
    "windowed-praos": (
        lambda m: m["pr"].praos(48, slot_us=20_000, n_slots=6,
                                leader_prob=2.0 / 48, fanout=4,
                                relay_interval=500, mailbox_cap=16),
        _wlink, 600, lambda m: {"window": 3_000}, "delivered"),
    "windowed-gossip": (
        lambda m: m["g"].gossip(64, fanout=4, think_us=700,
                                gossip_interval=500, end_us=400_000,
                                mailbox_cap=16),
        _wlink, 600, lambda m: {"window": 3_000}, "delivered"),
    # tests/test_zfault_parity.py
    "faulted-ring": (
        lambda m: m["tr"].token_ring(16, n_tokens=6, think_us=5_000,
                                     bootstrap_us=1_000, end_us=400_000),
        lambda m: m["tr"].token_ring_links(16), 400,
        lambda m: {"faults": _ring_sched(m)}, "fault_dropped"),
    "faulted-gossip-windowed": (
        lambda m: m["g"].gossip(64, fanout=4, think_us=700, burst=True,
                                end_us=400_000, mailbox_cap=16),
        _wlink, 600,
        lambda m: {"window": 3_000, "faults": _gossip_sched(m)},
        "fault_dropped"),
    "faulted-lean-ring": (
        lambda m: m["tr"].token_ring(24, n_tokens=8, think_us=4_000,
                                     bootstrap_us=1_000, end_us=400_000,
                                     with_observer=False, mailbox_cap=8),
        lambda m: m["d"].UniformDelay(1_000, 5_000), 2000,
        lambda m: {"faults": _edge_sched(m)}, "fault_dropped"),
}

_COUNTERS = (("overflow_total", "overflow"), ("bad_dst_total", "bad_dst"),
             ("short_delay_total", "short_delay"),
             ("fault_dropped_total", "fault_dropped"))


def _leaf(x, u32=False):
    a = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    return a.astype(np.uint32) if u32 else a


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_oracle_equals_reference_oracle_and_engine(name):
    build, link, steps, kw, must = CONFIGS[name]
    jkw = kw(J) if kw else {}
    tkw = kw(T) if kw else {}
    sc = build(T)
    jo = JOracle(build(J), link(J), **jkw)
    jt = jo.run(steps)
    po = SuperstepOracle(sc, link(T), device=CPU, **tkw)
    pt = po.run(steps)
    st, et = TorchEngine(sc, link(T), device=CPU, **tkw).run(steps)
    assert np.array_equal(_rows(pt), _rows(jt))
    assert np.array_equal(_rows(pt), _rows(et))
    for ocount, leaf in _COUNTERS:
        want = getattr(jo, ocount)
        assert getattr(po, ocount) == want == int(getattr(st, leaf)), \
            ocount
    assert {"delivered": int(st.delivered) > 0,
            "overflow": po.overflow_total > 0,
            "bad_dst": po.bad_dst_total > 0,
            "fault_dropped": po.fault_dropped_total > 0}[must]
    u32 = set(sc.u32_states)
    for k, v in po.states.items():
        ref = np.asarray(jo.states[k])
        assert np.array_equal(_leaf(v, k in u32), ref), k
        assert np.array_equal(_leaf(st.states[k], k in u32), ref), k
    assert po.wake == [int(w) for w in jo.wake] == st.wake.tolist()
    assert po.last_run_stats["supersteps"] == len(pt)


def test_event_logs_equal_reference():
    """tests/test_parity.py's ``record_events`` aggregates, and the two
    oracles' logs event for event (a faulted ring too: the restart
    firing at t_up, no firing while down)."""
    def build(m):
        return m["tr"].token_ring(32, n_tokens=4, think_us=3_000,
                                  bootstrap_us=1000, end_us=150_000,
                                  with_observer=True, mailbox_cap=16)
    po = SuperstepOracle(build(T), ttr.token_ring_links(32),
                         record_events=True, device=CPU)
    tr = po.run(2000)
    jo = JOracle(build(J), jtr.token_ring_links(32), record_events=True)
    jo.run(2000)
    assert po.events == [tuple(int(x) if not isinstance(x, str) else x
                               for x in e) for e in jo.events]
    kinds = [e[0] for e in po.events]
    assert kinds.count("fire") == int(tr.fired_count.sum())
    assert kinds.count("recv") == int(tr.recv_count.sum())
    assert kinds.count("sent") == int(tr.sent_count.sum())
    assert SuperstepOracle(build(T), ttr.token_ring_links(32),
                           device=CPU).events is None

    def ring(m):
        return m["tr"].token_ring(8, n_tokens=8, think_us=3_000,
                                  bootstrap_us=1_000, end_us=200_000,
                                  with_observer=False, mailbox_cap=8)

    def sched(m):
        return m["f"].FaultSchedule((m["f"].NodeCrash(
            2, 20_000, 70_000, reset_state=True),))
    po = SuperstepOracle(ring(T), td.UniformDelay(1_000, 4_000),
                         faults=sched(T), record_events=True, device=CPU)
    po.run(2000)
    jo = JOracle(ring(J), jd.UniformDelay(1_000, 4_000), faults=sched(J),
                 record_events=True)
    jo.run(2000)
    assert po.events == [tuple(int(x) if not isinstance(x, str) else x
                               for x in e) for e in jo.events]
    from timewarp_tpu_torch.faults.properties import no_fire_while_down
    assert no_fire_while_down(po.events, sched(T))
    assert [e for e in po.events
            if e[0] == "fire" and e[2] == 2 and e[1] == 70_000]


def test_oracle_refusals_and_device():
    sc = tg.gossip(64, fanout=4, think_us=700, gossip_interval=500,
                   end_us=400_000, mailbox_cap=16)
    with pytest.raises(ValueError, match="min_delay_us"):
        SuperstepOracle(sc, td.UniformDelay(1_000, 5_000), window=2_000,
                        device=CPU)
    with pytest.raises(ValueError, match="'auto'"):
        SuperstepOracle(sc, td.UniformDelay(1_000, 5_000), window="8ms",
                        device=CPU)
    fleet = tf.FaultFleet((tf.FaultSchedule(()),))
    with pytest.raises(ValueError, match="one world"):
        SuperstepOracle(sc, td.UniformDelay(1_000, 5_000), faults=fleet,
                        device=CPU)
    o = SuperstepOracle(sc, _wlink(T), window="auto", device=CPU)
    assert o.window == 3_000
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SuperstepOracle(sc, _wlink(T))


def test_short_delay_counted_as_reference():
    """tests/test_windowed.py's lying link: a declared floor above the
    real delays is caught by the short-delay counter, never silent."""
    class Liar(td.UniformDelay):
        @property
        def min_delay_us(self):
            return 2_000

    class JLiar(jd.UniformDelay):
        @property
        def min_delay_us(self):
            return 2_000
    sc = tg.gossip(64, fanout=4, think_us=700, gossip_interval=500,
                   end_us=400_000, mailbox_cap=16)
    jsc = jg.gossip(64, fanout=4, think_us=700, gossip_interval=500,
                    end_us=400_000, mailbox_cap=16)
    po = SuperstepOracle(sc, Liar(500, 5_000), window=2_000, device=CPU)
    pt = po.run(300)
    jo = JOracle(jsc, JLiar(500, 5_000), window=2_000)
    jt = jo.run(300)
    assert np.array_equal(_rows(pt), _rows(jt))
    assert po.short_delay_total == jo.short_delay_total > 0

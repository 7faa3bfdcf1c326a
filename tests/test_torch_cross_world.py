"""The cross-world law on the port: a net program (``models/*_net.py``,
effect programs over the network stack under the DES) and its batched
scenario (``models/*.py`` under ``SuperstepOracle`` and ``TorchEngine``)
give the same application event stream, µs for µs.

Every case of ``tests/test_cross_world.py``, ``test_cross_world_more.py``
and ``test_cross_world_socket_state.py`` runs here on the port's twins:

- port twin ≡ reference twin: the port's ``token_ring_net``,
  ``ping_pong_net``, ``gossip_net``, ``praos_net`` and
  ``socket_state_net`` under the port's DES give the same events and
  results as the reference's under the reference's DES, on the same
  links (the reference's in ``jax.numpy``, the port's in torch);
- port twin ≡ the closed-form prediction of the reference's tests;
- port twin ≡ the port's ``SuperstepOracle`` ≡ ``TorchEngine(device=
  "cpu")`` on the batched twin (traces bit for bit).

The reference's wall-clock case (``test_net_world_values_under_real_
asyncio``) has no twin here: it measures the host's scheduling, not the
port. Tolerance: exact (every value compared with ``==``).
"""

import numpy as np
import pytest
import torch

import test_cross_world as ref_cw
import test_cross_world_more as ref_more
from timewarp_tpu.interp.ref.des import run_emulation as ref_run_emulation
from timewarp_tpu.models import gossip_net as ref_gossip_net
from timewarp_tpu.models import ping_pong_net as ref_ping_pong_net
from timewarp_tpu.models import praos_net as ref_praos_net
from timewarp_tpu.models import socket_state_net as ref_socket_state_net
from timewarp_tpu.models import token_ring_net as ref_token_ring_net
from timewarp_tpu.net import backend as ref_backend
from timewarp_tpu.net import delays as ref_delays
from timewarp_tpu_torch.interp.ref.des import run_emulation
from timewarp_tpu_torch.interp.ref.superstep import SuperstepOracle
from timewarp_tpu_torch.interp.torch_engine.edge_engine import EdgeEngine
from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
from timewarp_tpu_torch.interp.torch_engine.fused_sparse import \
    FusedSparseEngine
from timewarp_tpu_torch.models.gossip import gossip
from timewarp_tpu_torch.models.gossip_net import (gossip_net,
                                                  gossip_net_ports,
                                                  host_lcg_peers, lcg_init)
from timewarp_tpu_torch.models.ping_pong import ping_pong
from timewarp_tpu_torch.models.ping_pong_net import ping_pong_net
from timewarp_tpu_torch.models.praos import praos
from timewarp_tpu_torch.models.praos_net import (leader_schedule, praos_net,
                                                 praos_net_ports)
from timewarp_tpu_torch.models.socket_state import (roulette_sends,
                                                    socket_state)
from timewarp_tpu_torch.models.socket_state_net import socket_state_net
from timewarp_tpu_torch.models.token_ring import token_ring
from timewarp_tpu_torch.models.token_ring_net import (OBSERVER_PORT,
                                                      token_ring_net)
from timewarp_tpu_torch.net.backend import EmulatedBackend, endpoint_id
from timewarp_tpu_torch.net.delays import (FixedDelay, FnDelay, Quantize,
                                           SeededHashUniform, UniformDelay)
from timewarp_tpu_torch.trace.events import assert_traces_equal

# one intra-op thread per test process: the test session's workers
# share the host's cores
torch.set_num_threads(1)

CPU = "cpu"
N_RING, B, D, O = ref_cw.N_RING, ref_cw.B, ref_cw.D, ref_cw.O
THINK, DURATION = ref_cw.THINK, ref_cw.DURATION


def _i64(x, like):
    return torch.full_like(like, x, dtype=torch.int64)


def _no_drop(d):
    return torch.zeros_like(d, dtype=torch.bool)


def _net_delays():
    """test_cross_world ``_net_delays`` in torch: observer-bound chunks
    take O, everything else D."""
    obs = endpoint_id(f"127.0.0.1:{OBSERVER_PORT}")

    def fn(src, dst, t, key):
        d = torch.where((dst & 0xFFFFFFFF) == obs, _i64(O, dst),
                        _i64(D, dst))
        return d, _no_drop(d)
    return FnDelay(fn)


def _batched_links():
    def fn(src, dst, t, key):
        d = torch.where(dst == N_RING, _i64(O, dst), _i64(D, dst))
        return d, _no_drop(d)
    return FnDelay(fn)


def _rnd():
    return SeededHashUniform(ref_cw.RND_LO, ref_cw.RND_HI, ref_cw.RND_SALT)


def _net_delays_random():
    """test_cross_world ``_net_delays_random`` in torch."""
    rnd = _rnd()

    def fn(src, dst, t, key):
        d32 = dst & 0xFFFFFFFF
        du = rnd.sample(src, dst, t, None)[0]
        d = torch.where(d32 == N_RING, _i64(O, du),
                        torch.where(d32 < N_RING, du, _i64(D, du)))
        return d, _no_drop(d)
    return FnDelay(fn)


def _batched_links_random():
    rnd = _rnd()

    def fn(src, dst, t, key):
        du = rnd.sample(src, dst, t, None)[0]
        return torch.where(dst == N_RING, _i64(O, du), du), _no_drop(du)
    return FnDelay(fn)


def _draw(model, dst, t) -> int:
    """One (dst, t)-keyed draw of a seeded model on the host."""
    return int(model.sample(None, torch.tensor(dst, dtype=torch.int64), t,
                            None)[0])


def _closed_form(draw=lambda dst, t: D):
    """test_cross_world's ``_closed_form`` (fixed hops) and
    ``_closed_form_random`` (``draw`` the seeded hop), one algebra."""
    receipts, notes = [], []
    v, t_send = 1, B
    R = t_send + draw(1 % N_RING, t_send)
    while R < DURATION:
        receipts.append((R, v % N_RING + 1, v))
        notes.append((R + O, v))
        t_send = R + O + D + THINK
        v += 1
        R = t_send + draw(v % N_RING, t_send)
    return receipts, notes


def _ring_net(run, net, backend):
    receipts = []
    notes, errors = run(net(
        backend, N_RING, duration_us=DURATION, passing_delay_us=THINK,
        bootstrap_us=B, prewarm=True, bootstrap_at=True,
        receipts=receipts))
    return notes, errors, receipts


def _batched(sc, link, steps):
    """The batched twin through the port's oracle (events recorded) and
    ``TorchEngine`` on the CPU."""
    oracle = SuperstepOracle(sc, link, record_events=True, device=CPU)
    otrace = oracle.run(steps)
    state, etrace = TorchEngine(sc, link, device=CPU).run(steps)
    return oracle, otrace, state, etrace


def _ring_streams(oracle):
    recvs = [e for e in oracle.events if e[0] == "recv"]
    receipts = [(t, i + 1, pay) for (_, t, i, src, dt, pay) in recvs
                if i != N_RING and t < DURATION]
    notes = [(t, pay) for (_, t, i, src, dt, pay) in recvs
             if i == N_RING and t < DURATION]
    return receipts, notes


# -- token ring (test_cross_world.py) ---------------------------------------

@pytest.fixture(scope="module")
def ring_worlds():
    port = _ring_net(run_emulation, token_ring_net,
                     EmulatedBackend(_net_delays(), seed=0))
    ref = _ring_net(ref_run_emulation, ref_token_ring_net.token_ring_net,
                    ref_backend.EmulatedBackend(ref_cw._net_delays(),
                                                seed=0))
    sc = token_ring(N_RING, think_us=THINK + O + D, bootstrap_us=B,
                    end_us=DURATION)
    return port, ref, _batched(sc, _batched_links(), 800)


def test_net_world_matches_closed_form(ring_worlds):
    (notes, errors, receipts), ref, _ = ring_worlds
    exp_receipts, exp_notes = _closed_form()
    assert errors == []
    assert receipts == exp_receipts and notes == exp_notes
    assert len(notes) >= 6
    assert (notes, errors, receipts) == ref     # port twin = reference's


def test_batched_world_matches_closed_form(ring_worlds):
    oracle = ring_worlds[2][0]
    assert _ring_streams(oracle) == _closed_form()


def test_cross_world_event_streams_identical(ring_worlds):
    (notes, _, receipts), _, (oracle, *_) = ring_worlds
    assert _ring_streams(oracle) == (receipts, notes)


def test_batched_engine_matches_oracle(ring_worlds):
    _, otrace, state, etrace = ring_worlds[2]
    assert_traces_equal(otrace, etrace)
    assert int(state.overflow) == 0 and int(state.bad_dst) == 0


def _endpoint_map():
    ids = {f"127.0.0.1:{2000 + no}": no - 1 for no in range(1, N_RING + 1)}
    ids[f"127.0.0.1:{OBSERVER_PORT}"] = N_RING
    return ids


@pytest.fixture(scope="module")
def ring_worlds_random():
    # precondition of the dst-keyed mixed model: no ephemeral endpoint
    # name may crc-collide into the mapped id range [0, N_RING]
    for p in range(49152, 49152 + 4 * N_RING + 16):
        assert endpoint_id(f"127.0.0.1:{p}") > N_RING
    port = _ring_net(run_emulation, token_ring_net,
                     EmulatedBackend(_net_delays_random(), seed=0,
                                     endpoint_ids=_endpoint_map()))
    ref = _ring_net(ref_run_emulation, ref_token_ring_net.token_ring_net,
                    ref_backend.EmulatedBackend(
                        ref_cw._net_delays_random(), seed=0,
                        endpoint_ids=ref_cw._endpoint_map()))
    sc = token_ring(N_RING, think_us=THINK + O + D, bootstrap_us=B,
                    end_us=DURATION)
    return port, ref, _batched(sc, _batched_links_random(), 800)


def test_net_world_random_matches_closed_form(ring_worlds_random):
    (notes, errors, receipts), ref, _ = ring_worlds_random
    rnd = _rnd()
    assert errors == []
    assert (receipts, notes) == _closed_form(
        lambda dst, t: _draw(rnd, dst, t))
    assert len(notes) >= 6
    assert (notes, errors, receipts) == ref


def test_cross_world_random_links_identical(ring_worlds_random):
    (notes, _, receipts), _, (oracle, *_) = ring_worlds_random
    assert _ring_streams(oracle) == (receipts, notes)


def test_batched_engine_matches_oracle_random(ring_worlds_random):
    _, otrace, state, etrace = ring_worlds_random[2]
    assert_traces_equal(otrace, etrace)
    assert int(state.overflow) == 0 and int(state.bad_dst) == 0


def test_hand_rolled_trace_matches_both_engines_and_oracle():
    """test_cross_world's hand-rolled dense-ring trace (built from the
    reference's hash functions, no executor) reproduced by the port's
    oracle, ``TorchEngine`` and ``EdgeEngine``."""
    from timewarp_tpu.trace.hashing import (FIRED, RECV, SENT, combine_py,
                                            mix32_py)
    from timewarp_tpu_torch.trace.events import SuperstepTrace
    n, BB, DD, E = 64, 10_000, 700, 16_000
    mask = (1 << 32) - 1
    rows, k = [], 0
    while True:
        t = BB + k * DD
        fired_hash = combine_py(mix32_py(FIRED, i) for i in range(n))
        if k == 0:
            recv_count, recv_hash = 0, combine_py([])
        else:
            recv_count = n
            recv_hash = combine_py(
                mix32_py(RECV, i, (i - 1) % n, t & mask, t >> 32, k)
                for i in range(n))
        if t < E:
            dt = t + DD
            sent_count = n
            sent_hash = combine_py(
                mix32_py(SENT, i, (i + 1) % n, dt & mask, dt >> 32, k + 1)
                for i in range(n))
        else:
            sent_count, sent_hash = 0, combine_py([])
        rows.append((t, n, fired_hash, recv_count, recv_hash,
                     sent_count, sent_hash, 0))
        if t >= E:
            break
        k += 1
    expected = SuperstepTrace.from_rows(rows)
    sc = token_ring(n, n_tokens=n, think_us=0, bootstrap_us=BB, end_us=E,
                    with_observer=False, mailbox_cap=4)
    link = FixedDelay(DD)
    assert_traces_equal(expected, SuperstepOracle(sc, link, device=CPU)
                        .run(100), "hand-rolled", "oracle")
    assert_traces_equal(expected, TorchEngine(sc, link, device=CPU)
                        .run(100)[1], "hand-rolled", "torch-engine")
    assert_traces_equal(expected, EdgeEngine(sc, link, cap=2, device=CPU)
                        .run(100)[1], "hand-rolled", "edge-engine")


# -- ping-pong, gossip, Praos (test_cross_world_more.py) --------------------

RND = SeededHashUniform(3_000, 9_000, 7)
REF_RND = ref_more.RND


@pytest.fixture(scope="module")
def pp_worlds():
    def net(mod, backend_mod, rnd, delays, run):
        events = []
        backend = backend_mod.EmulatedBackend(
            rnd, connect_delays=delays.FixedDelay(500), seed=0,
            endpoint_ids=ref_more._pp_endpoint_map())
        run(mod.ping_pong_net(
            backend, ping_port=ref_more.PP_PING_PORT,
            pong_port=ref_more.PP_PONG_PORT, warmup_us=ref_more.PP_START,
            rounds=ref_more.PP_ROUNDS, send_at=True, prewarm=True,
            events_out=events))
        return events
    import timewarp_tpu_torch.net.backend as port_backend
    import timewarp_tpu_torch.net.delays as port_delays
    port = net(__import__("timewarp_tpu_torch.models.ping_pong_net",
                          fromlist=["x"]), port_backend, RND, port_delays,
               run_emulation)
    ref = net(ref_ping_pong_net, ref_backend, REF_RND, ref_delays,
              ref_run_emulation)
    sc = ping_pong(rounds=ref_more.PP_ROUNDS, start_us=ref_more.PP_START)
    return port, ref, _batched(sc, RND, 2000)


def test_ping_pong_net_matches_closed_form(pp_worlds):
    port, ref, _ = pp_worlds
    pongs, pings = [], []
    t = ref_more.PP_START
    for _ in range(ref_more.PP_ROUNDS):
        a = t + _draw(RND, 1, t)
        pongs.append(a)
        b = a + _draw(RND, 0, a)
        pings.append(b)
        t = b
    assert [t for tag, t in port if tag == "pong-got-ping"] == pongs
    assert [t for tag, t in port if tag == "ping-got-pong"] == pings
    assert port == ref


def test_ping_pong_cross_world_identical(pp_worlds):
    port, _, (oracle, *_) = pp_worlds
    recvs = [e for e in oracle.events if e[0] == "recv"]
    assert [dt for (_, t, i, src, dt, pay) in recvs if i == 1] == \
        [t for tag, t in port if tag == "pong-got-ping"]
    assert [dt for (_, t, i, src, dt, pay) in recvs if i == 0] == \
        [t for tag, t in port if tag == "ping-got-pong"]


def test_ping_pong_engine_matches_oracle(pp_worlds):
    _, otrace, state, etrace = pp_worlds[2]
    assert_traces_equal(otrace, etrace)
    assert int(state.overflow) == 0


G = dict(n=ref_more.G_N, fanout=ref_more.G_FANOUT, think=ref_more.G_THINK,
         boot=ref_more.G_BOOT, dur=ref_more.G_DUR)


def _gossip_net_run(run, backend_mod, delays, rnd, net, ports):
    receipts = []
    backend = backend_mod.EmulatedBackend(
        rnd, connect_delays=delays.FixedDelay(500), seed=0,
        endpoint_ids=ports(G["n"]))
    run(net(backend, G["n"], fanout=G["fanout"], think_us=G["think"],
            bootstrap_us=G["boot"], duration_us=G["dur"], prewarm=True,
            receipts=receipts))
    return sorted((t, i) for t, i in receipts if t < G["dur"])


@pytest.fixture(scope="module")
def gossip_worlds():
    import timewarp_tpu_torch.net.backend as port_backend
    import timewarp_tpu_torch.net.delays as port_delays
    for p in range(49152, 49152 + 4 * G["n"] + 16):
        assert endpoint_id(f"127.0.0.1:{p}") > G["n"]
    port = _gossip_net_run(run_emulation, port_backend, port_delays, RND,
                           gossip_net, gossip_net_ports)
    ref = _gossip_net_run(ref_run_emulation, ref_backend, ref_delays,
                          REF_RND, ref_gossip_net.gossip_net,
                          ref_gossip_net.gossip_net_ports)
    sc = gossip(G["n"], fanout=G["fanout"], think_us=G["think"], burst=True,
                bootstrap_us=G["boot"], end_us=G["dur"], mailbox_cap=16)
    return port, ref, _batched(sc, RND, 4000)


def test_gossip_closed_form_diffusion(gossip_worlds):
    port, ref, _ = gossip_worlds
    _, dsts = host_lcg_peers(lcg_init(0), 0, G["n"], G["fanout"])
    front = [(G["boot"] + _draw(RND, d, G["boot"]), d) for d in dsts]
    assert set(front) <= set(port)
    assert port[0] == min(front)
    assert port == ref
    assert host_lcg_peers(lcg_init(5), 5, G["n"], G["fanout"]) == \
        ref_gossip_net.host_lcg_peers(ref_gossip_net.lcg_init(5), 5,
                                      G["n"], G["fanout"])


def test_gossip_cross_world_identical(gossip_worlds):
    port, _, (oracle, _, state, _) = gossip_worlds
    recvs = sorted((e[4], e[2]) for e in oracle.events
                   if e[0] == "recv" and e[4] < G["dur"])
    assert recvs == port
    assert len(recvs) >= G["n"]
    assert int(state.overflow) == 0


def test_gossip_engine_matches_oracle(gossip_worlds):
    _, otrace, state, etrace = gossip_worlds[2]
    assert_traces_equal(otrace, etrace)
    assert int(state.overflow) == 0


P = dict(n=ref_more.P_N, slot=ref_more.P_SLOT, slots=ref_more.P_SLOTS,
         prob=ref_more.P_PROB, fan=ref_more.P_FAN, dur=ref_more.P_DUR)


def _praos_net_run(run, backend_mod, delays, rnd, net, ports):
    receipts = []
    backend = backend_mod.EmulatedBackend(
        rnd, connect_delays=delays.FixedDelay(500), seed=0,
        endpoint_ids=ports(P["n"]))
    best = run(net(backend, P["n"], seed=0, slot_us=P["slot"],
                   n_slots=P["slots"], leader_prob=P["prob"],
                   fanout=P["fan"], receipts=receipts))
    return best, sorted((t, i, ln) for t, i, ln in receipts
                        if t < P["dur"])


@pytest.fixture(scope="module")
def praos_worlds():
    import timewarp_tpu_torch.net.backend as port_backend
    import timewarp_tpu_torch.net.delays as port_delays
    for p in range(49152, 49152 + 30 * P["n"] + 16):
        assert endpoint_id(f"127.0.0.1:{p}") > P["n"]
    port = _praos_net_run(run_emulation, port_backend, port_delays, RND,
                          praos_net, praos_net_ports)
    ref = _praos_net_run(ref_run_emulation, ref_backend, ref_delays,
                         REF_RND, ref_praos_net.praos_net,
                         ref_praos_net.praos_net_ports)
    sc = praos(P["n"], slot_us=P["slot"], n_slots=P["slots"],
               leader_prob=P["prob"], fanout=P["fan"], burst=True,
               mailbox_cap=16)
    return port, ref, _batched(sc, RND, 4000)


def test_praos_tie_preconditions(praos_worlds):
    (_, receipts), ref, _ = praos_worlds
    sched = leader_schedule(0, P["n"], P["slots"], P["slot"], P["prob"])
    assert sched == ref_praos_net.leader_schedule(
        0, P["n"], P["slots"], P["slot"], P["prob"])
    by_key = {}
    for t, i, ln in receipts:
        by_key.setdefault((t, i), set()).add(ln)
    assert all(len(v) == 1 for v in by_key.values())
    for (t, i) in by_key:
        assert not (t in sched and i in sched[t])


def test_praos_cross_world_identical(praos_worlds):
    (best, receipts), ref, (oracle, _, state, _) = praos_worlds
    assert (best, receipts) == ref
    recvs = sorted((e[4], e[2], e[5]) for e in oracle.events
                   if e[0] == "recv" and e[4] < P["dur"])
    assert recvs == receipts
    assert len(recvs) > P["n"]
    assert [best[i] for i in range(P["n"])] == \
        state.states["best"].tolist()
    assert int(state.overflow) == 0


def test_praos_engine_matches_oracle(praos_worlds):
    _, otrace, state, etrace = praos_worlds[2]
    assert_traces_equal(otrace, etrace)
    assert int(state.overflow) == 0


# -- socket-state (test_cross_world_socket_state.py) ------------------------

SEED = 3


@pytest.fixture(scope="module")
def socket_worlds():
    port = run_emulation(socket_state_net(EmulatedBackend(FixedDelay(3_000)),
                                          seed=SEED))
    ref = ref_run_emulation(ref_socket_state_net.socket_state_net(
        ref_backend.EmulatedBackend(ref_delays.FixedDelay(3_000)),
        seed=SEED))
    sc = socket_state(n_clients=3, seed=SEED)
    return port, ref, _batched(sc, FixedDelay(3_000), 4000)


def test_roulette_matches_net_world(socket_worlds):
    port, ref, _ = socket_worlds
    sends = roulette_sends(3, SEED)
    assert port["client_sends"] == {cid: sends[cid - 1] for cid in (1, 2, 3)}
    assert sum(sends) > 0
    assert port == ref


def test_socket_state_cross_world_counters(socket_worlds):
    port, _, (_, _, state, _) = socket_worlds
    cnt = state.states["cnt"][0].tolist()
    sends = roulette_sends(3, SEED)
    assert sorted(cnt[c] for c in range(3) if sends[c] > 0) == \
        port["per_socket"]
    assert all(cnt[c] == 0 for c in range(3) if sends[c] == 0)
    assert cnt == sends


def test_socket_state_engine_matches_oracle(socket_worlds):
    _, otrace, state, etrace = socket_worlds[2]
    assert_traces_equal(otrace, etrace)
    assert int(state.overflow) == 0 and int(state.bad_dst) == 0


def test_socket_state_deadline_stops_counting():
    sc = socket_state(n_clients=3, seed=24, send_interval_us=50_000,
                      server_life_us=120_000)
    link = Quantize(UniformDelay(3_000, 9_000), 1_000)
    otrace = SuperstepOracle(sc, link, device=CPU).run(4000)
    state, etrace = TorchEngine(sc, link, device=CPU).run(4000)
    assert_traces_equal(otrace, etrace)
    sends = roulette_sends(3, 24)
    assert state.states["cnt"][0].tolist() == [min(s, 2) for s in sends]
    assert sum(sends) > sum(min(s, 2) for s in sends)


def test_socket_state_fused_sparse_column():
    """The 1024-node windowed shape: fused ≡ general, trace and state;
    every scheduled ping counted or in the overflow counter."""
    sc = socket_state(n_clients=1023, seed=1, send_interval_us=20_000,
                      server_life_us=2_000_000, mailbox_cap=64)
    link = Quantize(UniformDelay(3_000, 9_000), 1_000)
    ref = TorchEngine(sc, link, window=3_000, device=CPU)
    fus = FusedSparseEngine(sc, link, window=3_000, device=CPU)
    assert_traces_equal(ref.run(200)[1], fus.run(200)[1], "general",
                        "fused-sparse")
    rs, fs = ref.run_quiet(200), fus.run_quiet(200)
    for name in rs._fields:
        a, b = getattr(rs, name), getattr(fs, name)
        if isinstance(a, dict):
            assert all(torch.equal(a[k], b[k]) for k in a), name
        else:
            assert torch.equal(a, b), name
    cnt = rs.states["cnt"][0]
    assert int(rs.overflow) > 0
    assert int(cnt.sum()) + int(rs.overflow) == \
        sum(roulette_sends(1023, 1))
    np.testing.assert_array_equal(cnt.numpy(), fs.states["cnt"][0].numpy())

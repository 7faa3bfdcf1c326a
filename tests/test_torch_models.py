"""The port's scenario steps against the reference's, leaf for leaf: one
gossip step (burst, paced and steady), one Praos step (burst and paced,
with stake weights and random firing entropy), one token-ring step (with
the observer, the ordered-inbox scenario, and the static ring without it,
whose ``static_dst`` is held too), one ping-pong step and one
socket-state step (its per-client counters fed payloads outside
``[1, C]`` too) on random inboxes and states made with numpy from a
seed, plus the initial states (the per-node ``init`` of Praos, the token
ring, ping-pong and socket-state too). Ping-pong and socket-state key
their roles on the node id, so their steps run many lanes that repeat
the ids ``0..n-1``.
The reference step is ``vmap``-ed exactly as ``JaxEngine`` does (inbox
and outbox node axis minor); the port's step is batched by hand.

Tolerance: exact (every leaf is integer).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from timewarp_tpu.core.scenario import Inbox as JInbox
from timewarp_tpu.core.scenario import Outbox as JOutbox
from timewarp_tpu.interp.jax_engine.common import \
    init_states_wake as j_init_states_wake
from timewarp_tpu.models.gossip import gossip as jgossip
from timewarp_tpu.models.ping_pong import ping_pong as jping
from timewarp_tpu.models.socket_state import socket_state as jsocket
from timewarp_tpu.models.praos import praos as jpraos
from timewarp_tpu.models.token_ring import token_ring as jring
from timewarp_tpu_torch.core.scenario import NEVER, Inbox
from timewarp_tpu_torch.models.gossip import gossip as tgossip
from timewarp_tpu_torch.models.ping_pong import ping_pong as tping
from timewarp_tpu_torch.models.socket_state import socket_state as tsocket
from timewarp_tpu_torch.models.praos import praos as tpraos
from timewarp_tpu_torch.models.token_ring import token_ring as tring

# one intra-op thread per test process: the test session's workers
# share the host's cores (a process of the default width each
# oversubscribes them several times over)
torch.set_num_threads(1)

I32MIN, I32MAX = -2**31, 2**31 - 1


def _inbox(rng, K, P, n, pay_lo, pay_hi, kinds=False):
    payload = rng.integers(pay_lo, pay_hi, (K, P, n)).astype(np.int32)
    if kinds:
        payload[:, 1, :] = rng.integers(0, 2, (K, n))
    return dict(valid=rng.random((K, n)) < 0.4,
                src=rng.integers(0, n, (K, n)).astype(np.int32),
                time=rng.integers(0, 10**6, (K, n)).astype(np.int64),
                payload=payload)


def _both_steps(jsc, tsc, states, inbox, now, key=None, ids=None):
    """One step of each package on the same inputs; ``key`` (optional) is
    the firing entropy as two uint32 arrays ``[n]``, ``ids`` the node id
    of each lane (default ``0..n-1``). States the scenario declares in
    ``u32_states`` go to the reference as uint32 and to the port as int64
    words."""
    n = now.size
    ids = np.arange(n, dtype=np.int32) if ids is None else ids
    u32 = set(tsc.u32_states)
    jout = jax.vmap(
        jsc.step,
        in_axes=(0, JInbox(valid=-1, src=-1, time=-1, payload=-1), 0, 0,
                 None if key is None else 0),
        out_axes=(0, JOutbox(valid=-1, dst=-1, payload=-1), 0))(
            {k: jnp.asarray(v.astype(np.uint32) if k in u32 else v)
             for k, v in states.items()},
            JInbox(**{k: jnp.asarray(v) for k, v in inbox.items()}),
            jnp.asarray(now), jnp.asarray(ids),
            None if key is None else tuple(jnp.asarray(w) for w in key))
    tout = tsc.step({k: torch.from_numpy(v) for k, v in states.items()},
                    Inbox(**{k: torch.from_numpy(v)
                             for k, v in inbox.items()}),
                    torch.from_numpy(now), torch.from_numpy(ids),
                    None if key is None else tuple(
                        torch.from_numpy(w.astype(np.int64)) for w in key))
    (js, jo, jw), (ts, to, tw) = jout, tout
    assert set(js) == set(ts)
    for k in js:
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]),
                                      err_msg=f"state.{k}")
    for f in ("valid", "dst", "payload"):
        np.testing.assert_array_equal(getattr(to, f).numpy(),
                                      np.asarray(getattr(jo, f)),
                                      err_msg=f"outbox.{f}")
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw),
                                  err_msg="wake")
    return ts, to


def _gossip_states(rng, n, fanout):
    lcg = rng.integers(I32MIN, I32MAX, n).astype(np.int32)
    lcg[:4] = (I32MIN, I32MAX, 0, -1)
    return dict(
        hop=rng.integers(-1, 6, n).astype(np.int32),
        lcg=lcg,
        left=rng.integers(0, fanout + 1, n).astype(np.int32),
        next=np.where(rng.random(n) < 0.3, NEVER,
                      rng.integers(0, 2 * 10**6, n)).astype(np.int64))


@pytest.mark.parametrize("burst,steady", [(True, False), (False, False),
                                          (False, True)],
                         ids=["burst", "paced", "steady"])
def test_gossip_step_equal(burst, steady):
    n, K = 301, 8
    fanout = 1 if steady else 8
    kw = dict(fanout=fanout, think_us=2_000, burst=burst, end_us=10**6,
              steady=steady, mailbox_cap=K)
    jsc, tsc = jgossip(n, **kw), tgossip(n, **kw)
    assert (tsc.max_out, tsc.payload_width, tsc.mailbox_cap,
            tsc.commutative_inbox, tsc.inbox_src) == \
        (jsc.max_out, jsc.payload_width, jsc.mailbox_cap,
         jsc.commutative_inbox, jsc.inbox_src)
    rng = np.random.default_rng(11 + burst + 2 * steady)
    states = _gossip_states(rng, n, fanout)
    now = rng.integers(0, 2 * 10**6, n).astype(np.int64)
    now[:8] = states["next"][:8].clip(max=2 * 10**6)   # some nodes due
    _, out = _both_steps(jsc, tsc, states, _inbox(rng, K, 1, n, 0, 10),
                         now)
    assert bool(out.valid.any())


@pytest.mark.parametrize("with_observer", [True, False],
                         ids=["observer", "static-ring"])
def test_token_ring_step_equal(with_observer):
    n_ring, K = 63, 8
    kw = dict(n_tokens=16, think_us=1_000, with_observer=with_observer,
              mailbox_cap=K)
    jsc, tsc = jring(n_ring, **kw), tring(n_ring, **kw)
    assert (tsc.commutative_inbox, tsc.max_out, tsc.payload_width) == \
        (jsc.commutative_inbox, jsc.max_out, jsc.payload_width)
    # the lean ring declares its successor table; the observer's does not
    if with_observer:
        assert tsc.static_dst is None and jsc.static_dst is None
    else:
        assert tsc.static_dst.dtype == np.int32
        np.testing.assert_array_equal(tsc.static_dst, jsc.static_dst)
    n = jsc.n_nodes
    rng = np.random.default_rng(13 + with_observer)
    states = dict(
        cnt=rng.integers(0, 3, n).astype(np.int32),
        val=rng.integers(0, 50, n).astype(np.int32),
        send_at=np.where(rng.random(n) < 0.5, NEVER,
                         rng.integers(0, 30_000, n)).astype(np.int64))
    if with_observer:
        states.update(prev=rng.integers(0, 50, n).astype(np.int32),
                      errs=rng.integers(0, 3, n).astype(np.int32))
    inbox = _inbox(rng, K, 2, n, 0, 50, kinds=True)
    inbox["valid"][:, -1] = True          # the last node's inbox is full
    now = rng.integers(0, 30_000, n).astype(np.int64)
    _both_steps(jsc, tsc, states, inbox, now)


@pytest.mark.parametrize("burst", [True, False], ids=["burst", "paced"])
def test_praos_step_equal(burst):
    n, K, fanout, slot_us = 517, 8, 8, 100_000
    rng = np.random.default_rng(31 + burst)
    stake = rng.integers(0, 4, n)
    kw = dict(slot_us=slot_us, n_slots=5, leader_prob=0.2, stake=stake,
              fanout=fanout, burst=burst, mailbox_cap=K)
    jsc, tsc = jpraos(n, **kw), tpraos(n, **kw)
    assert (tsc.max_out, tsc.payload_width, tsc.mailbox_cap,
            tsc.commutative_inbox, tsc.inbox_src, tsc.needs_key) == \
        (jsc.max_out, jsc.payload_width, jsc.mailbox_cap,
         jsc.commutative_inbox, jsc.inbox_src, jsc.needs_key)
    thr = tsc.init_batched(n, torch.device("cpu"))[0]["thr"].numpy()
    now = rng.integers(0, 6 * slot_us, n).astype(np.int64)
    lcg = rng.integers(I32MIN, I32MAX, n).astype(np.int32)
    lcg[:4] = (I32MIN, I32MAX, 0, -1)
    states = dict(best=rng.integers(0, 6, n).astype(np.int32), lcg=lcg,
                  slot=rng.integers(0, 6, n).astype(np.int32),
                  nslot=now + rng.integers(-slot_us, slot_us, n), thr=thr)
    if not burst:
        states.update(left=rng.integers(0, fanout + 1, n).astype(np.int32),
                      nrelay=np.where(rng.random(n) < 0.3, NEVER,
                                      now + rng.integers(-3_000, 3_000, n)))
    key = tuple(rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
                for _ in range(2))
    ts, out = _both_steps(jsc, tsc, states, _inbox(rng, K, 2, n, 0, 8), now,
                          key)
    assert bool(out.valid.any())
    assert int((ts["best"] > torch.from_numpy(states["best"])).sum()) > 0


def test_praos_init_equal():
    stake = np.arange(300) % 3
    for burst in (True, False):
        kw = dict(leader_prob=0.01, stake=stake, burst=burst)
        jsc, tsc = jpraos(300, **kw), tpraos(300, **kw)
        js, jw = jsc.init_batched(300)
        ts, tw = tsc.init_batched(300, torch.device("cpu"))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        assert set(js) == set(ts) and np.asarray(js["thr"]).dtype == np.uint32
        for k in js:
            want = np.asarray(js[k])
            assert ts[k].dtype == (torch.int64 if k in tsc.u32_states
                                   else getattr(torch, str(want.dtype)))
            np.testing.assert_array_equal(ts[k].numpy(), want)
        for i in (0, 1, 299):
            (jst, jwi), (tst, twi) = jsc.init(i), tsc.init(i)
            assert jwi == twi and set(jst) == set(tst)
            for k in jst:
                assert int(tst[k]) == int(jst[k]), (i, k)


@pytest.mark.parametrize("which", ["gossip", "token_ring"])
def test_init_states_equal(which):
    if which == "gossip":
        jsc = jgossip(1000, burst=True)
        tsc = tgossip(1000, burst=True)
    else:
        jsc = jring(99, n_tokens=7)
        tsc = tring(99, n_tokens=7)
    js, jw = jsc.init_batched(jsc.n_nodes)
    ts, tw = tsc.init_batched(tsc.n_nodes, torch.device("cpu"))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert set(js) == set(ts)
    for k in js:
        assert ts[k].dtype == getattr(torch, str(np.asarray(js[k]).dtype))
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
    if which == "token_ring":
        # the per-node init: holders, non-holders and the observer (id 99)
        for i in (0, 6, 7, 98, 99):
            (jst, jwi), (tst, twi) = jsc.init(i), tsc.init(i)
            assert int(jwi) == int(twi) and set(jst) == set(tst)
            for k in jst:
                assert tst[k].dtype == getattr(
                    torch, str(np.asarray(jst[k]).dtype)), (i, k)
                assert int(tst[k]) == int(jst[k]), (i, k)


def test_ping_pong_step_equal():
    lanes, K, start = 400, 4, 1_000
    jsc, tsc = jping(rounds=5, start_us=start), tping(rounds=5,
                                                      start_us=start)
    assert (tsc.n_nodes, tsc.max_out, tsc.payload_width, tsc.mailbox_cap,
            tsc.commutative_inbox, tsc.inbox_src) == \
        (jsc.n_nodes, jsc.max_out, jsc.payload_width, jsc.mailbox_cap,
         jsc.commutative_inbox, jsc.inbox_src)
    rng = np.random.default_rng(41)
    states = dict(rem=rng.integers(0, 4, lanes).astype(np.int32),
                  seq=rng.integers(0, 3, lanes).astype(np.int32))
    now = np.where(rng.random(lanes) < 0.3, start,
                   rng.integers(0, 5_000, lanes)).astype(np.int64)
    inbox = _inbox(rng, K, 2, lanes, -5, 9, kinds=True)
    _, out = _both_steps(jsc, tsc, states, inbox, now,
                         ids=np.arange(lanes, dtype=np.int32) % 2)
    assert bool(out.valid[0, 0::2].any()) and bool(out.valid[0, 1::2].any())


def test_socket_state_step_equal():
    C, lanes, K = 5, 600, 8
    kw = dict(n_clients=C, send_interval_us=50_000, server_life_us=120_000,
              seed=3, mailbox_cap=K)
    jsc, tsc = jsocket(**kw), tsocket(**kw)
    assert tsc.meta["sends"] == jsc.meta["sends"]
    assert (tsc.n_nodes, tsc.max_out, tsc.payload_width,
            tsc.commutative_inbox, tsc.inbox_src) == \
        (jsc.n_nodes, jsc.max_out, jsc.payload_width,
         jsc.commutative_inbox, jsc.inbox_src)
    rng = np.random.default_rng(43)
    states = dict(cnt=rng.integers(0, 9, (lanes, C)).astype(np.int32),
                  left=rng.integers(0, 4, lanes).astype(np.int32),
                  next=rng.integers(0, 200_000, lanes).astype(np.int64))
    # payloads 1..C count; 0 and -C+1..-1 wrap as jnp's scatter wraps
    # them; beyond C, below -C and I32MIN (whose - 1 wraps) add nothing
    inbox = _inbox(rng, K, 1, lanes, -C - 3, C + 4)
    inbox["payload"][0, 0, :8] = I32MIN
    now = rng.integers(0, 240_000, lanes).astype(np.int64)
    ts, out = _both_steps(jsc, tsc, states, inbox, now,
                          ids=np.arange(lanes, dtype=np.int32) % (C + 1))
    assert int((ts["cnt"] != torch.from_numpy(states["cnt"])).sum()) > 0
    assert bool(out.valid.any())


def test_roulette_and_inits_equal():
    from timewarp_tpu.models.socket_state import roulette_sends as jroul
    from timewarp_tpu_torch.models.socket_state import roulette_sends
    for C, seed in ((3, 24), (1023, 1), (50, 0)):
        assert roulette_sends(C, seed) == jroul(C, seed)
    for jsc, tsc in ((jping(rounds=7, start_us=500),
                      tping(rounds=7, start_us=500)),
                     (jsocket(n_clients=40, seed=5),
                      tsocket(n_clients=40, seed=5))):
        n = jsc.n_nodes
        js, jw = j_init_states_wake(jsc)   # ping-pong: its stacked init
        ts, tw = tsc.init_batched(n, torch.device("cpu"))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        assert set(js) == set(ts)
        for k in js:
            assert ts[k].dtype == getattr(torch, str(np.asarray(js[k]).dtype))
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
        for i in range(n):
            (jst, jwi), (tst, twi) = jsc.init(i), tsc.init(i)
            assert int(jwi) == int(twi) and set(jst) == set(tst)
            for k in jst:
                np.testing.assert_array_equal(tst[k].numpy(),
                                              np.asarray(jst[k]))

"""The general engine's eager and lazy routing paths and its event ring:
``TorchEngine(device="cpu")`` (K1's plain version) against
``JaxEngine(insert="xla")`` — bit-identical to ``insert="interpret"`` by
the reference's own law (tests/test_pallas_insert.py). Same scenario,
link, seed, window and budget through both packages; equal traces (the
SENT digest included) and equal final states, every ``EngineState`` leaf
and counter, on:

- the ``JaxEngine`` configurations of tools/parity_tpu.py that leave the
  adaptive regime: gossip-64-drop (eager, droppy), praos-48-burst-
  windowed-routecap (lazy, windowed), ping-pong and socket-state-4
  (window 1, ``max_out`` 1) and token-ring-64-observer (an ``FnDelay``,
  which may drop: eager, ordered inbox with src); and
  socket-state-1024-windowed, on ``TorchEngine`` and ``FusedSparseEngine``;
- tests/test_pallas_insert.py's drop-eager and lazy-cap configurations
  (N = 1024), and each path with a ``route_cap`` below the active count
  (``route_drop > 0``: the lazy SENT digest covers the sliced survivors,
  the eager one every sent message);
- a windowed droppy burst gossip (the eager 3-key sort), steady gossip
  at N = 1024, and a ``never`` link (every message dropped);
- ``record_events``: the ring and ``events()`` equal the reference's,
  also once the ring overflows, on both engines, and a state with a
  ring carried across (state_io.py).

Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from timewarp_tpu.interp.jax_engine.engine import EngineState as JState
from timewarp_tpu.interp.jax_engine.engine import JaxEngine
from timewarp_tpu.models.gossip import gossip as jgossip
from timewarp_tpu.models.ping_pong import ping_pong as jping
from timewarp_tpu.models.praos import praos as jpraos
from timewarp_tpu.models.socket_state import socket_state as jsocket
from timewarp_tpu.models.token_ring import token_ring as jring
from timewarp_tpu.models.token_ring import token_ring_links as jring_links
from timewarp_tpu.net import delays as jd
from timewarp_tpu.net.links import parse_link as jparse
from timewarp_tpu.trace.events import (assert_states_equal,
                                       assert_traces_equal)
from timewarp_tpu_torch.interp.torch_engine.engine import (TorchEngine,
                                                           sort_batch)
from timewarp_tpu_torch.interp.torch_engine.fused_sparse import \
    FusedSparseEngine
from timewarp_tpu_torch.interp.torch_engine.state_io import (
    state_from_numpy, state_to_numpy)
from timewarp_tpu_torch.models.gossip import gossip as tgossip
from timewarp_tpu_torch.models.ping_pong import ping_pong as tping
from timewarp_tpu_torch.models.praos import praos as tpraos
from timewarp_tpu_torch.models.socket_state import socket_state as tsocket
from timewarp_tpu_torch.models.token_ring import token_ring as tring
from timewarp_tpu_torch.models.token_ring import token_ring_links as \
    tring_links
from timewarp_tpu_torch.net import delays as td
from timewarp_tpu_torch.net.links import parse_link as tparse


def _wlink(m):
    """tools/parity_tpu.py's windowed link: 3 ms floor."""
    return m.Quantize(m.UniformDelay(3_000, 9_000), 1_000)


# tools/parity_tpu.py's configurations as (reference, port) pairs: each a
# function of the package's model builders and delays module
_PARITY = {
    "ping-pong": (
        lambda g, p, r, s, m: p(rounds=50),
        lambda m: m.UniformDelay(500, 2_000), 400, {}),
    "token-ring-64-observer": (
        lambda g, p, r, s, m: r(64, n_tokens=8, think_us=3_000,
                                bootstrap_us=1000, end_us=300_000,
                                with_observer=True, mailbox_cap=16),
        None, 600, {}),
    "gossip-64-drop": (
        lambda g, p, r, s, m: g(64, fanout=6, think_us=3_000,
                                gossip_interval=1_000, end_us=5_000_000),
        lambda m: m.WithDrop(m.UniformDelay(2_000, 30_000), 0.15), 800, {}),
    "praos-48-burst-windowed-routecap": (
        lambda g, p, r, s, m: m(48, slot_us=20_000, n_slots=6,
                                leader_prob=2.0 / 48, fanout=4, burst=True,
                                mailbox_cap=16),
        _wlink, 600, {"window": 3_000, "route_cap": 96}),
    "socket-state-4": (
        lambda g, p, r, s, m: s(n_clients=3, seed=24,
                                send_interval_us=50_000,
                                server_life_us=120_000),
        _wlink, 400, {}),
}
_JAX = (jgossip, jping, jring, jsocket, jpraos)
_TORCH = (tgossip, tping, tring, tsocket, tpraos)


def _port_as_jax(ts, sc=None):
    return JState(**state_to_numpy(ts, sc))


def _run_both(jsc, jl, tsc, tl, steps, engine=TorchEngine, **kw):
    """Both packages through ``run``: equal traces and final states.
    Returns the port's engine, state and trace and the reference's engine
    and state."""
    je = JaxEngine(jsc, jl, insert="xla", **kw)
    te = engine(tsc, tl, device="cpu", **kw)
    js, jt = je.run(steps)
    ts, tt = te.run(steps)
    assert te.window == je.window
    assert_traces_equal(jt, tt, "jax", "torch")
    assert_states_equal(js, _port_as_jax(ts, tsc), "jax vs torch")
    return te, ts, tt, je, js


@pytest.mark.parametrize("name", list(_PARITY))
def test_parity_configs_equal_reference(name):
    build, link, steps, kw = _PARITY[name]
    jsc, tsc = build(*_JAX), build(*_TORCH)
    if link is None:                       # the observer ring's FnDelay
        jl, tl = jring_links(64), tring_links(64)
    else:
        jl, tl = link(jd), link(td)
    te, ts, tt, _, _ = _run_both(jsc, jl, tsc, tl, steps, **kw)
    assert not te.adaptive
    assert te.lazy == ("route_cap" in kw)
    assert len(tt) > 5 and int(ts.delivered) > 0
    assert int(ts.bad_dst) == int(ts.bad_delay) == 0


@pytest.mark.parametrize("engine", [TorchEngine, FusedSparseEngine],
                         ids=["general", "fused"])
def test_socket_state_1024_windowed(engine):
    """The 1023-way co-temporal fan-in that overflows the hub mailbox;
    no message drops in either engine, so both equal ``JaxEngine``."""
    kw = dict(n_clients=1023, seed=1, send_interval_us=20_000,
              server_life_us=2_000_000, mailbox_cap=64)
    _, ts, _, _, _ = _run_both(jsocket(**kw), _wlink(jd), tsocket(**kw),
                               _wlink(td), 250, engine=engine, window=3_000)
    assert int(ts.overflow) > 0 and int(ts.route_drop) == 0


def _burst_gossip(m, **kw):
    args = dict(fanout=4, think_us=700, burst=True, end_us=300_000,
                mailbox_cap=8)
    args.update(kw)
    return m(1024, **args)


@pytest.mark.parametrize("link,kw,dropped", [
    (lambda m: m.WithDrop(m.UniformDelay(2_000, 9_000), 0.1), {}, False),
    (lambda m: m.UniformDelay(2_000, 9_000), dict(route_cap=2048), False),
    (lambda m: m.UniformDelay(2_000, 9_000), dict(route_cap=3), True),
    (lambda m: m.WithDrop(m.UniformDelay(2_000, 9_000), 0.1),
     dict(route_cap=3), True),
    (lambda m: m.WithDrop(_wlink(m), 0.1), dict(window=3_000), False),
], ids=["drop-eager", "lazy-cap", "lazy-cap-below-active",
        "eager-cap-below-active", "windowed-drop-eager"])
def test_eager_and_lazy_equal_reference(link, kw, dropped):
    """tests/test_pallas_insert.py's drop-eager and lazy-cap shapes, each
    path with a cap below the active count, and the windowed eager
    path's 3-key sort."""
    te, ts, tt, _, _ = _run_both(_burst_gossip(jgossip), link(jd),
                                 _burst_gossip(tgossip), link(td), 60, **kw)
    assert (int(ts.route_drop) > 0) == dropped
    assert te.lazy == ("route_cap" in kw and not te.link.can_drop)
    if dropped and te.lazy:
        # the lazy digest covers the sliced survivors only
        assert int(np.asarray(tt.sent_count).max()) <= kw["route_cap"]
    elif dropped:
        # the eager digest counts every sent message, sliced away or not
        assert int(np.asarray(tt.sent_count).max()) > kw["route_cap"]


def test_steady_gossip_equal_reference():
    """Rumor mongering at N = 1024 (bench.py gossip_steady_1m's shape at a
    small size): every infected node relays each 1 ms round, window 1."""
    kw = dict(fanout=1, think_us=1_000, gossip_interval=1_000,
              end_us=1 << 50, steady=True, mailbox_cap=8)
    jl, tl = (m.Quantize(m.UniformDelay(500, 4_500), 1_000) for m in (jd, td))
    te, ts, tt, _, _ = _run_both(jgossip(1024, **kw), jl,
                                 tgossip(1024, **kw), tl, 40)
    assert not te.adaptive and not te.lazy and len(tt) == 40
    assert int(np.asarray(tt.sent_count)[-1]) == 1024   # everyone relays
    assert int(ts.route_drop) == int(ts.bad_dst) == 0
    with pytest.raises(ValueError, match="burst applies"):
        tgossip(64, steady=True, burst=True)


def test_never_link_drops_everything():
    kw = dict(fanout=3, think_us=1_000, end_us=100_000)
    _, ts, tt, _, _ = _run_both(jgossip(64, **kw), jparse("never"),
                                tgossip(64, **kw), tparse("never"), 50)
    assert int(ts.delivered) == 0 and len(tt) >= 1
    assert int(np.asarray(tt.sent_count).sum()) == 0


@pytest.mark.parametrize("which,E", [("ping-pong", 64), ("ping-pong", 4096),
                                     ("gossip-drop", 300)],
                         ids=["ping-pong-overflows", "ping-pong",
                              "gossip-drop-overflows"])
def test_record_events_equal_reference(which, E):
    """The ring (ordered inbox with src; commutative without) and its
    decoding, complete and overflowing (``ev_count`` past E)."""
    if which == "ping-pong":
        pair = (jping(rounds=50), jd.UniformDelay(500, 2_000),
                tping(rounds=50), td.UniformDelay(500, 2_000))
    else:
        kw = dict(fanout=4, think_us=700, burst=True, end_us=300_000)
        pair = (jgossip(128, **kw), jd.WithDrop(jd.UniformDelay(2_000, 9_000),
                                                0.1),
                tgossip(128, **kw), td.WithDrop(td.UniformDelay(2_000, 9_000),
                                                0.1))
    te, ts, _, je, js = _run_both(*pair, 200, record_events=E)
    got, missing = te.events(ts)
    want, want_missing = je.events(js)
    assert got == want and missing == want_missing
    assert (missing > 0) == (E != 4096)
    assert {e[0] for e in got} == {"fire", "recv"}


def test_record_events_fused_engine():
    """The fused engine keeps the general engine's ring (no message drops
    at this ``max_batch``, so both compute the same function)."""
    kw = dict(fanout=4, think_us=700, burst=True, end_us=300_000,
              mailbox_cap=16)
    te, ts, _, je, js = _run_both(
        jgossip(1024, **kw), _wlink(jd), tgossip(1024, **kw), _wlink(td),
        60, engine=FusedSparseEngine, window=3_000, record_events=2048)
    got, missing = te.events(ts)
    assert (got, missing) == je.events(js) and missing > 0


def test_state_with_event_ring_carried_across():
    sc = (jping(rounds=30), tping(rounds=30))
    je = JaxEngine(sc[0], jd.UniformDelay(500, 2_000), record_events=128)
    mid, _ = je.run(20)
    leaves = {f: ({k: np.asarray(v) for k, v in mid.states.items()}
                  if f == "states" else np.asarray(getattr(mid, f)))
              for f in mid._fields}
    carried = state_from_numpy(leaves, "cpu")
    assert carried.ev_time.shape == (128,)
    te = TorchEngine(sc[1], td.UniformDelay(500, 2_000), record_events=128,
                     device="cpu")
    js, jt = je.run(20, mid)
    ts, tt = te.run(20, carried)
    assert_traces_equal(jt, tt, "jax", "torch")
    assert_states_equal(js, _port_as_jax(ts), "after carry")
    assert te.events(ts) == je.events(js)
    with pytest.raises(ValueError, match="record_events=64"):
        TorchEngine(sc[1], td.UniformDelay(500, 2_000), record_events=64,
                    device="cpu").run(1, carried)
    bad = dict(leaves, ev_meta=leaves["ev_meta"][:, :64])
    with pytest.raises(ValueError, match="event ring"):
        state_from_numpy(bad, "cpu")


def test_sort_batch_many_ties():
    """The eager batch's keys: most lanes share the sentinel, every woff
    is 0 at window 1; against numpy's lexsort of ``(dst, woff, smrank)``
    (each smrank once, so the order is total)."""
    rng = np.random.default_rng(5)
    n, S = 64, 4096
    dst = np.where(rng.random(S) < 0.8, n, rng.integers(0, n, S))
    for woff in (np.zeros(S, np.int64), rng.integers(0, 3, S)):
        smrank = rng.permutation(S)
        perm = sort_batch(*(torch.from_numpy(a.astype(np.int32))
                            for a in (dst, woff, smrank)))
        np.testing.assert_array_equal(perm.numpy(),
                                      np.lexsort((smrank, woff, dst)))

"""The edge engine of the port, ``EdgeEngine(device="cpu")``, against the
reference's JAX ``EdgeEngine``: the same scenario, link, seed, cap and
budget through both packages; equal traces (``assert_traces_equal``,
digests included) and every ``EdgeState`` leaf equal, through ``run`` and
``run_quiet``, on the configurations of tests/test_edge_engine.py:

- the dense ring with ``FixedDelay(500)`` (one shift edge, ``torch.roll``);
- the sparse ring with ``UniformDelay`` (threefry per edge);
- the ring with ``WithDrop(UniformDelay(500, 1500), 0.3)`` (the link's
  drop mask on the routing path);
- a run resumed from a mid-run JAX state carried across with
  ``edge_state_from_numpy``;
- the generic gather topology (a random permutation, n=40);
- the ordered inbox on a double ring (n=24): the five-key inbox sort,
  with many ties among the invalid rows;
- per-edge overflow (cap=1) with sends on an undeclared slot;
- a delay past 2^31 µs, clamped and counted.

Also ``EdgeTopology.build`` field for field against the reference's, and
the refusals. Tolerance: exact (every observable is integer).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from timewarp_tpu.core.scenario import NEVER as JNEVER
from timewarp_tpu.core.scenario import Outbox as JOutbox
from timewarp_tpu.core.scenario import Scenario as JScenario
from timewarp_tpu.interp.jax_engine.edge_engine import EdgeEngine as JEdge
from timewarp_tpu.interp.jax_engine.edge_engine import \
    EdgeTopology as JTopology
from timewarp_tpu.models.token_ring import token_ring as jring
from timewarp_tpu.net import delays as jd
from timewarp_tpu.trace.events import assert_traces_equal
from timewarp_tpu_torch.core.scenario import NEVER, Outbox, Scenario
from timewarp_tpu_torch.interp.torch_engine.edge_engine import (
    EdgeEngine, EdgeTopology)
from timewarp_tpu_torch.interp.torch_engine.state_io import (
    edge_state_from_numpy, edge_state_to_numpy)
from timewarp_tpu_torch.models.token_ring import token_ring as tring
from timewarp_tpu_torch.net import delays as td


def jax_leaves(st):
    """A reference state as numpy leaves (``states`` a dict)."""
    return {f: ({k: np.asarray(v) for k, v in st.states.items()}
                if f == "states" else np.asarray(getattr(st, f)))
            for f in st._fields}


def assert_leaves_equal(want, got, tag=""):
    """Every leaf equal, dtype included."""
    assert set(want) == set(got), tag
    for name, w in want.items():
        g = got[name]
        if name == "states":
            assert set(w) == set(g), tag
            for k in w:
                assert w[k].dtype == g[k].dtype, f"{tag} states.{k}"
                np.testing.assert_array_equal(g[k], w[k],
                                              err_msg=f"{tag} states.{k}")
        else:
            assert w.dtype == g.dtype, f"{tag} {name}"
            np.testing.assert_array_equal(g, w, err_msg=f"{tag} {name}")


def run_both(pair, steps, quiet=False, **kw):
    """One budget through both engines: equal traces and states. Returns
    the port's engine and final state."""
    (jsc, jl), (tsc, tl) = pair
    je, te = JEdge(jsc, jl, **kw), EdgeEngine(tsc, tl, device="cpu", **kw)
    if quiet:
        js, ts = je.run_quiet(steps), te.run_quiet(steps)
    else:
        (js, jt), (ts, tt) = je.run(steps), te.run(steps)
        assert_traces_equal(jt, tt, "jax", "torch")
        assert len(tt) > 0
    assert_leaves_equal(jax_leaves(js), edge_state_to_numpy(ts))
    return te, ts


def ring_pair(n, link, **kw):
    kw = dict(kw, with_observer=False)
    return (jring(n, **kw), link(jd)), (tring(n, **kw), link(td))


RINGS = {
    "dense-fixed": (dict(n=32, n_tokens=32, think_us=0, bootstrap_us=1000,
                         end_us=200_000, mailbox_cap=4),
                    lambda m: m.FixedDelay(500), 600, {}),
    "sparse-uniform": (dict(n=64, n_tokens=1, think_us=10_000,
                            bootstrap_us=1000, end_us=2_000_000,
                            mailbox_cap=4),
                       lambda m: m.UniformDelay(1000, 5000), 300, {}),
    "with-drop": (dict(n=48, n_tokens=16, think_us=2_000, bootstrap_us=1000,
                       end_us=500_000, mailbox_cap=6),
                  lambda m: m.WithDrop(m.UniformDelay(500, 1500), 0.3), 2000,
                  dict(cap=3)),
}


@pytest.mark.parametrize("name", list(RINGS))
def test_ring_equals_reference(name):
    args, link, steps, kw = RINGS[name]
    args = dict(args)
    n = args.pop("n")
    te, ts = run_both(ring_pair(n, link, **args), steps, seed=3, **kw)
    assert int(ts.overflow) == 0 and int(ts.delivered) > 0
    assert te.topo.shift == [(1, 0)]


def test_run_quiet_equals_reference():
    args, link, steps, _ = RINGS["dense-fixed"]
    args = dict(args)
    n = args.pop("n")
    _, ts = run_both(ring_pair(n, link, **args), 200, quiet=True)
    assert int(ts.steps) == 200 and int(ts.delivered) == 199 * 32


def test_resume_from_carried_jax_state():
    """A mid-run JAX state carried into the port (``edge_state_from_numpy``)
    runs on exactly as the reference does; the state goes back too, and a
    leaf of the wrong dtype is refused."""
    (jsc, jl), (tsc, tl) = ring_pair(
        32, lambda m: m.UniformDelay(200, 900), n_tokens=8, think_us=1_000,
        bootstrap_us=1000, end_us=300_000, mailbox_cap=4)
    je = JEdge(jsc, jl, seed=4)
    mid, _ = je.run(150)
    leaves = jax_leaves(mid)
    carried = edge_state_from_numpy(leaves, "cpu")
    assert_leaves_equal(leaves, edge_state_to_numpy(carried), "carried")
    te = EdgeEngine(tsc, tl, seed=4, device="cpu")
    (js, jt), (ts, tt) = je.run(150, mid), te.run(150, carried)
    assert_traces_equal(jt, tt, "jax", "torch")
    assert_leaves_equal(jax_leaves(js), edge_state_to_numpy(ts), "resumed")
    assert int(ts.steps) > 150
    quiet = te.run_quiet(150, carried)
    assert_leaves_equal(edge_state_to_numpy(ts), edge_state_to_numpy(quiet),
                        "run vs run_quiet")
    with pytest.raises(ValueError, match="dtype"):
        edge_state_from_numpy(
            dict(leaves, q_rel=leaves["q_rel"].astype(np.int64)), "cpu")
    with pytest.raises(ValueError, match="missing"):
        edge_state_from_numpy({k: v for k, v in leaves.items()
                               if k != "q_pay"}, "cpu")


# -- the non-ring topologies of the reference tests, in both packages -------

def _perm_pair(n, perm):
    """Node i sends to perm[i] every 1 ms, payload a running counter;
    order-insensitive (sum reduction)."""
    sd = np.asarray(perm, np.int32).reshape(n, 1)

    def jstep(state, inbox, now, i, key):
        seen, sent = state["seen"], state["sent"]
        got = jnp.sum(jnp.where(inbox.valid, inbox.payload[:, 0], 0),
                      dtype=jnp.int32)
        alive = now < 50_000
        out = JOutbox(valid=alive[None], dst=jnp.asarray(perm)[i][None],
                      payload=jnp.stack([sent + 1, jnp.int32(0)])[None])
        wake = jnp.where(alive, now + 1_000, jnp.int64(JNEVER))
        return {"seen": seen + got, "sent": sent + 1}, out, wake

    def jinit(i):
        return {"seen": jnp.int32(0), "sent": jnp.int32(0)}, 0

    dst = torch.from_numpy(np.asarray(perm, np.int32))

    def tstep(state, inbox, now, i, key):
        seen, sent = state["seen"], state["sent"]
        got = torch.where(inbox.valid, inbox.payload[:, 0, :], 0).sum(
            dim=0, dtype=torch.int32)
        alive = now < 50_000
        out = Outbox(valid=alive[None], dst=dst[i.long()][None],
                     payload=torch.stack([sent + 1,
                                          torch.zeros_like(sent)])[None])
        wake = torch.where(alive, now + 1_000, NEVER)
        return {"seen": seen + got, "sent": sent + 1}, out, wake

    def tinit(nn, device):
        z = torch.zeros(nn, dtype=torch.int32, device=device)
        return {"seen": z, "sent": z.clone()}, \
            torch.zeros(nn, dtype=torch.int64, device=device)

    common = dict(name="perm-scatter", n_nodes=n, payload_width=2,
                  max_out=1, mailbox_cap=8, static_dst=sd,
                  commutative_inbox=True)
    return JScenario(step=jstep, init=jinit, **common), \
        Scenario(step=tstep, init_batched=tinit, **common)


def test_generic_gather_topology_equals_reference():
    n = 40
    perm = np.random.default_rng(7).permutation(n).astype(np.int32)
    jsc, tsc = _perm_pair(n, perm)
    te, ts = run_both(((jsc, jd.UniformDelay(100, 2_500)),
                       (tsc, td.UniformDelay(100, 2_500))), 300, cap=8)
    assert any(s is None for s in te.topo.shift)   # the gather path
    assert int(ts.delivered) > 100


def _double_ring_pair(n):
    """An order-sensitive step (a sequential hash fold over the inbox) on
    a static double ring, sending two messages per ms."""
    sd = np.stack([(np.arange(n) + 1) % n, (np.arange(n) + 2) % n],
                  axis=1).astype(np.int32)

    def jstep(state, inbox, now, i, key):
        h, sent, nxt = state["h"], state["sent"], state["next_send"]

        def fold(carry, j):
            mixed = carry * jnp.int32(1000003) \
                + inbox.payload[j, 0] * jnp.int32(31) + inbox.src[j]
            return jnp.where(inbox.valid[j], mixed, carry), None

        h1, _ = jax.lax.scan(fold, h, jnp.arange(inbox.valid.shape[0]))
        alive = now < 40_000
        due = (nxt <= now) & alive
        out = JOutbox(
            valid=jnp.stack([due, due]), dst=jnp.asarray(sd)[i],
            payload=jnp.stack([jnp.stack([sent + 1, jnp.int32(0)]),
                               jnp.stack([sent + 2, jnp.int32(0)])]))
        nxt1 = jnp.where(due, nxt + 1_000, nxt)
        wake = jnp.where(alive, nxt1, jnp.int64(JNEVER))
        return {"h": h1, "sent": sent + jnp.where(due, 2, 0),
                "next_send": nxt1}, out, wake

    def jinit(i):
        return {"h": jnp.int32(i), "sent": jnp.int32(0),
                "next_send": jnp.int64(0)}, 0

    tsd = torch.from_numpy(sd.T.copy())                      # [2, n]

    def tstep(state, inbox, now, i, key):
        h, sent, nxt = state["h"], state["sent"], state["next_send"]
        for j in range(inbox.valid.shape[0]):
            mixed = h * 1000003 + inbox.payload[j, 0] * 31 + inbox.src[j]
            h = torch.where(inbox.valid[j], mixed, h)
        alive = now < 40_000
        due = (nxt <= now) & alive
        zero = torch.zeros_like(sent)
        out = Outbox(valid=torch.stack([due, due]), dst=tsd[:, i.long()],
                     payload=torch.stack([torch.stack([sent + 1, zero]),
                                          torch.stack([sent + 2, zero])]))
        nxt1 = torch.where(due, nxt + 1_000, nxt)
        wake = torch.where(alive, nxt1, NEVER)
        return {"h": h, "sent": sent + torch.where(due, 2, 0).to(torch.int32),
                "next_send": nxt1}, out, wake

    def tinit(nn, device):
        return {"h": torch.arange(nn, dtype=torch.int32, device=device),
                "sent": torch.zeros(nn, dtype=torch.int32, device=device),
                "next_send": torch.zeros(nn, dtype=torch.int64,
                                         device=device)}, \
            torch.zeros(nn, dtype=torch.int64, device=device)

    common = dict(name="double-ring-ordered", n_nodes=n, payload_width=2,
                  max_out=2, mailbox_cap=16, static_dst=sd,
                  commutative_inbox=False)
    return JScenario(step=jstep, init=jinit, **common), \
        Scenario(step=tstep, init_batched=tinit, **common)


def test_ordered_inbox_sort_equals_reference():
    """Per-source delays (700 or 1700 µs by sender parity) interleave
    messages of different supersteps in one inbox; the fold's hash pins
    the order. Eight queue slots on each of two edges leave most inbox
    rows invalid: ties the sort must keep harmless."""
    jsc, tsc = _double_ring_pair(24)
    jl = jd.FnDelay(lambda s, d, t, k: (
        jnp.where(s % 2 == 0, jnp.int64(700), jnp.int64(1700)),
        jnp.zeros(jnp.shape(d), bool)))
    tl = td.FnDelay(lambda s, d, t, k: (
        torch.where(s % 2 == 0, 700, 1700),
        torch.zeros(d.shape, dtype=torch.bool)))
    te, ts = run_both(((jsc, jl), (tsc, tl)), 300, cap=8)
    assert te.topo.shift == [(1, 0), (2, 1)]
    assert int(ts.overflow) == 0 and int(ts.unrouted) == 0
    assert int(ts.delivered) > 1000


def _hot_dst_pair():
    """Nodes 1 and 2 flood node 0 every 100 µs; node 2's slot is
    undeclared (static_dst -1)."""
    sd = np.asarray([[0], [0], [-1]], np.int32)

    def jstep(state, inbox, now, i, key):
        on = (i > 0) & (now < 20_000)
        out = JOutbox(valid=on[None], dst=jnp.int32(0)[None],
                      payload=jnp.zeros((1, 2), jnp.int32))
        return state, out, jnp.where(on, now + 100, jnp.int64(JNEVER))

    def jinit(i):
        return {"x": jnp.int32(0)}, 0 if i > 0 else JNEVER

    def tstep(state, inbox, now, i, key):
        on = (i > 0) & (now < 20_000)
        n = i.shape[0]
        out = Outbox(valid=on[None], dst=torch.zeros((1, n), dtype=torch.int32),
                     payload=torch.zeros((1, 2, n), dtype=torch.int32))
        return state, out, torch.where(on, now + 100, NEVER)

    def tinit(nn, device):
        ids = torch.arange(nn, device=device)
        return {"x": torch.zeros(nn, dtype=torch.int32, device=device)}, \
            torch.where(ids > 0, 0, NEVER)

    common = dict(name="hot-dst", n_nodes=3, payload_width=2, max_out=1,
                  mailbox_cap=8, static_dst=sd, commutative_inbox=True)
    return JScenario(step=jstep, init=jinit, **common), \
        Scenario(step=tstep, init_batched=tinit, **common)


def test_per_edge_overflow_counted_as_reference():
    jsc, tsc = _hot_dst_pair()
    # the port's own warning names the port's general engine
    with pytest.warns(RuntimeWarning, match="TorchEngine"):
        _, ts = run_both(((jsc, jd.FixedDelay(10_000)),
                          (tsc, td.FixedDelay(10_000))), 400, cap=1)
    assert int(ts.overflow) > 0
    assert int(ts.unrouted) > 0


def _slow_link_pair():
    n = 4
    sd = ((np.arange(n, dtype=np.int32) + 1) % n).reshape(n, 1)

    def jstep(state, inbox, now, i, key):
        alive = now < 5_000
        out = JOutbox(valid=alive[None], dst=jnp.asarray(sd)[i],
                      payload=jnp.zeros((1, 2), jnp.int32))
        return state, out, jnp.where(alive, now + 1_000, jnp.int64(JNEVER))

    def jinit(i):
        return {"x": jnp.int32(0)}, 0

    tsd = torch.from_numpy(sd.T.copy())

    def tstep(state, inbox, now, i, key):
        alive = now < 5_000
        out = Outbox(valid=alive[None], dst=tsd[:, i.long()],
                     payload=torch.zeros((1, 2, n), dtype=torch.int32))
        return state, out, torch.where(alive, now + 1_000, NEVER)

    def tinit(nn, device):
        return {"x": torch.zeros(nn, dtype=torch.int32, device=device)}, \
            torch.zeros(nn, dtype=torch.int64, device=device)

    common = dict(name="slowlink", n_nodes=n, payload_width=2, max_out=1,
                  mailbox_cap=4, static_dst=sd, commutative_inbox=True)
    return JScenario(step=jstep, init=jinit, **common), \
        Scenario(step=tstep, init_batched=tinit, **common)


def test_huge_delay_clamped_and_counted_as_reference():
    jsc, tsc = _slow_link_pair()
    # 50 min: past the int32-relative queue times
    with pytest.warns(RuntimeWarning, match="TorchEngine"):
        _, ts = run_both(((jsc, jd.FixedDelay(3_000_000_000)),
                          (tsc, td.FixedDelay(3_000_000_000))), 40)
    assert int(ts.bad_delay) > 0


# -- topology and refusals -------------------------------------------------

def _topologies():
    rng = np.random.default_rng(3)
    n = 16
    ids = np.arange(n, dtype=np.int32)
    return {
        "ring": ((ids + 1) % n).reshape(n, 1),
        "perm": rng.permutation(n).astype(np.int32).reshape(n, 1),
        "double-ring": np.stack([(ids + 1) % n, (ids + 2) % n], axis=1),
        "hot-dst": np.asarray([[0], [0], [-1]], np.int32),
        "unused-column": np.stack([(ids + 3) % n, np.full(n, -1)], axis=1),
        "partial": np.stack([(ids + 1) % n,
                             np.where(ids % 3 == 0, (ids + 5) % n, -1)],
                            axis=1),
        "fan-in": np.stack([np.zeros(n), (ids * 7) % n], axis=1),
    }


@pytest.mark.parametrize("name", list(_topologies()))
def test_topology_equals_reference(name):
    sd = _topologies()[name].astype(np.int32)
    n = sd.shape[0]
    want, got = JTopology.build(sd, n), EdgeTopology.build(sd, n)
    assert got.n_edges == want.n_edges and got.shift == want.shift
    for f in ("in_valid", "in_src", "in_slot", "in_flat"):
        w, g = getattr(want, f), getattr(got, f)
        assert w.dtype == g.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def test_refusals():
    with pytest.raises(ValueError, match="out-of-range"):
        EdgeTopology.build(np.full((8, 1), 8, np.int32), 8)
    with pytest.raises(ValueError, match="static_dst"):
        EdgeEngine(tring(8, with_observer=True), td.FixedDelay(1),
                   device="cpu")
    sc = tring(8, n_tokens=8, with_observer=False)
    # the run-mode planes are ported: bad values are refused with the
    # reference's guidance, and the reference's EdgeEngine has no
    # speculate option at all
    for kw, msg in ((dict(telemetry="counters "), "telemetry must be"),
                    (dict(controller=object()), "DispatchController"),
                    (dict(verify="guards"), "verify must be"),
                    (dict(record="all"), "record must be"),
                    (dict(record_cap=0), "record_cap must be")):
        with pytest.raises(ValueError, match=msg):
            EdgeEngine(sc, td.FixedDelay(1), device="cpu", **kw)
    with pytest.raises(TypeError):
        EdgeEngine(sc, td.FixedDelay(1), device="cpu", speculate="auto")
    # faults are ported: what is not one FaultSchedule is refused, as the
    # reference refuses it
    with pytest.raises(ValueError, match="must be a FaultSchedule"):
        EdgeEngine(sc, td.FixedDelay(1), device="cpu", faults=object())
    with pytest.raises(TypeError):
        EdgeEngine(sc, td.FixedDelay(1), device="cpu", window=8)
    with pytest.raises(ValueError, match="static_dst shape"):
        Scenario(name="bad", n_nodes=8, step=None, init_batched=None,
                 static_dst=np.zeros((8, 2), np.int32))

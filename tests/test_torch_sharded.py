"""The port's sharded engines on ``torch.distributed``, run as four gloo
ranks on the CPU, against the reference: the cases of
tests/test_sharded.py, test_fused_sparse.py (sharded leg),
test_windowed.py (sharded), test_world_batch.py (sharded fleet),
test_zfault_parity.py (sharded chaos fleet), test_zztelemetry.py
(sharded planes), test_zzzdispatch.py (sharded controller) and
test_zzzzzflight.py (sharded recorder), and the integrity plane and the
streamed driver over the ranks: every sharded engine's ``run_verified``
in every verify mode (a flip on a rank other than 0 under digest and
shadow) against the reference's one-device ``run_verified`` (traces,
leaves, ``digest_chain`` and ``last_run_integrity``), the sharded digest
against the gathered state's, ``run_quiet``'s guard over the ranks, the
world-sharded ``run_stream`` against the reference's, and a checkpoint of
the ranks read by the reference's ``load_state`` and resumed on them.

One module-scoped fixture spawns the four ranks once
(``parallel.launch.spawn``, the ``spawn`` start method: this process
holds JAX's threads) and runs every case of tests/torch_sharded_cases.py,
which imports only the port; each test holds its case's result against
the reference's one-device run in this process: the trace (digests
included), every leaf of the gathered state and every counter, exactly.
The bucket-overflow case depends on the device count and is held against
the reference's ``ShardedEngine`` on a 4-device mesh. Also: a rank that
fails fails the launch with its traceback, ``backend="nccl"`` without a
GPU per rank and ``device="cuda"`` without a card are refused (K1 at a
rank's post-exchange shape on the card: tests/test_torch_sharded_card.py).
Tolerance: exact (every observable is integer).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_sharded import _shift_scenario as jshift
from timewarp_tpu.core.scenario import NEVER as JNEVER
from timewarp_tpu.core.scenario import Inbox as JInbox
from timewarp_tpu.core.scenario import Outbox as JOutbox
from timewarp_tpu.core.scenario import Scenario as JScenario
from timewarp_tpu.dispatch import DispatchController as JController
from timewarp_tpu.faults import FaultFleet as JFleet
from timewarp_tpu.faults import FaultSchedule as JSchedule
from timewarp_tpu.faults import NodeCrash as JCrash
from timewarp_tpu.integrity import FlipInjector as JFlip
from timewarp_tpu.interp.jax_engine.batched import BatchSpec as JSpec
from timewarp_tpu.interp.jax_engine.edge_engine import EdgeEngine as JEdge
from timewarp_tpu.interp.jax_engine.edge_engine import EdgeState as JEdgeState
from timewarp_tpu.interp.jax_engine.engine import EngineState as JState
from timewarp_tpu.interp.jax_engine.engine import JaxEngine
from timewarp_tpu.models.gossip import gossip as jgossip
from timewarp_tpu.models.gossip import gossip_links as jgossip_links
from timewarp_tpu.models.token_ring import token_ring as jring
from timewarp_tpu.models.token_ring import token_ring_links as jring_links
from timewarp_tpu.net import delays as jd
from timewarp_tpu.trace.events import assert_states_equal, assert_traces_equal
from timewarp_tpu_torch.parallel.launch import RankFailed, spawn
from torch_sharded_cases import (STREAM_BUDGETS, VERIFY_BUDGET, VERIFY_CHUNK,
                                 VERIFY_FLIPS, VERIFY_MODES)

# one intra-op thread per test process: the test session's workers
# share the host's cores (a process of the default width each
# oversubscribes them several times over)
torch.set_num_threads(1)

RANKS = 4
JLINK = jd.Quantize(jd.UniformDelay(3_000, 9_000), 1_000)
W = 3_000


@pytest.fixture(scope="module")
def ranks():
    """Every CPU case, run once in four gloo ranks of one torch thread
    each (the cases are small; the test session's other workers share the
    host)."""
    return spawn("torch_sharded_cases:run_all", RANKS, backend="gloo",
                 device="cpu", threads=1)


def case(ranks, name):
    got = ranks[0][name]
    if isinstance(got, tuple) and got and got[0] == "error":
        pytest.fail(f"case {name} raised in the ranks:\n{got[1]}")
    return got


def _edge(st, leaves):
    assert_states_equal(st, JEdgeState(**leaves), "sharded edge")


def _gen(st, leaves, tag="sharded"):
    assert_states_equal(st, JState(**leaves), tag)


# -- the reference's scenarios written inline in tests/test_sharded.py ------

def jparity_delay():
    return jd.FnDelay(lambda s, d, t, k: (
        jnp.where(s % 2 == 0, jnp.int64(700), jnp.int64(1700)),
        jnp.zeros(jnp.shape(d), bool)))


def jrandom_dst(n=64):
    def step(state, inbox: JInbox, now, i, key):
        seen = state["seen"] + jnp.sum(
            jnp.where(inbox.valid, inbox.payload[:, 0], 0), dtype=jnp.int32)
        lcg = state["lcg"] * jnp.int32(1103515245) + jnp.int32(12345)
        dst = jnp.abs(lcg) % jnp.int32(n)
        alive = now < 60_000
        due = (state["next"] <= now) & alive
        out = JOutbox(valid=due[None], dst=dst[None],
                      payload=jnp.stack([state["sent"] + 1,
                                         jnp.int32(0)])[None])
        nxt = jnp.where(due, state["next"] + 2_000, state["next"])
        wake = jnp.where(alive, nxt, jnp.int64(JNEVER))
        return {"seen": seen, "sent": state["sent"] + due.astype(jnp.int32),
                "lcg": lcg, "next": nxt}, out, wake

    def init(i):
        return {"seen": jnp.int32(0), "sent": jnp.int32(0),
                "lcg": jnp.int32(i * 7 + 3), "next": jnp.int64(0)}, 0

    return JScenario(name="rand-dst", n_nodes=n, step=step, init=init,
                     payload_width=2, max_out=1, mailbox_cap=16,
                     commutative_inbox=True)


def jhub_flood(n=64):
    def step(state, inbox, now, i, key):
        alive = now < 20_000
        due = alive & (i > 0)
        out = JOutbox(valid=due[None], dst=jnp.int32(0)[None],
                      payload=jnp.zeros((1, 2), jnp.int32))
        return state, out, jnp.where(due, now + 1_000, jnp.int64(JNEVER))

    def init(i):
        return {"x": jnp.int32(0)}, 0 if i > 0 else JNEVER

    return JScenario(name="hub-flood", n_nodes=n, step=step, init=init,
                     payload_width=2, max_out=1, mailbox_cap=64,
                     commutative_inbox=True)


# -- tests/test_sharded.py: the edge engine over the mesh --------------------

@pytest.mark.parametrize("name,sc,link,steps,cap", [
    ("dense_ring", lambda: jring(64, n_tokens=64, think_us=0,
                                 bootstrap_us=1000, end_us=150_000,
                                 with_observer=False, mailbox_cap=4),
     lambda: jd.FixedDelay(500), 400, 2),
    ("ring_drop", lambda: jring(64, n_tokens=16, think_us=2_000,
                                bootstrap_us=1000, end_us=400_000,
                                with_observer=False, mailbox_cap=6),
     lambda: jd.WithDrop(jd.UniformDelay(500, 1500), 0.3), 1200, 3),
    ("shifts", lambda: jshift(64, [1, 10, 17, 33]),
     lambda: jd.UniformDelay(100, 900), 150, 8),
    ("noncommutative", lambda: jshift(48, [1, 2], commutative=False),
     jparity_delay, 150, 8),
], ids=["dense_ring", "ring_drop", "shifts", "noncommutative"])
def test_edge_equals_reference(ranks, name, sc, link, steps, cap):
    got = case(ranks, name)
    js, jt = JEdge(sc(), link(), cap=cap).run(steps)
    assert_traces_equal(jt, got["trace"], "reference", f"sharded {name}")
    _edge(js, got["state"])
    assert int(got["state"]["overflow"]) == 0
    assert int(got["trace"].recv_count.sum()) > 30


def test_edge_run_quiet_equals_traced(ranks):
    got = case(ranks, "quiet_equals_traced")
    for k, v in got["traced"].items():
        if k == "states":
            for s in v:
                np.testing.assert_array_equal(v[s], got["quiet"][k][s])
        else:
            np.testing.assert_array_equal(v, got["quiet"][k], err_msg=k)


def test_edge_resume(ranks):
    got = case(ranks, "edge_resume")
    full, first, rest = got["full"], got["first"], got["rest"]
    for f in ("times", "recv_hash", "sent_hash", "fired_hash"):
        np.testing.assert_array_equal(
            np.concatenate([getattr(first, f), getattr(rest, f)]),
            getattr(full, f))
    sc = jring(64, n_tokens=8, think_us=1_000, bootstrap_us=1000,
               end_us=150_000, with_observer=False, mailbox_cap=4)
    _, jt = JEdge(sc, jd.UniformDelay(200, 900)).run(150)
    assert_traces_equal(jt, full, "reference", "sharded resume")


def test_state_lives_per_rank(ranks):
    for r, res in enumerate(ranks):
        got = res["state_per_rank"]
        assert got["rank"] == r
        assert got["wake"] == (16,) and got["q_rel"][-1] == 16
        assert got["final_wake"] == (16,)
        assert got["gathered_wake"] == (64,)
        assert got["first_id"] == 16 * r


@pytest.mark.parametrize("name,match", [
    ("non_shift", "not pure shifts"),
    ("indivisible", "not divisible"),
    ("indivisible_general", "not divisible"),
    ("record_general", "unsupported on the node-sharded"),
    ("record_fused", "unsupported on the node-sharded"),
    ("record_edge", "unsupported on the node-sharded"),
    ("fused_ordered", "commutative_inbox"),
    ("no_batch", "needs a BatchSpec"),
    ("indivisible_fleet", "not divisible"),
    ("default_device", "device='cpu'"),
    ("nccl", "one GPU per rank"),
])
def test_refusals(ranks, name, match):
    msg = case(ranks, "refusals")[name]
    assert msg is not None and match in msg, msg


def test_lazy_path_never_runs_sharded(ranks):
    got = case(ranks, "refusals")
    assert got["lazy"] is False and got["adaptive"] is False


def test_sharded_engines_lint_knob(ranks):
    """tests/test_analysis.py's construction-lint knob on every sharded
    engine: clean under "error" with the report kept, "warn" by default,
    nothing under "off", and a TW104 defect refused under "error"."""
    got = case(ranks, "lint")
    for name in ("edge", "general", "fused", "fleet"):
        assert got[name][:4] == (True, "warn", True, None), (name, got)
        assert "TW104" in got[name][4], (name, got)


def test_meshcomm_roll_matches_global_roll(ranks):
    got = case(ranks, "roll")
    assert all(a and b for a, b in got.values()), got


# -- tests/test_sharded.py: the general engine over the mesh -----------------

@pytest.mark.parametrize("name,sc,link,steps", [
    ("observer_ring", lambda: jring(63, n_tokens=8, think_us=3_000,
                                    bootstrap_us=1000, end_us=200_000,
                                    with_observer=True, mailbox_cap=16),
     lambda: jring_links(63), 250),
    ("random_dst", jrandom_dst,
     lambda: jd.WithDrop(jd.UniformDelay(300, 2_000), 0.2), 300),
], ids=["observer_ring", "random_dst"])
def test_general_equals_reference(ranks, name, sc, link, steps):
    got = case(ranks, name)
    js, jt = JaxEngine(sc(), link()).run(steps)
    assert_traces_equal(jt, got["trace"], "reference", f"sharded {name}")
    _gen(js, got["state"])
    assert int(got["state"]["overflow"]) == 0
    assert int(got["trace"].recv_count.sum()) > 100


def test_general_resume_and_quiet(ranks):
    got = case(ranks, "general_resume")
    full, first, rest = got["full"], got["first"], got["rest"]
    for f in ("times", "recv_hash", "sent_hash"):
        np.testing.assert_array_equal(
            np.concatenate([getattr(first, f), getattr(rest, f)]),
            getattr(full, f))
    sc = jring(63, n_tokens=4, think_us=2_000, bootstrap_us=1000,
               end_us=150_000, with_observer=True, mailbox_cap=16)
    js, jt = JaxEngine(sc, jring_links(63)).run(120)
    assert_traces_equal(jt, full, "reference", "sharded general")
    _gen(js, got["traced"])
    _gen(js, got["quiet"], "sharded run_quiet")


def test_general_bucket_overflow_counted(ranks):
    """bucket_cap below the per-shard fan-in: the overflow is counted,
    as the reference's ShardedEngine counts it on a 4-device mesh."""
    from timewarp_tpu.interp.jax_engine.sharded import (ShardedEngine,
                                                        make_mesh)
    got = case(ranks, "bucket_overflow")
    js, jt = ShardedEngine(jhub_flood(), jd.FixedDelay(500), make_mesh(4),
                           bucket_cap=3).run(60)
    assert int(got["state"]["overflow"]) > 0
    for f in ("overflow", "delivered", "steps", "time"):
        assert int(got["state"][f]) == int(getattr(js, f)), f
    np.testing.assert_array_equal(got["trace"].times, jt.times)
    np.testing.assert_array_equal(got["trace"].recv_count, jt.recv_count)
    np.testing.assert_array_equal(got["trace"].overflow, jt.overflow)


def test_two_axis_mesh(ranks):
    got = case(ranks, "two_axis")
    link = jd.UniformDelay(300, 1_200)
    sc = jring(64, n_tokens=16, think_us=1_000, bootstrap_us=1000,
               end_us=120_000, with_observer=False, mailbox_cap=4)
    assert_traces_equal(JEdge(sc, link).run(150)[1], got["ring"],
                        "1-device", "2x2-mesh ring")
    sc2 = jgossip(64, fanout=4, think_us=2_000, gossip_interval=1_000,
                  end_us=300_000, mailbox_cap=8)
    assert_traces_equal(JaxEngine(sc2, link).run(150)[1], got["general"],
                        "1-device", "2x2-mesh all_to_all")


# -- test_windowed.py and test_fused_sparse.py's sharded legs ---------------

def test_windowed_sharded(ranks):
    got = case(ranks, "windowed")
    sc = jgossip(64, fanout=4, think_us=700, gossip_interval=500,
                 end_us=400_000, mailbox_cap=16)
    _, jt = JaxEngine(sc, JLINK, window=W).run(400)
    for name in ("flat", "dcn_ici", "route_cap"):
        assert_traces_equal(jt, got[name], "reference", f"windowed {name}")
    assert got["route_cap_drop"] == 0


def test_fused_sharded_leg(ranks):
    """ShardedFusedSparseEngine (K1 per shard after the exchange) equals
    the one-device engine and ShardedEngine bit for bit."""
    got = case(ranks, "fused_sharded")
    sc = jgossip(8192, fanout=4, think_us=3_000, burst=True,
                 end_us=400_000, mailbox_cap=8)
    ref = JaxEngine(sc, JLINK, window=3_000)
    js, jt = ref.run(60)
    assert_traces_equal(jt, got["trace"], "general-1dev", "sharded-fused")
    assert_traces_equal(jt, got["general_trace"], "general-1dev", "sharded")
    _gen(js, got["state"], "sharded-fused")
    _gen(js, got["general_state"], "sharded-general")
    _gen(ref.run_quiet(60), got["quiet"], "sharded-fused run_quiet")
    assert got["S2"] == got["stage_S"] == 32768
    assert got["bucket_cap"] == 2048 * 4


# -- the world-sharded fleet ---------------------------------------------------

def test_sharded_fleet_equals_local_fleet(ranks):
    got = case(ranks, "fleet")
    sc = jring(32, n_tokens=4, think_us=2_000, bootstrap_us=1_000,
               end_us=150_000)
    eng = JaxEngine(sc, jring_links(32), batch=JSpec(seeds=tuple(range(8))))
    jf, jtr = eng.run(100)
    for b in range(8):
        assert_traces_equal(jtr[b], got["traces"][b], "local", f"w{b}")
    _gen(jf, got["state"], "sharded fleet")
    _gen(eng.run_quiet(60), got["quiet"], "sharded fleet run_quiet")
    _, jv = eng.run(np.array([5, 60, 0, 100, 7, 7, 30, 1]))
    for b in range(8):
        assert_traces_equal(jv[b], got["vec_traces"][b], "local",
                            f"budget vector w{b}")
    assert got["local_B"] == 2
    assert got["supersteps"] == sum(len(t) for t in jtr)   # every world's


def test_sharded_chaos_fleet(ranks):
    got = case(ranks, "chaos_fleet")
    sc = jring(16, n_tokens=4, think_us=2_000, bootstrap_us=1_000,
               end_us=150_000, with_observer=True, mailbox_cap=16)
    fleet = JFleet(tuple(JSchedule((
        JCrash((3 * b + 1) % 16, 20_000, 60_000 + 1_000 * b,
               reset_state=True),)) for b in range(4)))
    jf, jtr = JaxEngine(sc, jring_links(16), batch=JSpec(seeds=(0, 1, 2, 3)),
                        faults=fleet).run(80)
    for b in range(4):
        assert_traces_equal(jtr[b], got["traces"][b], "local", f"w{b}")
    _gen(jf, got["state"], "sharded chaos fleet")
    assert int(np.asarray(jf.fault_dropped).sum()) > 0


# -- the run-mode planes -----------------------------------------------------

def _frames_equal(want, got, skip=()):
    if isinstance(want, list):
        assert len(want) == len(got)
        for w, g in zip(want, got):
            _frames_equal(w, g, skip)
        return
    for k, v in want.data.items():
        if k not in skip:
            np.testing.assert_array_equal(np.asarray(v), got[k], err_msg=k)


def test_sharded_telemetry(ranks):
    """Telemetry on is bit-identical to off, and its frames are the
    one-device reference's (the routing rung apart: the port's sharded
    engine routes eagerly, rung -1, where the reference ladders)."""
    got = case(ranks, "telemetry")
    for eng in ("edge", "general"):
        (t0, s0), (t1, s1) = got[f"{eng}_off"], got[f"{eng}_full"]
        assert_traces_equal(t0, t1, "off", f"{eng} full")
        for k in s0:
            if k != "states":
                np.testing.assert_array_equal(s0[k], s1[k], err_msg=k)
    ring = jring(32, n_tokens=8, think_us=2000, bootstrap_us=1000,
                 end_us=150_000, with_observer=False, mailbox_cap=8)
    je = JEdge(ring, jd.FixedDelay(500), telemetry="full", lint="off")
    _, jt = je.run(24)
    assert len(jt) > 4
    assert_traces_equal(jt, got["edge_full"][0], "reference", "edge full")
    _frames_equal(je.last_run_telemetry, got["edge_frames"])
    sc = jgossip(48, fanout=3, burst=True, end_us=150_000, mailbox_cap=16)
    jg = JaxEngine(sc, JLINK, window="auto", telemetry="full", lint="off")
    _, jt = jg.run(16)
    assert_traces_equal(jt, got["general_full"][0], "reference", "full")
    _frames_equal(jg.last_run_telemetry, got["general_frames"], ("rung",))
    assert (got["general_frames"]["rung"] == -1).all()
    jb = JaxEngine(sc, JLINK, window="auto", telemetry="full", lint="off",
                   batch=JSpec(seeds=(0, 1, 2, 3)))
    jf, jtr = jb.run(16)
    for mode in ("off", "counters", "full"):
        trs, st = got[f"fleet_{mode}"]
        for b in range(4):
            assert_traces_equal(jtr[b], trs[b], "reference", f"{mode} w{b}")
        _gen(jf, st, f"fleet telemetry={mode}")
    _frames_equal(jb.last_run_telemetry, got["fleet_frames_full"], ("rung",))


def test_sharded_controller_matches_reference(ranks):
    """The world-sharded fleet under a controller: every rank decides
    from the gathered telemetry; the decisions, traces and state are the
    reference's one-device fleet's."""
    got = case(ranks, "controller")
    sc = jgossip(32, fanout=4, think_us=2_000, burst=True, end_us=120_000,
                 mailbox_cap=16)
    link = jd.Quantize(jgossip_links(median_us=20_000, sigma=0.6,
                                     floor_us=8_000), 1_000)
    eng = JaxEngine(sc, link, window="auto", telemetry="counters",
                    lint="off", insert="xla",
                    controller=JController(chunk=8, chunk_max=32),
                    batch=JSpec(seeds=(0, 1, 2, 3)))
    jf, jtr = eng.run_controlled(1 << 12)
    # every decision field but the observed routing rung: the reference
    # ladders, the port routes at its static width (rung 256 here)
    def strip(ds):
        return [dict(d, obs={k: v for k, v in d["obs"].items()
                             if k != "rung_used"}) for d in ds]
    assert strip(got["decisions"]) == strip([d.to_json() for d in
                                             eng.last_run_decisions])
    assert len(got["decisions"]) > 2
    for b in range(4):
        assert_traces_equal(jtr[b], got["traces"][b], "reference", f"w{b}")
    _gen(jf, got["state"], "sharded controlled fleet")


def test_sharded_record_worlds_match_solo(ranks):
    got = case(ranks, "flight")
    (t0, s0), (t1, s1) = got["off"], got["full"]
    for b in range(4):
        assert_traces_equal(t0[b], t1[b], "off", f"record w{b}")
    sc = jgossip(32, fanout=3, burst=True, end_us=150_000, mailbox_cap=16)
    for b in range(4):
        solo = JaxEngine(sc, JLINK, window="auto", lint="off", seed=b,
                         record="full")
        solo.run(16)
        assert got["keysets"][b] == solo.last_run_flight.keyset(), b


def test_sharded_speculation_masked_rollback(ranks):
    """The world-sharded fleet's speculative run: only the violating
    worlds re-run, on their ranks; everything equals the one-device
    fleet's run (tests/test_torch_speculate_fleet.py holds that against
    the reference)."""
    got = case(ranks, "speculation")
    sh, lo = got["sharded"], got["local"]
    for b in range(4):
        assert_traces_equal(lo["traces"][b], sh["traces"][b], "local",
                            f"sharded w{b}")
    for k, v in lo["state"].items():
        if k == "states":
            for s in v:
                np.testing.assert_array_equal(v[s], sh["state"][k][s])
        else:
            np.testing.assert_array_equal(v, sh["state"][k], err_msg=k)
    assert sh["speculation"] == lo["speculation"]
    assert sh["chains"] == lo["chains"]
    assert sh["speculation"]["rollbacks"] >= 1
    assert {v["world"] for v in sh["speculation"]["violations"]} <= {0, 2}
    assert sh["speculation"]["rerun_worlds"] >= 1


# -- the integrity plane and the streamed driver over the ranks ---------------

def _jverify_gossip(**kw):
    return JaxEngine(jgossip(64, fanout=3, burst=True, end_us=150_000,
                             mailbox_cap=16), JLINK, window="auto",
                     lint="off", **kw)


@pytest.fixture(scope="module")
def verify_reference():
    """The reference's one-device ``run_verified`` of each sharded
    engine's configuration in each mode, with the same flip: final
    state, traces, integrity record and the flip's description. A verify
    mode is host state in the reference (every mode but off traces one
    program), so each configuration builds one engine; ShardedEngine and
    ShardedFusedSparseEngine share the general one's."""
    engines = {
        "general": _jverify_gossip(verify="digest"),
        "edge": JEdge(jring(16, n_tokens=4, think_us=2000, bootstrap_us=1000,
                            end_us=120_000, with_observer=False,
                            mailbox_cap=8), jd.FixedDelay(500), lint="off",
                      verify="digest"),
        "fleet": _jverify_gossip(verify="digest",
                                 batch=JSpec(seeds=(0, 1, 2, 3))),
    }
    out = {}
    for name, eng in engines.items():
        for mode, spec in zip(VERIFY_MODES, VERIFY_FLIPS[name]):
            eng.verify = mode
            flip = None if spec is None else JFlip(spec)
            fin, tr = eng.run_verified(VERIFY_BUDGET, chunk=VERIFY_CHUNK,
                                       inject=flip)
            out[name, mode] = (fin, tr, eng.last_run_integrity,
                               None if flip is None else flip.desc)
    return out


@pytest.mark.parametrize("mode", VERIFY_MODES)
@pytest.mark.parametrize("engine", list(VERIFY_FLIPS))
def test_sharded_verified_equals_reference(ranks, verify_reference, engine,
                                           mode):
    """``run_verified`` on 4 ranks = the reference's one-device run of the
    same configuration, seed, chunk and flip: the trace, every leaf, the
    integrity record (its ``digest_chain``, checks, rollbacks and
    violations) on every rank; under digest and shadow the flip (on a
    rank other than 0) is detected, and the recovered run is the clean
    guard run."""
    jfin, jtr, jrec, jdesc = verify_reference[
        "general" if engine == "fused" else engine, mode]
    got = case(ranks, "verified")[f"{engine}-{mode}"]
    for b, (x, y) in enumerate(zip(*(t if isinstance(t, list) else [t]
                                     for t in (jtr, got["trace"])))):
        assert_traces_equal(x, y, "reference", f"sharded {engine} w{b}")
    (_edge if engine == "edge" else _gen)(jfin, got["state"])
    assert got["rec"] == jrec
    for r in range(1, RANKS):
        assert ranks[r]["verified"][f"{engine}-{mode}"]["rec"] == jrec
    if mode == "guard":
        assert got["flip"] is None and jrec["rollbacks"] == 0
        return
    fired, desc = got["flip"]
    assert fired and desc == jdesc
    assert got["rec"]["rollbacks"] >= 1 and got["rec"]["violations"]
    shape = got["state"][desc.split("[")[0]].shape
    idx = int(desc.split("[")[1].split("]")[0])
    owner = idx // (int(np.prod(shape[1:])) * (shape[0] // RANKS)) \
        if engine == "fleet" else (idx % shape[-1]) // (shape[-1] // RANKS)
    assert owner != 0, desc
    clean = case(ranks, "verified")[f"{engine}-guard"]
    for b, (x, y) in enumerate(zip(*(t if isinstance(t, list) else [t]
                                     for t in (clean["trace"],
                                               got["trace"])))):
        assert_traces_equal(x, y, "clean", f"recovered w{b}")


@pytest.mark.parametrize("engine", list(VERIFY_FLIPS))
def test_sharded_digest_equals_gathered(ranks, engine):
    """The digest of a rank's shard (the per-rank sums under global
    indices, one all_sum; a fleet's gathered per world) = ``tree_digest``
    / ``fleet_digest`` of the gathered state, on every rank and mode."""
    for r in range(RANKS):
        for mode in VERIFY_MODES:
            sharded, gathered = ranks[r]["verified"][
                f"{engine}-{mode}"]["digests"]
            assert sharded == gathered, (r, mode)


@pytest.mark.parametrize("engine", list(VERIFY_FLIPS))
def test_sharded_quiet_guard_judges_the_global_state(ranks, engine):
    """A negative wake (a fleet's steps) on rank 2 alone: ``run_quiet``'s
    final-state guard raises on every rank, naming the field."""
    field = "steps" if engine == "fleet" else "wake"
    for r in range(RANKS):
        msg = ranks[r]["verified"][f"{engine}-quiet"]
        assert msg is not None and f"{field}: -5" in msg, (r, msg)


def test_sharded_run_stream_equals_reference(ranks):
    """The world-sharded ``run_stream`` under per-world budgets = the
    reference's: the same traces and final state, each world's
    ``on_quiesce`` once, at the same superstep, with the gathered fleet
    (every callback's state holds all 4 worlds)."""
    got = case(ranks, "stream")
    eng = _jverify_gossip(batch=JSpec(seeds=(0, 1, 2, 3)))
    seen = []
    jf, jtr = eng.run_stream(np.array(STREAM_BUDGETS), chunk=VERIFY_CHUNK,
                             on_quiesce=lambda b, st: seen.append(
                                 (b, int(st.steps[b]), 4)))
    assert got["seen"] == seen
    assert sorted(b for b, _, _ in seen) == [0, 1, 2, 3]
    assert got["chunks"] and set(got["chunks"]) == {4}
    for b in range(4):
        assert_traces_equal(jtr[b], got["traces"][b], "reference", f"w{b}")
    _gen(jf, got["state"], "sharded run_stream")
    assert got["supersteps"] == sum(len(t) for t in jtr)
    for r in range(1, RANKS):
        assert ranks[r]["stream"]["seen"] == seen


def test_sharded_checkpoint_resumes_across_packages(ranks, verify_reference):
    """The gathered state of 4 ranks, written by rank 0, is read by the
    reference's ``load_state`` as the ranks' 24-superstep state; loaded on
    every rank and cut to its shard it resumes to the uninterrupted run,
    which is the reference's 48 supersteps (the clean guard run of
    ``verify_reference``), node- and world-sharded."""
    import shutil
    from timewarp_tpu.utils.checkpoint import load_state as jload
    got = case(ranks, "checkpoint")
    try:
        for name in ("general", "fleet"):
            g = got[name]
            jfull, jtr = verify_reference[name, "guard"][:2]
            jst, _ = jload(g["path"], jfull)
            _gen(jst, g["mid"], f"{name} checkpoint")
            _gen(jfull, g["resumed"], f"{name} resumed")
            _gen(jfull, g["full"], f"{name} uninterrupted")
            for z, w in zip(*(t if isinstance(t, list) else [t]
                              for t in (jtr, g["full_trace"]))):
                assert_traces_equal(z, w, "reference", f"{name} full")
            for x, w in zip(*(t if isinstance(t, list) else [t]
                              for t in (g["trace"], g["full_trace"]))):
                for f in ("times", "recv_hash", "sent_hash"):
                    np.testing.assert_array_equal(
                        getattr(x, f), getattr(w, f)[-len(x):])
    finally:
        shutil.rmtree(got["dir"], ignore_errors=True)


# -- the launcher ----------------------------------------------------------------

def test_ranks_import_neither_jax_nor_reference(ranks):
    assert all(r["sys_modules"] == [] for r in ranks)


def test_ranks_run_the_threads_asked(ranks):
    assert [r["threads"] for r in ranks] == [1] * RANKS


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(RankFailed, match="rank 1 fails on purpose"):
        spawn("torch_sharded_cases:fail_on_rank", 2, backend="gloo",
              device="cpu", args=(1,))


def test_launch_refusals():
    with pytest.raises(RuntimeError, match="one GPU per rank"):
        spawn("torch_sharded_cases:run_all", 2 + torch.cuda.device_count(),
              backend="nccl", device="cuda" if torch.cuda.is_available()
              else "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            spawn("torch_sharded_cases:run_all", 2, backend="gloo",
                  device="cuda")
    with pytest.raises(ValueError, match="module:function"):
        spawn("torch_sharded_cases", 2, backend="gloo", device="cpu")

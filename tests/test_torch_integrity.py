"""The integrity plane of the port (``timewarp_tpu_torch/integrity/`` and
the engines' ``verify=`` knob) against the JAX package, mirroring
tests/test_zzzzintegrity.py:

- ``tree_digest`` and ``fleet_digest`` equal the reference's word for
  word on solo, fleet, Praos (``u32_states``) and ``EdgeState`` states
  carried across by ``state_io``, and so does the sha256 chain of a
  verified run;
- ``apply_flip`` picks the same leaf, element and bit as the reference;
- the detection law: an injected flip is detected and the rolled-back run
  equals the clean one (states, traces, digest chain) and the reference's
  run (rollback count, violations, chain) — solo, on a fleet, under a
  ``FaultFleet``, on ``EdgeEngine``, and at a sparse shadow cadence;
- persistent corruption raises after ``max_rollbacks``; an in-place
  corrupted snapshot escalates;
- ``run_quiet``'s final-state guard; the guard names the superstep and the
  field in the reference's words; the integrity metrics lines equal the
  reference's.

Tolerance: exact.
"""

import numpy as np
import pytest

from timewarp_tpu.integrity import FlipInjector as JFlip
from timewarp_tpu.integrity import apply_flip as japply
from timewarp_tpu.integrity.checks import final_state_guard as jfinal_guard
from timewarp_tpu.integrity.digest import fleet_digest as jfleet
from timewarp_tpu.integrity.digest import tree_digest as jtree
from timewarp_tpu.interp.jax_engine.batched import BatchSpec as JSpec
from timewarp_tpu.interp.jax_engine.edge_engine import EdgeEngine as JEdge
from timewarp_tpu.interp.jax_engine.engine import EngineState as JState
from timewarp_tpu.interp.jax_engine.engine import JaxEngine
from timewarp_tpu.models import gossip as jg
from timewarp_tpu.models import praos as jp
from timewarp_tpu.models import token_ring as jr
from timewarp_tpu.net import delays as jd
from timewarp_tpu.obs.metrics import MetricsRegistry as JRegistry
from timewarp_tpu.trace.events import assert_traces_equal
import timewarp_tpu.faults as jf
import timewarp_tpu_torch.faults as tf
from timewarp_tpu_torch.integrity import (FlipInjector, IntegrityViolation,
                                          apply_flip)
from timewarp_tpu_torch.integrity.digest import fleet_digest, tree_digest
from timewarp_tpu_torch.interp.torch_engine.batched import BatchSpec
from timewarp_tpu_torch.interp.torch_engine.edge_engine import EdgeEngine
from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
from timewarp_tpu_torch.interp.torch_engine.state_io import (
    edge_state_from_numpy, edge_state_to_numpy, state_from_numpy,
    state_to_numpy)
from timewarp_tpu_torch.models import gossip as tg
from timewarp_tpu_torch.models import praos as tp
from timewarp_tpu_torch.models import token_ring as tr
from timewarp_tpu_torch.net import delays as td
from timewarp_tpu_torch.obs.metrics import MetricsRegistry

N = 40
BUDGET = 48     # whole chunks: one driver length to compile
CHUNK = 8


def _gossip(G, D):
    return (G.gossip(N, fanout=3, burst=True, end_us=150_000,
                     mailbox_cap=16),
            D.Quantize(D.UniformDelay(3000, 9000), 1000))


def _ring(R, D):
    return (R.token_ring(16, n_tokens=4, think_us=2000, bootstrap_us=1000,
                         end_us=120_000, with_observer=False,
                         mailbox_cap=8), D.FixedDelay(500))


def _fleet_faults(F):
    return F.FaultFleet((F.parse_faults("crash:2:20ms:60ms:reset"),
                         F.parse_faults("degrade:all:all:20ms:60ms:2.0")))


def jgossip(**kw):
    return JaxEngine(*_gossip(jg, jd), window="auto", lint="off", **kw)


def tgossip(**kw):
    return TorchEngine(*_gossip(tg, td), window="auto", device="cpu", **kw)


def jring(**kw):
    return JEdge(*_ring(jr, jd), lint="off", **kw)


def tring(**kw):
    return EdgeEngine(*_ring(tr, td), device="cpu", **kw)


#: the detection law's legs: (reference factory, port factory, flip spec,
#: run_verified kwargs)
LAW = {
    "solo": (lambda: jgossip(verify="digest"),
             lambda: tgossip(verify="digest"), "flip:7:2:mb_rel", {}),
    "fleet": (lambda: jgossip(verify="digest", batch=JSpec(seeds=(0, 7))),
              lambda: tgossip(verify="digest", batch=BatchSpec(seeds=(0, 7))),
              "flip:11:2", {}),
    "fault-fleet-ledger": (
        lambda: jgossip(verify="digest", batch=JSpec(seeds=(0, 5)),
                        faults=_fleet_faults(jf)),
        lambda: tgossip(verify="digest", batch=BatchSpec(seeds=(0, 5)),
                        faults=_fleet_faults(tf)),
        "flip:5:3:restart_done", {}),
    "fault-fleet-payload": (
        lambda: jgossip(verify="digest", batch=JSpec(seeds=(0, 5)),
                        faults=_fleet_faults(jf)),
        lambda: tgossip(verify="digest", batch=BatchSpec(seeds=(0, 5)),
                        faults=_fleet_faults(tf)),
        "flip:9:3:mb_payload", {}),
    "edge": (lambda: jring(verify="digest"), lambda: tring(verify="digest"),
             "flip:3:2:q_rel", {}),
    "shadow-cadence-2": (lambda: jgossip(verify="shadow"),
                         lambda: tgossip(verify="shadow"),
                         "flip:13:2:mb_src", dict(chunk=4, cadence=2)),
}


def _numpy(st):
    return (edge_state_to_numpy if hasattr(st, "q_rel")
            else state_to_numpy)(st)


def _leaves(st):
    """A port state's or a JAX state's leaves as numpy (``states`` a
    dict)."""
    if hasattr(st.wake, "cpu"):
        return _numpy(st)
    return {k: ({s: np.asarray(x) for s, x in v.items()}
                if k == "states" else np.asarray(v))
            for k, v in st._asdict().items()}


def _states_equal(a, b, what):
    """Two states (port or JAX, any mix) leaf for leaf."""
    sa, sb = _leaves(a), _leaves(b)
    assert sorted(sa) == sorted(sb), what
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


@pytest.fixture(scope="module")
def law_reference():
    """Each detection-law leg's injected run through the reference (its
    recovered state and traces are the clean run's by the reference's own
    law): final state, traces, digest chain, integrity record, the flip's
    description. Legs that share a configuration share an engine."""
    out, engines = {}, {}
    for name, (jmake, _, spec, kw) in LAW.items():
        key = name.rsplit("-", 1)[0] if name.startswith("fault") else name
        if name.startswith("shadow"):
            # the solo engine in shadow mode: the reference's verify mode
            # is host state (any mode but off traces the same program),
            # so its compiled drivers serve both legs
            key = "solo"
        if key not in engines:
            engines[key] = jmake()
        eng = engines[key]
        eng.verify = "shadow" if name.startswith("shadow") else "digest"
        eng.metrics, eng.metrics_label = JRegistry(run="r"), name
        flip = JFlip(spec)
        fi, ti = eng.run_verified(BUDGET, chunk=kw.get("chunk", CHUNK),
                                  inject=flip,
                                  **{k: v for k, v in kw.items()
                                     if k != "chunk"})
        out[name] = (fi, ti, eng.last_run_stats["digest_chain"],
                     eng.last_run_integrity, flip.desc, eng.metrics.lines,
                     eng)
    return out


# ---------------------------------------------------------------------------
# digests and flips, word for word
# ---------------------------------------------------------------------------

def _port(jst, sc=None):
    leaves = {k: (dict(v) if k == "states" else np.asarray(v))
              for k, v in jst._asdict().items()}
    if hasattr(jst, "q_rel"):
        return edge_state_from_numpy(leaves, "cpu", sc)
    return state_from_numpy(leaves, "cpu", sc)


@pytest.mark.parametrize("leg", ["solo", "fleet", "fault-fleet-ledger",
                                 "edge"])
def test_tree_digest_equals_reference(leg, law_reference):
    """Solo, fleet, faulted fleet (its restart ledger) and edge states
    carried across: the port's digests equal the reference's word for
    word."""
    jst = law_reference[leg][0]
    tst = _port(jst)
    if leg.startswith("solo") or leg == "edge":
        assert int(tree_digest(tst)) == int(jtree(jst))
    else:
        assert fleet_digest(tst).tolist() \
            == np.asarray(jfleet(jst)).tolist()


def test_tree_digest_praos_u32_words():
    """Praos's uint32 ``thr`` is one word an element, as in the
    reference."""
    jsc = jp.praos(64, slot_us=100_000, n_slots=4, leader_prob=4 / 64,
                   fanout=4, burst=True)
    tsc = tp.praos(64, slot_us=100_000, n_slots=4, leader_prob=4 / 64,
                   fanout=4, burst=True)
    jps = JaxEngine(jsc, jd.UniformDelay(8_000, 20_000), window="auto",
                    lint="off").init_state()
    tps = _port(jps, tsc)
    assert int(tree_digest(tps, tsc.u32_states)) == int(jtree(jps))
    assert int(tree_digest(tps)) != int(jtree(jps))   # the words matter


@pytest.mark.parametrize("seed,plane", [(7, "mb_rel"), (11, None),
                                        (3, "wake"), (5, "restart_done"),
                                        (9, "states.hop"), (21, None)])
def test_apply_flip_picks_the_reference_bit(seed, plane, law_reference):
    jst = law_reference["fault-fleet-ledger"][0]
    tst = _port(jst)
    jbad, jdesc = japply(jst, seed, plane)
    tbad, tdesc = apply_flip(tst, seed, plane)
    assert tdesc == jdesc
    _states_equal(tbad, jbad, f"flip {seed} {plane}")
    _states_equal(tst, jst, "apply_flip is pure")


def test_apply_flip_u32_words_equal_reference():
    jsc = jp.praos(64, slot_us=100_000, n_slots=4, leader_prob=4 / 64,
                   fanout=4, burst=True)
    tsc = tp.praos(64, slot_us=100_000, n_slots=4, leader_prob=4 / 64,
                   fanout=4, burst=True)
    jst = JaxEngine(jsc, jd.UniformDelay(8_000, 20_000), window="auto",
                    lint="off").init_state()
    tst = _port(jst, tsc)
    for seed in (1, 2, 3):
        jbad, jdesc = japply(jst, seed, "thr")
        inj = FlipInjector(f"flip:{seed}:1:thr", u32=tsc.u32_states)
        tbad = inj(0, tst)
        assert inj.desc == jdesc
        assert np.array_equal(state_to_numpy(tbad, tsc)["states"]["thr"],
                              np.asarray(jbad.states["thr"]))


# ---------------------------------------------------------------------------
# the detection law
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(LAW))
def test_detection_law(name, law_reference):
    _, tmake, spec, kw = LAW[name]
    jfc, jtc, jchain, jrec, jdesc = law_reference[name][:5]  # recovered
    clean, injected = tmake(), tmake()
    fc, tc = clean.run_verified(BUDGET, **dict(dict(chunk=CHUNK), **kw))
    flip = FlipInjector(spec)
    fi, ti = injected.run_verified(BUDGET, inject=flip,
                                   **dict(dict(chunk=CHUNK), **kw))
    assert flip.fired and flip.desc == jdesc
    rec = injected.last_run_integrity
    assert rec["rollbacks"] >= 1 and rec["violations"], \
        f"injected flip went undetected ({flip.desc})"
    # the recovered run is the clean run, and both are the reference's
    _traces(tc, ti, "clean vs recovered")
    _states_equal(fc, fi, "recovered")
    _traces(jtc, tc, "reference vs port")
    _states_equal(fc, jfc, "reference vs port")
    assert clean.last_run_stats["digest_chain"] \
        == injected.last_run_stats["digest_chain"] == jchain
    assert rec == jrec
    if name == "shadow-cadence-2":
        assert rec["violations"][0]["kind"] == "entry_digest"
    if name.startswith("fault-fleet"):
        assert int(fc.fault_dropped.sum()) > 0 \
            or int(fc.restart_done.sum()) > 0


def test_shadow_zero_false_positives():
    for make, ref in ((lambda: tgossip(verify="shadow"), tgossip),
                      (lambda: tring(verify="shadow"), tring)):
        eng = make()
        fs, _ = eng.run_verified(BUDGET, chunk=CHUNK)
        rec = eng.last_run_integrity
        assert rec["rollbacks"] == 0 and not rec["violations"], rec
        assert rec["checks"] > 0
        _states_equal(ref().run(BUDGET)[0], fs, "shadow = plain run")


def test_persistent_corruption_raises_after_max_rollbacks():
    eng = tgossip(verify="digest")

    def always_corrupt(chunk_idx, state):
        if chunk_idx == 1:
            return apply_flip(state, seed=chunk_idx + 17, plane="mb_rel")[0]
        return None
    with pytest.raises(IntegrityViolation, match="persistent"):
        eng.run_verified(BUDGET, chunk=CHUNK, inject=always_corrupt)
    assert eng.last_run_integrity is None


def test_rollback_never_reanchors_on_corrupt_snapshot(monkeypatch):
    eng = tgossip(verify="digest")
    real = eng._state_digests
    calls = {"n": 0}

    def poisoned(state):
        calls["n"] += 1
        d = np.array(real(state))
        if calls["n"] >= 4:
            d ^= np.uint32(1)
        return d
    monkeypatch.setattr(eng, "_state_digests", poisoned)
    with pytest.raises(IntegrityViolation, match="snapshot"):
        eng.run_verified(BUDGET, chunk=CHUNK)


# ---------------------------------------------------------------------------
# the guard
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def guard_engines(law_reference):
    """A verifying engine of each kind and package with a state 8
    supersteps in: the reference's are the detection law's engines, whose
    drivers are compiled already (any mode but off runs the guard)."""
    out = {"jgossip": law_reference["solo"][6],
           "jring": law_reference["edge"][6],
           "tgossip": tgossip(verify="digest"),
           "tring": tring(verify="digest")}
    return {k: (eng, eng.run(8)[0]) for k, eng in out.items()}


def _guard_message(eng, st, bad_of, quiet=False):
    with pytest.raises(Exception) as err:
        (eng.run_quiet if quiet else eng.run)(8, state=bad_of(st))
    return type(err.value).__name__, str(err.value)


def _negative(st):
    return st._replace(delivered=st.delivered * 0 - 1_000_000)


def _future(st):
    return st._replace(time=st.time + (1 << 40))


@pytest.mark.parametrize("what", ["neg_counter", "time_regress"])
def test_guard_names_superstep_and_field(what, guard_engines):
    bad = _negative if what == "neg_counter" else _future
    for kind, name in (("gossip", "JaxEngine"), ("ring", "EdgeEngine")):
        jname, jmsg = _guard_message(*guard_engines["j" + kind], bad)
        tname, tmsg = _guard_message(*guard_engines["t" + kind], bad)
        assert tname == "IntegrityViolation" == jname
        assert tmsg.replace(type(guard_engines["t" + kind][0]).__name__,
                            name) == jmsg
        assert "superstep 0" in tmsg and what in tmsg and "\n" not in tmsg
        assert len(tmsg) < 300 and "[" not in tmsg


def test_guard_clean_run_equals_off_and_quiet_guard(guard_engines):
    f0, t0 = tgossip().run(30)
    f1, t1 = tgossip(verify="guard").run(30)
    assert_traces_equal(t0, t1, "off", "guard")
    _states_equal(f0, f1, "guard clean")
    eng, st = guard_engines["tgossip"]
    assert int(eng.run_quiet(6, state=st).steps) >= int(st.steps)
    tname, tmsg = _guard_message(eng, st, _negative, quiet=True)
    # the reference's run_quiet raises what its final_state_guard raises
    # on the same final state
    final = tgossip().run_quiet(8, state=_negative(st))
    with pytest.raises(Exception) as err:
        jfinal_guard(JState(**state_to_numpy(final)), "JaxEngine")
    assert tname == type(err.value).__name__ == "IntegrityViolation"
    assert "delivered" in tmsg
    assert tmsg.replace("TorchEngine", "JaxEngine") == str(err.value)


def test_run_verified_metrics_equal_reference(law_reference):
    """A verified run with a flip writes the reference's metrics lines:
    one ``integrity`` line per verified chunk or rollback, the violation
    as an ``event``."""
    eng = tgossip(verify="digest")
    eng.metrics, eng.metrics_label = MetricsRegistry(run="r"), "solo"
    eng.run_verified(BUDGET, chunk=CHUNK, inject=FlipInjector(LAW["solo"][2]))
    lines = eng.metrics.lines
    assert lines == law_reference["solo"][5]
    assert {ln["kind"] for ln in lines} == {"integrity", "event"}
    assert any(ln.get("event") == "rollback" for ln in lines)

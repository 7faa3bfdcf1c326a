"""The port's adversarial chaos search (``timewarp_tpu_torch/search/``) on
the CPU, held against the reference's (``timewarp_tpu/search/``) case for
case of ``tests/test_zzzzzzzzsearch.py``: the same configurations, seeds
and schedules through both packages.

- ``check_worlds`` over both evaluators' traces, and its refusals;
- the snapshot-fork law on the reference test's 8-node token ring: world
  0 of the fork fleet (an empty suffix) equals the uninterrupted run,
  digest chain included, in each package, and the digest chains, the six
  counters and ``saving_frac`` equal the reference's;
- a crash suffix opening at the executed horizon (which the validation
  admits) differs from the from-scratch run, one opening a link delay
  later equals it, in both packages alike;
- fork-suffix validation, the same refusals word for word;
- the minimizer (same trials, drops, tightening and result string), the
  objective grammar, the campaign's refusals, ``domain_for`` and
  ``candidate_config``, the seeded mutation streams, and the
  ``load_world_state`` guards (the port also loads the reference's
  snapshot);
- the campaign: ``bench.py`` ``search_gossip``'s 64-node campaign through
  the port, held against constants recorded from the reference (the
  reference takes about 50 s on this CPU, nearly all of it JAX compiles;
  the port about 5 s), its determinism law (two runs, identical histories
  and ``repro.json`` bytes), and its journal ingested by both run ledgers
  as the same ``search`` record; the ``slow`` twin runs the reference
  test's own ``_campaign`` through both packages and compares
  everything, the journal records (without ``ts``) included, and
  re-derives the constants from the reference.

The ``cuda`` cases run the small campaign and the fork law on the card,
equal to the CPU run.

Tolerance: exact (the search uses integer links only).
"""

import dataclasses
import importlib
import json

import numpy as np
import pytest
import torch

import timewarp_tpu.search.campaign as RC
import timewarp_tpu.search.domain as RD
import timewarp_tpu.search.fork as RF
import timewarp_tpu.search.minimize as RM
import timewarp_tpu.search.objectives as RO
from timewarp_tpu.faults import schedule as RS
from timewarp_tpu.sweep import bucket as RB
from timewarp_tpu.sweep import spec as RSp
from timewarp_tpu_torch.faults import properties as PP
from timewarp_tpu_torch.faults import schedule as PS
from timewarp_tpu_torch.search import campaign as PC
from timewarp_tpu_torch.search import domain as PD
from timewarp_tpu_torch.search import fork as PF
from timewarp_tpu_torch.search import minimize as PM
from timewarp_tpu_torch.search import objectives as PO
from timewarp_tpu_torch.sweep import bucket as PB
from timewarp_tpu_torch.sweep import spec as PSp

# one intra-op thread per test process: the test session's workers
# share the host's cores (a process of the default width each
# oversubscribes them several times over)
torch.set_num_threads(1)

# the packages export a function ``mutate`` that shadows the module's name
RMu = importlib.import_module("timewarp_tpu.search.mutate")
PMu = importlib.import_module("timewarp_tpu_torch.search.mutate")
CPU = "cpu"
_FIELDS = ("times", "fired_count", "fired_hash", "recv_count", "recv_hash",
           "sent_count", "sent_hash", "overflow")
_COUNTERS = ("time", "steps", "delivered", "overflow", "fault_dropped",
             "short_delay")


def _gossip_cfg(spec, run_id="w0", *, nodes=8, end_us=120_000, budget=300,
                faults=None, seed=0):
    params = {"nodes": nodes, "fanout": 2, "end_us": end_us,
              "burst": True, "think_us": 5000, "mailbox_cap": 16}
    return spec.RunConfig(run_id=run_id, family="gossip",
                          params=tuple(sorted(params.items())),
                          link="uniform:1000:5000", seed=seed,
                          window="auto", budget=budget, faults=faults)


def _ring_cfg(spec, run_id="w0", *, budget=60, faults=None):
    params = {"nodes": 8, "n_tokens": 2, "think_us": 2000,
              "bootstrap_us": 1000, "end_us": 1 << 40, "mailbox_cap": 8}
    return spec.RunConfig(run_id=run_id, family="token-ring",
                          params=tuple(sorted(params.items())),
                          link="uniform:1000:5000", seed=3,
                          window="auto", budget=budget, faults=faults)


def _same_trace(a, b):
    assert len(a) == len(b)
    for f in _FIELDS:
        assert np.array_equal(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f))), f


def _fmt(S, sched):
    """A schedule's grammar string, "" for the empty one."""
    return S.format_faults(sched) if sched.events else ""


def _message(fn):
    """The text of the exception ``fn()`` raises (ValueError or the
    grammar's SystemExit)."""
    with pytest.raises((ValueError, SystemExit)) as e:
        fn()
    return str(e.value)


# -- batched property checks (faults/properties.py) ------------------------

_EVALS = {}


def _evals():
    """The reference test's two worlds (a clean one and node 0 crashed
    for the whole run) through both evaluators, cached for the module."""
    if not _EVALS:
        _EVALS["ref"] = RO.evaluate_configs(
            [_gossip_cfg(RSp, "ok"),
             _gossip_cfg(RSp, "kill", faults="crash:0:0:240000")],
            lint="off")
        _EVALS["port"] = PO.evaluate_configs(
            [_gossip_cfg(PSp, "ok"),
             _gossip_cfg(PSp, "kill", faults="crash:0:0:240000")],
            device=CPU)
    return _EVALS["ref"], _EVALS["port"]


def test_check_worlds_slices_the_fleet():
    from timewarp_tpu.faults import properties as RP
    ref, port = _evals()
    for rid in ("ok", "kill"):
        _same_trace(port[rid].trace, ref[rid].trace)
        assert (port[rid].supersteps, port[rid].quiesced,
                port[rid].budget) == (ref[rid].supersteps,
                                      ref[rid].quiesced, ref[rid].budget)
        assert _fmt(PS, port[rid].schedule) == _fmt(RS, ref[rid].schedule)
    res = PP.check_worlds([port["ok"].trace, port["kill"].trace],
                          [port["ok"].schedule, port["kill"].schedule],
                          [PP.prop_eventually_delivered(0)],
                          run_ids=["ok", "kill"])
    want = RP.check_worlds([ref["ok"].trace, ref["kill"].trace],
                           [ref["ok"].schedule, ref["kill"].schedule],
                           [RP.prop_eventually_delivered(0)],
                           run_ids=["ok", "kill"])
    assert list(res.ok) == list(want.ok) == [True, False]
    assert not res.all_ok
    assert [tuple(f) for f in res.failures] \
        == [tuple(f) for f in want.failures]
    f = res.failures[0]
    assert (f.world, f.run_id, f.prop) == (1, "kill",
                                           "eventually-delivered:0")
    assert "no delivery" in f.detail
    res2 = PP.check_worlds([port["ok"].trace, port["kill"].trace], None,
                           [PP.prop_converged(lambda r: True)])
    assert list(res2.ok) == [True, len(port["kill"].trace) > 0]


def test_check_worlds_refuses_mismatched_shapes():
    from timewarp_tpu.faults import properties as RP
    ref, port = _evals()
    for P, S, tr in ((PP, PS, [port["ok"].trace]),
                     (RP, RS, [ref["ok"].trace])):
        with pytest.raises(ValueError, match="world schedules"):
            P.check_worlds(tr, [S.FaultSchedule(()), S.FaultSchedule(())],
                           [P.prop_eventually_delivered(0)])
        with pytest.raises(ValueError, match="run_ids"):
            P.check_worlds(tr, None, [P.prop_eventually_delivered(0)],
                           run_ids=["a", "b"])
    assert _message(lambda: PP.check_worlds(
        [port["ok"].trace], None, [PP.prop_eventually_delivered(0)],
        run_ids=["a", "b"])) == _message(lambda: RP.check_worlds(
            [ref["ok"].trace], None, [RP.prop_eventually_delivered(0)],
            run_ids=["a", "b"]))


# -- the snapshot-fork law -------------------------------------------------

def _fork_law(pkg, tmp_path, device=CPU):
    """The reference test's fork law through one package: the
    uninterrupted run, 20 supersteps and a snapshot, a K=3 fork fleet
    with a wider pad (world 0's suffix empty, a crash, a degrade).
    Returns the digests and counters both sides compare."""
    if pkg == "ref":
        from timewarp_tpu.utils.checkpoint import save_state
        spec, Bk, F, S = RSp, RB, RF, RS
        kw, host = {"lint": "off"}, np.asarray
    else:
        from timewarp_tpu_torch.utils.checkpoint import save_state
        spec, Bk, F, S = PSp, PB, PF, PS
        kw, host = {"device": device}, (lambda x: x.cpu().numpy())
    base = _ring_cfg(spec, faults="crash:2:20000:40000")
    pad = (2, 1, 1)
    bucket = Bk.Bucket("u", (base,), 1000, fault_pad=pad)
    eng_u = Bk.build_bucket_engine(bucket, **kw)
    final_u, traces_u = eng_u.run_stream(bucket.budgets, chunk=64)
    eng_p = Bk.build_bucket_engine(Bk.Bucket("p", (base,), 1000,
                                             fault_pad=pad), **kw)
    st, traces_pre = eng_p.run(np.asarray([20], np.int64),
                               state=eng_p.init_state())
    ckpt = str(tmp_path / f"snap-{pkg}.npz")
    if pkg == "ref":
        save_state(ckpt, st, meta={"t": "fork-test"})
    else:
        save_state(ckpt, st, meta={"t": "fork-test"},
                   scenario=eng_p.scenario)
    t_fork = int(host(st.time)[0])
    evs = tuple(base.parse_faults().events)
    s1 = S.FaultSchedule(evs + (S.NodeCrash(5, t_fork + 1000,
                                            t_fork + 60_000),))
    s2 = S.FaultSchedule(evs + (S.LinkWindow(None, None, t_fork + 2000,
                                             t_fork + 80_000, 2.0),))
    fengine, _ = F.fork_bucket(base, [base.parse_faults(), s1, s2], t_fork,
                               fault_pad=(3, 1, 1), **kw)
    state, t_fork2, meta = F.load_fork_state(fengine, ckpt, 0)
    assert (t_fork2, meta) == (t_fork, {"t": "fork-test"})
    fr = F.run_fork(fengine, state, base.budget, chunk=64)
    Z, chain = spec.DIGEST_ZERO, spec.chain_digest
    return dict(
        t_fork=t_fork, prefix=fr.prefix_supersteps,
        suffix=list(fr.suffix_supersteps), quiesced=list(fr.quiesced),
        saving=fr.saving_frac,
        uninterrupted=chain(Z, traces_u[0]),
        forked=chain(chain(Z, traces_pre[0]), fr.traces[0]),
        worlds=[chain(Z, t) for t in fr.traces],
        fork_counters={f: host(getattr(fr.final, f)).tolist()
                       for f in _COUNTERS},
        counters_u={f: int(host(getattr(final_u, f))[0])
                    for f in _COUNTERS})


_FORK = {}


def test_fork_world0_unchanged_suffix_is_bit_identical(tmp_path):
    port = _FORK["cpu"] = _fork_law("port", tmp_path)
    assert port["prefix"] == 20
    assert 0.0 < port["saving"] < 1.0
    # the fork law in the port: world 0 = the uninterrupted run, digest
    # chain and counters
    assert port["forked"] == port["uninterrupted"]
    assert {f: v[0] for f, v in port["fork_counters"].items()} \
        == port["counters_u"]
    # the divergent suffixes bit: world 1's crash drops deliveries
    assert port["fork_counters"]["fault_dropped"][1] \
        > port["fork_counters"]["fault_dropped"][0]
    assert port["worlds"][1] != port["worlds"][0]
    # and every number equals the reference's run of the same law
    assert port == _fork_law("ref", tmp_path)


def _crash_forks(pkg, tmp_path):
    """The ring snapshot at 20 supersteps forked into two worlds that
    crash node 0 (which the token is in flight to) from ``t_fork + 1000``
    (the executed horizon) and from ``t_fork + 6000`` (one link delay
    later: ``uniform:1000:5000`` delays are at most 5000 µs). Returns
    each world's digest chain and its from-scratch solo run's."""
    if pkg == "ref":
        from timewarp_tpu.sweep import solo_result
        from timewarp_tpu.utils.checkpoint import save_state
        spec, Bk, F, S, D = RSp, RB, RF, RS, RD
        kw, host = {"lint": "off"}, np.asarray
    else:
        from timewarp_tpu_torch.sweep import solo_result
        from timewarp_tpu_torch.utils.checkpoint import save_state
        spec, Bk, F, S, D = PSp, PB, PF, PS, PD
        kw, host = {"device": CPU}, (lambda x: x.cpu().numpy())
    base = _ring_cfg(spec, faults="crash:2:20000:40000")
    eng = Bk.build_bucket_engine(Bk.Bucket("p", (base,), 1000,
                                           fault_pad=(2, 1, 1)), **kw)
    st, pre = eng.run(np.asarray([20], np.int64), state=eng.init_state())
    ckpt = str(tmp_path / f"crash-{pkg}.npz")
    save_state(ckpt, st, **({} if pkg == "ref"
                            else {"scenario": eng.scenario}))
    t = int(host(st.time)[0])
    scheds = [S.FaultSchedule(tuple(base.parse_faults().events)
                              + (S.NodeCrash(0, t + off, t + 60_000),))
              for off in (1000, 6000)]
    fengine, _ = F.fork_bucket(base, scheds, t, fault_pad=(3, 1, 1), **kw)
    state, _, _ = F.load_fork_state(fengine, ckpt, 0)
    fr = F.run_fork(fengine, state, base.budget)
    chain, Z = spec.chain_digest, spec.DIGEST_ZERO
    return ([chain(chain(Z, pre[0]), tr) for tr in fr.traces],
            [solo_result(D.candidate_config(base, s, f"c{i}"),
                         **kw)["trace_digest"]
             for i, s in enumerate(scheds)])


def test_fork_crash_suffix_needs_a_link_delay_past_the_horizon(tmp_path):
    """A crash drops the messages whose deliver time lands in its window
    when they are routed (``faults/apply.py`` ``down_mask``), so a crash
    suffix opening at the executed horizon, which ``validate_fork_suffix``
    admits, misses messages the snapshot already holds: its world
    differs from the from-scratch run of its schedule. One opening a link
    delay later equals it. The reference does the same, digest for
    digest."""
    forks, solos = _crash_forks("port", tmp_path)
    assert forks[0] != solos[0]
    assert forks[1] == solos[1]
    assert (forks, solos) == _crash_forks("ref", tmp_path)


def test_fork_suffix_validation():
    t_fork, window = 50_000, 1000
    cases = [
        ("unmodified prefix", lambda S, b: S.FaultSchedule(
            (S.NodeCrash(3, 60_000, 70_000),))),
        ("rewrite the snapshot", lambda S, b: S.FaultSchedule(
            tuple(b.events) + (S.NodeCrash(3, 10_000, 70_000),))),
        ("executed horizon", lambda S, b: S.FaultSchedule(
            tuple(b.events)
            + (S.NodeCrash(3, t_fork + window - 1, 70_000),))),
        ("ClockSkew", lambda S, b: S.FaultSchedule(
            tuple(b.events) + (S.ClockSkew(1, 100),))),
        ("scale < 1", lambda S, b: S.FaultSchedule(
            tuple(b.events)
            + (S.LinkWindow(None, None, 60_000, 70_000, 0.5),))),
    ]
    for match, make in cases:
        msgs = []
        for S, F in ((PS, PF), (RS, RF)):
            b = S.parse_faults("crash:2:20000:40000")
            with pytest.raises(ValueError, match=match) as e:
                F.validate_fork_suffix(b, make(S, b), t_fork, window)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    b = PS.parse_faults("crash:2:20000:40000")
    PF.validate_fork_suffix(b, PS.FaultSchedule(
        tuple(b.events) + (PS.NodeCrash(3, t_fork + window, 70_000),)),
        t_fork, window)


# -- the minimizer ---------------------------------------------------------

def test_minimizer_drops_and_tightens_deterministically():
    def judge(s):   # a crash on node 0 covering [10_000, 11_000)
        return any(type(e).__name__ == "NodeCrash" and e.node == 0
                   and e.t_down <= 10_000 and e.t_up >= 11_000
                   for e in s.events)
    spec_str = ("degrade:all:all:0:50000:2.0; crash:0:2000:90000; "
                "partition:0-3|4-7:1000:2000; crash:5:0:80000")
    res = PM.minimize_counterexample(
        _gossip_cfg(PSp), PS.parse_faults(spec_str),
        PO.parse_objective("eventually-delivered"), _judge=judge)
    want = RM.minimize_counterexample(
        _gossip_cfg(RSp), RS.parse_faults(spec_str),
        RO.parse_objective("eventually-delivered"), _judge=judge)
    assert [type(e).__name__ for e in res.schedule.events] == ["NodeCrash"]
    e = res.schedule.events[0]
    assert (e.node, e.t_down, e.t_up) == (0, 10_000, 11_000)
    assert res.dropped_events == 3
    assert (PS.format_faults(res.schedule), res.trials, res.dropped_events,
            res.tightened_us) == (RS.format_faults(want.schedule),
                                  want.trials, want.dropped_events,
                                  want.tightened_us)
    msgs = [_message(lambda: M.minimize_counterexample(
        _gossip_cfg(Sp), S.parse_faults("skew:1:5"),
        O.parse_objective("eventually-delivered"), _judge=lambda s: False))
        for M, Sp, S, O in ((PM, PSp, PS, PO), (RM, RSp, RS, RO))]
    assert "does not violate" in msgs[0] and msgs[0] == msgs[1]


def test_objective_grammar():
    for O in (PO, RO):
        assert O.parse_objective("eventually-delivered").after_t == 0
        assert O.parse_objective("eventually-delivered:5ms").after_t == 5000
        assert O.parse_objective("convergence:2s").limit_us == 2_000_000
    for spec in ("eventually-delivered", "eventually-delivered:5ms",
                 "convergence:2s"):
        p, r = PO.parse_objective(spec), RO.parse_objective(spec)
        assert type(p).__name__ == type(r).__name__
        assert dataclasses.asdict(p) == dataclasses.asdict(r)
    for bad in ("bogus", "convergence", "eventually-delivered:x:y"):
        msg = _message(lambda: PO.parse_objective(bad))
        assert "grammar" in msg
        assert msg == _message(lambda: RO.parse_objective(bad))


# -- the campaign ----------------------------------------------------------

def _bench_base(spec):
    """``bench.py`` ``bench_search_gossip``'s base config (64 nodes,
    budget 300)."""
    return _gossip_cfg(spec, "search-base", nodes=64, budget=300)


#: ``bench.py`` ``bench_search_gossip``'s campaign (64 nodes, budget 300,
#: ``eventually-delivered``, population 8, 6 generations, seed 2,
#: ``fork_k`` 2, a journal dir) through the reference on the CPU, as
#: ``python -c`` of ``ChaosSearch(base=<_bench_base(timewarp_tpu.sweep.
#: spec)>, objective="eventually-delivered", population=8, generations=6,
#: seed=2, fork_k=2, journal_dir=D).run()`` under ``JAX_PLATFORMS=cpu``
#: with x64 on: ``to_json()`` without ``repro_path``, ``generations``
#: and ``D/repro.json``'s text (the ``slow`` twin re-derives them)
REF_RESULT = {
    "found": True, "counterexample": "partition:0-3|4-63:0:10248",
    "minimized": "partition:0-3|4-63:1000:1001", "generations": 2,
    "evaluations": 28,
    "fork": {"forks": 1, "fork_worlds": 2, "prefix_supersteps": 23,
             "suffix_supersteps": 47, "full_supersteps": 93,
             "confirmations": 0, "saving_frac": 0.2473}}
REF_HISTORY = [
    {"gen": 0, "population": 8, "evaluations": 8, "best_score": 4817,
     "best_faults": "", "violations": []},
    {"gen": 1, "population": 8, "evaluations": 12,
     "best_score": 4611686018427387904,
     "best_faults": "partition:0-3|4-63:0:10248",
     "violations": ["partition:0-3|4-63:0:10248"]}]
REF_REPRO = """{
 "budget": 300,
 "events": 1,
 "faults": "partition:0-3|4-63:1000:1001",
 "found_gen": 1,
 "kind": "chaos-search-repro",
 "link": "uniform:1000:5000",
 "objective": "eventually-delivered:0",
 "params": {
  "burst": true,
  "end_us": 120000,
  "fanout": 2,
  "mailbox_cap": 16,
  "nodes": 64,
  "think_us": 5000
 },
 "repro_schema": 1,
 "scenario": "gossip",
 "search_seed": 2,
 "seed": 0,
 "window": "auto"
}
"""


def _bench_campaign(C, spec, jdir, **kw):
    return C.ChaosSearch(base=_bench_base(spec),
                         objective="eventually-delivered", population=8,
                         generations=6, seed=2, fork_k=2,
                         journal_dir=str(jdir), **kw)


def _result(r):
    return {k: v for k, v in r.to_json().items() if k != "repro_path"}


def _journal(jd, pkg="port"):
    if pkg == "port":
        from timewarp_tpu_torch.sweep.journal import SweepJournal
    else:
        from timewarp_tpu.sweep.journal import SweepJournal
    return [{k: v for k, v in e.items() if k != "ts"}
            for e in SweepJournal(str(jd)).records()]


def _ledger_record(Ledger, root, jd):
    led = Ledger(str(root))
    (rid,) = led.add_source(str(jd))
    rec = led.get(rid)
    return {k: v for k, v in rec.items() if k not in ("run_id", "git_sha")}


def test_campaign_matches_reference_and_is_deterministic(tmp_path):
    """The bench campaign through the port equals the reference's, whose
    constants above come from (about 50 s, from the repository's root)::

        JAX_PLATFORMS=cpu python -c "import sys, jax; \\
        jax.config.update('jax_enable_x64', True); \\
        sys.path.insert(0, 'tests'); import test_torch_search as t; \\
        r = t._bench_campaign(t.RC, t.RSp, '/tmp/sj').run(); \\
        print(r.to_json(), r.generations, open('/tmp/sj/repro.json').read())"
    """
    from timewarp_tpu.obs.ledger import RunLedger as RefLedger
    from timewarp_tpu_torch.obs.ledger import RunLedger
    runs = [_bench_campaign(PC, PSp, tmp_path / j, device=CPU).run()
            for j in ("j1", "j2")]
    texts = [open(tmp_path / j / "repro.json").read() for j in ("j1", "j2")]
    for r, text in zip(runs, texts):
        assert _result(r) == REF_RESULT
        assert r.generations == REF_HISTORY
        assert text == REF_REPRO
        assert r.repro == json.loads(REF_REPRO)
    # the determinism law: the two runs' journals are equal too
    assert _journal(tmp_path / "j1") == _journal(tmp_path / "j2")
    # the minimized repro re-fails the property solo
    obj, violated, _ = PO.rejudge_repro(runs[0].repro, device=CPU)
    assert violated and obj.name == "eventually-delivered:0"
    # the journal ingests into both ledgers as the same `search` record
    rec = _ledger_record(RunLedger, tmp_path / "led", tmp_path / "j1")
    assert rec == _ledger_record(RefLedger, tmp_path / "ref-led",
                                 tmp_path / "j1")
    assert rec["kind"] == "search"
    assert rec["search"]["found"] is True
    assert rec["search"]["minimized"] == REF_RESULT["minimized"]
    assert rec["config_key"].startswith("search|gossip|")


def _campaign(C, spec, jdir, **kw):
    """The reference test's ``_campaign``: a near-violation seed
    schedule (node 0 down to 20 ms of a 30 ms deadline)."""
    base = _gossip_cfg(spec, "search-base", end_us=30_000, budget=120,
                       faults="crash:0:0:20000")
    return C.ChaosSearch(base=base, objective="eventually-delivered",
                         population=5, generations=4, seed=0, fork_k=2,
                         minimize_trials=60, journal_dir=str(jdir), **kw)


@pytest.mark.slow
def test_campaign_determinism_and_repro_against_reference(tmp_path):
    ref = _campaign(RC, RSp, tmp_path / "r").run()
    port = _campaign(PC, PSp, tmp_path / "p", device=CPU).run()
    assert ref.found and port.found
    assert _result(port) == _result(ref)
    assert port.generations == ref.generations
    assert port.repro == ref.repro
    assert open(tmp_path / "p" / "repro.json").read() \
        == open(tmp_path / "r" / "repro.json").read()
    assert _journal(tmp_path / "p") == _journal(tmp_path / "r", "ref")
    _, violated, _ = PO.rejudge_repro(port.repro, device=CPU)
    assert violated
    # the bench campaign's constants, re-derived from the reference
    bench = _bench_campaign(RC, RSp, tmp_path / "rb").run()
    assert _result(bench) == REF_RESULT
    assert bench.generations == REF_HISTORY
    assert open(tmp_path / "rb" / "repro.json").read() == REF_REPRO


def test_campaign_refuses_trivially_violated_objective():
    msgs = []
    for C, spec, kw in ((PC, PSp, {"device": CPU}), (RC, RSp, {})):
        base = _gossip_cfg(spec, "search-base", end_us=30_000, budget=120)
        c = C.ChaosSearch(base=base,
                          objective="eventually-delivered:29000000",
                          population=3, generations=1, seed=0, **kw)
        msgs.append(_message(c.run))
    assert "already violates" in msgs[0] and msgs[0] == msgs[1]


def test_campaign_refuses_reused_journal_dir(tmp_path):
    jd = tmp_path / "j"
    jd.mkdir()
    (jd / "journal.jsonl").write_text('{"ev": "search_campaign"}\n')
    msgs = []
    for C, spec, kw in ((PC, PSp, {"device": CPU}), (RC, RSp, {})):
        base = _gossip_cfg(spec, "search-base", end_us=30_000, budget=120)
        msgs.append(_message(lambda: C.ChaosSearch(
            base=base, objective="eventually-delivered", population=3,
            generations=1, seed=0, journal_dir=str(jd), **kw)))
    assert "fresh --journal" in msgs[0] and msgs[0] == msgs[1]


def test_campaign_guards_elites_below_population():
    msgs = []
    for C, spec, kw in ((PC, PSp, {"device": CPU}), (RC, RSp, {})):
        base = _gossip_cfg(spec, "search-base", end_us=30_000, budget=120)
        c = C.ChaosSearch(base=base, objective="eventually-delivered",
                          population=2, generations=1, seed=0, **kw)
        assert c.elites == 1
        msgs.append(_message(lambda: C.ChaosSearch(
            base=base, objective="eventually-delivered", population=4,
            generations=1, seed=0, elites=4, **kw)))
    assert "no offspring" in msgs[0] and msgs[0] == msgs[1]


def test_domain_and_candidate_config():
    for D, spec, S in ((PD, PSp, PS), (RD, RSp, RS)):
        base = _gossip_cfg(spec)
        dom = D.domain_for(base)
        assert (dom.n_nodes, dom.horizon_us) == (8, 120_000)
        assert dom.table_pad == (3, 2, 2) and dom.t_max == 240_000
        pp = spec.RunConfig(run_id="pp", family="ping-pong", params=(),
                            budget=10)
        with pytest.raises(ValueError, match="horizon_us"):
            D.domain_for(pp)
        assert D.domain_for(pp, horizon_us=1000).n_nodes == 2
        sched = S.parse_faults("crash:1:0:5000")
        cand = D.candidate_config(base, sched, "c1")
        assert cand.run_id == "c1"
        assert cand.parse_faults().events == sched.events
        assert D.candidate_config(base, S.FaultSchedule(()), "c2").faults \
            is None
    sched = "crash:1:0:5000; partition:0-3|4-7:10ms:20ms"
    assert PD.candidate_config(_gossip_cfg(PSp), PS.parse_faults(sched),
                               "c").to_json() \
        == RD.candidate_config(_gossip_cfg(RSp), RS.parse_faults(sched),
                               "c").to_json()


def test_mutation_streams_are_deterministic_and_admissible():
    streams = {}
    for C, Mu, D, S, F, tag in ((PC, PMu, PD, PS, PF, "port"),
                                (RC, RMu, RD, RS, RF, "ref")):
        dom = D.ScheduleDomain(8, 120_000)
        s, seen = S.FaultSchedule(()), []
        for i in range(30):
            s = Mu.mutate(C._rng(7, "t", i), s, dom)
            assert dom.admissible(s)
            seen.append(_fmt(S, s))
        s2 = S.FaultSchedule(())
        for i in range(30):
            s2 = Mu.mutate(C._rng(7, "t", i), s2, dom)
        assert _fmt(S, s2) == seen[-1]
        base = S.parse_faults("crash:1:0:5000")
        for i in range(20):
            out = Mu.suffix_mutate(C._rng(9, i), base, 60_000, dom)
            seen.append(None if out is None else S.format_faults(out))
            if out is not None:
                F.validate_fork_suffix(base, out, 59_000, 1000)
        a, b = S.parse_faults(seen[10]), S.parse_faults(seen[20])
        for i in range(10):
            child = Mu.crossover(C._rng(3, i), a, b, dom)
            seen.append(None if child is None else S.format_faults(child))
        streams[tag] = seen
    # equal seeds give the reference's schedules, draw for draw
    assert streams["port"] == streams["ref"]


def test_load_world_state_guards(tmp_path):
    from timewarp_tpu.utils.checkpoint import save_state as ref_save
    from timewarp_tpu_torch.interp.torch_engine.batched import world_slice
    from timewarp_tpu_torch.utils.checkpoint import (load_world_state,
                                                     save_state)
    base = _ring_cfg(PSp)
    eng = PB.build_bucket_engine(PB.Bucket("g", (base,), 1000), device=CPU)
    st = eng.init_state()
    path = str(tmp_path / "s.npz")
    save_state(path, st, meta={}, scenario=eng.scenario)
    solo = world_slice(st, 0)
    out, _ = load_world_state(path, solo, 0, scenario=eng.scenario)
    for a, b in zip(out, solo):
        for x, y in (zip(a.values(), b.values()) if isinstance(a, dict)
                     else [(a, b)]):
            assert torch.equal(x, y)
    with pytest.raises(ValueError, match="out of range"):
        load_world_state(path, solo, 5, scenario=eng.scenario)
    with pytest.raises(ValueError, match="world-stacked"):
        load_world_state(path, st, 0, scenario=eng.scenario)
    # the reference's snapshot of the same bucket loads into the port's
    # fork fleet as the port's own does
    rb = RB.Bucket("g", (_ring_cfg(RSp),), 1000)
    rpath = str(tmp_path / "r.npz")
    ref_save(rpath, RB.build_bucket_engine(rb, lint="off").init_state(),
             meta={"src": "ref"})
    fengine, _ = PF.fork_bucket(base, [PS.FaultSchedule(())] * 2, 0,
                                device=CPU)
    mine, t0, _ = PF.load_fork_state(fengine, path, 0)
    theirs, t1, meta = PF.load_fork_state(fengine, rpath, 0)
    assert (t0, t1, meta) == (0, 0, {"src": "ref"})
    for a, b in zip(mine, theirs):
        for x, y in (zip(a.values(), b.values()) if isinstance(a, dict)
                     else [(a, b)]):
            assert torch.equal(x, y)


# -- on the card -----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return "cuda"


@pytest.mark.cuda
def test_fork_law_on_the_card_equals_cpu(cuda_device, tmp_path):
    card = _fork_law("port", tmp_path, device=cuda_device)
    assert card["forked"] == card["uninterrupted"]
    assert card == (_FORK.get("cpu") or _fork_law("port", tmp_path))


@pytest.mark.cuda
def test_campaign_on_the_card_equals_cpu(cuda_device, tmp_path):
    card = _bench_campaign(PC, PSp, tmp_path / "c", device=cuda_device).run()
    cpu = _bench_campaign(PC, PSp, tmp_path / "h", device=CPU).run()
    assert _result(card) == _result(cpu) == REF_RESULT
    assert card.generations == cpu.generations
    assert open(tmp_path / "c" / "repro.json").read() \
        == open(tmp_path / "h" / "repro.json").read() == REF_REPRO
    assert _journal(tmp_path / "c") == _journal(tmp_path / "h")
    _, violated, _ = PO.rejudge_repro(card.repro, device=cuda_device)
    assert violated

"""The port's open buckets under admission, rebinding and packing: the
zero-rebuild cases of ``tests/test_zzzzzzzzzzoperand.py`` and the serve
and merge cases of ``tests/test_zzzzzzzzzzpack.py`` on the port, held to
the port's solo runs and to the reference.

- **The zero-rebuild admission law**: after one warm-up chunk, 8
  sequential admissions and a fault-pad-compatible faulted admission
  rebind the SAME ``TorchEngine`` (``rebind_identity``): one
  ``engine_builds``, ``compiles`` 0, the engine object kept, every
  admitted world's result = its solo runs (port and reference).
- **Rebind exactness**: a warm fleet rebound to new seeds and same-shape
  fault tables equals a fresh engine with that identity, and the
  reference's fresh ``JaxEngine`` fleet, state leaf for leaf and trace
  for trace.
- **Pad inertness**: a wider-padded fault fleet is trace- and
  counter-identical, in the port as in the reference.
- **The masked re-run law**: one violating world of an 8-world
  speculative fleet re-runs alone; every world equals its solo run on
  the canonical surface.
- **Predictive packing at the frontend and the curator**: placement
  decisions journaled before the admit (journals equal the reference's),
  the best-horizon bucket, the merge refusing a wider donor pad, the
  speculation chain carried across a merge (equal to the reference's
  unmerged run) and a repack straddling a kill and resume.

Tolerance: exact (records, journals, traces and state leaves compared
with ``==``).
"""

import os

import numpy as np
import pytest

from timewarp_tpu_torch.faults import FaultFleet, FaultSchedule, NodeCrash
from timewarp_tpu_torch.interp.torch_engine.batched import BatchSpec
from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
from timewarp_tpu_torch.interp.torch_engine.state_io import state_to_numpy
from timewarp_tpu_torch.models.gossip import gossip
from timewarp_tpu_torch.models.token_ring import token_ring, token_ring_links
from timewarp_tpu_torch.net.delays import UniformDelay
from timewarp_tpu_torch.serve.curator import CuratorKilled, ServeCurator
from timewarp_tpu_torch.serve.frontend import ServeFrontend, bucket_key_sha
from timewarp_tpu_torch.serve.worker import OpenBucketRunner
from timewarp_tpu_torch.speculate import assert_spec_equiv, canonical_rows
from timewarp_tpu_torch.sweep.journal import SweepJournal
from timewarp_tpu_torch.sweep.spec import (RunConfig, resolve_window,
                                           solo_result)
from timewarp_tpu_torch.trace.events import assert_traces_equal
import torch

# one intra-op thread per test process: the test session's workers
# share the host's cores (a process of the default width each
# oversubscribes them several times over)
torch.set_num_threads(1)

CPU = "cpu"
RING = {"nodes": 64, "n_tokens": 4, "think_us": 2000,
        "end_us": 1 << 40, "mailbox_cap": 8}


def _cfg(i, seed, budget, faults=None, speculate=None,
         link="uniform:1000:5000"):
    d = {"id": f"w{i}", "scenario": "token-ring", "params": RING,
         "link": link, "seed": seed, "budget": budget}
    if faults:
        d["faults"] = faults
    if speculate:
        d["speculate"] = speculate
    return d


def assert_law(cfg, streamed):
    """Streamed = the port's solo run = the reference's solo run."""
    from timewarp_tpu.sweep.spec import RunConfig as RefConfig
    from timewarp_tpu.sweep.spec import solo_result as ref_solo_result
    want = solo_result(cfg, device=CPU)
    assert want == streamed, (
        f"survival law violated for {cfg.run_id}:\n"
        f"  solo:     {want}\n  streamed: {streamed}")
    assert want == ref_solo_result(RefConfig.from_json(cfg.to_json(), 0),
                                   lint="off"), cfg.run_id


def _event_index(scan, **match):
    for i, e in enumerate(scan.events):
        if all(e.get(k) == v for k, v in match.items()):
            return i
    raise AssertionError(f"no event matching {match}")


def _records(root, drop=("wall_s", "compiles", "ts", "seq", "host")):
    return [{k: v for k, v in e.items() if k not in drop}
            for e in SweepJournal(root).records()]


# -- the zero-rebuild admission law ---------------------------------------

def test_zero_rebuild_admission_law(tmp_path):
    journal = SweepJournal(str(tmp_path), host="a")
    done = {}
    c0 = RunConfig.from_json(
        _cfg(0, 0, 48, faults="crash:3:5ms:40ms:reset"), 0)
    runner = OpenBucketRunner("zb0", journal, done, capacity=10,
                              window=resolve_window(c0), chunk=8,
                              device=CPU)
    runner.admit(0, c0)
    assert runner.step() == "running"        # warm-up: the ONE build
    eng = runner.engine
    assert runner.util["engine_builds"] == 1
    cfgs = [c0]
    for i in range(1, 9):                    # 8 sequential admissions
        cfg = RunConfig.from_json(
            _cfg(i, i, 48, link=f"uniform:1000:{4000 + 250 * i}"), 0)
        cfgs.append(cfg)
        runner.admit(i, cfg)
        assert runner.step() == "running"
        assert runner.engine is eng, f"admission {i} rebuilt"
    # new fault VALUES at the realized table shapes: same engine
    cf = RunConfig.from_json(
        _cfg(9, 9, 48, faults="crash:5:7ms:30ms:reset"), 0)
    cfgs.append(cf)
    runner.admit(9, cf)
    assert runner.step() == "running"
    assert runner.engine is eng
    assert runner.util["engine_builds"] == 1
    while runner.step() == "running":
        pass
    u = journal.scan().util["zb0"]
    assert u["engine_builds"] == 1 and u["compiles"] == 0
    for cfg in (cfgs[9], cfgs[8], cfgs[0]):
        assert_law(cfg, done[cfg.run_id])


# -- rebind exactness and pad inertness (engine layer) ---------------------

def _ring16(mod):
    sc = mod.token_ring(16, n_tokens=4, think_us=2_000, bootstrap_us=1_000,
                        end_us=150_000, with_observer=True, mailbox_cap=16)
    return sc, mod.token_ring_links(16)


def _crash_fleet(F, node, t0, t1):
    return F.FaultFleet((F.FaultSchedule((
        F.NodeCrash(node, t0, t1, reset_state=True),)),
        F.FaultSchedule(())))


def test_rebind_identity_exactness():
    """A warm fleet rebound to new seeds and same-shape fault tables =
    a fresh port engine = the reference's fresh fleet."""
    import timewarp_tpu.faults as JF
    import timewarp_tpu.models.token_ring as jr
    from timewarp_tpu.interp.jax_engine.batched import BatchSpec as JSpec
    from timewarp_tpu.interp.jax_engine.engine import EngineState as JState
    from timewarp_tpu.interp.jax_engine.engine import JaxEngine
    from timewarp_tpu.trace.events import assert_states_equal
    import timewarp_tpu_torch.faults as TF
    import timewarp_tpu_torch.models.token_ring as tr
    sc, link = _ring16(tr)
    eng = TorchEngine(sc, link, window="auto", device=CPU,
                      batch=BatchSpec(seeds=(0, 1)),
                      faults=_crash_fleet(TF, 3, 20_000, 60_000))
    eng.run(300)
    assert eng.rebind_identity(BatchSpec(seeds=(2, 3)),
                               faults=_crash_fleet(TF, 5, 25_000, 65_000))
    st2, tr2 = eng.run(300)
    st3, tr3 = TorchEngine(sc, link, window="auto", device=CPU,
                           batch=BatchSpec(seeds=(2, 3)),
                           faults=_crash_fleet(TF, 5, 25_000,
                                               65_000)).run(300)
    jsc, jlink = _ring16(jr)
    jst, jtr = JaxEngine(jsc, jlink, window="auto", insert="xla",
                         batch=JSpec(seeds=(2, 3)),
                         faults=_crash_fleet(JF, 5, 25_000,
                                             65_000)).run(300)
    assert_states_equal(JState(**state_to_numpy(st3)),
                        JState(**state_to_numpy(st2)), "rebound vs fresh")
    assert_states_equal(jst, JState(**state_to_numpy(st2)),
                        "rebound vs the reference")
    for b in range(2):
        assert_traces_equal(tr3[b], tr2[b], "fresh", f"rebound w{b}")
        assert_traces_equal(jtr[b], tr2[b], "reference", f"rebound w{b}")


def test_pad_inertness_operand_tables():
    import timewarp_tpu.faults as JF
    import timewarp_tpu.models.token_ring as jr
    from timewarp_tpu.interp.jax_engine.batched import BatchSpec as JSpec
    from timewarp_tpu.interp.jax_engine.engine import JaxEngine
    sc = token_ring(16, n_tokens=4, think_us=2_000, bootstrap_us=1_000,
                    end_us=150_000, with_observer=True, mailbox_cap=16)
    link = token_ring_links(16)
    sched = FaultSchedule((NodeCrash(3, 20_000, 60_000, reset_state=True),))
    runs = [TorchEngine(sc, link, window="auto", device=CPU,
                        batch=BatchSpec(seeds=(0, 1)),
                        faults=FaultFleet((s, FaultSchedule(())))).run(300)
            for s in (sched, sched.padded(3, 1, 1))]
    (fn, tn), (fw, tw) = runs
    jsc, jlink = _ring16(jr)
    jsched = JF.FaultSchedule((JF.NodeCrash(3, 20_000, 60_000,
                                            reset_state=True),))
    jfw, jtw = JaxEngine(jsc, jlink, window="auto", insert="xla",
                         batch=JSpec(seeds=(0, 1)),
                         faults=JF.FaultFleet((jsched.padded(3, 1, 1),
                                               JF.FaultSchedule(())))
                         ).run(300)
    for b in range(2):
        assert_traces_equal(tn[b], tw[b], "narrow", f"wide w{b}")
        assert_traces_equal(jtw[b], tw[b], "reference wide", f"w{b}")
    assert np.array_equal(fn.fault_dropped.numpy(),
                          fw.fault_dropped.numpy())
    assert np.array_equal(np.asarray(jfw.fault_dropped),
                          fw.fault_dropped.numpy())
    assert fw.restart_done.shape[-1] == 3 > fn.restart_done.shape[-1]


# -- the masked re-run law (speculation) -----------------------------------

def test_masked_rerun_preserves_clean_worlds():
    sc = gossip(48, fanout=3, burst=True, end_us=250_000, mailbox_cap=16,
                think_us=700)
    los = [6_000] * 8
    los[3] = 500                 # the one world that CAN violate
    spec = BatchSpec(seeds=tuple(range(8)), link_params={"lo": los})
    eng = TorchEngine(sc, UniformDelay(6_000, 9_000), window="auto",
                      batch=spec, speculate="fixed:3000", device=CPU)
    assert eng.spec_floor == 500
    st, rows = eng.run_speculative(np.full(8, 1_000), chunk=16)
    rec = eng.last_run_speculation
    assert rec["rollbacks"] >= 1, "no violation was forced"
    assert rec["rerun_worlds"] >= 1
    violators = {b for b, chain in enumerate(eng.last_run_decisions_world)
                 if any(d.obs.get("rolled_back") for d in chain)}
    assert violators == {3}, violators
    canon = canonical_rows(st, rows, B=8)
    for b in range(8):
        solo = TorchEngine(sc, UniformDelay(los[b], 9_000), window="auto",
                           seed=b, device=CPU)
        cfin, ctr = solo.run(1_000)
        assert_spec_equiv([dict(canon[b], world=0)],
                          canonical_rows(cfin, ctr), f"world {b}")


# -- serve: predicted placement -------------------------------------------

def _placements(root, J, F):
    os.makedirs(root)
    front = F(J(root, host="a"), "a", ("127.0.0.1", 1), slots=2,
              pack_mode="predicted")
    return [front.admit(_cfg(0, 0, 96)), front.admit(_cfg(1, 3, 64)),
            front.admit(_cfg(2, 5, 32))]


def test_frontend_predicted_placement_journals_before_admit(tmp_path):
    from timewarp_tpu.serve.frontend import ServeFrontend as RefFront
    from timewarp_tpu.sweep.journal import SweepJournal as RefJournal
    got = _placements(str(tmp_path / "p"), SweepJournal, ServeFrontend)
    assert [b for _, b, _ in got] == ["sb0", "sb0", "sb1"]
    scan = SweepJournal(str(tmp_path / "p")).scan()
    places = [e for e in scan.pack_decisions if e.get("kind") == "place"]
    assert [p["run_id"] for p in places] == ["w0", "w1", "w2"]
    assert [p["bucket"] for p in places] == ["sb0", "sb0", "sb1"]
    assert [p["predicted"] for p in places] == [96, 64, 32]
    assert places[1]["horizon"] == 96
    for p in places:
        assert _event_index(scan, ev="pack_decision",
                            run_id=p["run_id"]) < \
            _event_index(scan, ev="admit", run_id=p["run_id"])
    assert got == _placements(str(tmp_path / "r"), RefJournal, RefFront)
    assert _records(str(tmp_path / "p")) == _records(str(tmp_path / "r"))
    j2 = SweepJournal(str(tmp_path / "ff"), host="a")
    ServeFrontend(j2, "a", ("127.0.0.1", 1), slots=2).admit(_cfg(0, 0, 96))
    assert not SweepJournal(str(tmp_path / "ff")).scan().pack_decisions


def _two_open_buckets(root):
    j = SweepJournal(root, host="a")
    for bid, cfg in (("sb0", RunConfig.from_json(_cfg(0, 0, 96), 0)),
                     ("sb1", RunConfig.from_json(_cfg(1, 3, 8), 0))):
        j.append({"ev": "bucket_open", "bucket": bid,
                  "key": bucket_key_sha(cfg), "capacity": 4,
                  "window": resolve_window(cfg)})
        j.append({"ev": "admit", "run_id": cfg.run_id, "bucket": bid,
                  "slot": 0, "config": cfg.to_json()})
    return j


def test_frontend_predicted_picks_best_horizon_bucket(tmp_path):
    from timewarp_tpu.serve.frontend import ServeFrontend as RefFront
    from timewarp_tpu.sweep.journal import SweepJournal as RefJournal
    ff = ServeFrontend(_two_open_buckets(str(tmp_path / "ff")), "a",
                       ("127.0.0.1", 1), slots=4)
    assert ff.admit(_cfg(2, 5, 8))[1] == "sb0"
    pr = ServeFrontend(_two_open_buckets(str(tmp_path / "pr")), "a",
                       ("127.0.0.1", 1), slots=4, pack_mode="predicted")
    assert pr.admit(_cfg(2, 5, 8))[1] == "sb1"
    scan = SweepJournal(str(tmp_path / "pr")).scan()
    place = [e for e in scan.pack_decisions if e.get("run_id") == "w2"]
    assert len(place) == 1 and place[0]["bucket"] == "sb1"
    assert place[0]["predicted"] == 8 and place[0]["horizon"] == 8
    # the reference's frontend on the port-written journal places the
    # same way (the bucket_open keys are one hash in both packages)
    _two_open_buckets(str(tmp_path / "ref"))
    ref = RefFront(RefJournal(str(tmp_path / "ref"), host="a"), "a",
                   ("127.0.0.1", 1), slots=4, pack_mode="predicted")
    assert ref.admit(_cfg(2, 5, 8))[1] == "sb1"


# -- serve: merge_from edge cases -----------------------------------------

def test_merge_refuses_wider_donor_pad_and_accepts_reverse(tmp_path):
    journal = SweepJournal(str(tmp_path), host="a")
    done = {}
    c_f = RunConfig.from_json(
        _cfg(0, 0, 16, faults="crash:3:5ms:40ms:reset"), 0)
    c_p = RunConfig.from_json(_cfg(1, 3, 96), 0)
    c_n = RunConfig.from_json(_cfg(2, 5, 64), 0)
    w = resolve_window(c_p)
    wide = OpenBucketRunner("sb0", journal, done, capacity=3, window=w,
                            chunk=8, device=CPU)
    wide.admit(0, c_f)
    wide.admit(1, c_p)
    while c_f.run_id not in done:
        assert wide.step() == "running"
    assert wide.min_pad[0] >= 1, "fault pad must stay realized"
    narrow = OpenBucketRunner("sb1", journal, done, capacity=2, window=w,
                              chunk=8, device=CPU)
    narrow.admit(0, c_n)
    assert narrow.step() == "running"   # mid-flight, pad (0,0,0)
    with pytest.raises(ValueError, match="never shrinks"):
        narrow.merge_from(wide)
    assert wide.merge_from(narrow) == ["w2"]
    while wide.step() == "running":
        pass
    for cfg in (c_f, c_p, c_n):
        assert_law(cfg, done[cfg.run_id])


def test_merge_carries_inflight_speculation_chain(tmp_path):
    """The moved world's committed decision chain splices over and keeps
    growing; its result and chain equal the same world run without the
    repack, in the port and in the reference."""
    from timewarp_tpu.serve.worker import OpenBucketRunner as RefRunner
    from timewarp_tpu.sweep.journal import SweepJournal as RefJournal
    from timewarp_tpu.sweep.spec import RunConfig as RefConfig
    c_s = RunConfig.from_json(_cfg(0, 0, 96, speculate="fixed:6000"), 0)
    w = resolve_window(c_s)
    for d in ("ref", "re", "jax"):
        (tmp_path / d).mkdir()
    ref_done = {}
    ref = OpenBucketRunner("sb0", SweepJournal(str(tmp_path / "ref"),
                                               host="a"),
                           ref_done, capacity=2, window=w, chunk=8,
                           device=CPU)
    ref.admit(0, c_s)
    while ref.step() == "running":
        pass
    journal = SweepJournal(str(tmp_path / "re"), host="a")
    done = {}
    r1 = OpenBucketRunner("sb1", journal, done, capacity=2, window=w,
                          chunk=8, device=CPU)
    r1.admit(0, c_s)
    assert r1.step() == "running"
    assert r1.step() == "running"
    pre = [dict(d) for d in r1.spec_chains[0]]
    assert pre, "the chain must be in flight before the repack"
    r0 = OpenBucketRunner("sb0", journal, done, capacity=2, window=w,
                          chunk=8, device=CPU)
    assert r0.merge_from(r1) == ["w0"]
    assert r0.spec_chains[0] == pre
    while r0.step() == "running":
        pass
    assert r0.spec_chains[0][:len(pre)] == pre
    scan = SweepJournal(str(tmp_path / "re")).scan()
    rec = next(e for e in scan.events if e.get("ev") == "world_done"
               and e["result"]["run_id"] == "w0")
    assert rec["spec_chain"] == r0.spec_chains[0]
    assert ref_done["w0"] == done["w0"]
    jdone = {}
    jr = RefRunner("sb0", RefJournal(str(tmp_path / "jax"), host="a"),
                   jdone, capacity=2, window=w, chunk=8)
    jr.admit(0, RefConfig.from_json(c_s.to_json(), 0))
    while jr.step() == "running":
        pass
    assert jdone["w0"] == done["w0"]
    assert jr.spec_chains[0] == ref.spec_chains[0]


def test_serve_repack_straddles_kill_resume(tmp_path):
    root = str(tmp_path)
    ja = SweepJournal(root, host="a")
    c0 = RunConfig.from_json(_cfg(0, 0, 96), 0)
    c1 = RunConfig.from_json(_cfg(1, 3, 96), 0)
    for bid, cfg in (("sb0", c0), ("sb1", c1)):
        ja.append({"ev": "bucket_open", "bucket": bid,
                   "key": bucket_key_sha(cfg), "capacity": 4,
                   "window": resolve_window(cfg)})
        ja.append({"ev": "admit", "run_id": cfg.run_id, "bucket": bid,
                   "slot": 0, "config": cfg.to_json()})
    ja.append({"ev": "serve_drain", "host": "a"})
    with pytest.raises(CuratorKilled):
        ServeCurator(root, "a", chunk=8, lease_ttl_s=60.0, journal=ja,
                     pack_mode="predicted", die_after_chunks=4,
                     device=CPU).run(max_seconds=180)
    ja.close()
    mid = SweepJournal(root).scan()
    assert mid.repacks and mid.repacks[0]["moved"] == ["w1"], \
        "the kill must land AFTER the repack"
    assert len(mid.done) < 2, "the kill must land mid-bucket"
    ServeCurator(root, "a", chunk=8, lease_ttl_s=60.0,
                 device=CPU).run(max_seconds=240)
    scan = SweepJournal(root).scan()
    assert sorted(scan.done) == ["w0", "w1"]
    for cfg in (c0, c1):
        assert_law(cfg, scan.done[cfg.run_id])
    ids = sorted(e["result"]["run_id"] for e in scan.events
                 if e.get("ev") == "world_done")
    assert ids == ["w0", "w1"], "double-run across the kill boundary"
    dec = [e for e in scan.pack_decisions if e.get("kind") == "repack"]
    assert len(dec) == 1 and dec[0]["bucket"] == "sb1" \
        and dec[0]["into"] == "sb0"
    assert dec[0]["predicted_occupancy"] <= 0.5
    assert _event_index(scan, ev="pack_decision", kind="repack") < \
        _event_index(scan, ev="repack")
    assert "sb1" in scan.bucket_done

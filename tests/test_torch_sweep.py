"""The port's fault-tolerant sweep service (``timewarp_tpu_torch/sweep/``)
on the CPU, held to the sweep survival law and against the reference's
service.

The survival law: every world's streamed result record (chained trace
digest, supersteps, virtual time, every never-silent counter) equals the
port's solo run of that config — through shape bucketing, an injected
transient retry, a kill and resume, an OOM split, a watchdog-abandoned
attempt and a stale attempt epoch — and the journal and checkpoints
survive damage as the reference's do (the cases of
``tests/test_zsweep.py``). Against the reference: the same pack through
both services gives equal results record for record and an equal journal
(wall-clock fields and the reference's per-bucket XLA ``compiles`` count
left out: the port compiles nothing per run), equal bucket plans, and the
port's solo result equals the reference's for every world; a bucket
checkpoint the port wrote before a kill loads in the reference's
``load_state`` with its meta.

Tolerance: exact (records, journals and state leaves compared with
``==``).
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from timewarp_tpu_torch.sweep import (SweepConfigError, SweepJournal,
                                      SweepPack, SweepService, plan_buckets,
                                      solo_result)
from timewarp_tpu_torch.sweep.service import SweepKilled, _is_oom

# one intra-op thread per test process: the test session's workers
# share the host's cores (a process of the default width each
# oversubscribes them several times over)
torch.set_num_threads(1)

_RING = {"nodes": 20, "n_tokens": 3, "think_us": 2000, "end_us": 70000,
         "mailbox_cap": 8}
_GOSSIP = {"nodes": 24, "fanout": 3, "burst": True, "end_us": 90000,
           "mailbox_cap": 16, "think_us": 700}

#: tests/test_zsweep.py's PACK
PACK_JSON = [
    {"id": "ring-a", "scenario": "token-ring", "params": _RING,
     "link": "uniform:1000:5000", "seed": 0, "budget": 60},
    {"id": "ring-b", "scenario": "token-ring", "params": _RING,
     "link": "uniform:2000:7000", "seed": 3, "budget": 90},
    {"id": "ring-c", "scenario": "token-ring", "params": _RING,
     "link": "uniform:1000:5000", "seed": 7, "budget": 25,
     "faults": "crash:3:5ms:20ms"},
    {"id": "gos-a", "scenario": "gossip", "params": _GOSSIP,
     "link": "quantize:1000:uniform:3000:9000", "seed": 2,
     "window": "auto", "budget": 100},
]
#: the same pack with its token rings booting at 1 ms: the ring family's
#: default boot (1 s) lies past their ``end_us``, so in PACK those worlds
#: quiesce after one superstep; here they run for 25-90 supersteps over
#: several chunks, which the chaos cases below need
PACK = SweepPack.from_json([
    {**c, "params": {**c["params"], "bootstrap_us": 1000}}
    if c["scenario"] == "token-ring" else c for c in PACK_JSON])
CPU = "cpu"
_SOLO = {}


def solo(run_id, pack=PACK):
    """The port's solo results, cached across the module."""
    key = (pack.sha(), run_id)
    if key not in _SOLO:
        _SOLO[key] = solo_result(pack.by_id(run_id), device=CPU)
    return _SOLO[key]


def assert_survival_law(report):
    assert report.ok, report.to_json()
    for rid, res in report.done.items():
        assert solo(rid) == res, (
            f"sweep survival law violated for {rid}:\n"
            f"  solo:     {solo(rid)}\n  streamed: {res}")


def run_service(tmp_path, name, **kw):
    svc = SweepService(PACK, str(tmp_path / name), chunk=16, device=CPU,
                       **kw)
    return svc, svc.run()


def _events(jd, drop=("wall_s", "compiles")):
    """The journal's records, wall-clock fields dropped."""
    return [{k: v for k, v in e.items() if k not in drop}
            for e in SweepJournal(jd).records()]


# -- the service: survival law under chaos --------------------------------

def test_survival_law_with_injected_transient_retry(tmp_path):
    _, report = run_service(tmp_path, "j1", inject="fail:2")
    assert report.retries == 1
    assert_survival_law(report)
    scan = SweepJournal(str(tmp_path / "j1")).scan()
    done = [e["result"]["run_id"] for e in scan.events
            if e.get("ev") == "world_done"]
    assert sorted(done) == sorted(c.run_id for c in PACK.configs)
    assert scan.retries == 1
    assert all(solo(r)["supersteps"] > 1 for r in done)


def test_kill_mid_bucket_then_resume_exactly(tmp_path):
    jd = str(tmp_path / "j2")
    svc = SweepService(PACK, jd, chunk=16, inject="die:4", device=CPU)
    with pytest.raises(SweepKilled):
        svc.run()
    mid = SweepJournal(jd).scan()
    assert 0 < len(mid.done) < len(PACK.configs), sorted(mid.done)
    report = SweepService.resume(jd, chunk=16, device=CPU).run()
    assert_survival_law(report)
    ids = [e["result"]["run_id"] for e in SweepJournal(jd).scan().events
           if e.get("ev") == "world_done"]
    assert sorted(ids) == sorted(set(ids)), "world double-journaled"
    assert sorted(ids) == sorted(c.run_id for c in PACK.configs)


def test_oom_split_down_to_smaller_buckets(tmp_path):
    _, report = run_service(tmp_path, "j3", inject="oom:2")
    assert report.splits >= 1
    assert_survival_law(report)
    assert SweepJournal(str(tmp_path / "j3")).scan().splits


def test_cuda_out_of_memory_is_an_oom():
    """``torch.cuda.OutOfMemoryError`` (its text: "CUDA out of memory")
    takes the split path, like the reference's RESOURCE_EXHAUSTED."""
    assert _is_oom(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"))
    assert _is_oom(RuntimeError("CUDA error: out of memory"))
    assert not _is_oom(RuntimeError("CUDA error: illegal address"))


def test_terminal_failure_is_loud_not_silent(tmp_path, caplog):
    import logging
    jd = str(tmp_path / "j4")
    svc = SweepService(PACK, jd, chunk=16, max_retries=1, backoff_us=1_000,
                       inject="fail:1;fail:2", device=CPU)
    with caplog.at_level(logging.ERROR, logger="timewarp.sweep"):
        report = svc.run()
    assert not report.ok
    assert set(report.failed) == {"ring-a", "ring-b", "ring-c"}
    assert solo("gos-a") == report.done["gos-a"]
    assert any("TERMINALLY FAILED" in r.message for r in caplog.records)
    assert set(SweepJournal(jd).scan().failed) == set(report.failed)
    report2 = SweepService.resume(jd, chunk=16, device=CPU).run()
    assert set(report2.failed) == set(report.failed) and not report2.ok


def test_digest_verify_rolls_back_a_flip(tmp_path):
    """``verify="digest"``: a bit flip written into a bucket's state
    between chunks is caught at the next chunk's entry, journaled, and
    rolled back to the last verified checkpoint — results unchanged."""
    jd = str(tmp_path / "jv")
    report = SweepService(PACK, jd, chunk=16, verify="digest",
                          inject="flip:7:2", device=CPU).run()
    assert_survival_law(report)
    assert len(SweepJournal(jd).scan().integrity) == 1


def test_watchdog_abandons_wedged_attempt(tmp_path):
    """The per-bucket ``WithTimeout`` watchdog on a stubbed wedged runner:
    the attempt returns at the deadline flagged ``timed_out``, its epoch
    invalidated, without waiting out the wedge."""
    import time
    from types import SimpleNamespace

    from timewarp_tpu_torch.interp.aio.timed import run_real_time
    from timewarp_tpu_torch.manage.jobs import JobCurator

    class Wedged:
        bucket = SimpleNamespace(bucket_id="w0", B=1, configs=(),
                                 run_ids=())
        attempts = epoch = calls = 0
        abandoned = False

        def begin_attempt(self):
            self.epoch += 1
            return self.epoch

        def abandon(self, epoch):
            if self.epoch == epoch:
                self.epoch += 1
                self.abandoned = True

        def prepare(self, epoch=None):
            pass

        def step(self, epoch=None):
            self.calls += 1
            time.sleep(0.6)
            raise RuntimeError("zombie woke up")

    svc = SweepService(PACK, str(tmp_path / "j5"), device=CPU,
                       bucket_timeout_us=120_000, grace_us=30_000)
    wedge, res = Wedged(), {}

    def prog():
        t0 = time.monotonic()
        res["out"] = yield from svc._attempt(JobCurator(), wedge)
        res["elapsed"] = time.monotonic() - t0

    run_real_time(prog)
    out = res["out"]
    assert out.timed_out and not out.ok and out.error is None
    assert wedge.abandoned and wedge.calls == 1
    assert res["elapsed"] < 0.55, res["elapsed"]


def test_stale_attempt_epoch_bars_zombie_writes(tmp_path):
    from timewarp_tpu_torch.sweep.runner import BucketRunner, StaleAttempt
    bucket = plan_buckets(PACK.configs)[0]
    r = BucketRunner(bucket, SweepJournal(str(tmp_path / "jz")), {},
                     chunk=8, device=CPU)
    epoch = r.begin_attempt()
    r.abandon(epoch)
    with pytest.raises(StaleAttempt):
        r.prepare(epoch)
    with pytest.raises(StaleAttempt):
        r.step(epoch)
    assert not os.path.exists(str(tmp_path / "jz" / "journal.jsonl"))
    assert r.begin_attempt() > epoch


# -- journal / checkpoint robustness --------------------------------------

def test_checkpoint_write_is_atomic_and_corrupt_load_actionable(tmp_path):
    from timewarp_tpu_torch.sweep.bucket import build_bucket_engine
    from timewarp_tpu_torch.utils.checkpoint import load_state, save_state
    eng = build_bucket_engine(plan_buckets(PACK.configs)[0], device=CPU)
    path = str(tmp_path / "ck.npz")
    save_state(path, eng.init_state(), meta={"k": 1})
    assert os.listdir(tmp_path) == ["ck.npz"], "temp file leaked"
    assert load_state(path, eng.init_state())[1] == {"k": 1}
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[:len(blob) // 3])
    with pytest.raises(ValueError) as ei:
        load_state(path, eng.init_state())
    msg = str(ei.value)
    assert path in msg and "expected layout" in msg and "leaf_0" in msg
    open(path, "wb").write(b"not a checkpoint at all")
    with pytest.raises(ValueError, match="truncated or corrupt"):
        load_state(path, eng.init_state())
    with pytest.raises(FileNotFoundError):
        load_state(str(tmp_path / "absent.npz"), eng.init_state())


def test_journal_tolerates_torn_tail_rejects_midfile_damage(tmp_path):
    from timewarp_tpu_torch.sweep.journal import SweepJournalError
    j = SweepJournal(str(tmp_path / "jj"))
    j.append({"ev": "pack", "sha": "x", "worlds": 1})
    j.append({"ev": "bucket_start", "bucket": "b0", "attempt": 1})
    j.close()
    with open(j.path, "a") as f:
        f.write('{"ev": "world_done", "result": {"run_id"')
    assert len(j.records()) == 2
    lines = open(j.path).read().splitlines()
    lines[0] = lines[0][:10]
    open(j.path, "w").write("\n".join(lines) + "\n")
    with pytest.raises(SweepJournalError, match="corrupt mid-file"):
        j.records()


def test_journal_refuses_conflicting_double_results(tmp_path):
    from timewarp_tpu_torch.sweep.journal import SweepJournalError
    j = SweepJournal(str(tmp_path / "jj2"))
    j.append({"ev": "world_done", "result": {"run_id": "w0", "d": 1}})
    j.append({"ev": "world_done", "result": {"run_id": "w0", "d": 2}})
    j.close()
    with pytest.raises(SweepJournalError, match="double-journaled"):
        j.scan()


def test_resume_refuses_a_different_pack(tmp_path):
    from timewarp_tpu_torch.sweep.journal import SweepJournalError
    jd = str(tmp_path / "j6")
    run_service(tmp_path, "j6")
    other = SweepPack.from_json([
        {"id": "only", "scenario": "token-ring", "params": _RING,
         "budget": 10}])
    with pytest.raises(SweepJournalError, match="different pack"):
        SweepService(other, jd, device=CPU).run()


def test_run_config_validation_is_loud():
    with pytest.raises(SweepConfigError, match="unknown scenario"):
        SweepPack.from_json([{"id": "x", "scenario": "nope"}])
    with pytest.raises(SweepConfigError, match="takes no param"):
        SweepPack.from_json([{"id": "x", "scenario": "gossip",
                              "params": {"fanouts": 3}}])
    with pytest.raises(SweepConfigError, match="grammar"):
        SweepPack.from_json([{"id": "x", "scenario": "gossip",
                              "link": "bogus:1"}]).configs[0].parse_link()
    with pytest.raises(SweepConfigError, match="inject"):
        SweepService(PACK, "/tmp/never-created", inject="fail", device=CPU)


# -- against the reference -------------------------------------------------

@pytest.fixture(scope="module")
def ref_sweep(tmp_path_factory):
    """The reference's service on the same pack, transient retry included,
    and its solo results."""
    from timewarp_tpu.sweep import SweepPack as RefPack
    from timewarp_tpu.sweep import SweepService as RefService
    from timewarp_tpu.sweep import solo_result as ref_solo
    jd = str(tmp_path_factory.mktemp("ref") / "j")
    pack = RefPack.from_json(PACK_JSON)
    report = RefService(pack, jd, chunk=16, lint="off",
                        inject="fail:2").run()
    solos = {c.run_id: ref_solo(c, lint="off") for c in pack.configs}
    return jd, report, solos


def test_sweep_equals_reference(tmp_path, ref_sweep):
    ref_jd, ref_report, ref_solos = ref_sweep
    jd = str(tmp_path / "jp")
    pack = SweepPack.from_json(PACK_JSON)
    report = SweepService(pack, jd, chunk=16, inject="fail:2",
                          device=CPU).run()
    assert report.to_json() == ref_report.to_json()
    assert report.done == ref_report.done
    assert _events(jd) == _events(ref_jd)
    assert {u["compiles"] for u in SweepJournal(jd).scan().util.values()} \
        == {0}
    for c in pack.configs:
        assert solo(c.run_id, pack) == ref_solos[c.run_id], c.run_id


def test_plan_buckets_equal_reference():
    from timewarp_tpu.sweep import SweepPack as RefPack
    from timewarp_tpu.sweep import plan_buckets as ref_plan
    ref_cfgs = RefPack.from_json(PACK.to_json()).configs
    for kw in ({}, {"max_bucket": 2}, {"max_bucket": 2,
                                       "pack_mode": "predicted"}):
        got = [(b.bucket_id, b.run_ids, b.window, b.fault_pad, b.B)
               for b in plan_buckets(PACK.configs, **kw)]
        want = [(b.bucket_id, b.run_ids, b.window, b.fault_pad, b.B)
                for b in ref_plan(ref_cfgs, **kw)]
        assert got == want, kw


def test_killed_bucket_checkpoint_loads_in_the_reference(tmp_path):
    """A bucket checkpoint the port wrote before a kill — digest chains,
    trails and, under ``verify="digest"``, the verified-epoch chain in
    its meta — loads in the reference's ``load_state`` against the
    reference's bucket engine, leaf for leaf."""
    from timewarp_tpu.sweep import SweepPack as RefPack
    from timewarp_tpu.sweep.bucket import build_bucket_engine as ref_build
    from timewarp_tpu.sweep.bucket import plan_buckets as ref_plan
    import jax

    from timewarp_tpu.utils.checkpoint import load_state as ref_load
    from timewarp_tpu_torch.integrity.digest import state_leaves
    from timewarp_tpu_torch.sweep.bucket import build_bucket_engine
    from timewarp_tpu_torch.utils.checkpoint import load_state
    jd = str(tmp_path / "jk")
    with pytest.raises(SweepKilled):
        SweepService(PACK, jd, chunk=16, verify="digest", inject="die:3",
                     device=CPU).run()
    paths = sorted(glob.glob(os.path.join(jd, "bucket-*.npz")))
    assert paths
    ref_cfgs = RefPack.from_json(PACK.to_json()).configs
    ref_buckets = {b.bucket_id: b for b in ref_plan(ref_cfgs)}
    port_buckets = {b.bucket_id: b for b in plan_buckets(PACK.configs)}
    for path in paths:
        bid = os.path.basename(path)[len("bucket-"):-len(".npz")]
        ref_eng = ref_build(ref_buckets[bid], lint="off")
        rst, rmeta = ref_load(path, ref_eng.init_state())
        eng = build_bucket_engine(port_buckets[bid], device=CPU)
        pst, pmeta = load_state(path, eng.init_state())
        assert rmeta == pmeta
        assert {"digests", "supersteps", "trail", "chunks",
                "state_digests", "verify_chain"} <= set(rmeta)
        ref_leaves = jax.tree.leaves(rst)
        port_leaves = [x for _, x in state_leaves(pst)]
        assert len(ref_leaves) == len(port_leaves)
        for a, b in zip(ref_leaves, port_leaves):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # the journal's results so far are the solo runs' (the law holds at
    # the kill too)
    for rid, res in SweepJournal(jd).scan().done.items():
        assert res == solo(rid)
    assert json.loads(open(os.path.join(jd, "pack.json")).read()) \
        == PACK.to_json()

"""The port's serving layer (``timewarp_tpu_torch/serve/``) on the CPU,
held to the extended survival law and against the reference's results:
the cases of ``tests/test_zzzzzzzzzserve.py`` on the port.

The law: every result the serving layer streams — over the wire or into
the shared journal — equals the port's solo run of its config and the
reference's solo run of the same config, across two-host leases,
work-stealing after a curator kill, mid-bucket admission, re-packing,
kill and resume, and the multi-host sweep (``SweepService(host=...)``);
and lease reclaim never double-runs a bucket (one ``world_done`` per
run_id on the merged journal). Against the reference besides: the same
open bucket driven through both packages journals equal records
(wall-clock fields left out; ``compiles`` is 0 in the port), lease files
written by either package bind the other's hosts, the reference's ledger
ingests a port serve journal to the port ledger's record, the frontend's
refusals read the same, and a serve bucket checkpoint the port wrote
before a kill loads in the reference's ``load_state`` with its meta.

Tolerance: exact (records, journals and state leaves compared with
``==``). Every run has its own time limit (``max_seconds``, thread joins).
"""

import importlib
import json
import os
import socket
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from timewarp_tpu_torch.serve.curator import CuratorKilled, ServeCurator
from timewarp_tpu_torch.serve.frontend import ServeFrontend, bucket_key_sha
from timewarp_tpu_torch.serve.lease import LeaseDir, LeaseLost
from timewarp_tpu_torch.serve.worker import OpenBucketRunner
from timewarp_tpu_torch.sweep.journal import SweepJournal, status_fields
from timewarp_tpu_torch.sweep.spec import (RunConfig, SweepPack,
                                           resolve_window, solo_result)

# one intra-op thread per test process: the test session's workers
# share the host's cores (a process of the default width each
# oversubscribes them several times over)
torch.set_num_threads(1)

CPU = "cpu"
RING = {"nodes": 64, "n_tokens": 4, "think_us": 2000,
        "end_us": 1 << 40, "mailbox_cap": 8}


def _cfg(i, seed, budget, faults=None, link="uniform:1000:5000"):
    d = {"id": f"w{i}", "scenario": "token-ring", "params": RING,
         "link": link, "seed": seed, "budget": budget}
    if faults:
        d["faults"] = faults
    return d


def _open_bucket(journal, cfg0, bid="sb0", capacity=4):
    journal.append({"ev": "bucket_open", "bucket": bid,
                    "key": bucket_key_sha(cfg0), "capacity": capacity,
                    "window": resolve_window(cfg0)})


def _admit(journal, bid, slot, cfg):
    journal.append({"ev": "admit", "run_id": cfg.run_id,
                    "bucket": bid, "slot": slot,
                    "config": cfg.to_json()})


def _world_done_ids(scan):
    return sorted(e["result"]["run_id"] for e in scan.events
                  if e.get("ev") == "world_done")


_SOLO = {}


def _solo_key(cfg):
    return json.dumps(cfg.to_json(), sort_keys=True)


def solo(cfg):
    """The port's solo result, cached across the module."""
    k = _solo_key(cfg)
    if k not in _SOLO:
        _SOLO[k] = solo_result(cfg, device=CPU)
    return _SOLO[k]


_REF_SOLO = {}


def ref_solo(cfg):
    """The reference's solo result of the same config (JAX on the CPU),
    cached across the module."""
    from timewarp_tpu.sweep.spec import RunConfig as RefConfig
    from timewarp_tpu.sweep.spec import solo_result as ref_solo_result
    k = _solo_key(cfg)
    if k not in _REF_SOLO:
        _REF_SOLO[k] = ref_solo_result(
            RefConfig.from_json(cfg.to_json(), 0), lint="off")
    return _REF_SOLO[k]


def assert_law(cfg, streamed):
    """Streamed = the port's solo run = the reference's solo run."""
    want = solo(cfg)
    assert want == streamed, (
        f"serve survival law violated for {cfg.run_id}:\n"
        f"  solo:     {want}\n  streamed: {streamed}")
    assert want == ref_solo(cfg), cfg.run_id


def _records(root, drop=("wall_s", "compiles", "ts", "seq", "host")):
    """The merged journal's records, wall-clock and host stamps left
    out."""
    return [{k: v for k, v in e.items() if k not in drop}
            for e in SweepJournal(root).records()]


# -- the lease protocol ----------------------------------------------------

def _lease_dirs(pair):
    from timewarp_tpu.serve.lease import LeaseDir as RefLeaseDir
    return {"port": LeaseDir, "ref": RefLeaseDir}[pair[0]], \
        {"port": LeaseDir, "ref": RefLeaseDir}[pair[1]]


@pytest.mark.parametrize("pair", [("port", "port"), ("ref", "port"),
                                  ("port", "ref")])
def test_lease_acquire_peer_blocked_release(tmp_path, pair):
    """Two hosts over one lease directory, each host on either package:
    the lease files are one protocol."""
    A, B = _lease_dirs(pair)
    a = A(str(tmp_path), "a", ttl_s=30.0)
    b = B(str(tmp_path), "b", ttl_s=30.0)
    la = a.try_acquire("b0")
    assert la is not None and la.gen == 1 and la.stolen_from is None
    assert b.try_acquire("b0") is None     # fresh peer lease blocks
    a.renew(la)                            # heartbeat keeps it ours
    a.release(la)
    lb = b.try_acquire("b0")
    assert lb is not None and lb.stolen_from is None


def test_lease_stale_reclaim_and_loser_abandons(tmp_path):
    a = LeaseDir(str(tmp_path), "a", ttl_s=0.2)
    b = LeaseDir(str(tmp_path), "b", ttl_s=0.2)
    la = a.try_acquire("b0")
    time.sleep(0.3)                        # a "dies": no renewals
    lb = b.try_acquire("b0")
    assert lb is not None and lb.stolen_from == "a" \
        and lb.gen == la.gen + 1
    with pytest.raises(LeaseLost):
        a.renew(la)
    with pytest.raises(LeaseLost):
        a.check(la)
    a.release(la)                          # refuses silently: not ours
    b.check(lb)                            # the thief's stays valid


def test_lease_self_reacquire_bumps_generation(tmp_path):
    a1 = LeaseDir(str(tmp_path), "a", ttl_s=60.0)
    la1 = a1.try_acquire("b0")
    a2 = LeaseDir(str(tmp_path), "a", ttl_s=60.0)
    la2 = a2.try_acquire("b0")
    assert la2 is not None and la2.gen == la1.gen + 1
    with pytest.raises(LeaseLost):
        a1.check(la1)


# -- the extended survival law --------------------------------------------

def _mid_bucket(root, ns):
    """``test_serve_mid_bucket_admission_survival_law``'s drive, through
    the package ``ns`` (the port's modules or the reference's)."""
    os.makedirs(root)
    journal = ns.SweepJournal(root, host="solo")
    done = {}
    c0 = ns.RunConfig.from_json(_cfg(0, 0, 96), 0)
    c1 = ns.RunConfig.from_json(
        _cfg(1, 7, 64, faults="crash:3:5ms:40ms:reset"), 0)
    runner = ns.OpenBucketRunner("sb0", journal, done, capacity=4,
                                 window=ns.resolve_window(c0), chunk=8,
                                 **ns.kw)
    runner.admit(0, c0)
    assert runner.step() == "running"
    assert runner.step() == "running"      # c0 is mid-flight
    runner.admit(1, c1)                    # late admission, new pad
    while runner.step() == "running":
        pass
    return (c0, c1), done, runner


def _ns(root, **kw):
    """The serving modules of package ``root``; ``kw`` goes to every
    runner (the port's ``device``)."""
    mod = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    spec = mod("sweep.spec")
    return SimpleNamespace(
        SweepJournal=mod("sweep.journal").SweepJournal,
        RunConfig=spec.RunConfig, resolve_window=spec.resolve_window,
        OpenBucketRunner=mod("serve.worker").OpenBucketRunner,
        ServeFrontend=mod("serve.frontend").ServeFrontend,
        ServeRejected=mod("serve.frontend").ServeRejected, kw=kw)


PORT = _ns("timewarp_tpu_torch", device=CPU)
REF = _ns("timewarp_tpu")


def test_serve_mid_bucket_admission_survival_law(tmp_path):
    """An open bucket driven directly: one config, two chunks, then a
    faulted late admission that grows the fault pad — both streamed
    results equal their solo runs in both packages, and the port's
    journal equals the reference's record for record."""
    cfgs, done, runner = _mid_bucket(str(tmp_path / "p"), PORT)
    for cfg in cfgs:
        assert_law(cfg, done[cfg.run_id])
    scan = SweepJournal(str(tmp_path / "p")).scan()
    assert _world_done_ids(scan) == ["w0", "w1"]
    assert runner.util["engine_builds"] == 2     # first build + pad growth
    assert runner.util["compiles"] == 0
    _, ref_done, _ = _mid_bucket(str(tmp_path / "r"), REF)
    assert ref_done == done
    assert _records(str(tmp_path / "p")) == _records(str(tmp_path / "r"))


def test_serve_steal_after_kill_no_double_run(tmp_path):
    root = str(tmp_path)
    ja = SweepJournal(root, host="a")
    c0 = RunConfig.from_json(_cfg(0, 0, 96), 0)
    c1 = RunConfig.from_json(_cfg(1, 3, 48), 0)
    _open_bucket(ja, c0)
    _admit(ja, "sb0", 0, c0)
    _admit(ja, "sb0", 1, c1)
    ja.append({"ev": "serve_drain", "host": "a"})
    cur_a = ServeCurator(root, "a", chunk=8, lease_ttl_s=0.4,
                         journal=ja, die_after_chunks=2, device=CPU)
    with pytest.raises(CuratorKilled):
        cur_a.run(max_seconds=120)
    ja.close()
    time.sleep(0.5)                        # a's lease goes stale
    cur_b = ServeCurator(root, "b", chunk=8, lease_ttl_s=0.4, device=CPU)
    cur_b.run(max_seconds=180)
    scan = SweepJournal(root).scan()
    assert sorted(scan.done) == ["w0", "w1"]
    for cfg in (c0, c1):
        assert_law(cfg, scan.done[cfg.run_id])
    assert _world_done_ids(scan) == ["w0", "w1"]   # no duplicates
    steals = [e for e in scan.events
              if e.get("ev") == "lease_acquire" and e.get("stolen_from")]
    assert steals and steals[0]["host"] == "b" \
        and steals[0]["stolen_from"] == "a"
    hosts = scan.hosts_block()
    assert hosts["b"]["stolen"] == 1
    assert hosts["b"]["stolen_buckets"] == [{"bucket": "sb0", "from": "a"}]


def test_serve_kill_resume_same_host(tmp_path):
    """kill -> resume under one host name; the checkpoint the killed
    incarnation left loads in the reference's ``load_state`` against the
    reference's bucket engine, leaf for leaf, with the same meta."""
    import jax

    from timewarp_tpu.serve.worker import OpenBucketRunner as RefRunner
    from timewarp_tpu.sweep.journal import SweepJournal as RefJournal
    from timewarp_tpu.sweep.spec import RunConfig as RefConfig
    from timewarp_tpu.utils.checkpoint import load_state as ref_load
    from timewarp_tpu_torch.integrity.digest import state_leaves
    from timewarp_tpu_torch.utils.checkpoint import load_state
    root = str(tmp_path)
    ja = SweepJournal(root, host="a")
    c0 = RunConfig.from_json(_cfg(0, 5, 96), 0)
    _open_bucket(ja, c0, capacity=2)
    _admit(ja, "sb0", 0, c0)
    ja.append({"ev": "serve_drain", "host": "a"})
    with pytest.raises(CuratorKilled):
        ServeCurator(root, "a", chunk=8, lease_ttl_s=60.0, journal=ja,
                     die_after_chunks=2, device=CPU).run(max_seconds=120)
    ja.close()
    path = SweepJournal(root).checkpoint_path("sb0")
    assert os.path.exists(path)
    ref = RefRunner("sb0", RefJournal(str(tmp_path / "r"), host="r"), {},
                    capacity=2, window=resolve_window(c0), chunk=8)
    ref.admit(0, RefConfig.from_json(c0.to_json(), 0))
    ref._rebuild()
    rst, rmeta = ref_load(path, ref.engine.init_state(),
                          expect_meta={"bucket": "sb0"})
    port = OpenBucketRunner("sb0", SweepJournal(str(tmp_path / "p"),
                                                host="p"), {},
                            capacity=2, window=resolve_window(c0),
                            chunk=8, device=CPU)
    port.admit(0, c0)
    port._rebuild()
    pst, pmeta = load_state(path, port.engine.init_state(),
                            scenario=port.engine.scenario)
    assert rmeta == pmeta and pmeta["members"] == ["w0", None]
    assert pmeta["chunks"] == 1 and pmeta["supersteps"][0] == 8
    ref_leaves = jax.tree.leaves(rst)
    port_leaves = [x for _, x in state_leaves(pst)]
    assert len(ref_leaves) == len(port_leaves)
    for a, b in zip(ref_leaves, port_leaves):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # own-name leases are always reclaimable: resume without a TTL wait
    ServeCurator(root, "a", chunk=8, lease_ttl_s=60.0,
                 device=CPU).run(max_seconds=180)
    scan = SweepJournal(root).scan()
    assert_law(c0, scan.done["w0"])
    assert _world_done_ids(scan) == ["w0"]


def test_serve_repack_merges_under_occupied(tmp_path):
    root = str(tmp_path)
    journal = SweepJournal(root, host="a")
    done = {}
    c0 = RunConfig.from_json(_cfg(0, 0, 32), 0)
    c1 = RunConfig.from_json(_cfg(1, 9, 96), 0)
    w = resolve_window(c0)
    r0 = OpenBucketRunner("sb0", journal, done, capacity=4, window=w,
                          chunk=8, device=CPU)
    r1 = OpenBucketRunner("sb1", journal, done, capacity=4, window=w,
                          chunk=8, device=CPU)
    r0.admit(0, c0)
    r1.admit(0, c1)
    assert r0.step() == "running"
    assert r1.step() == "running"          # both mid-flight
    while r0.step() == "running":          # sb0's world finishes
        pass
    donor_state = r1.state
    before = {f: x.clone() for f, x in zip(donor_state._fields,
                                            donor_state)
              if not isinstance(x, dict)}
    moved = r0.merge_from(r1)              # the re-packing splice
    assert moved == ["w1"]
    journal.append({"ev": "repack", "from": "sb1", "into": "sb0",
                    "moved": moved, "host": "a"})
    while r0.step() == "running":          # w1 continues inside sb0
        pass
    # the splice copied the donor's slice: the donor's tensors saw
    # neither the merge nor the target's later chunks
    for f, x in before.items():
        assert torch.equal(x, getattr(donor_state, f)), f
    for cfg in (c0, c1):
        assert_law(cfg, done[cfg.run_id])
    scan = SweepJournal(root).scan()
    assert _world_done_ids(scan) == ["w0", "w1"]
    assert scan.repacks and scan.repacks[0]["moved"] == ["w1"]


def test_multi_host_sweep_kill_steal_verify(tmp_path):
    """``SweepService(host=...)``: host a dies to an injected kill while
    holding its lease; host b steals after the TTL and completes — every
    world journaled once, each equal to its solo runs."""
    from timewarp_tpu_torch.sweep.service import SweepKilled, SweepService
    root = str(tmp_path)
    pack = SweepPack.from_json([
        _cfg(0, 0, 96),
        _cfg(1, 1, 64, faults="crash:3:5ms:40ms:reset"),
        _cfg(2, 2, 48, link="uniform:2000:7000"),
    ])
    with pytest.raises(SweepKilled):
        SweepService(pack, root, chunk=16, host="a", lease_ttl_s=0.4,
                     inject="die:2", device=CPU).run()
    time.sleep(0.5)
    svc_b = SweepService(pack, root, chunk=16, host="b", lease_ttl_s=0.4,
                         peer_poll_us=100_000, device=CPU)
    report = svc_b.run()
    assert report.ok, report.to_json()
    scan = SweepJournal(root).scan()
    assert sorted(scan.done) == ["w0", "w1", "w2"]
    for cfg in pack.configs:
        assert_law(cfg, scan.done[cfg.run_id])
    assert _world_done_ids(scan) == ["w0", "w1", "w2"]
    steals = [e for e in scan.events
              if e.get("ev") == "lease_acquire" and e.get("stolen_from")]
    assert steals and steals[0]["host"] == "b" \
        and steals[0]["stolen_from"] == "a"


def _served_journal(root, seed, budget, *, listen=False):
    ja = SweepJournal(root, host="a")
    if listen:
        ja.append({"ev": "serve_open", "host": "a",
                   "listen": "127.0.0.1:7700", "slots": 2})
    c0 = RunConfig.from_json(_cfg(0, seed, budget), 0)
    _open_bucket(ja, c0, capacity=2)
    _admit(ja, "sb0", 0, c0)
    ja.append({"ev": "serve_drain", "host": "a"})
    ServeCurator(root, "a", chunk=8, lease_ttl_s=30.0, journal=ja,
                 device=CPU).run(max_seconds=120)
    return ja, c0


def test_hosts_block_watch_equals_status(tmp_path):
    from timewarp_tpu.obs.watch import SweepWatch as RefWatch
    from timewarp_tpu_torch.obs.watch import SweepWatch
    from timewarp_tpu_torch.sweep.journal import JournalState
    root = str(tmp_path)
    ja, c0 = _served_journal(root, 4, 48)
    ja.append({"ev": "serve_done", "host": "a", "admitted": 1,
               "completed": 1})
    ja.close()
    scan = SweepJournal(root).scan()
    assert_law(c0, scan.done["w0"])
    want = status_fields(scan, len(scan.admits))
    assert "hosts" in want and "serve" in want
    w = SweepWatch(root)
    snap = w.poll()
    got = {k: v for k, v in snap.items() if k != "watch"}
    assert got == want
    assert w.finished
    ref = {k: v for k, v in RefWatch(root).poll().items() if k != "watch"}
    assert ref == want
    plain = JournalState()
    plain.apply({"ev": "pack", "sha": "x", "worlds": 1})
    assert "hosts" not in status_fields(plain, 1)


def test_serve_ledger_ingest_kind(tmp_path):
    from timewarp_tpu.obs.ledger import RunLedger as RefLedger
    from timewarp_tpu_torch.obs.ledger import RunLedger
    root = str(tmp_path / "svc")
    ja, c0 = _served_journal(root, 11, 32, listen=True)
    ja.close()
    led = RunLedger(str(tmp_path / "ledger"))
    rids = led.add_source(root)
    assert len(rids) == 1
    rec = led.get(rids[0])
    assert rec["kind"] == "serve"
    assert rec["serve"]["admitted"] == 1
    assert rec["serve"]["completed"] == 1
    assert rec["serve"]["steals"] == 0
    assert "a" in rec["serve"]["hosts"]
    assert rec["config_key"].startswith("serve|a|")
    ref = RefLedger(str(tmp_path / "ref-ledger"))
    (rid,) = ref.add_source(root)

    def strip(r):
        return {k: v for k, v in r.items() if k not in ("run_id",
                                                        "git_sha")}
    assert strip(ref.get(rid)) == strip(rec)


def test_serve_tcp_roundtrip_streams_bit_identical(tmp_path):
    """The wire path in one process: the port's RPC frontend over
    loopback TCP (``AioBackend``) under the port's ``run_real_time``, an
    embedded curator thread; a client submits two configs, streams both
    ``world_done`` records back and drains."""
    from timewarp_tpu_torch.core.effects import Program, fork_, timeout
    from timewarp_tpu_torch.core.errors import TimeoutExpired
    from timewarp_tpu_torch.interp.aio.timed import run_real_time
    from timewarp_tpu_torch.manage.sync import Flag
    from timewarp_tpu_torch.net.backend import AioBackend
    from timewarp_tpu_torch.net.dialog import Dialog
    from timewarp_tpu_torch.net.rpc import Rpc
    from timewarp_tpu_torch.net.transfer import Transport
    from timewarp_tpu_torch.serve.frontend import (ServeAwait, ServeDrain,
                                                   ServeSubmit)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = str(tmp_path)
    journal = SweepJournal(root, host="alpha")
    front = ServeFrontend(journal, "alpha", ("127.0.0.1", port),
                          slots=2, poll_us=50_000)
    cur = ServeCurator(root, "alpha", chunk=16, lease_ttl_s=30.0,
                       poll_s=0.05, journal=journal, device=CPU)
    worker = threading.Thread(target=cur.run, kwargs={"max_seconds": 120},
                              daemon=True)
    worker.start()
    server = Rpc(Dialog(Transport(AioBackend())))
    client = Rpc(Dialog(Transport(AioBackend())))
    addr = ("127.0.0.1", port)
    configs = [_cfg(0, 0, 64), _cfg(1, 5, 32)]
    results = {}

    def call_retry(req) -> Program:
        for _ in range(40):
            try:
                return (yield from timeout(
                    5_000_000, lambda: client.call(addr, req)))
            except TimeoutExpired:
                continue
        raise AssertionError("service never answered")

    def main() -> Program:
        yield from fork_(lambda: front.program(server, max_seconds=120))
        flags = []
        for d in configs:
            ack = yield from call_retry(
                ServeSubmit(json.dumps(d, sort_keys=True)))
            assert ack.run_id == d["id"]
            flag = Flag()
            flags.append(flag)

            def mk(rid=ack.run_id, flag=flag):
                def prog() -> Program:
                    r = yield from call_retry(ServeAwait(rid))
                    results[rid] = json.loads(r.record_json)
                    yield from flag.set()
                return prog
            yield from fork_(mk())
        for flag in flags:
            yield from flag.wait()
        yield from call_retry(ServeDrain())
        yield from client.dialog.transport.close(addr)

    run_real_time(main)
    worker.join(timeout=60)
    assert not worker.is_alive(), "curator never drained"
    for d in configs:
        assert_law(RunConfig.from_json(d, 0), results[d["id"]]["result"])
    scan = SweepJournal(root).scan()
    assert len([e for e in scan.events
                if e.get("ev") == "admit"]) == len(configs)


def _refusals(ns, root):
    os.makedirs(root)
    journal = ns.SweepJournal(root, host="a")
    front = ns.ServeFrontend(journal, "a", ("127.0.0.1", 1), slots=2)
    msgs = []
    for bad in ({**_cfg(0, 0, 8), "controller": "auto"},
                {k: v for k, v in _cfg(0, 0, 8).items() if k != "id"}):
        with pytest.raises(ns.ServeRejected) as e:
            front.admit(bad)
        msgs.append(str(e.value))
    placed = [front.admit(_cfg(0, 0, 8)), front.admit(_cfg(0, 0, 8))]
    with pytest.raises(ns.ServeRejected) as e:
        front.admit(_cfg(0, 1, 8))
    msgs.append(str(e.value))
    placed.append(front.admit({**_cfg(2, 0, 8), "link": "fixed:2500"}))
    placed.append(front.admit({**_cfg(3, 0, 8), "speculate": "fixed:6000"}))
    return msgs, placed


def test_serve_admission_refusals(tmp_path):
    """Controller configs, id-less configs and a reused run_id with a
    different config are refused; re-submission is idempotent; a second
    key and a speculate config open their own buckets — placements and
    the refusals' wording as the reference's (apart from where a
    controller pack runs), journals equal."""
    msgs, placed = _refusals(PORT, str(tmp_path / "p"))
    assert "controller" in msgs[0]
    assert 'explicit "id"' in msgs[1]
    assert "different config" in msgs[2]
    assert placed == [("w0", "sb0", 0), ("w0", "sb0", 0),
                      ("w2", "sb1", 0), ("w3", "sb2", 0)]
    ref_msgs, ref_placed = _refusals(REF, str(tmp_path / "r"))
    assert placed == ref_placed
    assert msgs[1:] == ref_msgs[1:]
    assert msgs[0].split(";")[0] == ref_msgs[0].split(";")[0]
    assert _records(str(tmp_path / "p")) == _records(str(tmp_path / "r"))
    # the admission pre-flight takes the reference's lint modes
    assert ServeFrontend(SweepJournal(str(tmp_path / "l"), host="a"), "a",
                         ("127.0.0.1", 1), lint="warn").lint == "warn"
    with pytest.raises(ValueError, match="lint"):
        ServeFrontend(SweepJournal(str(tmp_path / "l"), host="a"), "a",
                      ("127.0.0.1", 1), lint="loud")

"""Heterogeneous packs through the port's sweep service and the
reference's, on the CPU.

- ``examples/packs/hetero.json`` (gossip with crash faults, a partitioned
  token ring, Praos on a lognormal link, a speculating gossip world):
  equal results record for record, equal journals (wall-clock fields and
  the reference's XLA ``compiles`` count left out), every result equal
  to the port's solo run (the speculating world's replaying its bucket's
  journaled decisions), and equal ``util_rollup`` packing rollups.
- The ``controller: auto`` form of ``bench.py``
  ``bench_sweep_hetero_auto`` at 64 nodes: equal journaled
  ``dispatch_decision`` records (the observed ``rung_used`` apart: the
  port has no routing ladder) and equal results; each controller
  world's solo twin, replaying its bucket's decision chain, equals its
  streamed record (the replay law carrying the survival law).
- Predictive packing from an artifact the reference's ``save_artifact``
  wrote: ``load_artifact``, ``predict_supersteps`` and
  ``predicted_order`` agree with the reference's, and the ``predicted``
  plan (with its journaled ``pack_decision`` records) equals the
  reference's.

Tolerance: exact (records, journals and plans compared with ``==``).
"""

import os

import pytest

from timewarp_tpu_torch.sweep import SweepPack, SweepService, solo_result
from timewarp_tpu_torch.sweep.journal import SweepJournal, util_rollup

HETERO = os.path.join(os.path.dirname(__file__), "..", "examples", "packs",
                      "hetero.json")
CPU = "cpu"


def _events(jd, drop=("wall_s", "compiles")):
    return [{k: v for k, v in e.items() if k not in drop}
            for e in SweepJournal(jd).records()]


def _both(tmp_path, pack_json, **kw):
    """The pack through the reference's service and the port's: both
    reports and journal dirs."""
    from timewarp_tpu.sweep import SweepPack as RefPack
    from timewarp_tpu.sweep import SweepService as RefService
    ref_jd, jd = str(tmp_path / "ref"), str(tmp_path / "port")
    ref = RefService(RefPack.from_json(pack_json), ref_jd, lint="off",
                     **kw).run()
    port = SweepService(SweepPack.from_json(pack_json), jd, device=CPU,
                        **kw).run()
    return ref, ref_jd, port, jd


def test_hetero_pack_equals_reference(tmp_path):
    import json
    pack_json = json.load(open(HETERO))
    ref, ref_jd, port, jd = _both(tmp_path, pack_json, chunk=16,
                                  inject="fail:2")
    assert port.ok and port.retries == 1
    assert port.to_json() == ref.to_json()
    assert port.done == ref.done
    assert _events(jd) == _events(ref_jd)
    scan, ref_scan = SweepJournal(jd).scan(), SweepJournal(ref_jd).scan()
    assert util_rollup(scan.util) == util_rollup(ref_scan.util)
    svc = SweepService(SweepPack.from_json(pack_json), jd, device=CPU)
    for cfg in svc.pack.configs:
        want = solo_result(cfg, device=CPU,
                           decisions=svc.decisions_for_world(cfg.run_id,
                                                             scan))
        assert want == port.done[cfg.run_id], cfg.run_id
    assert scan.decisions, "the speculating bucket journaled no decisions"


def _auto_pack(n=64, steps=200):
    """``bench.py`` ``bench_sweep_hetero_auto``'s pack at ``n`` nodes."""
    ring = {"nodes": n, "n_tokens": max(4, n // 64), "think_us": 2000,
            "end_us": 1 << 40, "mailbox_cap": 8}
    gossip = {"nodes": n, "fanout": 4, "burst": True,
              "end_us": 400_000, "mailbox_cap": 16, "think_us": 700}
    return [
        {"id": "ring-s0", "scenario": "token-ring", "params": ring,
         "link": "uniform:1000:5000", "seed": 0, "budget": steps},
        {"id": "gos-a0", "scenario": "gossip", "params": gossip,
         "link": "quantize:1000:uniform:3000:9000", "seed": 3,
         "window": "auto", "budget": steps, "controller": "auto"},
        {"id": "gos-a1", "scenario": "gossip", "params": gossip,
         "link": "quantize:1000:uniform:3000:9000", "seed": 4,
         "window": "auto", "budget": max(steps // 2, 8),
         "controller": "auto"},
        {"id": "gos-a2", "scenario": "gossip", "params": gossip,
         "link": "quantize:1000:uniform:4000:8000", "seed": 5,
         "window": "auto", "budget": steps, "controller": "auto"},
    ]


def _no_rung(decisions):
    """Decision records with the observed ``rung_used`` left out: the
    telemetry ``rung`` column is the compacted batch's static sender width
    on the port, which has no routing ladder (the planes' one stated
    difference); every knob and every other observation is compared."""
    return {b: [{**d, "obs": {k: v for k, v in d["obs"].items()
                              if k != "rung_used"}} for d in ds]
            for b, ds in decisions.items()}


def test_controller_auto_pack_equals_reference(tmp_path):
    steps = 200
    ref, ref_jd, port, jd = _both(tmp_path, _auto_pack(steps=steps),
                                  chunk=max(16, steps // 16),
                                  inject="fail:2")
    assert port.ok and port.retries >= 1
    assert port.done == ref.done
    scan, ref_scan = SweepJournal(jd).scan(), SweepJournal(ref_jd).scan()
    assert _no_rung(scan.decisions) == _no_rung(ref_scan.decisions)
    assert sum(len(v) for v in scan.decisions.values()) > 0
    svc = SweepService(SweepPack.from_json(_auto_pack(steps=steps)), jd,
                       device=CPU)
    for rid, res in port.done.items():
        cfg = svc.pack.by_id(rid)
        dec = svc.decisions_for_world(rid, scan)
        assert (dec is not None) == (cfg.controller == "auto")
        assert solo_result(cfg, device=CPU, decisions=dec) == res, rid


@pytest.fixture
def artifact(tmp_path):
    """A predictor artifact fitted and written by the reference."""
    from timewarp_tpu.pack.predict import fit_rows, save_artifact
    from timewarp_tpu.pack.predict import training_rows
    from timewarp_tpu.sweep import SweepPack as RefPack
    pack = RefPack.from_json(_auto_pack(steps=400))
    done = {c.run_id: {"supersteps": s} for c, s in
            zip(pack.configs, (400, 60, 40, 90))}
    path = str(tmp_path / "predictor.json")
    save_artifact(fit_rows(training_rows(pack.configs, done)), path)
    return path


def test_predictor_artifact_from_the_reference(tmp_path, artifact):
    from timewarp_tpu.pack.allocate import predicted_order as ref_order
    from timewarp_tpu.pack.predict import load_artifact as ref_load
    from timewarp_tpu.pack.predict import predict_supersteps as ref_predict
    from timewarp_tpu.sweep import SweepPack as RefPack
    from timewarp_tpu.sweep.bucket import plan_buckets as ref_plan
    from timewarp_tpu_torch.pack import (load_artifact, predict_supersteps,
                                         predicted_order)
    from timewarp_tpu_torch.sweep import plan_buckets
    art, ref_art = load_artifact(artifact), ref_load(artifact)
    assert art == ref_art
    pack_json = [{**c, "budget": 300} for c in _auto_pack(steps=300)]
    cfgs = SweepPack.from_json(pack_json).configs
    ref_cfgs = RefPack.from_json(pack_json).configs
    got = [predict_supersteps(c, art) for c in cfgs]
    assert got == [ref_predict(c, ref_art) for c in ref_cfgs]
    assert len(set(got)) > 1, "the artifact must discriminate"

    def predict(c):
        return predict_supersteps(c, art)
    assert [c.run_id for c in predicted_order(cfgs, predict)] == \
        [c.run_id for c in ref_order(ref_cfgs,
                                     lambda c: ref_predict(c, ref_art))]
    plan = [(b.bucket_id, b.run_ids, b.window)
            for b in plan_buckets(cfgs, 2, pack_mode="predicted",
                                  predict=predict)]
    assert plan == [(b.bucket_id, b.run_ids, b.window)
                    for b in ref_plan(ref_cfgs, 2, pack_mode="predicted",
                                      predict=lambda c: ref_predict(
                                          c, ref_art))]
    # the service journals that plan, one pack_decision a bucket, before
    # any bucket starts
    jd = str(tmp_path / "jp")
    report = SweepService(SweepPack.from_json(pack_json), jd, max_bucket=2,
                          pack_mode="predicted", pack_artifact=artifact,
                          device=CPU).run()
    assert report.ok
    decs = SweepJournal(jd).scan().pack_decisions
    assert [(d["bucket"], tuple(d["members"])) for d in decs] == \
        [p[:2] for p in plan]
    assert {d["artifact_sha"] for d in decs} == {art["sha"]}

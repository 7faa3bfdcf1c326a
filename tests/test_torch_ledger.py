"""The port's cross-run plane (``timewarp_tpu_torch/obs/ledger.py``,
``regress.py`` and ``watch.py``, and ``pack.predict.fit_from_ledger``
over them) on the CPU, held against the reference's on the same inputs.

The journals are the port's: a small pack through the port's
``SweepService`` (predicted packing, a transient retry, telemetry
counters streaming ``metrics.jsonl``) and a small chaos-search campaign.
Each source goes through both ``RunLedger``s, and the records must be
equal, run id and git sha aside; so must a BENCH_SCHEMA=2 bench line's
and a metrics stream's. ``compare_runs``, ``compare_selections`` and
``detect_target_anomalies`` give the reference's findings on the same
ledgers and journals; the ``SweepWatch`` snapshot equals the
reference's on the same journal (its wall-clock rate and elapsed time
aside) and equals ``status_fields``, whose ``events`` block holds
``pack_decision`` as the reference's ``status_fields`` builds it; and
``fit_from_ledger`` equals the reference's, coefficient for coefficient,
and ``fit_rows`` over the same ``training_rows``.

Tolerance: exact (records, reports and coefficients compared with
``==``).
"""

import json
import os

import pytest

from timewarp_tpu.obs import ledger as RL
from timewarp_tpu.obs import regress as RG
from timewarp_tpu.obs import watch as RW
from timewarp_tpu.pack import predict as RP
from timewarp_tpu_torch.obs import ledger as PL
from timewarp_tpu_torch.obs import regress as PG
from timewarp_tpu_torch.obs import watch as PW
from timewarp_tpu_torch.pack import predict as PP
import torch

# one intra-op thread per test process: the test session's workers
# share the host's cores (a process of the default width each
# oversubscribes them several times over)
torch.set_num_threads(1)

CPU = "cpu"
_RING = {"nodes": 20, "n_tokens": 3, "think_us": 2000, "end_us": 70000,
         "bootstrap_us": 1000, "mailbox_cap": 8}
PACK = [
    {"id": "ring-a", "scenario": "token-ring", "params": _RING,
     "link": "uniform:1000:5000", "seed": 0, "budget": 60},
    {"id": "ring-b", "scenario": "token-ring", "params": _RING,
     "link": "uniform:2000:7000", "seed": 3, "budget": 90},
    {"id": "gos-a", "scenario": "gossip",
     "params": {"nodes": 24, "fanout": 3, "burst": True, "end_us": 90000,
                "mailbox_cap": 16, "think_us": 700},
     "link": "quantize:1000:uniform:3000:9000", "seed": 2,
     "window": "auto", "budget": 100, "faults": "crash:3:5ms:20ms"},
]
_SOURCES = {}


def _sweep_dir(tmp_path_factory):
    """The pack through the port's service on the CPU, cached for the
    module: ``pack_mode="predicted"`` with ``max_bucket=1`` (one
    ``pack_decision`` a bucket), ``inject="fail:1"`` (a retry) and
    ``telemetry="counters"`` (``metrics.jsonl`` beside the journal)."""
    if "sweep" not in _SOURCES:
        from timewarp_tpu_torch.sweep import SweepPack, SweepService
        d = str(tmp_path_factory.mktemp("sweep") / "j")
        rep = SweepService(SweepPack.from_json(PACK), d, chunk=16,
                           max_bucket=1, pack_mode="predicted",
                           inject="fail:1", telemetry="counters",
                           device=CPU).run()
        assert rep.ok and rep.retries == 1
        _SOURCES["sweep"] = d
    return _SOURCES["sweep"]


def _search_dir(tmp_path_factory):
    """A small campaign through the port on the CPU (the reference
    test's near-violation seed schedule, two generations, one fork
    world), cached for the module."""
    if "search" not in _SOURCES:
        from timewarp_tpu_torch.search import ChaosSearch
        from timewarp_tpu_torch.sweep.spec import RunConfig
        params = {"nodes": 8, "fanout": 2, "end_us": 30_000,
                  "burst": True, "think_us": 5000, "mailbox_cap": 16}
        base = RunConfig(run_id="search-base", family="gossip",
                         params=tuple(sorted(params.items())),
                         link="uniform:1000:5000", window="auto",
                         budget=120, faults="crash:0:0:20000")
        d = str(tmp_path_factory.mktemp("search") / "j")
        ChaosSearch(base=base, objective="eventually-delivered",
                    population=4, generations=2, seed=0, fork_k=1,
                    minimize_trials=8, journal_dir=d, device=CPU).run()
        _SOURCES["search"] = d
    return _SOURCES["search"]


def _both_ledgers(tmp_path):
    return (PL.RunLedger(str(tmp_path / "port-led")),
            RL.RunLedger(str(tmp_path / "ref-led")))


def _rec(led, rid):
    return {k: v for k, v in led.get(rid).items()
            if k not in ("run_id", "git_sha")}


def _index(led):
    return [{k: v for k, v in r.items() if k not in ("run_id", "git_sha")}
            for r in led.index()]


def _line(value=100.0, *, config="gossip_100k", n=2048, **over):
    """A BENCH_SCHEMA=2 line (``tests/test_zzzzzzzledger.py``'s)."""
    out = {"schema": 2, "config": config,
           "config_key": f"{config}|n{n}|s16384|cpu",
           "metric": f"gossip wave @{n} nodes", "value": value,
           "unit": "msg/s", "platform": "cpu", "device_kind": "cpu",
           "jax_version": "0.9", "git_sha": "cafe0123"}
    out.update(over)
    return out


def test_sweep_and_metrics_ingest_equal_reference(tmp_path,
                                                  tmp_path_factory):
    d = _sweep_dir(tmp_path_factory)
    port, ref = _both_ledgers(tmp_path)
    (pid,) = port.add_source(d)
    (rid,) = ref.add_source(d)
    rec = _rec(port, pid)
    assert rec == _rec(ref, rid)
    assert rec["kind"] == "sweep" and rec["config_key"].startswith("sweep|")
    assert rec["sweep"]["completed"] == 3 and rec["sweep"]["retries"] == 1
    assert rec["sweep"]["events"] == {"dispatch_decision": 0,
                                      "spec_rollback": 0,
                                      "integrity_violation": 0,
                                      "pack_decision": 3}
    assert len(rec["sweep"]["pack_stats"]) == 3
    m = os.path.join(d, "metrics.jsonl")
    assert _rec(port, port.add_metrics(m)) == _rec(ref, ref.add_metrics(m))
    assert _index(port) == _index(ref)
    with pytest.raises(PL.LedgerError, match="no sweep journal"):
        port.add_sweep(str(tmp_path / "empty"))


def test_search_ingest_equals_reference(tmp_path, tmp_path_factory):
    d = _search_dir(tmp_path_factory)
    port, ref = _both_ledgers(tmp_path)
    (pid,) = port.add_source(d)
    (rid,) = ref.add_source(d)
    rec = _rec(port, pid)
    assert rec == _rec(ref, rid)
    assert rec["kind"] == "search"
    assert rec["config_key"] == "search|gossip|eventually-delivered-0|s0"
    assert rec["search"]["generations_planned"] == 2
    msgs = []
    for led, err in ((port, PL.LedgerError), (ref, RL.LedgerError)):
        with pytest.raises(err, match="no search_campaign") as e:
            led.add_search(_sweep_dir(tmp_path_factory))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_bench_lines_and_compare_equal_reference(tmp_path):
    port, ref = _both_ledgers(tmp_path)
    smoke = {"schema": 2, "config": "praos_1m",
             "config_key": "praos_1m|n2048|s24|cpu",
             "metric": "praos @2048", "smoke": True, "ok": True,
             "seconds": 8.0, "platform": "cpu", "git_sha": "aaa111"}
    reports = []
    for led, R in ((port, PG), (ref, RG)):
        assert led.add_bench_line(_line(), batch="b0001",
                                  source="test") == "r0001"
        led.add_bench_line(smoke, batch="b0001")
        led.add_bench_line(_line(60.0, min=57.0, max=63.0, reps=3),
                           batch="b0002")
        led.add_bench_line(dict(smoke, seconds=16.0, git_sha="bbb222"),
                           batch="b0002")
        assert led.new_batch() == "b0003"
        rep = R.compare_selections(led, "b0001", "b0002")
        reports.append((rep.to_json(), rep.lines(),
                        [d.line() for d in rep.regressions]))
        # the un-doctored direction and a run_id/config_key selector
        reports.append(R.compare_selections(led, "b0001",
                                            "b0001").to_json())
        reports.append(R.compare_selections(led, "r0001",
                                            "gossip_100k").to_json())
        reports.append(R.compare_runs(
            [{"kind": "bench", "run_id": "r1", "config_key": "k",
              "seconds": 0.0, "git_sha": "g"}],
            [{"kind": "bench", "run_id": "r2", "config_key": "k",
              "seconds": 10.0, "git_sha": "g"}]).to_json())
    assert _index(port) == _index(ref)
    assert _rec(port, "r0001") == _rec(ref, "r0001")
    assert reports[:4] == reports[4:]
    doctored, _, regressions = reports[0]
    assert not doctored["ok"] and len(regressions) == 2
    assert any(ln.startswith("REGRESSION praos_1m|n2048|s24|cpu seconds: "
                             "8 -> 16 (+100.0%") for ln in regressions)
    assert PL.derive_config_key({"metric": "x @4 nodes", "value": 1.0}) \
        == RL.derive_config_key({"metric": "x @4 nodes", "value": 1.0})
    for led, err in ((port, PL.LedgerError), (ref, RL.LedgerError)):
        with pytest.raises(err, match="not a bench line"):
            led.add_bench_line({"value": 3.0})


def test_anomalies_equal_reference(tmp_path, tmp_path_factory):
    d = _sweep_dir(tmp_path_factory)
    got = [a.to_json() for a in PG.detect_target_anomalies(d)]
    assert got == [a.to_json() for a in RG.detect_target_anomalies(d)]
    # a metrics stream with a rollback storm and rung thrash (the
    # reference test's rows)
    p = tmp_path / "m.jsonl"
    rows = [{"schema": 5, "kind": "speculation", "label": "x",
             "chunk": i, "window_us": 16000, "outcome": "rollback"}
            for i in range(5)]
    rows += [{"schema": 2, "kind": "decision", "chunk": i,
              "window_us": 500, "rung_pin": i % 2, "chunk_len": 8}
             for i in range(10)]
    p.write_text("".join(json.dumps(r) + "\n" for r in rows))
    got = [a.to_json() for a in PG.detect_target_anomalies(str(p))]
    assert {a["kind"] for a in got} == {"rollback-storm", "rung-thrash"}
    assert got == [a.to_json() for a in RG.detect_target_anomalies(str(p))]
    msgs = []
    for R, err in ((PG, PL.LedgerError), (RG, RL.LedgerError)):
        with pytest.raises(err, match="no sweep journal") as e:
            R.detect_target_anomalies(str(tmp_path))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_watch_snapshot_equals_reference_and_status(tmp_path_factory):
    from timewarp_tpu_torch.sweep.journal import SweepJournal, status_fields
    d = _sweep_dir(tmp_path_factory)
    port, ref = PW.SweepWatch(d).poll(), RW.SweepWatch(d).poll()
    for snap in (port, ref):
        for k in ("elapsed_s", "worlds_done_per_s"):
            snap["watch"].pop(k)
    assert port == ref
    assert port["watch"]["finished"] and port["watch"]["parse_errors"] == 0
    assert port["watch"]["metrics_supersteps"] > 0
    status = status_fields(SweepJournal(d).scan(), len(PACK))
    assert {k: v for k, v in port.items() if k != "watch"} == status
    # the events block as status_fields builds it, pack_decision included
    assert status["events"] == {"dispatch_decision": 0, "spec_rollback": 0,
                                "integrity_violation": 0,
                                "pack_decision": 3}
    line = PW.SweepWatch(d)
    text = line.render(line.poll())
    assert text.startswith("sweep DONE | worlds 3/3 done")
    assert "\x1b" not in text and "\n" not in text


def test_tail_reader_equals_reference(tmp_path):
    p = str(tmp_path / "t.jsonl")
    readers = [PW.TailReader(p), RW.TailReader(p)]
    out = [[r.poll() for r in readers]]
    for chunk in ('{"a": 1}\n{"b": 2', '2}\n', 'not json\n{"c": 3}\n'):
        with open(p, "a") as f:
            f.write(chunk)
        out.append([r.poll() for r in readers])
        out.append([r.poll() for r in readers])
    assert all(a == b for a, b in out)
    assert [a for a, _ in out] == [[], [{"a": 1}], [], [{"b": 22}], [],
                                   [{"c": 3}], []]
    assert readers[0].parse_errors == readers[1].parse_errors == 1


def test_fit_from_ledger_equals_reference(tmp_path, tmp_path_factory):
    from timewarp_tpu_torch.sweep import SweepJournal, SweepPack
    d = _sweep_dir(tmp_path_factory)
    port, ref = _both_ledgers(tmp_path)
    port.add_source(d)
    ref.add_source(d)
    port.add_source(_search_dir(tmp_path_factory))
    art = PP.fit_from_ledger(port.root)
    assert art == RP.fit_from_ledger(ref.root)
    assert art["rows"] == 3 and art["sha"]
    rows = PP.training_rows(SweepPack.from_json(PACK).configs,
                            SweepJournal(d).scan().done)
    assert art == PP.fit_rows(rows)
    # the refusals, word for word
    empty = tmp_path / "empty-led"
    PL.RunLedger(str(empty)).add_bench_line(_line())
    for root, match in ((str(tmp_path / "nope"), "not a run ledger"),
                        (str(empty), "no pack_stats rows")):
        msgs = []
        for P in (PP, RP):
            with pytest.raises(P.PackFitError, match=match) as e:
                P.fit_from_ledger(root)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]

"""The port's service subcommands — ``sweep``, ``search``, ``serve`` /
``submit``, ``pack`` and ``ledger`` (``timewarp_tpu_torch/sweep/cli.py``,
``search/cli.py``, ``serve/cli.py``, ``pack/cli.py``, ``obs/ledger.py``
through ``timewarp_tpu_torch.cli.main``) — held against the reference's
on the same argv.

The port side runs with ``--device cpu``. Covered: ``sweep status`` of
``tests/test_zsweep.py`` (its pack through both CLIs: equal status
lines), the sweep CLI cases of ``test_zztelemetry.py`` and
``test_zzzzzflight.py`` (the recorded sweep's output, events log and
status; ``--verify`` auto-bisecting an injected flip to the reference's
chunk and digests; the flip refused without a verify), the CLI cases of
``test_zzzzzzzledger.py`` (``ledger import`` of the BENCH history,
``ledger compare`` exit codes, ``ledger anomalies`` refusing a bench
line, ``sweep watch --once`` = ``sweep status`` — its ``events`` block
asserted as ``status_fields`` builds it, ``pack_decision`` included), a
kill and ``sweep resume``, ``--hosts``, ``--pack predicted
--pack-artifact`` from ``pack fit`` over the port's ledger, ``search
run`` / ``search repro`` (equal result lines and ``repro.json``), and
``serve`` + ``submit --verify`` over loopback TCP.

Tolerance: exact, leaving out wall-clock keys (``wall_s``, ``ts``) and
the port's added ``device`` key.
"""

import json
import os
import socket
import threading
import time

import pytest
import torch

from timewarp_tpu.cli import main as ref_main
from timewarp_tpu_torch.cli import main
from timewarp_tpu_torch.obs.flight import load_flight_jsonl
from timewarp_tpu_torch.sweep.journal import SweepJournal

# one intra-op thread per test process: the test session's workers
# share the host's cores
torch.set_num_threads(1)

CPU = ["--device", "cpu"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOLATILE = {"wall_s", "wall_seconds", "ts", "elapsed_s",
            "worlds_done_per_s", "compiles"}
RING = {"nodes": 16, "n_tokens": 2, "think_us": 2000, "bootstrap_us": 1000,
        "end_us": 60_000, "mailbox_cap": 8}


def _strip(x, drop=()):
    if isinstance(x, dict):
        return {k: _strip(v, drop) for k, v in x.items()
                if k not in VOLATILE and k not in drop}
    if isinstance(x, list):
        return [_strip(v, drop) for v in x]
    return x


def _out(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]


def _pack(tmp_path, worlds, name="pack.json"):
    path = tmp_path / name
    path.write_text(json.dumps(worlds))
    return str(path)


def _ring(i, seed, budget, **kw):
    return {"id": f"w{i}", "scenario": "token-ring", "params": RING,
            "link": "uniform:1000:5000", "seed": seed, "budget": budget,
            **kw}


def both(capsys, tmp_path, argv, journal_flag="--journal"):
    """``argv`` (``{jd}`` names the journal dir) through both CLIs, each
    on its own journal: ``(rc, lines, journal dir)`` per side."""
    got = {}
    for side, fn, extra in (("ref", ref_main, []), ("port", main, CPU)):
        jd = str(tmp_path / side)
        rc = fn([a.replace("{jd}", jd) for a in argv] + extra)
        got[side] = rc, _out(capsys), jd
    return got["port"], got["ref"]


# -- sweep -------------------------------------------------------------------

def test_sweep_status_cli_line(tmp_path, capsys):
    """test_zsweep's pack (two shape buckets, a faulted world) through
    ``sweep run`` and ``sweep status`` on both CLIs: equal lines."""
    from test_zsweep import PACK
    pack = _pack(tmp_path, [c.to_json() for c in PACK.configs])
    (rc, out, pjd), (rrc, rout, rjd) = both(
        capsys, tmp_path, ["sweep", "run", pack, "--journal", "{jd}",
                           "--chunk", "16", "--lint", "off"])
    assert rc == rrc == 0 and _strip(out) == _strip(rout)
    assert main(["sweep", "status", "--journal", pjd]) == 0
    status = _out(capsys)[-1]
    assert ref_main(["sweep", "status", "--journal", rjd]) == 0
    assert _strip(status) == _strip(_out(capsys)[-1])
    assert status["worlds"] == status["completed"] == len(PACK.configs)
    assert status["pending"] == 0 and status["failed"] == []


def test_sweep_record_streams_and_status(tmp_path, capsys):
    """test_zzzzzflight's recorded sweep with ``--verify``: the output
    line, the events log and ``sweep status`` equal the reference's."""
    from timewarp_tpu_torch.obs.metrics import validate_metrics_file
    pack = _pack(tmp_path, [_ring(0, 0, 24), _ring(1, 1, 24)])
    (rc, out, jd), (rrc, rout, rjd) = both(
        capsys, tmp_path, ["sweep", "run", pack, "--journal", "{jd}",
                           "--chunk", "8", "--lint", "off", "--record",
                           "full", "--verify"])
    assert rc == rrc == 0
    out, rout = out[-1], rout[-1]
    assert out["ok"] and out["flight_events"] > 0
    assert _strip(out, ("events",)) == _strip(rout, ("events",))
    ev = f"{jd}/events.jsonl"
    assert out["events"] == ev
    assert validate_metrics_file(ev) == out["flight_events"]
    assert [json.loads(x) for x in open(ev)] == \
        [json.loads(x) for x in open(f"{rjd}/events.jsonl")]
    assert len(load_flight_jsonl(ev, run_id="w0")) > 0
    with pytest.raises(ValueError, match="2 runs"):
        load_flight_jsonl(ev)
    assert main(["sweep", "status", "--journal", jd]) == 0
    status = _out(capsys)[-1]
    assert set(status["flight_events"]) == {"w0", "w1"}
    assert sum(status["flight_events"].values()) == out["flight_events"]
    assert ref_main(["sweep", "status", "--journal", rjd]) == 0
    assert _strip(status) == _strip(_out(capsys)[-1])


def test_sweep_verify_auto_bisects_injected_flip(tmp_path, capsys):
    pack = _pack(tmp_path, [_ring(0, 0, 24)])
    (rc, out, _), (rrc, rout, _) = both(
        capsys, tmp_path, ["sweep", "run", pack, "--journal", "{jd}",
                           "--chunk", "8", "--lint", "off", "--verify",
                           "--inject", "flip:2:2:time"])
    assert rc == rrc == 1
    (mm,) = out[-1]["verify_mismatches"]
    d1 = mm["first_divergence"]
    assert d1 is not None and d1["chunk"] == 1
    assert d1["supersteps"] == [8, 16] and d1["streamed"] != d1["solo"]
    assert _strip(out) == _strip(rout)


def test_sweep_flip_without_any_verify_is_refused(tmp_path):
    pack = _pack(tmp_path, [_ring(0, 0, 24)])
    with pytest.raises(SystemExit, match="auto-bisects"):
        main(["sweep", "run", pack, "--journal", str(tmp_path / "j"),
              "--chunk", "8", "--lint", "off", "--inject", "flip:2:2",
              *CPU])


def test_sweep_kill_resume_hosts_and_speculate(tmp_path, capsys):
    """``--inject die:2`` kills the sweep (exit 1, the kill line), ``sweep
    resume`` finishes it; under ``--hosts`` and ``--speculate fixed:W``
    (the pack-level default, replayed by ``--verify``): the final lines
    and the world results equal the reference's."""
    pack = _pack(tmp_path, [_ring(0, 0, 40), _ring(1, 3, 40)])
    run = ["sweep", "run", pack, "--journal", "{jd}", "--chunk", "8",
           "--lint", "off", "--hosts", "a", "--inject", "die:2",
           "--speculate", "fixed:2000"]
    (rc, out, jd), (rrc, rout, rjd) = both(capsys, tmp_path, run)
    assert rc == rrc == 1 and out[-1]["sweep"] == "killed"
    assert out == rout
    resume = ["sweep", "resume", "--journal", "{jd}", "--chunk", "8",
              "--lint", "off", "--hosts", "a", "--verify"]
    assert main([a.replace("{jd}", jd) for a in resume] + CPU) == 0
    out = _out(capsys)[-1]
    assert ref_main([a.replace("{jd}", rjd) for a in resume]) == 0
    assert _strip(out) == _strip(_out(capsys)[-1])
    assert out["verified"] == 2
    done = {e["result"]["run_id"]: e["result"]
            for e in SweepJournal(jd).scan().events
            if e.get("ev") == "world_done"}
    assert done == {e["result"]["run_id"]: e["result"]
                    for e in SweepJournal(rjd).scan().events
                    if e.get("ev") == "world_done"}


def test_sweep_status_surfaces_utilization(tmp_path, capsys):
    pack = _pack(tmp_path, [_ring(0, 0, 24)])
    d = str(tmp_path / "j")
    assert main(["sweep", "run", pack, "--journal", d, "--chunk", "8",
                 "--lint", "off", "--telemetry", "counters", *CPU]) == 0
    assert _out(capsys)[-1]["ok"]
    assert main(["sweep", "status", "--journal", d]) == 0
    status = _out(capsys)[-1]
    assert status["worlds"] == 1 and status["utilization"]


def test_sweep_watch_cli_once_and_status_events_block(tmp_path, capsys):
    """test_zzzzzzzledger's watch case on the port: ``watch --once
    --json`` = ``status``, the ``events`` block as ``status_fields``
    builds it (``pack_decision`` included — the reference's test lists
    the block without it)."""
    pack = _pack(tmp_path, [{**_ring(0, 0, 60), "id": "ring-a", "params": {
        "nodes": 20, "n_tokens": 3, "think_us": 2000, "end_us": 70000,
        "mailbox_cap": 8}}])
    d = str(tmp_path / "j")
    assert main(["sweep", "run", pack, "--journal", d, "--chunk", "16",
                 "--lint", "off", *CPU]) == 0
    capsys.readouterr()
    assert main(["sweep", "status", "--journal", d]) == 0
    status = json.loads(capsys.readouterr().out)
    assert status["events"] == {"dispatch_decision": 0, "spec_rollback": 0,
                                "integrity_violation": 0,
                                "pack_decision": 0}
    assert main(["sweep", "watch", "--journal", d, "--once", "--json"]) == 0
    snap = json.loads(capsys.readouterr().out)
    assert {k: v for k, v in snap.items() if k != "watch"} == status
    assert ref_main(["sweep", "status", "--journal", d]) == 0
    assert json.loads(capsys.readouterr().out) == status
    assert main(["sweep", "watch", "--journal", d, "--once"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("sweep DONE") and "\x1b" not in out
    with pytest.raises(SystemExit, match="no sweep journal"):
        main(["sweep", "watch", "--journal", str(tmp_path / "nope"),
              "--once"])
    with pytest.raises(SystemExit, match="interval"):
        main(["sweep", "watch", "--journal", d, "--interval", "0"])


def test_sweep_usage_is_loud():
    with pytest.raises(SystemExit, match="usage"):
        main(["sweep", "frobnicate"])
    with pytest.raises(SystemExit, match="holds no sweep"):
        main(["sweep", "status", "--journal", "/nonexistent/tw-j"])


# -- ledger and pack ----------------------------------------------------------

def test_ledger_import_compare_and_anomalies(tmp_path, capsys):
    """``ledger import`` of the BENCH history, ``ledger compare`` exit
    codes and ``ledger anomalies`` on a bench line, through the port's
    CLI; the imported index equals the reference's."""
    from timewarp_tpu_torch.obs.ledger import RunLedger
    files = [os.path.join(REPO, f"BENCH_r0{i}.json") for i in range(1, 6)]
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    assert main(["ledger", "import", "--ledger", port] + files) == 0
    assert ref_main(["ledger", "import", "--ledger", ref] + files) == 0
    capsys.readouterr()
    runs = RunLedger(port).index()
    assert [r["batch"] for r in runs] == [f"BENCH_r0{i}" for i in range(1, 6)]

    def key(r):
        return {k: v for k, v in r.items() if k not in ("ts", "source")}
    from timewarp_tpu.obs.ledger import RunLedger as RefLedger
    assert [key(r) for r in runs] == [key(r) for r in RefLedger(ref).index()]
    assert main(["ledger", "compare", "--ledger", port, "BENCH_r02",
                 "BENCH_r03"]) == 0
    smoke = {"schema": 2, "config": "praos_1m",
             "config_key": "praos_1m|n2048|s24|cpu", "metric": "praos @2048",
             "smoke": True, "ok": True, "seconds": 8.0, "platform": "cpu",
             "git_sha": "aaa111"}
    led = RunLedger(str(tmp_path / "led"))
    led.add_bench_line(smoke, batch="b0001", source="bench.py")
    led.add_bench_line(dict(smoke, seconds=16.0, git_sha="bbb222"),
                       batch="b0002", source="bench.py")
    assert main(["ledger", "compare", "--ledger", led.root, "b0001",
                 "b0002"]) == 1
    assert "REGRESSION praos_1m|n2048|s24|cpu seconds: 8 -> 16" in \
        capsys.readouterr().out
    assert main(["ledger", "compare", "--ledger", led.root, "b0001",
                 "b0001"]) == 0
    with pytest.raises(SystemExit, match="is a bench line"):
        main(["ledger", "anomalies", "r0001", "--ledger", led.root])


def test_pack_fit_and_predicted_sweep(tmp_path, capsys):
    """``ledger add`` of a finished sweep, ``pack fit`` over the port's
    ledger (the artifact's rows, keys and families = the reference's fit
    of the same ledger), then ``sweep run --pack predicted
    --pack-artifact``: the results equal the first-fit sweep's."""
    worlds = [_ring(i, i, b) for i, b in enumerate((24, 40, 16, 32))]
    pack = _pack(tmp_path, worlds)
    d = str(tmp_path / "first")
    assert main(["sweep", "run", pack, "--journal", d, "--chunk", "8",
                 "--lint", "off", "--max-bucket", "2", *CPU]) == 0
    first = _out(capsys)[-1]
    led = str(tmp_path / "led")
    assert main(["ledger", "add", d, "--ledger", led]) == 0
    art = str(tmp_path / "art.json")
    assert main(["pack", "fit", "--ledger", led, "--out", art]) == 0
    fit = _out(capsys)[-1]
    assert ref_main(["pack", "fit", "--ledger", led, "--out",
                     str(tmp_path / "ref_art.json")]) == 0
    ref_fit = _out(capsys)[-1]
    for k in ("rows", "keys", "families"):
        assert fit[k] == ref_fit[k]
    assert fit["rows"] == 4
    p = str(tmp_path / "pred")
    assert main(["sweep", "run", pack, "--journal", p, "--chunk", "8",
                 "--lint", "off", "--max-bucket", "2", "--pack",
                 "predicted", "--pack-artifact", art, "--verify",
                 *CPU]) == 0
    pred = _out(capsys)[-1]
    assert pred["verified"] == 4
    done = [{e["result"]["run_id"]: e["result"] for e in SweepJournal(j).scan().events
             if e.get("ev") == "world_done"} for j in (d, p)]
    assert done[0] == done[1] and first["completed"] == 4
    assert SweepJournal(p).scan().event_counts()["pack_decision"] > 0


# -- search -------------------------------------------------------------------

SEARCH = ["search", "run", "gossip", "--params",
          json.dumps({"nodes": 8, "fanout": 2, "end_us": 120_000,
                      "burst": True, "think_us": 1000}),
          "--link", "fixed:1000", "--budget", "200",
          "--objective", "eventually-delivered", "--population", "4",
          "--generations", "2", "--search-seed", "1",
          "--minimize-trials", "8", "--journal", "{jd}"]


def test_search_run_and_repro(tmp_path, capsys):
    """``search run`` and ``search repro`` through both CLIs: equal result
    lines, exit codes and ``repro.json``."""
    (rc, out, jd), (rrc, rout, rjd) = both(capsys, tmp_path, SEARCH)
    assert rc == rrc
    assert _strip(out) == _strip(rout)
    if rc == 0:
        with open(f"{jd}/repro.json") as f:
            rep = json.load(f)
        with open(f"{rjd}/repro.json") as f:
            assert _strip(rep) == _strip(json.load(f))
        assert main(["search", "repro", f"{jd}/repro.json", *CPU]) == 0
        line = _out(capsys)[-1]
        assert line["reproduced"] is True
        assert ref_main(["search", "repro", f"{jd}/repro.json"]) == 0
        assert line == _out(capsys)[-1]
    else:
        assert rc == 3 and out[-1]["found"] is False


def test_search_usage_and_refusals(tmp_path):
    with pytest.raises(SystemExit, match="usage"):
        main(["search", "frobnicate"])
    with pytest.raises(SystemExit, match="--params"):
        main(["search", "run", "gossip", "--params", "[1]", *CPU])
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    with pytest.raises(SystemExit, match="not a chaos-search repro"):
        main(["search", "repro", str(bad), *CPU])


# -- serve and submit -----------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_listening(port, th, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and th.is_alive():
        with socket.socket() as s:
            if s.connect_ex(("127.0.0.1", port)) == 0:
                return
        time.sleep(0.05)
    raise AssertionError("serve never listened")


def test_serve_submit_over_loopback(tmp_path, capsys):
    """``serve`` (frontend + embedded curator, on the CPU) in a thread and
    ``submit --verify --drain``: every streamed result = its solo run on
    the port and on the reference."""
    from timewarp_tpu.sweep.spec import RunConfig as RefConfig
    from timewarp_tpu.sweep.spec import solo_result as ref_solo
    port = _free_port()
    cfgs = [_ring(0, 0, 32), _ring(1, 5, 24)]
    path = _pack(tmp_path, cfgs, "cfgs.json")
    rc = {}
    th = threading.Thread(target=lambda: rc.setdefault("serve", main([
        "serve", "--journal", str(tmp_path / "j"), "--hosts", "alpha",
        "--listen", f"127.0.0.1:{port}", "--slots", "2", "--chunk", "16",
        "--poll-s", "0.05", "--max-seconds", "120", *CPU])), daemon=True)
    th.start()
    _wait_listening(port, th)
    assert main(["submit", path, "--connect", f"127.0.0.1:{port}",
                 "--verify", "--drain", *CPU]) == 0
    th.join(timeout=60)
    assert not th.is_alive() and rc["serve"] == 0
    lines = _out(capsys)
    final = [x for x in lines if "streamed" in x and "submitted" in x][-1]
    assert final["verified"] == 2 and final["failed"] == []
    served = [x for x in lines if x.get("serve") == "done"][-1]
    assert served["admitted"] == served["completed"] == 2
    streamed = {x["result"]["run_id"]: x["result"] for x in lines
                if x.get("ev") == "world_done"}
    for d in cfgs:
        assert streamed[d["id"]] == ref_solo(RefConfig.from_json(d, 0),
                                             lint="off")


def test_serve_refusals(tmp_path):
    with pytest.raises(SystemExit, match="serve nothing"):
        main(["serve", "--journal", str(tmp_path / "j"), "--hosts", "a",
              "--no-curator", *CPU])
    empty = tmp_path / "empty.json"
    empty.write_text("[]")
    with pytest.raises(SystemExit, match="holds no configs"):
        main(["submit", str(empty), "--connect", "127.0.0.1:1", *CPU])

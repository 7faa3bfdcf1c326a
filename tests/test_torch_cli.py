"""The port's command line (``python -m timewarp_tpu_torch``,
``timewarp_tpu_torch/cli.py``) held against the reference's
(``timewarp_tpu.cli.main``) on the same argv.

The port side runs with ``--device cpu``. For every argv of
``tests/test_cli.py``, of the CLI cases of ``test_zztelemetry.py``,
``test_zzzzzflight.py`` and ``test_zzzzzzzzzzpreflight.py``, and of the
``pack`` cases of ``test_zgrammar.py``, the port's summary line equals
the reference's, leaving out the wall-clock keys (``wall_seconds``), the
compile count (``compiles``: the port compiles nothing per run) and the
port's added ``device`` key; the files a run writes (trace CSV,
checkpoint leaves, flight-recorder JSONL, canonical CSV) are equal too.
The sharded engines run as two gloo ranks on the CPU, one spawn per
engine, against the reference's run over two host devices. Every guard
the reference's tests pin is pinned on the port, and so are the port's
stated differences: ``--insert`` and ``--jax-profile`` are refused, and
without CUDA every entry point that runs something refuses to start
unless given ``--device cpu``.

Tolerance: exact.
"""

import csv
import json

import numpy as np
import pytest
import torch

from timewarp_tpu.cli import main as ref_main
from timewarp_tpu_torch.cli import main, parse_link
from timewarp_tpu_torch.net.delays import (FixedDelay, LogNormalDelay,
                                           Quantize, UniformDelay, WithDrop)

# one intra-op thread per test process: the test session's workers
# share the host's cores
torch.set_num_threads(1)

CPU = ["--device", "cpu"]
#: keys that hold a wall-clock reading or the reference's compile count
VOLATILE = {"wall_seconds", "wall_s", "compiles", "per_chunk_compiles"}


def _strip(x, top=True):
    if isinstance(x, dict):
        return {k: _strip(v, False) for k, v in x.items()
                if k not in VOLATILE and not (top and k == "device")}
    if isinstance(x, list):
        return [_strip(v, False) for v in x]
    return x


def _last(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def port_cli(capsys, *args):
    assert main([*args, *CPU]) == 0
    return _last(capsys)


def ref_cli(capsys, *args):
    assert ref_main(list(args)) == 0
    return _last(capsys)


def both(capsys, *args):
    """The same argv through both CLIs: the port's summary (which names
    its device) equals the reference's."""
    ref = ref_cli(capsys, *args)
    port = port_cli(capsys, *args)
    assert port["device"] == "cpu"
    assert _strip(port) == _strip(ref)
    return port


def _csv(path):
    with open(path) as f:
        return list(csv.reader(f))


# -- tests/test_cli.py -------------------------------------------------------

def test_parse_link_specs():
    assert parse_link("fixed:500") == FixedDelay(500)
    assert parse_link("uniform:100:900") == UniformDelay(100, 900)
    assert parse_link("lognormal:20000:0.6") == LogNormalDelay(20000, 0.6)
    assert parse_link("drop:0.1:fixed:500") == WithDrop(FixedDelay(500), 0.1)
    q = parse_link("quantize:1000:drop:0.2:uniform:1:9")
    assert q == Quantize(WithDrop(UniformDelay(1, 9), 0.2), 1000)
    with pytest.raises(SystemExit):
        parse_link("bogus:1")


@pytest.mark.parametrize("engine", ["oracle", "general", "edge"])
def test_cli_oracle_and_engines_agree(capsys, engine):
    r = both(capsys, "token-ring", "--nodes", "32", "--steps", "200",
             "--tokens", "4", "--think-us", "10000",
             "--link", "uniform:1000:5000", "--engine", engine)
    assert r["delivered"] == 101


def test_cli_windowed_burst_oracle_engine_agree(capsys):
    common = ["gossip", "--nodes", "48", "--burst", "--fanout", "4",
              "--window", "2000",
              "--link", "quantize:1000:uniform:2000:8000",
              "--steps", "300", "--end-us", "300000"]
    oracle = both(capsys, *common, "--engine", "oracle")
    general = both(capsys, *common, "--engine", "general",
                   "--route-cap", "192")
    assert oracle["delivered"] == general["delivered"]
    assert oracle["supersteps"] == general["supersteps"]


def test_cli_rejects_ignored_knobs():
    with pytest.raises(SystemExit, match="general engines only"):
        main(["token-ring", "--engine", "edge", "--window", "3000", *CPU])
    with pytest.raises(SystemExit, match="general engines only"):
        main(["token-ring", "--engine", "oracle", "--route-cap", "8", *CPU])


@pytest.mark.parametrize("argv", [
    ["gossip", "--nodes", "64", "--engine", "sharded", "--steps", "150",
     "--link", "uniform:1000:5000", "--end-us", "300000"],
    ["token-ring", "--nodes", "64", "--engine", "sharded-edge",
     "--steps", "100", "--tokens", "8", "--think-us", "5000"],
], ids=["sharded", "sharded-edge"])
def test_cli_sharded_engines(capsys, argv):
    """Two ranks (one spawn) against the reference over two devices."""
    r = both(capsys, *argv, "--devices", "2")
    assert r["engine"] == argv[4] and r["delivered"] > 0


def test_cli_sharded_refusals():
    common = ["gossip", "--nodes", "64", "--engine", "sharded", *CPU]
    with pytest.raises(SystemExit, match="--devices N is required"):
        main(common)
    with pytest.raises(SystemExit, match="sharded state"):
        main([*common, "--devices", "2", "--save", "x.npz"])
    with pytest.raises(SystemExit, match="--devices must be >= 1"):
        main([*common, "--devices", "0"])


def test_cli_trace_csv_and_checkpoint_roundtrip(tmp_path, capsys):
    common = ["praos", "--nodes", "32", "--slots", "2",
              "--link", "uniform:2000:9000"]
    out = {}
    for side, run in (("port", port_cli), ("ref", ref_cli)):
        d = tmp_path / side
        d.mkdir()
        r1 = run(capsys, *common, "--steps", "150", "--seed", "5",
                 "--trace-csv", str(d / "t.csv"), "--save", str(d / "ck.npz"))
        # resume adopts the checkpoint's seed (no --seed passed here)
        r2 = run(capsys, *common, "--steps", "100", "--resume",
                 str(d / "ck.npz"))
        full = run(capsys, *common, "--steps", "250", "--seed", "5")
        rows = _csv(d / "t.csv")
        assert rows[0][0] == "t_us" and len(rows) - 1 == r1["supersteps"]
        assert r2["steps"] == r1["steps"] + r2["supersteps"]
        assert r1["supersteps"] + r2["supersteps"] == full["supersteps"]
        assert r1["delivered"] + r2["delivered"] == full["delivered"]
        out[side] = [_strip(r) for r in (r1, r2, full)], rows, \
            dict(np.load(d / "ck.npz"))
    (port, port_rows, port_ck), (ref, ref_rows, ref_ck) = \
        out["port"], out["ref"]
    assert port == ref and port_rows == ref_rows
    assert sorted(port_ck) == sorted(ref_ck)
    for k in ref_ck:
        np.testing.assert_array_equal(port_ck[k], ref_ck[k], err_msg=k)


def test_cli_resumes_the_reference_checkpoint(tmp_path, capsys):
    """A checkpoint the reference's CLI wrote resumes on the port's to
    the reference's own resumed run."""
    common = ["token-ring", "--nodes", "32", "--tokens", "4",
              "--think-us", "10000", "--link", "uniform:1000:5000"]
    ck = str(tmp_path / "ck.npz")
    ref_cli(capsys, *common, "--steps", "60", "--seed", "3", "--save", ck)
    want = ref_cli(capsys, *common, "--steps", "50", "--resume", ck)
    got = port_cli(capsys, *common, "--steps", "50", "--resume", ck)
    assert _strip(got) == _strip(want)


def test_cli_oracle_rejects_checkpoint_flags(tmp_path):
    with pytest.raises(SystemExit):
        main(["token-ring", "--engine", "oracle",
              "--save", str(tmp_path / "x.npz"), *CPU])


def test_cli_batched_run_and_guards(capsys, tmp_path):
    common = ["gossip", "--nodes", "48", "--steps", "120", "--burst",
              "--fanout", "4", "--end-us", "200000",
              "--link", "quantize:1000:uniform:2000:8000"]
    ref_csv, port_csv = tmp_path / "r.csv", tmp_path / "p.csv"
    want = ref_cli(capsys, *common, "--batch", "2",
                   "--trace-csv", str(ref_csv))
    r = port_cli(capsys, *common, "--batch", "2")
    assert _strip(r) == _strip(want)
    assert r["worlds"] == 2 and r["seeds"] == [0, 1]
    assert len(r["delivered"]) == 2 and len(r["supersteps"]) == 2
    r2 = both(capsys, *common, "--seeds", "7:9")
    assert r2["seeds"] == [7, 8]
    solo = port_cli(capsys, *common, "--seed", "7")
    assert r2["delivered"][0] == solo["delivered"]
    assert r2["supersteps"][0] == solo["supersteps"]
    # the batched trace CSV carries the world column, the reference's rows
    r3 = port_cli(capsys, *common, "--batch", "2",
                  "--trace-csv", str(port_csv))
    rows = _csv(port_csv)
    assert rows[0][0] == "world" and len(rows) - 1 == sum(r3["supersteps"])
    assert rows == _csv(ref_csv)
    for eng in ("oracle", "edge", "fused-sparse", "sharded"):
        with pytest.raises(SystemExit, match="world axis"):
            main([*common, "--engine", eng, "--batch", "2",
                  "--devices", "2", *CPU] if eng == "sharded" else
                 [*common, "--engine", eng, "--batch", "2", *CPU])
    with pytest.raises(SystemExit, match="world axis"):
        main([*common, "--engine", "edge", "--seeds", "0:2", *CPU])
    with pytest.raises(SystemExit, match="needs --batch"):
        main([*common, "--engine", "sharded-batched", "--devices", "2",
              *CPU])
    with pytest.raises(SystemExit, match="solo-run debug ring"):
        main([*common, "--batch", "2", "--record-events", "16", *CPU])
    with pytest.raises(SystemExit, match="disagrees"):
        main([*common, "--batch", "3", "--seeds", "0:2", *CPU])


def test_cli_sharded_batched_matches_general_batched(capsys):
    common = ["token-ring", "--nodes", "32", "--steps", "100",
              "--tokens", "4", "--think-us", "10000",
              "--link", "uniform:1000:5000", "--seeds", "1:5"]
    sh = both(capsys, *common, "--engine", "sharded-batched",
              "--devices", "2")
    loc = port_cli(capsys, *common)
    assert sh["engine"] == "sharded-batched"
    for k in ("delivered", "supersteps", "virtual_time_us", "overflow"):
        assert sh[k] == loc[k]


def test_cli_batched_checkpoint_seed_fleet_pinned(capsys, tmp_path):
    ck = tmp_path / "fleet.npz"
    common = ["token-ring", "--nodes", "32", "--steps", "80",
              "--tokens", "4", "--think-us", "10000",
              "--link", "uniform:1000:5000"]
    port_cli(capsys, *common, "--seeds", "3:5", "--save", str(ck))
    with pytest.raises(SystemExit, match="matching --batch/--seeds"):
        main([*common, "--seeds", "0:2", "--resume", str(ck), *CPU])
    r = port_cli(capsys, *common, "--seeds", "3:5", "--resume", str(ck))
    assert r["seeds"] == [3, 4]


def test_parse_link_malformed_specs_name_the_grammar():
    for bad in ("uniform:5", "fixed:x", "lognormal:1000",
                "drop:0.1", "quantize:5", "fixed:1:2",
                "uniform:1:2:3", "drop:x:fixed:5", "bogus:1",
                "drop:0.5:uniform:7"):
        with pytest.raises(SystemExit) as ei:
            parse_link(bad)
        assert "grammar" in str(ei.value), bad


def test_cli_lint_subcommand_all_models_clean(capsys):
    args = ["lint", "--json", "--nodes", "32", "--no-probe"]
    assert main(args + CPU) == 0
    rep = _last(capsys)
    assert rep["errors"] == 0 and rep["subjects"] >= 14
    assert ref_main(args) == 0
    want = _last(capsys)
    assert rep["subjects"] == want["subjects"]
    assert {(f["code"], f["severity"], f["subject"])
            for f in rep["findings"]} == \
        {(f["code"], f["severity"], f["subject"]) for f in want["findings"]}


def test_cli_lint_subcommand_family_filter_with_probe(capsys):
    assert main(["lint", "gossip", "--json", "--nodes", "32", *CPU]) == 0
    rep = _last(capsys)
    assert rep["errors"] == 0 and rep["subjects"] == 4


def test_cli_lint_subcommand_rejects_unknown_family():
    with pytest.raises(SystemExit):
        main(["lint", "no-such-scenario", *CPU])


def test_cli_lint_flag_modes_run_identically(capsys):
    common = ["token-ring", "--nodes", "16", "--steps", "80",
              "--think-us", "10000", "--link", "fixed:2000"]
    base = ref_cli(capsys, *common)
    for mode in ("warn", "error", "off"):
        r = port_cli(capsys, *common, "--lint", mode)
        assert _strip(r) == _strip(base)


# -- the run drivers (verify, speculate, controller) -------------------------

@pytest.mark.parametrize("extra", [
    ["--verify", "digest", "--verify-chunk", "16",
     "--inject-flip", "flip:1:2:mb_rel"],
    ["--speculate", "fixed:4000", "--speculate-chunk", "16"],
    ["--controller", "auto", "--telemetry", "counters"],
], ids=["verified", "speculative", "controlled"])
def test_cli_drivers_equal_reference(capsys, tmp_path, extra):
    """``run_verified``, ``run_speculative`` and ``run_controlled``
    through both CLIs: the summary (integrity, speculation, controller
    receipts) and the canonical-surface CSV equal."""
    args = ["gossip", "--nodes", "48", "--burst", "--fanout", "4",
            "--window", "auto", "--steps", "96", "--end-us", "200000",
            "--link", "quantize:1000:uniform:2000:8000", "--lint", "off",
            *extra]
    canon = tmp_path / "c.csv"
    want = ref_cli(capsys, *args, "--canon-out", str(canon))
    want_rows = canon.read_text()
    r = port_cli(capsys, *args, "--canon-out", str(canon))
    assert _strip(r) == _strip(want)
    assert canon.read_text() == want_rows
    assert r["delivered"] > 0


# -- the stated differences ---------------------------------------------------

def test_cli_refuses_insert_and_jax_profile(tmp_path):
    for value in ("xla", "pallas", "interpret", "xla2d"):
        with pytest.raises(SystemExit, match="one insertion stage"):
            main(["gossip", "--nodes", "8", "--insert", value, *CPU])
    with pytest.raises(SystemExit, match="--torch-profile"):
        main(["gossip", "--nodes", "8", "--jax-profile",
              str(tmp_path), *CPU])
    with pytest.raises(SystemExit, match="--torch-profile"):
        main(["profile", "gossip", "--jax-profile", str(tmp_path), *CPU])


def test_cli_torch_profile_session(tmp_path, capsys):
    r = port_cli(capsys, "token-ring", "--nodes", "8", "--steps", "8",
                 "--lint", "off", "--torch-profile", str(tmp_path / "p"))
    assert r["supersteps"] > 0
    doc = json.loads((tmp_path / "p" / "trace.json").read_text())
    assert doc["traceEvents"]


def test_cli_refuses_to_start_without_cuda(monkeypatch, tmp_path):
    """No card and no ``--device cpu``: every entry point that runs
    something exits naming the flag, before it builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pack = tmp_path / "pack.json"
    pack.write_text(json.dumps([{"id": "w0", "scenario": "token-ring",
                                 "params": {"nodes": 8}, "budget": 4}]))
    argvs = [
        ["token-ring", "--nodes", "8", "--steps", "4"],
        ["gossip", "--nodes", "64", "--engine", "sharded",
         "--devices", "2"],
        ["lint", "gossip"],
        ["lint", "ping-pong", "--jaxpr"],
        ["bisect", "gossip", "--inject-flip", "flip:1:1"],
        ["profile", "token-ring"],
        ["sweep", "run", str(pack), "--journal", str(tmp_path / "j")],
        ["search", "run", "gossip"],
        ["serve", "--journal", str(tmp_path / "s"), "--hosts", "a"],
    ]
    for argv in argvs:
        with pytest.raises(SystemExit, match="--device cpu"):
            main(argv)
    assert not (tmp_path / "j").exists() and not (tmp_path / "s").exists()


# -- tests/test_zgrammar.py: pack fit ---------------------------------------

def test_pack_fit_refuses_absent_and_empty_ledgers(tmp_path):
    with pytest.raises(SystemExit) as ei:
        main(["pack", "fit", "--ledger", str(tmp_path / "nope")])
    assert "index.jsonl" in str(ei.value) \
        and "ledger add" in str(ei.value)
    from timewarp_tpu_torch.obs.ledger import RunLedger
    led = tmp_path / "led"
    RunLedger(str(led)).add_bench_line(
        {"config": "x", "config_key": "x|cpu", "value": 1.0,
         "schema": 2}, source="test")
    with pytest.raises(SystemExit) as ei:
        main(["pack", "fit", "--ledger", str(led)])
    assert "pack_stats" in str(ei.value)


def test_pack_subcommand_usage_is_loud():
    with pytest.raises(SystemExit) as ei:
        main(["pack", "frobnicate"])
    assert "usage" in str(ei.value)


# -- tests/test_zztelemetry.py: the CLI surface ------------------------------

def test_cli_telemetry_digests_match_off(tmp_path, capsys):
    from timewarp_tpu_torch.obs import validate_metrics_file
    args = ["gossip", "--nodes", "32", "--steps", "25", "--burst",
            "--window", "auto", "--link",
            "quantize:1000:uniform:3000:9000", "--lint", "off"]
    ref_cli(capsys, *args, "--trace-csv", str(tmp_path / "ref.csv"))
    off = port_cli(capsys, *args, "--trace-csv", str(tmp_path / "off.csv"))
    m, t = str(tmp_path / "m.jsonl"), str(tmp_path / "t.json")
    full = both(capsys, *args, "--trace-csv", str(tmp_path / "full.csv"),
                "--telemetry", "full", "--metrics-out", m, "--trace-out", t)
    # bit-identical traces with the plane off, on, and in the reference
    assert (tmp_path / "off.csv").read_text() \
        == (tmp_path / "full.csv").read_text() \
        == (tmp_path / "ref.csv").read_text()
    assert off["delivered"] == full["delivered"]
    assert full["telemetry"]["mode"] == "full"
    assert validate_metrics_file(m) >= 2
    assert json.loads(open(t).read())["traceEvents"]


def test_cli_guards(tmp_path):
    with pytest.raises(SystemExit, match="--telemetry"):
        main(["gossip", "--nodes", "8", "--steps", "4",
              "--metrics-out", str(tmp_path / "x.jsonl"), *CPU])
    with pytest.raises(SystemExit, match="oracle"):
        main(["gossip", "--nodes", "8", "--steps", "4",
              "--engine", "oracle", "--telemetry", "counters", *CPU])


def test_profile_subcommand(tmp_path, capsys):
    out = str(tmp_path / "p.json")
    assert main(["profile", "token-ring", "--out", out, "--nodes", "8",
                 "--steps", "16", "--lint", "off", *CPU]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["trace"] == out
    assert json.loads(lines[-2])["telemetry"]["mode"] == "full"
    assert json.loads(open(out).read())["traceEvents"]


# -- tests/test_zzzzzflight.py: the CLI surface ------------------------------

def test_cli_record_run_and_explain(tmp_path, capsys):
    from timewarp_tpu_torch.obs.flight import EV_DELIVER, load_flight_jsonl
    args = ["token-ring", "--nodes", "8", "--steps", "40", "--lint", "off"]
    ev, ref_ev = str(tmp_path / "ev.jsonl"), str(tmp_path / "ref.jsonl")
    ref_cli(capsys, *args, "--record", "full", "--record-out", ref_ev)
    line = port_cli(capsys, *args, "--record", "full", "--record-out", ev)
    assert line["flight"]["mode"] == "full"
    assert line["flight"]["events"] > 0 and line["flight"]["dropped"] == 0
    assert [json.loads(x) for x in open(ev)] == \
        [json.loads(x) for x in open(ref_ev)]
    off = port_cli(capsys, *args)
    assert "flight" not in off and off["delivered"] == line["delivered"]
    log = load_flight_jsonl(ev)
    dst = int(log.dst[log.kind == EV_DELIVER][0])
    assert main(["explain", ev, "--dst", str(dst), "--json"]) == 0
    res = _last(capsys)
    assert res["chain"][-1]["step"] == "deliver"
    assert ref_main(["explain", ref_ev, "--dst", str(dst), "--json"]) == 0
    assert res == _last(capsys)


def test_cli_record_guards(tmp_path):
    with pytest.raises(SystemExit, match="--record deliveries"):
        main(["gossip", "--nodes", "8", "--steps", "4",
              "--record-out", str(tmp_path / "e.jsonl"), *CPU])
    with pytest.raises(SystemExit, match="--record-cap"):
        main(["gossip", "--nodes", "8", "--steps", "4",
              "--record-cap", "64", *CPU])
    with pytest.raises(SystemExit, match="cannot carry"):
        main(["gossip", "--nodes", "8", "--steps", "4",
              "--engine", "oracle", "--record", "full", *CPU])


def test_cli_bisect_names_the_chunk(capsys):
    args = ["bisect", "gossip", "--nodes", "32", "--steps", "60",
            "--chunk", "16", "--burst",
            "--link", "quantize:1000:uniform:3000:9000",
            "--window", "auto", "--inject-flip", "flip:1:2:mb_rel", "--json"]
    assert main(args + CPU) == 0
    out = _last(capsys)
    d = out["divergence"]
    assert d["chunk"] == 1 and d["superstep"] is not None
    assert "clean != corrupt" in d["line"]
    assert ref_main(args) == 0
    assert out == _last(capsys)


def test_cli_bisect_refuses_nothing_to_bisect():
    with pytest.raises(SystemExit, match="nothing to bisect"):
        main(["bisect", "gossip", "--nodes", "8", *CPU])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        main(["bisect", "gossip", "--nodes", "8", "--engine-b",
              "edge", "--inject-flip", "flip:1:1", *CPU])


# -- tests/test_zzzzzzzzzzpreflight.py: lint's JSON and exit codes -----------

def test_lint_json_schema_and_exit_codes(capsys):
    from timewarp_tpu_torch.cli import lint_main
    rc = lint_main(["ping-pong", "--json", "--no-probe", *CPU])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert set(out) == {"subjects", "errors", "warnings", "infos",
                        "findings"}
    assert out["errors"] == 0
    for f in out["findings"]:
        assert {"code", "severity", "subject", "message"} <= set(f)


def test_lint_pack_json_schema_and_exit_codes(tmp_path, capsys):
    from test_zzzzzzzzzzpreflight import CLEAN, DOOMED
    from timewarp_tpu.cli import lint_pack_main as ref_lint_pack_main
    from timewarp_tpu_torch.cli import lint_pack_main
    for name, cfg, want_rc in (("clean", CLEAN, 0), ("doomed", DOOMED, 1)):
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps([cfg]))
        assert lint_pack_main([str(path), "--json"]) == want_rc
        out = json.loads(capsys.readouterr().out)
        assert set(out) == {"configs", "errors", "warnings", "infos",
                            "findings"}
        assert ref_lint_pack_main([str(path), "--json"]) == want_rc
        want = json.loads(capsys.readouterr().out)
        assert [(f["code"], f["severity"]) for f in out["findings"]] == \
            [(f["code"], f["severity"]) for f in want["findings"]]
        if want_rc:
            assert out["errors"] >= 1
            assert "TW602" in [f["code"] for f in out["findings"]]
        else:
            assert out["configs"] == 1 and out["errors"] == 0


def test_lint_jaxpr_exit_code(capsys):
    from timewarp_tpu_torch.cli import lint_main
    rc = lint_main(["ping-pong", "--jaxpr", "--json", *CPU])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["errors"] == 0
    assert any(f["code"] == "TW705" for f in out["findings"])
    assert not any(f["code"] in ("TW000", "TW700") for f in out["findings"])

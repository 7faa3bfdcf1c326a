"""The harness on the CPU: the files every cell and metric names, a
cell, configuration and metric added as files alone, the result line,
the import check and the refusals of ``run.py``."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

REPO = Path(__file__).resolve().parents[2]
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device",
                 "checks"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def spec():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_benchmark_json_shape():
    b = spec()
    assert list(b) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    assert len(json.dumps(b)) <= 64 * 1024


def test_every_cell_and_metric_resolves():
    bench = harness.Bench(REPO)
    b = bench.spec
    for w in b["workloads"]:
        cell = bench.cell(w["name"])
        assert harness.reference_model(cell.config).n == \
            cell.config["scenario"]["n"]
        assert cell.traffic["worlds"] >= 1
        # every cell reports setup_s, another end-to-end metric and a
        # per-layer metric
        assert "setup_s" in [m["name"] for m in cell.end_to_end]
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in b["per_layer"]:
        assert callable(bench.metric_reader(m["name"]).read)
    for k in ("k1", "k3"):
        rf = bench.roofline(k)
        assert rf.KERNEL and callable(rf.bytes_needed)


def test_added_files_run_without_edits(small_root, tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric, each
    a file of its own plus its BENCHMARK.json entry, run with no
    existing file edited."""
    root = tmp_path / "copy"
    root.mkdir()
    (root / "BENCHMARK.json").write_text(
        (small_root / "BENCHMARK.json").read_text())
    import shutil
    shutil.copytree(small_root / "benchmark", root / "benchmark")
    bdir = root / "benchmark"
    before = {p: p.read_bytes() for p in bdir.rglob("*") if p.is_file()}
    wave = json.loads((bdir / "configs" / "gossip-1m.json").read_text())
    wave.update(name="gossip-wave")
    wave["scenario"]["params"] = {"fanout": 8, "think_us": 2000,
                                  "burst": True, "end_us": 5_000_000,
                                  "mailbox_cap": 16}
    wave["link"] = {"kind": "quantize", "quantum_us": 1000,
                    "inner": {"kind": "lognormal", "median_us": 20000,
                              "sigma": 0.6, "cap_us": 10_000_000,
                              "floor_us": 8000}}
    wave["window"] = "auto"
    (bdir / "configs" / "gossip-wave.json").write_text(json.dumps(wave))
    (bdir / "traffic" / "wave.json").write_text(json.dumps(
        {"why": "a burst wave", "worlds": 2, "warm_supersteps": 4,
         "chunk_supersteps": 4, "trace_chunks": 1}))
    (bdir / "metrics" / "routed_per_step.py").write_text(
        "def read(ctx):\n    return ctx.routed / ctx.supersteps\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "gossip-wave", "source": "test",
                         "file": "benchmark/configs/gossip-wave.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "gossip-wave.wave", "config":
                           "gossip-wave", "traffic": "wave", "chips": 1,
                           "why": "test"})
    b["per_layer"].append({"name": "routed_per_step", "unit": "msgs/step",
                           "better": "higher", "source": "program_counter",
                           "layer": "routing", "moves": "msgs_per_s",
                           "workloads": ["gossip-wave.wave"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    code = ("import json, sys, torch; torch.set_num_threads(2); "
            f"sys.path[:0] = [{str(root)!r}, {str(REPO)!r}]; "
            "from benchmark import harness; "
            f"bench = harness.Bench({str(root)!r}); "
            "cell = bench.cell('gossip-wave.wave'); "
            "assert [m['name'] for m in cell.per_layer] == "
            "['routed_per_step']; "
            "line = harness.run_cell('gossip-wave.wave', 5, 0.3, False, "
            f"'cpu', {str(root)!r}); "
            "print(json.dumps(line))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] > 0
    assert "msgs_per_s" in line["metrics"]
    after = {p: p.read_bytes() for p in bdir.rglob("*") if p.is_file()
             and p in before}
    assert after == before


def test_line_keys_are_the_contract(small_root):
    line = harness.run_cell("gossip-1m.fleet8", 2**31 + 9, 0.3, False,
                            "cpu", small_root)
    assert list(line) == CONTRACT_KEYS
    assert line["correct"] is True
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["metrics"]) == {"msgs_per_s", "setup_s"}
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_import_check_compares_top_level_names(monkeypatch):
    sys.path.insert(0, str(REPO / "benchmark"))
    try:
        import run
    finally:
        sys.path.remove(str(REPO / "benchmark"))
    fake = dict(sys.modules)
    for k in [m for m in fake if m.split(".")[0] in run.FORBIDDEN]:
        del fake[k]
    fake.update({"timewarp_tpu_torch": None,
                 "timewarp_tpu_torch.core": None, "jaxfoo": None,
                 "flaxen": None})
    monkeypatch.setattr(sys, "modules", fake)
    assert run.forbidden_modules() == []
    fake.update({"timewarp_tpu.core.rng": None, "jax.numpy": None})
    assert run.forbidden_modules() == ["jax.numpy", "timewarp_tpu.core.rng"]


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "gossip-1m.fleet8", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=REPO, capture_output=True, text=True, timeout=300)
    if out.returncode == 0:
        pytest.skip("a CUDA device is present")
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_refuses_without_the_program(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text(
        (REPO / "BENCHMARK.json").read_text())
    import shutil
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "gossip-1m.fleet8", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "gossip-1m.fleet8", "--seed", "3", "--seconds", "2", "--trace",
         "0"], cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"

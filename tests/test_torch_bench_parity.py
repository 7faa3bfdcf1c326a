"""``bench_cuda.py``'s command line and line against ``bench.py``'s, and
its service, campaign and lint configs (``test_bench_config_runs`` of
``tests/test_torch_bench_configs.py``, split for time).

- ``main`` prints one BENCH_SCHEMA=2 line with ``bench.py``'s keys, but
  ``torch_version`` and ``power_limit`` in place of ``jax_version``
  (``tests/test_bench_configs.py``'s ``test_bench_main_prints_one_json_line``
  on the port);
- ``--ledger DIR`` twice at ``--smoke``, then ``python -m
  timewarp_tpu_torch ledger compare`` over the two batches, exits 0; the
  port's ledger records a line's ``torch_version`` and ``power_limit``,
  and records a ``bench.py`` line as the reference's ledger does;
- ``--reps`` under ``--smoke``, an unknown ``--device`` and an unknown
  config are refused; without a card the script exits naming
  ``--device cpu``;
- a run through ``bench_cuda.py`` loads neither JAX nor the reference;
  ``chip_smoke.py`` takes its workload builders and kernel timing helpers
  from ``bench_cuda.py`` (one copy), and the port's builders build the
  reference's scenarios.

Tolerance: exact.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

import bench_cuda
from test_torch_bench_configs import SERVICES, check_config

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


@pytest.mark.parametrize("cfg", SERVICES)
def test_bench_config_runs(cfg):
    """``tests/test_torch_bench_configs.py``'s test, for the services, the
    campaign and the lint corpus."""
    check_config(cfg)


def test_bench_main_prints_one_json_line(capsys, monkeypatch):
    monkeypatch.setenv("TW_BENCH_CONFIG", "token_ring_dense")
    monkeypatch.setenv("TW_BENCH_NODES", "256")
    monkeypatch.setenv("TW_BENCH_STEPS", "32")
    bench_cuda.main(CPU)
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    row = json.loads(out[0])
    assert set(row) == {"config", "config_key", "metric", "value", "unit",
                        "vs_baseline", "schema", "platform", "device_kind",
                        "torch_version", "power_limit", "git_sha", "calib"}
    assert row["unit"] == "msg/s"
    assert row["value"] > 0
    assert row["schema"] == bench_cuda.BENCH_SCHEMA == 2
    assert row["platform"] == "cpu"
    assert row["device_kind"] == "cpu"
    assert row["torch_version"] == torch.__version__
    assert row["power_limit"] is None        # no card, no limit
    assert row["config"] == "token_ring_dense"
    assert row["config_key"] == "token_ring_dense|n256|s32|cpu"
    assert isinstance(row["git_sha"], str) and row["git_sha"]
    assert row["calib"]["kernel"] == "sort_1m_int32_x64"
    assert row["calib"]["seconds"] > 0


def test_ledger_twice_at_smoke_then_compare(tmp_path, capsys, monkeypatch):
    from timewarp_tpu_torch.obs.ledger import RunLedger
    led = str(tmp_path / "ledger")
    cfgs = ["praos_1m_fused", "gossip_100k_insert"]
    monkeypatch.setenv("TW_BENCH_CONFIG", ",".join(cfgs))
    for _ in range(2):
        bench_cuda.main([*CPU, "--smoke", "--ledger", led])
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.strip().splitlines()]
    assert [ln["config"] for ln in lines] == cfgs * 2
    for ln in lines:
        assert ln["smoke"] is True and ln["ok"] is True
        assert ln["platform"] == "cpu" and ln["power_limit"] is None
        assert ln["config_key"] == "|".join(
            (ln["config"], *(f"{a}{b}" for a, b in zip(
                "ns", bench_cuda.SMOKE[ln["config"]])), "cpu"))
    runs = RunLedger(led).index()
    assert [r["batch"] for r in runs] == ["b0001"] * 2 + ["b0002"] * 2
    assert all(r["source"] == "bench_cuda.py" and r["smoke"]
               and r["torch_version"] == torch.__version__
               and r["power_limit"] is None for r in runs)
    proc = subprocess.run(
        [sys.executable, "-m", "timewarp_tpu_torch", "ledger", "compare",
         "--ledger", led, "b0001", "b0002"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "REGRESSION" not in proc.stdout


def test_ledger_records_torch_fields_beside_jax_version(tmp_path):
    from timewarp_tpu.obs.ledger import RunLedger as RefLedger
    from timewarp_tpu_torch.obs.ledger import RunLedger
    port = {"schema": 2, "config": "praos_1m",
            "config_key": "praos_1m|n2048|s24|cuda", "metric": "praos",
            "value": 5.0, "unit": "msg/s", "platform": "cuda",
            "device_kind": "NVIDIA H100 80GB HBM3",
            "torch_version": "2.11.0+cu128", "power_limit": "700.00 W",
            "git_sha": "cafe0123"}
    led = RunLedger(str(tmp_path / "p"))
    rec = led.get(led.add_bench_line(port, batch="b0001"))
    assert rec["torch_version"] == "2.11.0+cu128"
    assert rec["power_limit"] == "700.00 W"
    assert rec["jax_version"] is None
    assert led.index()[0]["power_limit"] == "700.00 W"
    # a bench.py line records as the reference's ledger records it
    ref_line = {k: v for k, v in port.items()
                if k not in ("torch_version", "power_limit")}
    ref_line["jax_version"] = "0.9"
    recs = []
    for L, d in ((RunLedger, "p2"), (RefLedger, "r2")):
        lg = L(str(tmp_path / d))
        recs.append(lg.get(lg.add_bench_line(ref_line, batch="b0001",
                                             source="bench.py")))
    assert recs[0] == recs[1]


@pytest.mark.parametrize("argv, env, message", [
    (["--smoke", "--reps", "3"], {}, "--reps applies to measured runs only"),
    (["--device", "tpu"], {}, "--device takes cuda or cpu"),
    (["--ledger"], {}, "--ledger takes a ledger directory"),
    (["--smoke"], {"TW_BENCH_CONFIG": "no_such"}, "unknown configs"),
    ([], {"TW_BENCH_CONFIG": "no_such"}, "unknown config"),
    (["--reps", "0"], {"TW_BENCH_CONFIG": "token_ring_dense"},
     "--reps must be >= 1"),
])
def test_bad_arguments_are_refused(argv, env, message, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if "--device" not in argv:
        argv = [*argv, *CPU]
    with pytest.raises(SystemExit, match=message):
        bench_cuda.main(argv)


def test_without_a_card_exits_naming_device_cpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "bench_cuda.py", "--smoke"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr
    assert proc.stdout == ""


def test_a_run_loads_neither_jax_nor_the_reference():
    """``bench_cuda.py`` imported first and alone in a fresh interpreter,
    then a config run through it, loads neither JAX nor the reference."""
    code = (
        "import sys, bench_cuda\n"
        "bench_cuda._run_config('token_ring_dense', 256, 8, 'cpu')\n"
        "bad = [m for m in sys.modules if m in ('jax', 'timewarp_tpu', "
        "'bench') or m.startswith(('jax.', 'timewarp_tpu.'))]\n"
        "print(len(bad), sorted(bad)[:5])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("0 "), out.stdout


def test_chip_smoke_takes_the_builders_from_bench_cuda():
    import chip_smoke
    for name in ("gossip_wave", "praos_consensus", "praos_link", "dense_ring",
                 "steady_gossip", "chaos_fleet", "bursty_gossip",
                 "spec_gossip", "hetero_pack", "search_base",
                 "serve_gossip_configs", "nvidia_smi", "k1_bytes",
                 "HBM_BYTES_PER_S"):
        assert getattr(chip_smoke, name) is getattr(bench_cuda, name), name
    assert chip_smoke._time_ms is bench_cuda.time_ms
    assert chip_smoke._stage_args is bench_cuda.stage_args


def test_builders_build_the_reference_scenarios():
    """Each builder's scenario and link carry the reference bench's
    parameters (``bench.py``'s private builders, at 1024 nodes)."""
    import bench
    pairs = [(bench_cuda.gossip_wave(1024), bench._gossip_wave(1024)),
             (bench_cuda.praos_consensus(1024), bench._praos_consensus(1024)),
             (bench_cuda.dense_ring(1024), bench._dense_ring(1024)),
             (bench_cuda.bursty_gossip(1024)[:2],
              bench._bursty_gossip(1024)[:2])]
    for (psc, plink), (rsc, rlink) in pairs:
        assert psc.n_nodes == rsc.n_nodes
        assert psc.mailbox_cap == rsc.mailbox_cap
        assert psc.payload_width == rsc.payload_width
        assert psc.max_out == rsc.max_out
        assert repr(plink) == repr(rlink)
    assert repr(bench_cuda.bursty_gossip(1024)[2]) \
        == repr(bench._bursty_gossip(1024)[2])

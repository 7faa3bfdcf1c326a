"""The port's network bench (``timewarp_tpu_torch/bench_net/``) held
against the reference's: every case of ``tests/test_bench_net.py`` on the
port, and the emulated bench's joined measure table equal to the
reference's on the same arguments (the same seeded payloads, the same
virtual timestamps). Host TCP programs over the port's ``net/``: nothing
here touches a device. Tolerance: exact, but for the real-TCP smoke,
which allows a straggler at teardown as the reference's does.
"""

import logging
import os

import pytest
import torch

from timewarp_tpu.bench_net.launch import launch as ref_launch
from timewarp_tpu_torch.bench_net.commons import (MeasureEvent,
                                                  parse_measure_line)
from timewarp_tpu_torch.bench_net.launch import launch, main
from timewarp_tpu_torch.bench_net.log_reader import (join_measures,
                                                     summarize, write_csv)
from timewarp_tpu_torch.utils.logconfig import (configure_logging,
                                                load_log_config)

# one intra-op thread per test process: the test session's workers
# share the host's cores
torch.set_num_threads(1)


def _plain(table):
    """A measure table with the events keyed by name (the two packages'
    ``MeasureEvent`` enums are distinct classes)."""
    return {mid: {getattr(k, "name", k): v for k, v in row.items()}
            if isinstance(row, dict) else row for mid, row in table.items()}


def test_measure_line_roundtrip():
    for ev in MeasureEvent:
        line = f"#123 {ev.value} (45) 678901"
        assert parse_measure_line(line) == (ev, 123, 45, 678901)
    assert parse_measure_line("ordinary log noise") is None


def test_emulated_bench_complete_timelines(tmp_path):
    table = launch(msgs=60, threads=5, duration_s=10, payload_bound=32,
                   delay_us=1500, seed=2, logs_dir=str(tmp_path / "logs"))
    mids = [k for k in table if isinstance(k, int)]
    assert len(mids) == 60
    for mid in mids:
        row = table[mid]
        a = row[MeasureEvent.PING_SENT]
        b = row[MeasureEvent.PING_RECEIVED]
        c = row[MeasureEvent.PONG_SENT]
        d = row[MeasureEvent.PONG_RECEIVED]
        assert a < b <= c < d
        assert b - a >= 1500
    out = tmp_path / "measures.csv"
    assert write_csv(table, str(out)) == 60
    assert out.read_text().splitlines()[0] == (
        "MsgId,PayloadBytes,PING_SENT,PING_RECEIVED,PONG_SENT,"
        "PONG_RECEIVED")
    logs = tmp_path / "logs"
    with open(logs / "sender.log") as f:
        s_lines = f.readlines()
    with open(logs / "receiver.log") as f:
        r_lines = f.readlines()
    assert join_measures(s_lines, r_lines) == table


@pytest.mark.parametrize("kw", [
    dict(msgs=60, threads=5, duration_s=10, payload_bound=32,
         delay_us=1500, seed=2),
    dict(msgs=40, threads=3, duration_s=5, payload_bound=16, seed=7),
    dict(msgs=30, threads=2, duration_s=5, no_pong=True),
], ids=["complete", "deterministic", "no-pong"])
def test_emulated_bench_equals_reference(kw):
    """The same bench on both packages: every message's four virtual
    timestamps and payload length equal."""
    assert _plain(launch(**kw)) == _plain(ref_launch(**kw))


def test_emulated_bench_deterministic():
    a = launch(msgs=40, threads=3, duration_s=5, payload_bound=16, seed=7)
    b = launch(msgs=40, threads=3, duration_s=5, payload_bound=16, seed=7)
    assert a == b


def test_no_pong_leaves_pong_columns_empty():
    table = launch(msgs=30, threads=2, duration_s=5, no_pong=True)
    mids = [k for k in table if isinstance(k, int)]
    assert len(mids) == 30
    for mid in mids:
        row = table[mid]
        assert MeasureEvent.PING_SENT in row
        assert MeasureEvent.PING_RECEIVED in row
        assert MeasureEvent.PONG_SENT not in row
        assert MeasureEvent.PONG_RECEIVED not in row


def test_real_tcp_bench_smoke():
    port = 25000 + (os.getpid() + 7919) % 20000
    table = launch(msgs=20, threads=2, duration_s=2, real=True, port=port)
    mids = [k for k in table if isinstance(k, int)]
    assert len(mids) == 20
    assert sum(1 for m in mids if len(table[m]) == 5) >= 18


def test_logconfig_severity_tree(tmp_path):
    configure_logging({"twtorchx": {"severity": "Warning",
                                    "sub": {"severity": "Error"}}})
    assert logging.getLogger("twtorchx").level == logging.WARNING
    assert logging.getLogger("twtorchx.sub").level == logging.ERROR
    assert logging.getLogger(
        "twtorchx.other").getEffectiveLevel() == logging.WARNING
    cfg = tmp_path / "log.yaml"
    cfg.write_text("twtorchy:\n  severity: Info\n  comm:\n"
                   "    severity: Error\n")
    load_log_config(str(cfg))
    assert logging.getLogger("twtorchy").level == logging.INFO
    assert logging.getLogger("twtorchy.comm").level == logging.ERROR


def test_duplicate_wire_name_rejected():
    from timewarp_tpu_torch.net.message import message

    @message(name="TorchUniqueWireNameX")
    class A:
        x: int

    with pytest.raises(ValueError, match="already registered"):
        @message(name="TorchUniqueWireNameX")
        class B:
            y: int


def test_summarize_stats():
    table = launch(msgs=50, threads=5, duration_s=5, delay_us=2_000, seed=1)
    s = summarize(table)
    assert s["messages"] == 50 and s["complete_timelines"] == 50
    assert 4_000 <= s["rtt_us"]["p50"] <= 6_000
    assert s["rtt_us"]["p50"] <= s["rtt_us"]["p90"] <= s["rtt_us"]["p99"]
    assert s["one_way_us"]["p50"] >= 2_000
    from timewarp_tpu.bench_net.log_reader import summarize as ref_summarize
    ref = ref_launch(msgs=50, threads=5, duration_s=5, delay_us=2_000,
                     seed=1)
    assert s == ref_summarize(ref)


def test_launch_main_writes_csv(tmp_path, capsys):
    """``python -m timewarp_tpu_torch.bench_net.launch``: the CSV and the
    stats line, equal to the reference launcher's files."""
    from timewarp_tpu.bench_net.launch import main as ref_main
    argv = ["--msgs", "30", "--threads", "3", "--duration", "3",
            "--payload-bound", "8", "--seed", "4", "--stats"]
    assert main(argv + ["--out", str(tmp_path / "p.csv")]) == 0
    port_out = capsys.readouterr().out.splitlines()
    assert ref_main(argv + ["--out", str(tmp_path / "r.csv")]) == 0
    ref_out = capsys.readouterr().out.splitlines()
    assert (tmp_path / "p.csv").read_text() == \
        (tmp_path / "r.csv").read_text()
    assert port_out[0].endswith("30 message timelines (30 complete)")
    assert port_out[1] == ref_out[1]

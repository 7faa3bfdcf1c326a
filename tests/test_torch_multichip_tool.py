"""``tools/multichip_cuda.py``, the port's twin of ``__graft_entry__.py``'s
``dryrun_multichip``, on the CPU: its rows 1-3 in four gloo ranks, each
held against the reference's one-device run of the same scenario
(``EdgeEngine``/``JaxEngine`` from ``timewarp_tpu``, the trace's digest
and the delivered count, exactly) as ``dryrun_multichip`` holds its own;
the artifact's keys; and the refusals: ``--dist-backend nccl`` on the CPU
or with fewer cards than ranks (through the tool, ``spawn`` and ``python
-m timewarp_tpu_torch ... --dist-backend nccl``), the card's default
without a card (naming ``--device cpu``), and a failed rank that does
not exit failing the launch at once. Tolerance: exact (every observable
is integer).
"""

import importlib
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from timewarp_tpu.interp.jax_engine.edge_engine import EdgeEngine as JEdge
from timewarp_tpu.interp.jax_engine.engine import JaxEngine
from timewarp_tpu.models.gossip import gossip as jgossip
from timewarp_tpu.models.token_ring import token_ring as jring
from timewarp_tpu.net import delays as jd
from timewarp_tpu_torch.cli import main as cli_main
from timewarp_tpu_torch.parallel.launch import RankFailed, spawn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

# one intra-op thread per test process: the test session's workers
# share the host's cores
torch.set_num_threads(1)

RANKS = 4


@pytest.fixture(scope="module")
def tool():
    return importlib.import_module("multichip_cuda")


@pytest.fixture(scope="module")
def artifact(tool, tmp_path_factory):
    """Rows 1-3 through the tool's ``main`` in four gloo ranks on the CPU,
    one torch thread each: ``(exit code, the JSON it wrote)``."""
    out = tmp_path_factory.mktemp("multichip") / "multichip.json"
    rc = tool.main(["--ranks", str(RANKS), "--dist-backend", "gloo",
                    "--device", "cpu", "--threads", "1", "--out", str(out)])
    with open(out) as f:
        return rc, json.load(f)


def reference_row(row, tool):
    """The reference's one-device run of ``dryrun_multichip``'s case
    ``row`` at four devices (``__graft_entry__.py:76-118``): ``(trace
    digest, delivered, overflow, short_delay)``."""
    n = RANKS
    link = jd.UniformDelay(200, 900)
    if row == 1:
        sc = jring(32 * n, n_tokens=32 * n, think_us=1_000,
                   bootstrap_us=1_000, end_us=1 << 50, with_observer=False,
                   mailbox_cap=4)
        st, tr = JEdge(sc, link).run(20)
    elif row == 2:
        sc = jgossip(16 * n, fanout=4, think_us=2_000, gossip_interval=1_000,
                     end_us=400_000, mailbox_cap=8)
        st, tr = JaxEngine(sc, link).run(60)
    else:
        sc = jgossip(16 * n, fanout=4, think_us=700, burst=True,
                     end_us=400_000, mailbox_cap=16)
        st, tr = JaxEngine(sc, jd.Quantize(jd.UniformDelay(2_000, 6_000),
                                           1_000), window=2_000).run(60)
    short = int(st.short_delay) if hasattr(st, "short_delay") else 0
    return (tool.trace_sha(tr), int(st.delivered), int(st.overflow), short)


@pytest.mark.parametrize("row", [1, 2, 3])
def test_dryrun_rows_equal_the_reference(artifact, tool, row):
    """Each row: the sharded trace = the port's one-device trace = the
    reference's one-device trace (their digests), delivered > 0 and the
    same, the ring's overflow and the window's short_delay 0."""
    rc, out = artifact
    got = out["rows"][row - 1]
    assert got["row"] == row and got["name"] == tool.ROWS[row]
    assert got["equal"] is True, got.get("error")
    sha, delivered, overflow, short = reference_row(row, tool)
    assert got["trace_sha"] == got["one_device_trace_sha"] == sha
    assert got["delivered"] == delivered > 0
    if row == 1:
        assert overflow == 0
    if row == 3:
        assert short == 0


def test_artifact_keys(artifact):
    """The reference record's keys, then the tool's; a row's columns."""
    rc, out = artifact
    assert rc == 0
    assert {k: out[k] for k in ("n_devices", "rc", "ok", "skipped",
                                "tail")} == {"n_devices": RANKS, "rc": 0,
                                             "ok": True, "skipped": False,
                                             "tail": ""}
    assert (out["backend"], out["device"], out["topology"]) == \
        ("gloo", "cpu", None)
    assert out["torch"] == torch.__version__
    assert [r["row"] for r in out["rows"]] == [1, 2, 3]
    for r in out["rows"]:
        assert {"name", "engine", "shape", "held_against", "kernels",
                "equal", "supersteps", "wall_ms_per_superstep",
                "exchange_share", "reduce_share", "launches", "trace_sha",
                "one_device_trace_sha", "delivered", "wall_s"} <= set(r)
        assert len(r["wall_ms_per_superstep"]) == len(r["exchange_share"]) \
            == len(r["reduce_share"]) == RANKS
        assert all(0 <= s <= 1 for s in r["exchange_share"]
                   + r["reduce_share"])


def test_tool_refuses_nccl_on_the_cpu(tool):
    with pytest.raises(SystemExit, match="--dist-backend nccl ships "
                       "device tensors.*--device cpu"):
        tool.main(["--device", "cpu"])


def test_tool_refuses_nccl_with_fewer_cards_than_ranks(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--ranks 4.*one GPU per rank: 4 "
                       "ranks but 1 CUDA device"):
        tool.main(["--ranks", "4"])


def test_tool_refuses_full_width_rows_on_the_cpu(tool):
    with pytest.raises(SystemExit, match="rows 4-8 .* only on the card"):
        tool.main(["--dist-backend", "gloo", "--device", "cpu",
                   "--rows", "1,4"])


def test_tool_without_a_card_names_device_cpu(tool):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is valid")
    with pytest.raises(SystemExit, match="--device cpu"):
        tool.main([])


def test_spawn_refuses_nccl_on_the_cpu(monkeypatch):
    """Even with a card a rank: NCCL ranks never run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="backend='nccl' ships device "
                       "tensors.*device='cpu'"):
        spawn("torch_sharded_cases:run_all", 1, backend="nccl",
              device="cpu")


GOSSIP = ["gossip", "--nodes", "64", "--engine", "sharded", "--steps", "20",
          "--devices", "2"]


def test_cli_refuses_nccl_on_the_cpu():
    """Through ``python -m timewarp_tpu_torch``: the exit names the
    cause, and no rank starts."""
    p = subprocess.run(
        [sys.executable, "-m", "timewarp_tpu_torch", *GOSSIP,
         "--dist-backend", "nccl", "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "--dist-backend nccl ships device tensors" in p.stderr
    assert "--dist-backend gloo" in p.stderr


def test_cli_refuses_nccl_with_fewer_cards_than_ranks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--dist-backend nccl --devices 2: "
                       "backend='nccl' needs one GPU per rank"):
        cli_main(GOSSIP + ["--dist-backend", "nccl"])


def test_cli_refuses_dist_backend_off_the_sharded_engines():
    with pytest.raises(SystemExit, match="--dist-backend chooses the "
                       "sharded engines' ranks"):
        cli_main(["gossip", "--nodes", "64", "--engine", "general",
                  "--dist-backend", "nccl", "--device", "cpu"])


def test_a_failed_rank_that_does_not_exit_fails_the_launch_at_once():
    """Rank 1 raises and then blocks on its way out (as a teardown left
    waiting would), while rank 0 sleeps in no collective: the launch
    fails with rank 1's traceback as soon as rank 1 claims the failure,
    well before ``timeout``, not when either rank ends."""
    t0 = time.monotonic()
    with pytest.raises(RankFailed, match="rank 1 of 2 failed"
                       "(.|\n)*rank 1 fails on purpose"):
        spawn("torch_sharded_cases:fail_with_a_slow_exit", 2,
              backend="gloo", device="cpu", args=(1, 600), timeout=120,
              threads=1)
    assert time.monotonic() - t0 < 60


def test_a_row_that_differs_fails_the_tool(tool, monkeypatch, tmp_path):
    """A group of rows that raises: every row in it unequal with the
    error's line, ``ok`` false, ``rc`` 1 in the file and as the exit
    code, the traceback in ``tail``."""
    def differs(*a, **kw):
        raise AssertionError("row 2 dryrun_all2all: state.delivered "
                             "differs")
    monkeypatch.setattr(tool, "run_dryrun_rows", differs)
    out = tmp_path / "m.json"
    rc = tool.main(["--ranks", "2", "--dist-backend", "gloo", "--device",
                    "cpu", "--out", str(out)])
    got = json.loads(out.read_text())
    assert rc == 1 and got["rc"] == 1 and got["ok"] is False
    assert [(r["row"], r["equal"]) for r in got["rows"]] == \
        [(1, False), (2, False), (3, False)]
    assert all(r["error"] == "AssertionError: row 2 dryrun_all2all: "
               "state.delivered differs" for r in got["rows"])
    assert "Traceback" in got["tail"] and "rows [1, 2, 3]" in got["tail"]

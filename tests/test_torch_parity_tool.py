"""``tools/parity_cuda.py``, the port's twin of ``tools/parity_tpu.py``:
its rows on the CPU equal the reference's committed ``PARITY_TPU.json``
field for field, the committed ``PARITY_CUDA.json`` (written on the
card) holds the same law, and a difference from the reference's artifact
fails the tool."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import parity_cuda  # noqa: E402

with open(os.path.join(ROOT, "PARITY_TPU.json")) as _f:
    REF = json.load(_f)

#: the fields a row must share with the reference's
MAIN = ("supersteps", "delivered", "oracle_sha", "engine_sha",
        "truncated_at_step_cap")


def _columns(entry):
    return {c: entry[c] for c in parity_cuda.COLUMNS if c in entry}


@pytest.mark.parametrize("name", ["ping-pong", "token-ring-64-fixed",
                                  "socket-state-4"])
def test_row_on_cpu_equals_the_reference(name):
    """``TorchEngine`` (``EdgeEngine`` on the fixed ring) on the CPU:
    every flag, digest and count as the reference's artifact."""
    got = parity_cuda.run_row(name, "cpu", reference=REF)
    want = REF["configs"][name]
    assert "reference_mismatch" not in got
    assert parity_cuda.row_ok(got)
    assert {f: got[f] for f in MAIN} == {f: want[f] for f in MAIN}
    for col, w in _columns(want).items():
        g = got[col]
        assert g["supported"] == w["supported"]
        for k in ("sha", "reason", "fault_dropped"):
            assert g.get(k) == w.get(k), (col, k)
    assert set(_columns(got)) == set(_columns(want))


def test_lane_rule_row_runs_fused_and_equals_the_general_engine():
    """The reference's fused engine refuses 64 nodes by its 1024-lane
    rule; the port's runs the row, and its digest is the row's
    ``engine_sha`` (fused = general), the reference's reason kept."""
    name = "gossip-64-burst-windowed"
    got = parity_cuda.run_row(name, "cpu", columns=("fused_sparse",),
                              reference=REF)
    assert "reference_mismatch" not in got
    fused = got["fused_sparse"]
    assert REF["configs"][name]["fused_sparse"]["reason"] == \
        parity_cuda.LANE_RULE == fused["reference_refused"]
    assert fused["supported"] and fused["equal"]
    assert fused["sha"] == REF["configs"][name]["engine_sha"]


def test_committed_artifact_is_from_the_card_and_equals_the_reference():
    with open(os.path.join(ROOT, "PARITY_CUDA.json")) as f:
        art = json.load(f)
    assert art["ok"] is True
    assert art["engine_platform"] == "cuda"
    assert art["oracle_platform"] == "cpu"
    name, limit = (s.strip() for s in art["device"].split(","))
    assert "H100" in name and limit.endswith(" W"), art["device"]
    assert set(art["configs"]) == set(REF["configs"])
    for cfg, want in REF["configs"].items():
        got = art["configs"][cfg]
        assert "reference_mismatch" not in got, cfg
        assert {f: got[f] for f in MAIN} == {f: want[f] for f in MAIN}, cfg
        assert set(_columns(got)) == set(_columns(want)), cfg
        for col, w in _columns(want).items():
            g = got[col]
            if not w["supported"] and w["reason"] == parity_cuda.LANE_RULE:
                assert g["supported"] and g["sha"] == want["engine_sha"]
                continue
            assert g["supported"] == w["supported"], (cfg, col)
            assert g.get("sha") == w.get("sha"), (cfg, col)
        assert got["wall_s"] > 0


def test_a_difference_from_the_reference_fails_the_tool(tmp_path, capsys):
    """An edited copy of the reference's artifact: ``ok`` false, the
    field named under ``reference_mismatch``, a nonzero exit, and
    ``--self-check`` writes nothing."""
    ref = json.loads(json.dumps(REF))
    ref["configs"]["socket-state-4"]["engine_sha"] = "0" * 16
    ref["configs"]["socket-state-4"]["batched"]["sha"][2] = "f" * 16
    path = tmp_path / "PARITY_TPU.json"
    path.write_text(json.dumps(ref))
    out = tmp_path / "PARITY_CUDA.json"
    rc = parity_cuda.main(["--device", "cpu", "--configs", "socket-state-4",
                           "--reference", str(path), "--out", str(out),
                           "--self-check"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc != 0
    assert json.loads(lines[-1]) == {"parity_cuda_ok": False,
                                     "engine_platform": "cpu"}
    art = json.loads(lines[-2])
    assert art["ok"] is False
    assert set(art["configs"]["socket-state-4"]["reference_mismatch"]) == \
        {"engine_sha", "batched.sha"}
    assert not out.exists()


def test_the_tool_needs_a_card_unless_told_cpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is valid")
    with pytest.raises(SystemExit, match="--device cpu"):
        parity_cuda.main(["--configs", "ping-pong", "--self-check"])

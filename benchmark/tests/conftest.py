"""A copy of the benchmark at CPU test size: every configuration at a
few thousand nodes, every traffic mix with short warm-ups and chunks,
and the cells whose files the benchmark keeps for a later one
(:data:`KEPT`) entered in the copy's ``BENCHMARK.json``."""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

#: cells whose configuration, mix and readers the benchmark keeps, but
#: not in ``BENCHMARK.json``: Praos on the fused engine with K3, whose
#: host-paced rate spread too widely on the card to be bounded
KEPT = {
    "configs": [{"name": "praos-1m", "source": "test",
                 "file": "benchmark/configs/praos-1m.json", "reduced": [],
                 "why": "the fused engine with K3"}],
    "workloads": [{"name": "praos-1m.diffusion", "config": "praos-1m",
                   "traffic": "diffusion", "chips": 1,
                   "why": "the fused engine with K3"}],
}


def shrink(root: Path, n: int = 2048) -> Path:
    """Copy ``BENCHMARK.json`` and ``benchmark/`` under ``root`` and cut
    every configuration to ``n`` nodes (Praos keeping about four leaders
    a slot and a batch that never drops) and every mix to at most 48
    warm supersteps and chunks of 8."""
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for key, entries in KEPT.items():
        spec[key] += [e for e in entries
                      if e["name"] not in {x["name"] for x in spec[key]}]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for f in (root / "benchmark" / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["scenario"]["n"] = n
        if c["scenario"]["family"] == "praos":
            c["scenario"]["params"]["leader_prob"] = 4 / n
            if "max_batch" in c["engine"]["kwargs"]:
                c["engine"]["kwargs"]["max_batch"] = n * 8
        f.write_text(json.dumps(c))
    for f in (root / "benchmark" / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t["warm_supersteps"] = min(t["warm_supersteps"], 48)
        t["chunk_supersteps"] = min(t["chunk_supersteps"], 8)
        f.write_text(json.dumps(t))
    return root


@pytest.fixture(scope="session")
def small_root(tmp_path_factory):
    torch.set_num_threads(2)
    return shrink(tmp_path_factory.mktemp("bench"))

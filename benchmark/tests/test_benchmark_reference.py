"""The plain reference against the program at a small size of both
configurations: the initial state, a warm-up from it, and a chunk from
the program's own state, every leaf bit for bit."""

import json

import pytest

from benchmark import harness, system
from benchmark.reference.engine import RefEngine

CASES = [("gossip-1m", 2048, [7], 40, 16),
         ("praos-1m", 2048, [2**31 + 5], 40, 16),
         ("praos-1m-general", 2048, [2**31 + 6], 40, 16),
         ("praos-1m-general", 1024, [41, 42], 40, 8),
         ("gossip-1m", 1024, [33, 34, 35], 40, 8)]


@pytest.mark.parametrize("name,n,seeds,warm,chunk", CASES,
                         ids=["gossip", "praos", "praos-general",
                              "praos-general-fleet", "gossip-fleet"])
def test_reference_equals_program(small_root, name, n, seeds, warm, chunk):
    config = json.loads(
        (small_root / "benchmark" / "configs" / f"{name}.json").read_text())
    config["scenario"]["n"] = n
    if config["scenario"]["family"] == "praos":
        config["scenario"]["params"]["leader_prob"] = 4 / n
        if "max_batch" in config["engine"]["kwargs"]:
            config["engine"]["kwargs"]["max_batch"] = n * 8
    eng = system.build_engine(config, seeds, "cpu")
    st0 = eng.init_state()
    stw = eng.run_quiet(warm, st0)
    st1 = eng.run_quiet(chunk, stw)
    ref = RefEngine(harness.reference_model(config), config["link"],
                    config["window"], seeds, "cpu")
    B = len(seeds)
    r0 = ref.init_state()
    assert harness.element_diff(system.state_dict(st0, B), r0) == (0, [])
    rw = ref.run(r0, warm)
    assert harness.element_diff(system.state_dict(stw, B), rw) == (0, [])
    r1 = ref.run(system.state_dict(stw, B), chunk)
    assert harness.element_diff(system.state_dict(st1, B), r1) == (0, [])
    # the run did something: messages moved and landed
    assert int(r1["delivered"].sum()) > int(rw["delivered"].sum()) > 0

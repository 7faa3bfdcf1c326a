"""Every config of the port's bench script (``bench_cuda.py``) runs on the
port's engines at ``tests/test_bench_configs.py``'s tiny sizes on the CPU
(the services', the campaign's and the lint corpus' in
``tests/test_torch_bench_parity.py``, through :func:`check_config`),
with every in-bench gate of ``bench.py`` on (bit-exact engine pairs, the
batch exactness law, the chaos properties, the replay and speculation
laws, the detection law, the record exactness law, the sweep and serve
survival laws, the search gates, the lint corpus), and asserts all that
``test_bench_config_runs`` asserts of ``bench.py``'s lines.

The deterministic integer fields of those lines (the chaos fleet's
per-world drops, the controller's and speculation's superstep counts and
windows, the recorder's event counts, the sweeps' worlds, buckets,
retries and packing rollups, the search campaign's evaluations and
repro, the serving bucket's counts, the lint corpus' subject counts)
equal ``bench.py``'s at the same size and seed: :data:`REF_FIELDS` holds
``bench._run_config``'s values, and the ``slow`` test at the end
re-derives them from ``bench.py`` itself (the reference's runs take
about 300 s on one process, most of it JAX compiles).

Tolerance: exact for every field compared.
"""

import pytest
import torch

import bench_cuda

# one intra-op thread per test process: the test session's workers share
# the host's cores
torch.set_num_threads(1)

CPU = "cpu"

#: ``tests/test_bench_configs.py``'s sizes
NODES = {"token_ring_dense": 512, "token_ring_dense_xla": 512,
         "token_ring_observer": 256,
         "gossip_100k": 512, "gossip_100k_fused": 2048,
         "gossip_100k_insert": 2048,
         "gossip_100k_b8": 512, "gossip_100k_chaos": 512,
         "gossip_100k_auto": 512, "gossip_100k_spec": 512,
         "gossip_100k_verify": 512,
         "gossip_100k_record": 512,
         "gossip_steady_1m": 512,
         "praos_1m": 512, "praos_1m_fused": 2048,
         "praos_1m_insert": 2048,
         "praos_1m_b4": 512, "sweep_hetero": 256,
         "sweep_hetero_auto": 256, "search_gossip": 64,
         "serve_gossip": 256, "lint_sweep": 64}


def _steps(cfg):
    """``tests/test_bench_configs.py``'s steps: the waves run to
    quiescence, the sweeps and the service take per-world budgets, the
    search a per-evaluation budget."""
    return 20_000 if cfg.startswith("gossip_100k") else \
        96 if cfg.startswith("sweep_hetero") else \
        300 if cfg == "search_gossip" else \
        96 if cfg == "serve_gossip" else 48


#: ``bench._run_config(cfg, NODES[cfg], _steps(cfg))``'s deterministic
#: fields, from ``bench.py`` on the CPU (re-derived by
#: ``test_reference_fields_are_bench_py_s``)
REF_FIELDS = {
    "gossip_100k_chaos": {
        "route_drop": [0, 0, 0, 0, 0, 0, 0, 0],
        "fault_dropped": [11563, 12063, 12578, 13116, 13624, 14108, 14649,
                          15150]},
    "gossip_100k_auto": {
        "supersteps_auto": 105, "supersteps_static": 158, "decisions": 3,
        "decision_windows": [8000]},
    "gossip_100k_spec": {
        "speculation_gain_frac": 0.5665, "rollbacks": 0,
        "rollback_rate": 0.0, "supersteps_spec": 189,
        "supersteps_conservative": 436, "windows": [1000, 2000, 4000],
        "floor_us": 500},
    "gossip_100k_record": {
        "record_events": {"deliveries": {"events": 4068, "dropped": 0},
                          "full": {"events": 8136, "dropped": 0}},
        "record_cap": 4096},
    "sweep_hetero": {
        "worlds": 5, "buckets": 4, "retries": 1, "splits": 0,
        "budget_efficiency": 0.7983, "pad_waste_frac": 0.0,
        "first_fit_budget_efficiency": 0.6755,
        "first_fit_pad_waste_frac": 0.0, "pack_decisions": 4},
    "sweep_hetero_auto": {
        "worlds": 4, "controller_worlds": 3, "decisions_journaled": 5,
        "retries": 1},
    "search_gossip": {
        "evaluations": 31, "generations": 2, "found": True,
        "fork_saving_frac": 0.2473, "forks": 1,
        "minimized": "partition:0-3|4-63:1000:1001", "minimized_events": 1},
    # both legs' packing rollups (and a repack's decisions) depend on when
    # the mid-bucket admissions land, in wall time; the counts and the
    # forecaster fitted from the first leg's results do not
    "serve_gossip": {
        "worlds": 8, "buckets": 1, "engine_builds": 1,
        "predictor_sha": "624e9308e174"},
    "lint_sweep": {
        "lint_subjects": 14, "pack_files": 2, "pack_configs": 9,
        "jaxpr_subjects": 47},
}


#: the configs that run a service, a campaign or the lint corpus:
#: ``tests/test_torch_bench_parity.py`` runs them (the two files' halves
#: take about as long each)
SERVICES = ("lint_sweep", "search_gossip", "serve_gossip", "sweep_hetero",
            "sweep_hetero_auto")


@pytest.mark.parametrize(
    "cfg", sorted(set(bench_cuda.CONFIGS) - set(SERVICES)))
def test_bench_config_runs(cfg):
    check_config(cfg)


def check_config(cfg):
    """``bench_cuda._run_config`` at the reference test's size on the CPU,
    with ``test_bench_config_runs``' assertions and :data:`REF_FIELDS`."""
    n, steps = NODES[cfg], _steps(cfg)
    metric, rate, extra = bench_cuda._run_config(cfg, n, steps, CPU)
    assert rate > 0
    assert str(n) in metric
    if cfg == "gossip_100k_chaos":
        # every world's schedule bites, and nothing is dropped by routing
        assert all(v > 0 for v in extra["fault_dropped"])
        assert all(v == 0 for v in extra["route_drop"])
    if cfg == "gossip_100k_spec":
        assert extra["speculation_gain_frac"] > 0
        assert extra["supersteps_spec"] < extra["supersteps_conservative"]
        assert 0.0 <= extra["rollback_rate"] <= 1.0
        assert extra["rollbacks"] >= 0
    if cfg == "serve_gossip":
        # one 8-slot bucket, one engine build across every mid-bucket
        # admission
        assert extra["worlds"] == 8
        assert extra["buckets"] == 1
        assert extra["engine_builds"] == 1
        assert extra["compiles"] >= 0
        assert extra["admit_per_s"] > 0
        assert 0 <= extra["submit_p50_s"] <= extra["submit_p95_s"]
        assert extra["delivered_per_s"] > 0
    if cfg == "search_gossip":
        assert extra["found"] is True
        assert extra["fork_saving_frac"] > 0
        assert extra["minimized"] and extra["minimized_events"] >= 1
        assert extra["evaluations"] > 0
    if cfg == "lint_sweep":
        assert extra["lint_subjects"] > 0
        assert extra["jaxpr_subjects"] > 0
        assert extra["pack_files"] >= 2
        assert extra["pack_configs"] > extra["pack_files"]
        assert all(extra[k] >= 0 for k in
                   ("sanitizer_s", "plan_s", "jaxpr_s"))
    if cfg == "gossip_100k_record":
        assert set(extra["record_overhead_frac"]) == {"deliveries", "full"}
        assert extra["record_events"]["deliveries"]["events"] > 0
        assert extra["record_events"]["full"]["events"] \
            > extra["record_events"]["deliveries"]["events"]
    if cfg.endswith("_insert"):
        # the one insertion stage: on the CPU both legs are the plain
        # versions, bit-equal (the gate ran in the config); the bytes and
        # the roofline constant ride the line
        assert extra["insert_resolved"] == "plain"
        assert extra["insert_stage_entries"] > 0
        assert extra["insert_bytes_per_step"] > 0
        assert extra["insert_stage_ms"] > 0 and extra["insert_hbm_frac"] > 0
        assert extra["hbm_gbps_assumed"] == 3350.0
    if cfg in ("gossip_100k_b8", "serve_gossip"):
        assert extra["compiles"] == 0
    if cfg in REF_FIELDS:
        assert {k: extra[k] for k in REF_FIELDS[cfg]} == REF_FIELDS[cfg]


@pytest.mark.slow
@pytest.mark.parametrize("cfg", sorted(REF_FIELDS))
def test_reference_fields_are_bench_py_s(cfg):
    import bench
    _, _, extra = bench._run_config(cfg, NODES[cfg], _steps(cfg))
    assert {k: extra[k] for k in REF_FIELDS[cfg]} == REF_FIELDS[cfg]

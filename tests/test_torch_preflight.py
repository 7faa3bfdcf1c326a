"""The port's pre-flight verification against the JAX package's, mirroring
tests/test_zzzzzzzzzzpreflight.py: the plan lint (TW6xx,
``analysis/plan_lint.py``) gives the reference's findings — code,
severity and subject — on the same pack JSON, the two example packs
included; the fault-aware capacity proofs (TW205/TW206) and
``max_delay_us`` agree over the port's link models and schedules; a torch
twin of every determinism-sanitizer fixture raises the reference's TW7xx
code; the engine-body scan and the off-mode neutrality proof (TW705) hold
on ``TorchEngine`` and ``EdgeEngine`` and catch a leaking plane; and the
gates the lint rides — the sweep service's pack refusal before any build,
the serve frontend's admission refusal with nothing journaled, admission
with lint off unchanged. (The reference's three CLI schema tests wait for
the port's CLI.)

Tolerance: exact (finding codes, severities and subjects).
"""

import json
import os

import numpy as np
import pytest
import torch

from timewarp_tpu.analysis import lint_capacity_faulted as jfaulted
from timewarp_tpu.analysis import lint_pack_json as jlint_pack_json
from timewarp_tpu.analysis import lint_pack_path as jlint_pack_path
from timewarp_tpu.analysis import lint_run_config as jlint_run_config
from timewarp_tpu.analysis import lint_scenario as jlint_scenario
from timewarp_tpu.faults.schedule import parse_faults as jparse_faults
from timewarp_tpu.sweep.spec import RunConfig as JRunConfig
from timewarp_tpu_torch.analysis import (LintError, lint_capacity_faulted,
                                         lint_engine_jaxpr, lint_pack_json,
                                         lint_pack_path, lint_run_config,
                                         lint_scenario, max_delay_us,
                                         prove_mode_neutrality,
                                         scan_jaxpr_determinism)
from timewarp_tpu_torch.analysis.jaxpr_lint import trace_graph
from timewarp_tpu_torch.core.scenario import NEVER, Outbox, Scenario
from timewarp_tpu_torch.faults.schedule import parse_faults
from timewarp_tpu_torch.net.delays import (FixedDelay, LogNormalDelay,
                                           Quantize, UniformDelay, WithDrop)
from timewarp_tpu_torch.sweep.spec import RunConfig

import test_analysis as ja  # the reference fixtures' jax steps

# one intra-op thread per test process: the test session's workers
# share the host's cores (a process of the default width each
# oversubscribes them several times over)
torch.set_num_threads(1)


def _found(rep):
    return sorted((f.code, f.severity, f.subject) for f in rep.findings)


def _same_json(data):
    """The port's and the reference's ``lint_pack_json`` on ``data``:
    ``(n, port report)`` after asserting equal findings."""
    n, rep = lint_pack_json(data)
    jn, jrep = jlint_pack_json(data)
    assert n == jn
    assert _found(rep) == _found(jrep), (rep.render(), jrep.render())
    return n, rep


def _same_cfg(d):
    rep = lint_run_config(RunConfig.from_json(d, 0))
    jrep = jlint_run_config(JRunConfig.from_json(d, 0))
    assert _found(rep) == _found(jrep), (rep.render(), jrep.render())
    return rep


# ----------------------------------------------------------------------
# plan lint (TW6xx)
# ----------------------------------------------------------------------

def test_plan_lint_clean_heterogeneous_pack_with_fault_fleets():
    n, rep = _same_json({"worlds": [
        {"scenario": "gossip", "params": {"nodes": 16},
         "link": "fixed:1000"},
        {"scenario": "gossip", "params": {"nodes": 16},
         "link": "fixed:1000", "seed": 1,
         "faults": "crash:3:5s:9s:reset"},
        {"scenario": "token-ring", "params": {"nodes": 8},
         "link": "fixed:1000",
         "faults": "crash:1:5s:9s:reset; partition:0-3|4-7:2s:4s"},
        {"scenario": "praos", "params": {"nodes": 8},
         "link": "uniform:1000:5000"},
    ]})
    assert n == 4 and rep.ok, rep.render()
    plan = [f for f in rep.infos if f.code == "TW601"]
    assert len(plan) == 1 and "4 world(s)" in plan[0].message
    assert "engine build(s)" in plan[0].message
    assert "fault pads" in plan[0].message


def test_plan_lint_predicts_bucket_sharing():
    world = {"scenario": "gossip", "params": {"nodes": 16},
             "link": "fixed:1000"}
    _, rep = _same_json([world, {**world, "id": "twin", "seed": 7}])
    plan = next(f for f in rep.infos if f.code == "TW601")
    assert "-> 1 bucket(s)" in plan.message
    assert "fleet widths [2]" in plan.message


def test_plan_lint_refuses_controller_times_speculate():
    _, rep = _same_json([
        {"scenario": "gossip", "params": {"nodes": 16},
         "controller": "auto", "speculate": "auto"}])
    assert not rep.ok and "TW600" in [f.code for f in rep.errors]
    assert "decision source" in rep.errors[0].message


def test_plan_lint_flags_degrade_window_undercut():
    rep = _same_cfg({"scenario": "gossip", "params": {"nodes": 16},
                     "link": "uniform:1000:5000", "window": 900,
                     "faults": "degrade:all:all:1s:2s:0.1:0"})
    tw602 = [f for f in rep.errors if f.code == "TW602"]
    assert len(tw602) == 1 and "degrades" in tw602[0].message


def test_plan_lint_window_within_floor_is_clean():
    assert _same_cfg({"scenario": "gossip", "params": {"nodes": 16},
                      "link": "uniform:1000:5000", "window": 1000}).ok


def test_plan_lint_flags_doomed_fixed_horizon():
    rep = _same_cfg({"scenario": "gossip", "params": {"nodes": 16},
                     "link": "fixed:5000", "window": "auto",
                     "speculate": "fixed:3000"})
    assert "TW603" in [f.code for f in rep.errors]
    assert _same_cfg({"scenario": "gossip", "params": {"nodes": 16},
                      "link": "fixed:5000", "window": "auto",
                      "speculate": "fixed:16000"}).ok


def test_plan_lint_flags_pad_growth_rebuild():
    base = {"scenario": "gossip", "params": {"nodes": 16},
            "link": "fixed:1000"}
    a = {**base, "id": "a", "faults": "crash:1:5s:9s:reset"}
    b = {**base, "id": "b",
         "faults": "crash:1:5s:9s:reset; crash:2:5s:9s:reset"}
    _, rep = _same_json([a, b])
    assert rep.ok
    tw605 = [f for f in rep.warnings if f.code == "TW605"]
    assert len(tw605) == 1 and "'b'" in tw605[0].subject
    assert "REBUILD" in tw605[0].message
    _, rep2 = _same_json([b, a])     # front-load the widest schedule
    assert not [f for f in rep2.warnings if f.code == "TW605"]


def test_plan_lint_malformed_entries_become_findings():
    n, rep = _same_json([
        {"scenario": "gossip", "params": {"nodes": 16},
         "link": "fixed:1000"},
        {"scenario": "warp-drive"},
        "not an object",
    ])
    assert n == 3 and not rep.ok
    assert [f.code for f in rep.errors].count("TW600") == 2
    assert any(f.code == "TW601" for f in rep.infos)


def test_plan_lint_bad_file_is_a_finding(tmp_path):
    p = tmp_path / "pack.json"
    p.write_text("{not json")
    _, rep = lint_pack_path(str(p))
    assert not rep.ok and rep.errors[0].code == "TW600"
    _, rep = lint_pack_path(str(tmp_path / "absent.json"))
    assert not rep.ok and "unreadable" in rep.errors[0].message


PACKS = os.path.join(os.path.dirname(__file__), os.pardir, "examples",
                     "packs")


@pytest.mark.parametrize("name", sorted(
    p for p in os.listdir(PACKS) if p.endswith(".json")))
def test_example_packs_lint_as_reference(name):
    path = os.path.join(PACKS, name)
    n, rep = lint_pack_path(path)
    jn, jrep = jlint_pack_path(path)
    assert n == jn and _found(rep) == _found(jrep), \
        (rep.render(), jrep.render())
    if "doomed" in name:
        # the three seeded dooms: controller x speculate, a degrade
        # undercut and a provable faulted overflow
        assert {"TW600", "TW602", "TW205"} <= {f.code for f in rep.errors}
    else:
        assert rep.ok, rep.render()


# ----------------------------------------------------------------------
# fault-aware capacity proofs (TW205/TW206)
# ----------------------------------------------------------------------

def test_max_delay_us_bounds():
    assert max_delay_us(FixedDelay(1000)) == 1000
    assert max_delay_us(UniformDelay(1000, 5000)) == 5000
    assert max_delay_us(WithDrop(UniformDelay(1000, 5000), 0.1)) == 5000
    assert max_delay_us(Quantize(UniformDelay(1000, 5000), 300)) == 5100
    assert max_delay_us(LogNormalDelay(2000, 0.5, cap_us=60_000)) == 60_000

    class FnDelay:
        pass
    assert max_delay_us(FnDelay()) is None


def _funnel(cap=4, sd=None):
    return Scenario(name="funnel", n_nodes=4, step=None,
                    init_batched=None, payload_width=1, mailbox_cap=cap,
                    static_dst=np.zeros((4, 1), np.int32) if sd is None
                    else sd)


@pytest.mark.parametrize("spec,sd,cap", [
    ("degrade:all:all:1s:2s:4.0:0", None, 4),
    ("degrade:all:all:1s:2s:1.0:10ms", None, 4),
    ("degrade:all:all:1s:2s:0.5:0", None, 4),
    ("crash:1:5s:9s:reset", None, 4),
    ("degrade:all:all:1s:2s:4.0:0; " + "; ".join(
        f"crash:{i}:0s:3s:reset" for i in range(4)), None, 4),
    ("degrade:all:all:1s:2s:4.0:0; partition:0|1-3:0s:3s",
     np.array([[-1], [0], [0], [0]], np.int32), 3),
    ("degrade:all:all:1s:2s:4.0:0",
     np.array([[-1], [0], [0], [0]], np.int32), 3),
], ids=["pileup", "extra-only", "shrink", "crash-only", "crash-relief",
        "partition-relief", "partition-absent"])
def test_faulted_capacity_as_reference(spec, sd, cap):
    link, jlink = UniformDelay(1000, 5000), ja.UniformDelay(1000, 5000)
    rep = lint_capacity_faulted(_funnel(cap, sd), parse_faults(spec), link,
                                1000)
    jsc = ja._mk(ja._ok_step, name="funnel", mailbox_cap=cap,
                 static_dst=np.zeros((4, 1), np.int32) if sd is None
                 else sd)
    jrep = jfaulted(jsc, jparse_faults(spec), jlink, 1000)
    assert _found(rep) == _found(jrep)
    assert [f.message for f in rep.findings] == \
        [f.message for f in jrep.findings]


def test_faulted_capacity_rides_run_config_lint():
    rep = _same_cfg({"scenario": "token-ring",
                     "params": {"nodes": 8, "with_observer": False,
                                "mailbox_cap": 1},
                     "link": "uniform:1000:5000", "window": 1000,
                     "faults": "degrade:all:all:1s:2s:6.0:0"})
    assert "TW205" in [f.code for f in rep.errors]


# ----------------------------------------------------------------------
# determinism sanitizer (TW7xx): a torch twin per reference fixture
# ----------------------------------------------------------------------

def _out(now):
    L = now.shape[0]
    return Outbox(valid=torch.zeros((1, L), dtype=torch.bool),
                  dst=torch.zeros((1, L), dtype=torch.int32),
                  payload=torch.zeros((1, 1, L), dtype=torch.int32))


def _mk(step, **kw):
    kw.setdefault("init_batched", lambda n, dev: (
        {"x": torch.zeros(n, dtype=torch.int32, device=dev)},
        torch.zeros(n, dtype=torch.int64, device=dev)))
    return Scenario(name="fixture", n_nodes=4, step=step, payload_width=1,
                    mailbox_cap=4, **kw)


def _float_scatter(state, inbox, now, i, bits):
    acc = torch.zeros((4, now.shape[0]), dtype=torch.float32)
    acc = acc.scatter_add(0, inbox.src.long(),
                          torch.full(inbox.src.shape, 1.5))
    x = state["x"] + acc.sum(0).to(torch.int32)
    return {"x": x}, _out(now), torch.full_like(now, NEVER)


def _int_scatter(state, inbox, now, i, bits):
    acc = torch.zeros((4, now.shape[0]), dtype=torch.int32)
    acc = acc.scatter_add(0, inbox.src.long(), torch.ones_like(inbox.src))
    return {"x": state["x"] + acc.sum(0, dtype=torch.int32)}, _out(now), \
        torch.full_like(now, NEVER)


def _transcendental(state, inbox, now, i, bits):
    lam = torch.exp(now.to(torch.float32) / 1e6)
    return {"x": state["x"] + lam.to(torch.int32)}, _out(now), \
        torch.full_like(now, NEVER)


@pytest.mark.parametrize("step,jstep,kw,code", [
    (_float_scatter, "float_scatter", {"inbox_src": True}, "TW701"),
    (_int_scatter, "int_scatter", {"inbox_src": True}, None),
    (_transcendental, "transcendental", {}, "TW702"),
], ids=["float-scatter-add", "integer-scatter-add", "transcendental"])
def test_step_sanitizer_as_reference(step, jstep, kw, code):
    import jax.numpy as jnp

    def j_float_scatter(state, inbox, now, i, key):
        acc = jnp.zeros((4,), jnp.float32).at[inbox.src].add(1.5)
        s = {"x": state["x"] + acc.sum().astype(jnp.int32)}
        return s, ja._out(), jnp.int64(NEVER)

    def j_int_scatter(state, inbox, now, i, key):
        acc = jnp.zeros((4,), jnp.int32).at[inbox.src].add(1)
        return {"x": state["x"] + acc.sum()}, ja._out(), jnp.int64(NEVER)

    def j_transcendental(state, inbox, now, i, key):
        lam = jnp.exp(now.astype(jnp.float32) / 1e6)
        s = {"x": state["x"] + lam.astype(jnp.int32)}
        return s, ja._out(), jnp.int64(NEVER)
    jsteps = {"float_scatter": j_float_scatter,
              "int_scatter": j_int_scatter,
              "transcendental": j_transcendental}
    rep = lint_scenario(_mk(step, **kw))
    jrep = jlint_scenario(ja._mk(jsteps[jstep], **kw))
    tw7 = sorted((f.code, f.severity) for f in rep.findings
                 if f.code.startswith("TW7"))
    assert tw7 == sorted((f.code, f.severity) for f in jrep.findings
                         if f.code.startswith("TW7"))
    if code is None:
        assert not tw7
    else:
        assert code in [c for c, _ in tw7]
    # TW103 rides the transcendental's float time, in both packages
    # (the integer twin's reference sum widens to int64 under x64 — a
    # TW106 of jax's promotion, not of the sanitizer)
    assert ("TW103" in rep.codes()) == ("TW103" in jrep.codes()) \
        == (code == "TW702")


def test_sanitizer_flags_host_read_in_traced_code():
    def driver(x):
        v = x.max().item()
        return x + v
    gm = trace_graph(driver, [torch.zeros(4, dtype=torch.int64)])
    rep = scan_jaxpr_determinism(gm, "planted")
    assert "TW704" in [f.code for f in rep.errors]
    rep2 = scan_jaxpr_determinism(gm, "planted", host_escapes=False)
    assert "TW704" not in [f.code for f in rep2.findings]


def test_sanitizer_flags_non_threefry_rng():
    gm = trace_graph(lambda x: x + torch.rand(4),
                     [torch.zeros(4, dtype=torch.float32)])
    rep = scan_jaxpr_determinism(gm, "planted")
    assert "TW703" in [f.code for f in rep.errors]


def test_lint_ignore_suppresses_tw7xx():
    sc = _mk(_float_scatter, inbox_src=True,
             meta={"lint_ignore": ["TW701"]})
    assert lint_scenario(sc).ok


def test_engine_body_scan_and_neutrality_proof():
    """tests/test_zzzzzzzzzzpreflight.py's ``jaxpr_sweep(["token-ring"],
    nodes=8)``: both engines' bodies scan clean (the kernels as their
    opaque nodes), both neutrality proofs land."""
    from timewarp_tpu_torch.interp.torch_engine.edge_engine import \
        EdgeEngine
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.models.token_ring import (token_ring,
                                                      token_ring_links)
    sc = token_ring(8)
    lean = token_ring(8, with_observer=False)
    builds = {
        "token-ring/general": lambda **kw: TorchEngine(
            sc, token_ring_links(8), device="cpu", **kw),
        "token-ring/edge": lambda **kw: EdgeEngine(
            lean, UniformDelay(1000, 5000), device="cpu", **kw),
    }
    for subject, build in builds.items():
        rep = lint_engine_jaxpr(build(), subject)
        assert rep.ok and not rep.findings, rep.render()
        proof = prove_mode_neutrality(build, subject)
        assert [(f.code, f.severity) for f in proof.findings] == \
            [("TW705", "info")], proof.render()


def test_engine_body_scan_sees_an_injected_host_read():
    """A ``.item()`` slipped into the superstep body is a TW704."""
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.models.gossip import gossip
    eng = TorchEngine(gossip(64, burst=True), FixedDelay(2_000),
                      window="auto", device="cpu")
    body = eng._superstep

    def leaky(st, node_next, t, with_trace):
        seen = st.steps.sum().item()        # read back, used as data
        return body(st._replace(steps=st.steps + seen), node_next, t,
                    with_trace)
    eng._superstep = leaky
    rep = lint_engine_jaxpr(eng, "leaky")
    assert "TW704" in [f.code for f in rep.errors], rep.render()


def test_neutrality_proof_catches_a_leaking_plane():
    class FakeEngine:
        def __init__(self, scale):
            self.scale = scale

        def init_state(self):
            return torch.zeros(2)

        def _lint_body(self, s):
            return s * self.scale

    def build(telemetry="counters", **kw):
        # telemetry='off' traces a DIFFERENT body — the defect
        return FakeEngine(3.0 if telemetry == "off" else 2.0)

    rep = prove_mode_neutrality(build, "fake")
    bad = [f for f in rep.errors if f.code == "TW705"]
    assert len(bad) == 1 and "telemetry" in bad[0].message


# ----------------------------------------------------------------------
# the gates: sweep pre-flight, serve admission
# ----------------------------------------------------------------------

DOOMED = {"scenario": "gossip", "params": {"nodes": 16},
          "link": "uniform:1000:5000", "window": 900,
          "faults": "degrade:all:all:1s:2s:0.1:0"}
CLEAN = {"scenario": "gossip", "params": {"nodes": 16},
         "link": "fixed:1000"}


def test_sweep_service_refuses_doomed_pack_pre_build(tmp_path):
    from timewarp_tpu_torch.sweep.service import SweepService
    from timewarp_tpu_torch.sweep.spec import SweepPack
    pack = SweepPack.from_json([DOOMED])
    with pytest.raises(LintError) as ei:
        SweepService(pack, str(tmp_path / "j"), lint="error", device="cpu")
    assert "TW602" in str(ei.value)
    # refused BEFORE any engine build or bucket journaling
    assert not (tmp_path / "j").exists() \
        or not any((tmp_path / "j").iterdir())
    # warn (the default) admits the same pack, the findings to the log
    svc = SweepService(pack, str(tmp_path / "j2"), device="cpu")
    assert svc.lint == "warn"


def test_sweep_engines_share_their_shape_lint():
    """The sweep's solo twins and bucket engines of one (family, params)
    shape take one cached construction lint (each builds its own
    scenario object); ``lint="off"`` looks at nothing; a fault spec is
    parsed once."""
    from timewarp_tpu_torch.sweep.bucket import (build_bucket_engine,
                                                 plan_buckets)
    from timewarp_tpu_torch.sweep.spec import SweepPack, solo_engine
    crashy = {**CLEAN, "faults": "crash:3:5000:12000"}
    pack = SweepPack.from_json([{**crashy, "id": "c0"},
                                {**crashy, "id": "c1", "seed": 1}])
    a, b = (solo_engine(c, device="cpu") for c in pack.configs)
    assert a.scenario is not b.scenario
    assert a.lint_report is b.lint_report and a.lint_report.ok
    eng = build_bucket_engine(plan_buckets(list(pack.configs))[0],
                              device="cpu")
    assert eng.lint_report is a.lint_report
    assert solo_engine(pack.configs[0], lint="off",
                       device="cpu").lint_report is None
    x, y = pack.configs
    assert x.parse_faults() is y.parse_faults()


def test_serve_admission_refuses_with_finding_and_no_journal(tmp_path):
    from timewarp_tpu_torch.serve.frontend import (ServeFrontend,
                                                   ServeRejected)
    from timewarp_tpu_torch.sweep.journal import SweepJournal
    journal = SweepJournal(str(tmp_path), host="h0")
    front = ServeFrontend(journal, "h0", ("127.0.0.1", 1), lint="error")
    with pytest.raises(ServeRejected) as ei:
        front.admit({**DOOMED, "id": "bad0"})
    msg = str(ei.value)
    assert "TW602" in msg and "pre-flight" in msg
    recs = SweepJournal(str(tmp_path)).scan()
    assert "bad0" not in recs.admits and not recs.serve_buckets
    rid, _, _ = front.admit({**CLEAN, "id": "ok0"})
    assert rid == "ok0"
    assert "ok0" in SweepJournal(str(tmp_path)).scan().admits
    journal.close()


def test_serve_admission_lint_off_is_unchanged(tmp_path):
    from timewarp_tpu_torch.serve.frontend import ServeFrontend
    from timewarp_tpu_torch.sweep.journal import SweepJournal
    journal = SweepJournal(str(tmp_path), host="h0")
    front = ServeFrontend(journal, "h0", ("127.0.0.1", 1))
    rid, _, _ = front.admit({**DOOMED, "id": "d0"})
    assert rid == "d0"               # off = the pre-gate behavior
    journal.close()


def test_pack_json_refuses_a_non_list():
    _same_json({"worlds": "nope"})
    n, rep = _same_json(json.loads("[]"))
    assert n == 0 and not rep.ok

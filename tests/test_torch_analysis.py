"""The port's scenario sanitizer (``timewarp_tpu_torch/analysis/``) against
the JAX package's, mirroring tests/test_analysis.py: a torch twin of every
seeded-defect fixture gives the reference's finding codes (and
severities) over the same declarations; every shipped model lints clean
with the reference's codes at every severity, the commutative-inbox probe
included; the AST program lint gives the reference's findings on the same
sources and passes the port's effect programs and the reference's
``models/*_net.py``; and every engine's construction ``lint=`` knob
behaves (``"error"`` raises ``LintError`` on a defect, ``"warn"`` keeps
the report, ``"off"`` looks at nothing), the oracle's and the sharded
engines' included (the latter in tests/torch_sharded_cases.py).

Tolerance: exact (finding codes and severities).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from timewarp_tpu.analysis import lint_capacity as jlint_capacity
from timewarp_tpu.analysis import lint_scenario as jlint
from timewarp_tpu.analysis import lint_source as jlint_source
from timewarp_tpu.analysis import \
    probe_commutative_inbox as jprobe
from timewarp_tpu.core.scenario import Outbox as JOutbox
from timewarp_tpu.core.scenario import Scenario as JScenario
from timewarp_tpu.models import gossip as jg
from timewarp_tpu.models import ping_pong as jpp
from timewarp_tpu.models import praos as jpr
from timewarp_tpu.models import socket_state as jss
from timewarp_tpu.models import token_ring as jtr
from timewarp_tpu.net import delays as jd
from timewarp_tpu_torch.analysis import (LintError, lint_capacity,
                                         lint_module_programs,
                                         lint_scenario, lint_source,
                                         probe_commutative_inbox,
                                         worst_case_fan_in)
from timewarp_tpu_torch.core.scenario import NEVER, Outbox, Scenario
from timewarp_tpu_torch.models import gossip as tg
from timewarp_tpu_torch.models import ping_pong as tpp
from timewarp_tpu_torch.models import praos as tpr
from timewarp_tpu_torch.models import socket_state as tss
from timewarp_tpu_torch.models import token_ring as ttr
from timewarp_tpu_torch.net.delays import FixedDelay, UniformDelay

# one intra-op thread per test process: the test session's workers
# share the host's cores (a process of the default width each
# oversubscribes them several times over)
torch.set_num_threads(1)

CPU = "cpu"


# ----------------------------------------------------------------------
# fixtures: a torch step and its reference twin per defect class
# ----------------------------------------------------------------------

def _out(now, M=1, P=1):
    L = now.shape[0]
    return Outbox(valid=torch.zeros((M, L), dtype=torch.bool),
                  dst=torch.zeros((M, L), dtype=torch.int32),
                  payload=torch.zeros((M, P, L), dtype=torch.int32))


def _never(now):
    return torch.full_like(now, NEVER)


def _init_x(n, dev):
    return ({"x": torch.zeros(n, dtype=torch.int32, device=dev)},
            torch.zeros(n, dtype=torch.int64, device=dev))


def _mk(step, name="fixture", **kw):
    kw.setdefault("n_nodes", 4)
    kw.setdefault("payload_width", 1)
    kw.setdefault("max_out", 1)
    kw.setdefault("mailbox_cap", 4)
    kw.setdefault("init_batched", _init_x)
    return Scenario(name=name, step=step, **kw)


def _jout(M=1, P=1):
    return JOutbox(valid=jnp.zeros((M,), bool),
                   dst=jnp.zeros((M,), jnp.int32),
                   payload=jnp.zeros((M, P), jnp.int32))


def _jmk(step, name="fixture", **kw):
    kw.setdefault("n_nodes", 4)
    kw.setdefault("payload_width", 1)
    kw.setdefault("max_out", 1)
    kw.setdefault("mailbox_cap", 4)
    kw.setdefault("init", lambda i: ({"x": jnp.int32(0)}, 0))
    return JScenario(name=name, step=step, **kw)


def _ok(state, inbox, now, i, bits):
    return state, _out(now), _never(now)


def _jok(state, inbox, now, i, key):
    return state, _jout(), jnp.int64(2**62 - 1)


def _codes(rep, severity=None):
    return sorted((f.code, f.severity) for f in rep.findings
                  if severity is None or f.severity == severity)


# -- the seeded defects, twin by twin ------------------------------------

def _host_read(state, inbox, now, i, bits):
    stall = now.max().item()            # a value read back to the host
    return state, _out(now), now + stall


def _j_host_read(state, inbox, now, i, key):
    jax.debug.callback(lambda v: None, now)
    return state, _jout(), jnp.int64(2**62 - 1)


def _trunc(state, inbox, now, i, bits):
    d = torch.div(now, 2, rounding_mode="floor").to(torch.int32)
    return state, _out(now), d.to(torch.int64) + 5


def _j_trunc(state, inbox, now, i, key):
    d = (now // 2).astype(jnp.int32)
    return state, _jout(), d.astype(jnp.int64) + 5


def _inbox_trunc(state, inbox, now, i, bits):
    t0 = inbox.time.amin(dim=0).to(torch.int32)
    return state, _out(now), t0.to(torch.int64) + 10


def _j_inbox_trunc(state, inbox, now, i, key):
    t0 = inbox.time.min().astype(jnp.int32)
    return state, _jout(), t0.astype(jnp.int64) + 10


def _float_time(state, inbox, now, i, bits):
    return state, _out(now), (now * 1.5).to(torch.int64)


def _j_float_time(state, inbox, now, i, key):
    return state, _jout(), (now * 1.5).astype(jnp.int64)


def _clean_time(state, inbox, now, i, bits):
    due = now >= 5                      # bool kills the taint
    x = state["x"] + due.to(torch.int32)
    return {"x": x}, _out(now), now + 1000


def _j_clean_time(state, inbox, now, i, key):
    due = now >= jnp.int64(5)
    x = state["x"] + due.astype(jnp.int32)
    return {"x": x}, _jout(), now + jnp.int64(1000)


def _narrow_wake(state, inbox, now, i, bits):
    return state, _out(now), torch.full_like(now, 5, dtype=torch.int32)


def _j_narrow_wake(state, inbox, now, i, key):
    return state, _jout(), jnp.int32(5)


def _bad_outbox(state, inbox, now, i, bits):
    L = now.shape[0]
    out = Outbox(valid=torch.zeros((2, L), dtype=torch.bool),   # M=1
                 dst=torch.zeros((1, L), dtype=torch.int32),
                 payload=torch.zeros((1, L), dtype=torch.int32))  # no P
    return state, out, _never(now)


def _j_bad_outbox(state, inbox, now, i, key):
    out = JOutbox(valid=jnp.zeros((2,), bool),
                  dst=jnp.zeros((1,), jnp.int32),
                  payload=jnp.zeros((1,), jnp.int32))
    return state, out, jnp.int64(2**62 - 1)


def _float_payload(state, inbox, now, i, bits):
    L = now.shape[0]
    out = Outbox(valid=torch.zeros((1, L), dtype=torch.bool),
                 dst=torch.zeros((1, L), dtype=torch.int32),
                 payload=torch.zeros((1, 1, L), dtype=torch.float32))
    return state, out, _never(now)


def _j_float_payload(state, inbox, now, i, key):
    out = JOutbox(valid=jnp.zeros((1,), bool),
                  dst=jnp.zeros((1,), jnp.int32),
                  payload=jnp.zeros((1, 1), jnp.float32))
    return state, out, jnp.int64(2**62 - 1)


def _unstable(state, inbox, now, i, bits):
    return {"x": state["x"].to(torch.int64)}, _out(now), _never(now)


def _j_unstable(state, inbox, now, i, key):
    return {"x": state["x"].astype(jnp.int64)}, _jout(), \
        jnp.int64(2**62 - 1)


def _uses_key(state, inbox, now, i, bits):
    b0, _ = bits
    return {"x": state["x"] + (b0 > 0).to(torch.int32)}, _out(now), \
        _never(now)


def _j_uses_key(state, inbox, now, i, key):
    b0, _ = key
    x = state["x"] + (b0 > 0).astype(jnp.int32)
    return {"x": x}, _jout(), jnp.int64(2**62 - 1)


def _reads_src(state, inbox, now, i, bits):
    return {"x": state["x"] + inbox.src.amax(dim=0)}, _out(now), \
        _never(now)


def _j_reads_src(state, inbox, now, i, key):
    return {"x": state["x"] + inbox.src.max()}, _jout(), \
        jnp.int64(2**62 - 1)


def _untraceable(state, inbox, now, i, bits):
    if bool((now > 0).any()):           # host branching on a value
        return state, _out(now), _never(now)
    return state, _out(now), _never(now)


def _j_untraceable(state, inbox, now, i, key):
    if int(now) > 0:
        return state, _jout(), jnp.int64(2**62 - 1)
    return state, _jout(), jnp.int64(2**62 - 1)


DEFECTS = {
    # name: (torch step, reference step, declarations, expected codes)
    "host-callback": (_host_read, _j_host_read, {}, {"TW101"}),
    "int32-time": (_trunc, _j_trunc, {}, {"TW102"}),
    "inbox-time": (_inbox_trunc, _j_inbox_trunc, {}, {"TW102"}),
    "float-time": (_float_time, _j_float_time, {}, {"TW103"}),
    "narrow-wake": (_narrow_wake, _j_narrow_wake, {}, {"TW104"}),
    "outbox-shape": (_bad_outbox, _j_bad_outbox, {}, {"TW105"}),
    "outbox-dtype": (_float_payload, _j_float_payload, {}, {"TW105"}),
    "unstable-state": (_unstable, _j_unstable, {}, {"TW106"}),
    "false-needs-key": (_uses_key, _j_uses_key, {"needs_key": False},
                        {"TW107"}),
    "conservative-key": (_ok, _jok, {"needs_key": True}, {"TW108"}),
    "false-inbox-src": (_reads_src, _j_reads_src, {"inbox_src": False},
                        {"TW109"}),
    "conservative-src": (_ok, _jok, {"inbox_src": True}, {"TW110"}),
}


@pytest.mark.parametrize("name", list(DEFECTS))
def test_seeded_defect_caught_as_reference(name):
    step, jstep, kw, want = DEFECTS[name]
    rep, jrep = lint_scenario(_mk(step, **kw)), jlint(_jmk(jstep, **kw))
    assert want <= set(rep.codes())
    assert _codes(rep) == _codes(jrep), (rep.render(), jrep.render())


def test_outbox_shape_counts_as_reference():
    rep = lint_scenario(_mk(_bad_outbox))
    assert [f.code for f in rep.errors].count("TW105") == 2


def test_int64_time_arithmetic_is_clean():
    rep = lint_scenario(_mk(_clean_time))
    assert not [f for f in rep.errors if f.code in ("TW102", "TW103")]
    assert _codes(rep) == _codes(jlint(_jmk(_j_clean_time)))


def test_untraceable_step_warns_not_crashes():
    rep = lint_scenario(_mk(_untraceable))
    assert "TW100" in [f.code for f in rep.warnings]
    assert rep.ok
    assert _codes(rep) == _codes(jlint(_jmk(_j_untraceable)))


def test_pass_through_flag_violations():
    """A bits word or inbox.src flowing straight into the returned state
    is consumed: TW107 / TW109, as in the reference."""
    def s_key(state, inbox, now, i, bits):
        return {"k": bits[0]}, _out(now), _never(now)

    def init_k(n, dev):
        return ({"k": torch.zeros(n, dtype=torch.int64, device=dev)},
                torch.zeros(n, dtype=torch.int64, device=dev))
    rep = lint_scenario(_mk(s_key, needs_key=False, init_batched=init_k,
                            u32_states=("k",)))
    assert "TW107" in [f.code for f in rep.errors]

    def s_src(state, inbox, now, i, bits):
        return {"s": inbox.src.T}, _out(now), _never(now)

    def init_s(n, dev):
        return ({"s": torch.zeros((n, 4), dtype=torch.int32, device=dev)},
                torch.zeros(n, dtype=torch.int64, device=dev))
    rep = lint_scenario(_mk(s_src, inbox_src=False, init_batched=init_s))
    assert "TW109" in [f.code for f in rep.errors]


# ----------------------------------------------------------------------
# capacity proofs
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n,sd,cap", [
    (8, np.zeros((8, 1), np.int32), 4),         # all 8 -> node 0: TW202
    (8, np.zeros((8, 1), np.int32), 8),         # the cap = the fan-in
    (4, np.full((4, 1), 9, np.int32), 4),       # out of range: TW201
    (4, np.full((4, 1), -1, np.int32), 4),      # -1 = unused is legal
    (4, None, 4),                               # dynamic: TW203 info
], ids=["overflow", "proof", "range", "unused", "dynamic"])
def test_capacity_as_reference(n, sd, cap):
    sc = _mk(_ok, n_nodes=n, static_dst=sd, mailbox_cap=cap)
    jsc = _jmk(_jok, n_nodes=n, static_dst=sd, mailbox_cap=cap)
    assert _codes(lint_capacity(sc)) == _codes(jlint_capacity(jsc))
    if sd is not None and n == 8:
        assert worst_case_fan_in(sc) == (8, 0)


# ----------------------------------------------------------------------
# commutative-inbox probe
# ----------------------------------------------------------------------

def test_probe_catches_order_dependent_step():
    def step(state, inbox, now, i, bits):
        return {"x": inbox.payload[0, 0, :]}, _out(now), _never(now)

    def jstep(state, inbox, now, i, key):
        return {"x": inbox.payload[0, 0]}, _jout(), jnp.int64(2**62 - 1)
    rep = probe_commutative_inbox(_mk(step, commutative_inbox=True),
                                  device=CPU)
    assert "TW401" in [f.code for f in rep.errors]
    assert _codes(rep) == _codes(jprobe(_jmk(jstep,
                                             commutative_inbox=True)))
    # undeclared: no probe at all
    assert not probe_commutative_inbox(
        _mk(step, commutative_inbox=False), device=CPU).findings


def test_probe_accepts_commutative_reduction():
    def step(state, inbox, now, i, bits):
        x = torch.where(inbox.valid, inbox.payload[:, 0, :], -1).amax(0)
        return {"x": x}, _out(now), _never(now)
    rep = probe_commutative_inbox(_mk(step, commutative_inbox=True),
                                  device=CPU)
    assert rep.ok and not rep.findings


def _order_dependent_step(state, inbox, now, i, bits):
    return {"x": inbox.payload[0, 0, :]}, _out(now), _never(now)


def test_probe_builds_only_the_probed_nodes():
    """The probe's cost does not grow with ``n_nodes``: a billion-node
    scenario builds the four probed nodes' states, from ``init_batched``
    or, where the scenario has one, from the per-node ``init``."""
    asked = []

    def init_batched(n, dev):
        asked.append(n)
        return _init_x(n, dev)
    sc = _mk(_order_dependent_step, n_nodes=10**9, commutative_inbox=True)
    sc.init_batched = init_batched
    assert "TW401" in probe_commutative_inbox(sc, device=CPU).codes()
    assert asked == [4]
    sc.init = lambda i: ({"x": torch.tensor(i, dtype=torch.int32)}, 0)
    assert "TW401" in probe_commutative_inbox(sc, device=CPU).codes()
    assert asked == [4]


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a host without a card")
def test_probe_runs_on_the_card_unless_asked():
    sc = _mk(_order_dependent_step, commutative_inbox=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe_commutative_inbox(sc)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lint_scenario(sc, probe=True)
    # no probe, no device: the declaration-free lint runs anywhere
    assert "TW401" not in lint_scenario(sc).codes()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the probe's step runs on the card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gossip", "praos", "socket-state"])
def test_probe_on_the_card_equals_cpu(cuda_device, name):
    bad = _mk(_order_dependent_step, commutative_inbox=True)
    assert probe_commutative_inbox(bad).codes() \
        == probe_commutative_inbox(bad, device=CPU).codes() == ["TW401"]
    sc = SHIPPED[name](_T)
    assert _codes(lint_scenario(sc, probe=True, device=cuda_device)) \
        == _codes(lint_scenario(sc, probe=True, device=CPU))


# ----------------------------------------------------------------------
# effect-program AST linter
# ----------------------------------------------------------------------

SOURCES = {
    "missing-yield-from": ("def prog():\n    wait(for_(sec(1)))\n"
                           "    yield GetTime()\n", True),
    "yield-of-combinator": ("def prog():\n    yield wait(5)\n", True),
    "lambda-factory": ("def prog():\n    yield Fork(lambda: wait(5))\n"
                       "    yield from schedule(after(10), lambda: "
                       "invoke(5, body))\n", True),
    "await-io-pure": ("def prog():\n    r = yield from await_io("
                      "sock.recv())\n    yield AwaitIO(fut)\n", True),
    "await-io-real": ("def prog():\n    r = yield from await_io("
                      "sock.recv())\n", False),
    "swallowed-killed": ("def prog():\n    try:\n        yield from "
                         "body()\n    except ThreadKilled:\n        pass\n",
                         True),
    "broad-handler": ("def prog():\n    try:\n        yield from body()\n"
                      "    except Exception:\n        log(1)\n", True),
    "repeat-forever-idiom": ("def prog():\n    try:\n        yield from "
                             "body()\n    except ThreadKilled:\n"
                             "        raise\n    except BaseException "
                             "as e:\n        nxt = handler(e)\n", True),
    "suppressed": ("def prog():\n    wait(5)  # tw-lint: ignore[TW301]\n"
                   "    unpark(tid)  # tw-lint: ignore\n", True),
}


@pytest.mark.parametrize("name", list(SOURCES))
def test_program_lint_as_reference(name):
    src, pure = SOURCES[name]
    got = lint_source(src, name="p", pure=pure)
    want = jlint_source(src, name="p", pure=pure)
    assert [(f.code, f.severity, f.location) for f in got.findings] == \
        [(f.code, f.severity, f.location) for f in want.findings]


def test_shipped_program_twins_lint_clean():
    """The port's effect programs, and the reference's ``*_net.py``
    models' source text through the port's linter."""
    import timewarp_tpu.models.gossip_net as gn
    import timewarp_tpu.models.ping_pong_net as ppn
    import timewarp_tpu.models.praos_net as prn
    import timewarp_tpu.models.socket_state_net as ssn
    import timewarp_tpu.models.token_ring_net as trn
    import timewarp_tpu_torch.core.effects as effects
    for mod in (effects, gn, ppn, prn, ssn, trn):
        rep = lint_module_programs(mod)
        assert not rep.findings, \
            f"{mod.__name__}: {[f.render() for f in rep.findings]}"


# ----------------------------------------------------------------------
# shipped models: zero error-severity findings, the reference's codes
# ----------------------------------------------------------------------

SHIPPED = {
    "ring-obs": lambda m: m[0].token_ring(32),
    "ring-lean": lambda m: m[0].token_ring(32, with_observer=False),
    "gossip": lambda m: m[1].gossip(32),
    "gossip-burst": lambda m: m[1].gossip(32, burst=True),
    "gossip-steady": lambda m: m[1].gossip(32, steady=True),
    "praos": lambda m: m[2].praos(32),
    "praos-burst": lambda m: m[2].praos(32, burst=True),
    "ping-pong": lambda m: m[3].ping_pong(),
    "socket-state": lambda m: m[4].socket_state(4),
}
_T = (ttr, tg, tpr, tpp, tss)
_J = (jtr, jg, jpr, jpp, jss)


@pytest.mark.parametrize("name", list(SHIPPED))
def test_shipped_models_lint_as_reference(name):
    rep = lint_scenario(SHIPPED[name](_T), probe=True, device=CPU)
    assert rep.ok, [f.render() for f in rep.errors]
    assert _codes(rep) == _codes(jlint(SHIPPED[name](_J), probe=True))


def test_meta_lint_ignore_suppression():
    assert "TW110" in lint_scenario(_mk(_ok, inbox_src=True)).codes()
    rep = lint_scenario(_mk(_ok, inbox_src=True,
                            meta={"lint_ignore": ["TW110", "TW203"]}))
    assert "TW110" not in rep.codes() and "TW203" not in rep.codes()


def test_lint_report_rendering_ranks_errors_first():
    rep = lint_scenario(_bad_scenario())
    assert rep.render().splitlines()[0].startswith("[ERROR")
    j = rep.to_json()
    assert j["errors"] >= 1 and j["findings"][0]["severity"] == "error"


# ----------------------------------------------------------------------
# engine-construction lint: every engine class
# ----------------------------------------------------------------------

def _bad_scenario():
    def step(state, inbox, now, i, bits):        # TW104
        return state, _out(now), torch.zeros_like(now, dtype=torch.int32)
    ring = np.array([[1], [2], [3], [0]], np.int32)
    return _mk(step, static_dst=ring, commutative_inbox=True)


def _engine_cases():
    from timewarp_tpu_torch.interp.ref.superstep import SuperstepOracle
    from timewarp_tpu_torch.interp.torch_engine.edge_engine import \
        EdgeEngine
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.interp.torch_engine.fused_ring import \
        FusedRingEngine
    from timewarp_tpu_torch.interp.torch_engine.fused_sparse import \
        FusedSparseEngine
    link = UniformDelay(1000, 5000)
    lean = ttr.token_ring(16, with_observer=False)
    return [
        ("oracle", SuperstepOracle, (ttr.token_ring(16), link)),
        ("general", TorchEngine, (ttr.token_ring(16), link)),
        ("edge", EdgeEngine, (lean, link)),
        ("fused", FusedSparseEngine,
         (tg.gossip(256, burst=True), FixedDelay(1000))),
        ("fused-ring", FusedRingEngine,
         (ttr.token_ring(64, with_observer=False), FixedDelay(1000))),
    ]


@pytest.mark.parametrize("case", _engine_cases(), ids=lambda c: c[0])
def test_engine_construction_lint_knob(case):
    _, cls, args = case
    # clean scenario: constructs even under the strict mode, report kept
    eng = cls(*args, lint="error", device=CPU)
    assert eng.lint_report is not None and eng.lint_report.ok
    # default is warn: report attached, no raise
    eng = cls(*args, device=CPU)
    assert eng.lint == "warn" and eng.lint_report is not None
    # off: no check at all
    assert cls(*args, lint="off", device=CPU).lint_report is None
    with pytest.raises(ValueError, match="lint"):
        cls(*args, lint="loud", device=CPU)


def test_engine_construction_lint_error_raises_on_defect():
    from timewarp_tpu_torch.interp.ref.superstep import SuperstepOracle
    from timewarp_tpu_torch.interp.torch_engine.edge_engine import \
        EdgeEngine
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    bad = _bad_scenario()
    link = FixedDelay(1000)
    for cls in (TorchEngine, EdgeEngine, SuperstepOracle):
        with pytest.raises(LintError) as ei:
            cls(bad, link, lint="error", device=CPU)
        assert "TW104" in ei.value.report.codes()
        cls(bad, link, lint="off", device=CPU)   # off: constructs fine
        cls(bad, link, device=CPU)               # warn: constructs fine


def test_fault_lint_rides_the_knob():
    """A schedule naming an absent node: TW501 under "error" (LintError),
    reported under "warn", not looked at under "off" — on the engines
    and the oracle, as the reference's."""
    from timewarp_tpu.faults.schedule import parse_faults as jparse
    from timewarp_tpu.interp.jax_engine.engine import JaxEngine
    from timewarp_tpu_torch.faults.schedule import parse_faults
    from timewarp_tpu_torch.interp.ref.superstep import SuperstepOracle
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    spec = "crash:99:5ms:9ms; crash:1:1ms:3ms; crash:1:3ms:4ms"
    sc, link = ttr.token_ring(16, with_observer=False), FixedDelay(1000)
    jeng = JaxEngine(jtr.token_ring(16, with_observer=False),
                     jd.FixedDelay(1000), faults=jparse(spec))
    for cls in (TorchEngine, SuperstepOracle):
        with pytest.raises(LintError, match="TW501"):
            cls(sc, link, faults=parse_faults(spec), lint="error",
                device=CPU)
        eng = cls(sc, link, faults=parse_faults(spec), device=CPU)
        assert _codes(eng.fault_lint_report) == \
            _codes(jeng.fault_lint_report)
        assert cls(sc, link, faults=parse_faults(spec), lint="off",
                   device=CPU).fault_lint_report is None

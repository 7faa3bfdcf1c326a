"""The port's causal queries and divergence bisection
(``timewarp_tpu_torch/obs/query.py``, ``obs/bisect.py``) and its
profiler session (``obs/profiler.py``) against the JAX package's,
mirroring tests/test_zzzzzflight.py's query and bisection cases: on the
same runs the port's ``explain_delivery`` chains and ``chain_lines``
equal the reference's line for line (the crash + degrade + partition
worked example, a deliveries-only log, a query with no match, the flow
arrows), ``bisect_engines`` pins the same one-line diagnostic for an
injected ``flip:`` (chunk, superstep, field, event delta), finds
nothing between bit-identical runs, and ``first_trail_divergence`` names
the same chunk. ``profile_session`` writes a Chrome trace that loads,
and degrades to a no-op without a logdir.

Tolerance: exact (every line and value).
"""

import json
import os

import pytest
import torch

from timewarp_tpu.faults.schedule import parse_faults as jparse_faults
from timewarp_tpu.integrity import FlipInjector as JFlip
from timewarp_tpu.interp.jax_engine.engine import JaxEngine
from timewarp_tpu.models import gossip as jg
from timewarp_tpu.net import delays as jd
from timewarp_tpu.obs import bisect as jbisect
from timewarp_tpu.obs import query as jquery
from timewarp_tpu_torch.faults.schedule import parse_faults
from timewarp_tpu_torch.integrity import FlipInjector
from timewarp_tpu_torch.interp.torch_engine.edge_engine import EdgeEngine
from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
from timewarp_tpu_torch.models import gossip as tg
from timewarp_tpu_torch.models import token_ring as ttr
from timewarp_tpu_torch.net import delays as td
from timewarp_tpu_torch.obs import bisect as tbisect
from timewarp_tpu_torch.obs import query as tquery
from timewarp_tpu_torch.obs.flight import EV_DELIVER

# one intra-op thread per test process: the test session's workers
# share the host's cores (a process of the default width each
# oversubscribes them several times over)
torch.set_num_threads(1)

CPU = "cpu"
STEPS = 25
FAULTS = ("crash:3:50000:120000;degrade:all:3:0:300000:2.0:500;"
          "partition:0-7|8-15:20000:40000")


def _link(d):
    return d.Quantize(d.UniformDelay(3000, 9000), 1000)


def _steady(m):
    return m.gossip(16, fanout=3, steady=True, end_us=300_000,
                    mailbox_cap=16)


@pytest.fixture(scope="module")
def faulted_logs():
    """The worked causal-chain run (steady gossip under a crash, a
    degraded-link window and a partition), recorded in full by both
    packages: ``(port log, reference log)``."""
    eng = TorchEngine(_steady(tg), _link(td), faults=parse_faults(FAULTS),
                      record="full", record_cap=1024, device=CPU)
    eng.run(200)
    jeng = JaxEngine(_steady(jg), _link(jd), lint="off",
                     faults=jparse_faults(FAULTS), record="full",
                     record_cap=1024)
    jeng.run(200)
    return eng.last_run_flight, jeng.last_run_flight


@pytest.mark.parametrize("nth", [0, 4, 7])
def test_explain_chain_equals_reference(faulted_logs, nth):
    log, jlog = faulted_logs
    assert log.dropped == 0
    hits = tquery.find_deliveries(log, dst=3)
    assert hits == jquery.find_deliveries(jlog, dst=3) and len(hits) > 5
    res = tquery.explain_delivery(log, dst=3, nth=nth, faults=FAULTS)
    want = jquery.explain_delivery(jlog, dst=3, nth=nth, faults=FAULTS)
    assert res == want
    assert tquery.chain_lines(res) == jquery.chain_lines(want)
    steps = [c["step"] for c in res["chain"]]
    assert steps[0] == "send" and steps[-1] == "deliver"
    assert "degrade" in steps
    if nth == 4:
        # a delivery due after the crash window: the whole chain
        assert "crash_window" in steps and "defer" in steps
    if nth == 0:
        assert "crash_window" not in steps


def _gossip_logs(record):
    eng = TorchEngine(tg.gossip(32, fanout=3, burst=True, end_us=150_000,
                                mailbox_cap=16), _link(td),
                      window="auto", record=record, device=CPU)
    eng.run(STEPS)
    jeng = JaxEngine(jg.gossip(32, fanout=3, burst=True, end_us=150_000,
                               mailbox_cap=16), _link(jd), window="auto",
                     lint="off", record=record)
    jeng.run(STEPS)
    return eng.last_run_flight, jeng.last_run_flight


def test_explain_deliveries_only_log_is_honest():
    log, jlog = _gossip_logs("deliveries")
    dst = int(log.dst[log.kind == EV_DELIVER][0])
    res = tquery.explain_delivery(log, dst=dst)
    assert res == jquery.explain_delivery(jlog, dst=dst)
    send = res["chain"][0]
    assert send["step"] == "send" and send.get("unknown")
    assert "record='full'" in send["why"]
    with pytest.raises(ValueError, match="no delivery to node 9999") as e:
        tquery.explain_delivery(log, dst=9999)
    with pytest.raises(ValueError) as je:
        jquery.explain_delivery(jlog, dst=9999)
    assert str(e.value) == str(je.value)


def test_flow_arrows_on_the_virtual_timeline(tmp_path):
    from timewarp_tpu_torch.obs.perfetto import TraceBuilder
    log, _ = _gossip_logs("full")
    tb = TraceBuilder(process="unit")
    n = tquery.add_flight_flows(tb, log, limit=16)
    assert 0 < n <= 16
    doc = json.loads(open(tb.save(str(tmp_path / "f.json"))).read())
    starts = [e for e in doc["traceEvents"] if e.get("ph") == "s"]
    ends = [e for e in doc["traceEvents"] if e.get("ph") == "f"]
    assert len(starts) == len(ends) == n
    assert {e["id"] for e in starts} == {e["id"] for e in ends}


# ---------------------------------------------------------------------------
# divergence bisection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("a,b,want", [
    (["a", "b", "c"], ["a", "b", "c"], None),
    (["a", "b", "c"], ["a", "x", "y"], 1),
    (["x"], ["y"], 0),
    (["a", "b"], ["a", "b", "c"], 2),
    ([], [], None),
])
def test_chain_bisect_units(a, b, want):
    assert tbisect.chain_bisect(a, b) == want == jbisect.chain_bisect(a, b)


def test_bisect_pinned_diagnostic_equals_reference():
    """An injected ``flip:1:2:mb_rel``: ONE line naming the chunk, the
    superstep, the field and the event delta — the reference's line."""
    sc = tg.gossip(32, fanout=4, burst=True, end_us=400_000, mailbox_cap=16)
    jsc = jg.gossip(32, fanout=4, burst=True, end_us=400_000,
                    mailbox_cap=16)

    def make(record="off"):
        return TorchEngine(sc, _link(td), seed=0, window="auto",
                           record=record, record_cap=4096, device=CPU)

    def jmake(record="off"):
        return JaxEngine(jsc, _link(jd), seed=0, window="auto",
                         lint="off", record=record, record_cap=4096)

    rep = tbisect.bisect_engines(
        make, make, 60, chunk=16, names=("clean", "corrupt"),
        inject_b=lambda: FlipInjector("flip:1:2:mb_rel"), basis="state")
    want = jbisect.bisect_engines(
        jmake, jmake, 60, chunk=16, names=("clean", "corrupt"),
        inject_b=lambda: JFlip("flip:1:2:mb_rel"), basis="state")
    line = rep.line()
    assert line == want.line()
    assert rep.to_json() == want.to_json()
    assert "\n" not in line and rep.chunk == 1
    assert f"superstep {rep.superstep}" in line
    assert "clean != corrupt" in line and rep.fields
    assert rep.only_a + rep.only_b > 0 and rep.first_delta in line


def test_bisect_identical_runs_report_none():
    sc = ttr.token_ring(16, n_tokens=4, think_us=2000, bootstrap_us=1000,
                        end_us=120_000, with_observer=False, mailbox_cap=8)

    def mk_gen(record="off"):
        return TorchEngine(sc, td.FixedDelay(500), seed=0, record=record,
                           device=CPU)

    def mk_edge(record="off"):
        return EdgeEngine(sc, td.FixedDelay(500), seed=0, record=record,
                          device=CPU)
    assert tbisect.bisect_engines(mk_gen, mk_edge, 30, chunk=8,
                                  basis="trace") is None
    with pytest.raises(ValueError, match="basis"):
        tbisect.bisect_engines(mk_gen, mk_edge, 30, basis="rows")


def test_first_trail_divergence_names_the_chunk():
    from timewarp_tpu_torch.sweep.spec import DIGEST_ZERO, chain_digest
    sc = ttr.token_ring(16, n_tokens=4, think_us=2000, bootstrap_us=1000,
                        end_us=120_000, with_observer=False, mailbox_cap=8)
    _, tr = TorchEngine(sc, td.FixedDelay(500), device=CPU).run(24)
    assert len(tr) >= 16

    class _Slice:
        def __init__(self, t, a, b):
            self.t, self.a, self.b = t, a, b

        def __len__(self):
            return self.b - self.a

        def row(self, i):
            return self.t.row(self.a + i)

    trail, cur = [], DIGEST_ZERO
    for hi in (8, 16, len(tr)):
        cur = chain_digest(cur, _Slice(tr, trail[-1][0] if trail else 0,
                                       hi))
        trail.append([hi, cur])
    assert tbisect.first_trail_divergence(trail, tr) is None
    bad = [list(e) for e in trail]
    bad[1][1] = "f" * 64
    d = tbisect.first_trail_divergence(bad, tr)
    assert d == jbisect.first_trail_divergence(bad, tr)
    assert d["chunk"] == 1 and d["supersteps"] == [8, 16]
    assert d["streamed"] == "f" * 64 and d["solo"] == trail[1][1]


# ---------------------------------------------------------------------------
# the profiler session
# ---------------------------------------------------------------------------

def test_profile_session_writes_a_trace(tmp_path):
    from timewarp_tpu_torch.obs.profiler import (TRACE_FILE, annotate,
                                                 profile_session)
    eng = TorchEngine(tg.gossip(32, fanout=3, burst=True, end_us=150_000,
                                mailbox_cap=16), _link(td), window="auto",
                      device=CPU)
    logdir = str(tmp_path / "prof")
    with profile_session(logdir) as got:
        with annotate("wave"):
            eng.run(8)
    assert got == logdir
    doc = json.loads(open(os.path.join(logdir, TRACE_FILE)).read())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "wave" in names
    with profile_session(None) as off:
        eng.run(2)
    assert off is None

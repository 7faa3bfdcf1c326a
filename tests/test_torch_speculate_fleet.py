"""Speculation on the port's fleets and routing regimes
(``TorchEngine(batch=..., speculate=...)``, ``route_cap``, a droppy link)
against ``JaxEngine(insert="xla", ...)``, at tests/test_zzzzzzspec.py's
shape (96 nodes, budget 3000, chunk 16), on an integer link with the
long-tail floor gap (declared 500 µs, no sample below 4 ms; exact across
backends):

- the eager (a droppy link) and lazy (``route_cap``) regimes speculate as
  the reference's do: canonical rows, traces, ``last_run_speculation``
  and decisions equal, a rollback in each, and the equivalence law
  against the port's conservative run;
- the **equivalence law** on a 2-world fleet and on a fault fleet whose
  shrink ``LinkWindow`` clamps the speculative window on the device: every
  world's canonical row equals its solo conservative run's;
- the **masked rollback**: per-world link parameters make one world
  violate and the other not; only the violating world re-runs
  (``rerun_worlds``), and ``last_run_speculation``, the per-world decision
  chains, the traces, the canonical rows and the metrics lines (the
  ``speculation`` lines; ``supersteps`` lines without the rung, the port
  having no routing ladder) equal the reference's; every world equals its
  row of one conservative fleet run;
- ``on_quiesce`` fires exactly once per world across a rollback;
- ``rebind_identity`` re-validates the conservative floor, undegraded,
  with the reference's verdicts.

Tolerance: exact.
"""

import pytest
import torch

import timewarp_tpu.faults as jf
import timewarp_tpu.speculate as jspec
from timewarp_tpu.interp.jax_engine.batched import BatchSpec as JSpec
from timewarp_tpu.interp.jax_engine.engine import JaxEngine
from timewarp_tpu.models import gossip as jg
from timewarp_tpu.net import delays as jd
from timewarp_tpu.obs.metrics import MetricsRegistry as JRegistry
from timewarp_tpu.trace.events import assert_traces_equal
import timewarp_tpu_torch.faults as tf
from timewarp_tpu_torch.interp.torch_engine.batched import BatchSpec
from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
from timewarp_tpu_torch.models import gossip as tg
from timewarp_tpu_torch.net import delays as td
from timewarp_tpu_torch.obs.metrics import MetricsRegistry
from timewarp_tpu_torch.speculate import assert_spec_equiv, canonical_rows
# the solo file's shape and integer gap link, one definition for both files
from test_torch_speculate import BUDGET, CHUNK, N, JGap, TGap, _gap, _sc

# one intra-op thread per test process: the test session's workers
# share the host's cores (a process of the default width each
# oversubscribes them several times over)
torch.set_num_threads(1)


def _shrink(F):
    """A degradation window that undercuts the 4 ms support to 1 ms inside
    [40 ms, 80 ms)."""
    return F.FaultSchedule((F.LinkWindow(None, None, 40_000, 80_000,
                                         scale=0.25),))


def _droppy(D):
    """The gap link behind a 10% drop: the eager path."""
    return D.Quantize(D.WithDrop((JGap if D is jd else TGap)(), 0.1), 500)


def _pair(j, link=_gap, **kw):
    """The engine in the reference (``j``) or the port."""
    if j:
        return JaxEngine(_sc(jg), link(jd), window="auto", lint="off",
                         insert="xla", **kw)
    return TorchEngine(_sc(tg), link(td), window="auto", device="cpu", **kw)


def _json(decs):
    return [d.to_json() for d in decs]


def _solo_conservative(seed, faults=None):
    eng = TorchEngine(_sc(tg), _gap(td), window="auto", device="cpu",
                      seed=seed, faults=faults)
    fin, tr = eng.run(BUDGET)
    return canonical_rows(fin, tr)


def _same_as_ref(eng, fin, traces, jeng, jfin, jtraces):
    B = len(traces)
    assert canonical_rows(fin, traces, B=B) \
        == jspec.canonical_rows(jfin, jtraces, B=B)
    for b in range(B):
        assert_traces_equal(jtraces[b], traces[b], f"jax w{b}", "torch")
    assert eng.last_run_speculation == jeng.last_run_speculation
    assert _json(eng.last_run_decisions) == _json(jeng.last_run_decisions)
    assert [_json(c) for c in eng.last_run_decisions_world] \
        == [_json(c) for c in jeng.last_run_decisions_world]


@pytest.mark.parametrize("regime", ["eager", "lazy"])
def test_routing_regimes_under_speculation(regime):
    link = _droppy if regime == "eager" else _gap
    kw = {} if regime == "eager" else {"route_cap": N * 4}  # drops nothing
    jeng, eng = (_pair(j, link, speculate="auto", **kw) for j in (1, 0))
    assert not eng.adaptive and eng.lazy == (regime == "lazy")
    jfin, jtr = jeng.run_speculative(BUDGET, chunk=CHUNK)
    fin, tr = eng.run_speculative(BUDGET, chunk=CHUNK)
    assert canonical_rows(fin, tr) == jspec.canonical_rows(jfin, jtr)
    assert_traces_equal(jtr, tr, "jax", "torch")
    assert eng.last_run_speculation == jeng.last_run_speculation
    assert _json(eng.last_run_decisions) == _json(jeng.last_run_decisions)
    assert eng.last_run_speculation["rollbacks"] >= 1
    cfin, ctr = _pair(False, link, **kw).run(BUDGET)
    assert_spec_equiv(canonical_rows(cfin, ctr), canonical_rows(fin, tr),
                      regime)
    assert len(tr) < len(ctr)


@pytest.mark.parametrize("case", ["fleet", "fault-fleet"])
def test_equivalence_law_fleets(case):
    faulted = case == "fault-fleet"
    seeds = (3, 4) if faulted else (0, 1)
    runs = []
    for j, F, Spec in ((True, jf, JSpec), (False, tf, BatchSpec)):
        kw = dict(faults=F.FaultFleet((_shrink(F), F.FaultSchedule(())))) \
            if faulted else {}
        eng = _pair(j, speculate="auto", batch=Spec(seeds=seeds), **kw)
        assert eng.spec_floor == 500    # the undegraded floor
        fin, traces = eng.run_speculative(BUDGET, chunk=CHUNK)
        runs.append((eng, fin, traces))
    (jeng, jfin, jtr), (eng, fin, traces) = runs
    _same_as_ref(eng, fin, traces, jeng, jfin, jtr)
    assert eng.last_run_speculation["rollbacks"] >= 1
    rows = canonical_rows(fin, traces, B=2)
    for b, seed in enumerate(seeds):
        want = _solo_conservative(seed, _shrink(tf) if faulted and b == 0
                                  else None)
        assert_spec_equiv(want, [dict(rows[b], world=0)], f"{case} w{b}")


def _lines(reg):
    """A registry's lines without the wall-clock spans and the rung."""
    return [{k: v for k, v in ln.items() if "rung" not in k}
            for ln in reg.lines if ln["kind"] != "span"]


def test_masked_fleet_rollback():
    # world 0's samples start at 4 ms, world 1's at 20 ms: at fixed:8000
    # only world 0 violates, and only it re-runs at the floor
    runs = []
    for j, Spec, Reg in ((True, JSpec, JRegistry),
                         (False, BatchSpec, MetricsRegistry)):
        eng = _pair(j, speculate="fixed:8000", telemetry="counters",
                    batch=Spec(seeds=(5, 6),
                               link_params={"inner.lo_us": [4_000, 20_000]}))
        eng.metrics, eng.metrics_label = Reg(run="r"), "masked"
        fin, traces = eng.run_speculative(BUDGET, chunk=CHUNK)
        runs.append((eng, fin, traces))
    (jeng, jfin, jtr), (eng, fin, traces) = runs
    _same_as_ref(eng, fin, traces, jeng, jfin, jtr)
    si = eng.last_run_speculation
    assert si["rollbacks"] >= 1 and si["rerun_worlds"] == 1
    assert {v["world"] for v in si["violations"]} == {0}
    chains = eng.last_run_decisions_world
    assert any(d.obs.get("rolled_back") for d in chains[0])
    # world 1 committed the violating chunk at 8 ms; later chunks are the
    # fleet's floor decisions (the fixed bet is burned)
    assert not any(d.obs.get("rolled_back") for d in chains[1])
    assert chains[1][si["violations"][0]["chunk"]].window_us == 8_000
    assert _lines(eng.metrics) == _lines(jeng.metrics)
    assert {ln["outcome"] for ln in eng.metrics.lines
            if ln["kind"] == "speculation"} == {"rollback", "committed"}
    # every world = its row of one conservative fleet run
    cons = TorchEngine(_sc(tg), _gap(td), window="auto", device="cpu",
                       batch=BatchSpec(seeds=(5, 6), link_params={
                           "inner.lo_us": [4_000, 20_000]}))
    cfin, ctr = cons.run(BUDGET)
    assert_spec_equiv(canonical_rows(cfin, ctr, B=2),
                      canonical_rows(fin, traces, B=2), "masked")


def test_on_quiesce_exactly_once_under_speculative_rollback():
    eng = _pair(False, speculate="fixed:16000",
                batch=BatchSpec(seeds=(0, 1)))
    calls = []
    eng.run_speculative(BUDGET, chunk=CHUNK,
                        on_quiesce=lambda b, st: calls.append(b))
    assert eng.last_run_speculation["rollbacks"] >= 1
    assert sorted(calls) == [0, 1], \
        f"quiesce callback fired {calls} — must be exactly once per world"


def test_rebind_identity_checks_the_conservative_floor():
    """A speculating fleet re-validates its conservative floor against the
    new identity, undegraded (the device clamps a degradation window), as
    the reference's does: the same verdicts and the same refusal."""
    msgs = []
    for j, F, Spec in ((True, jf, JSpec), (False, tf, BatchSpec)):
        def spec(q, seeds=(0, 1)):
            return Spec(seeds=seeds, link_params={"quantum_us": [q, q]})
        eng = _pair(j, speculate="auto", batch=spec(500),
                    faults=F.FaultFleet((_shrink(F), F.FaultSchedule(()))))
        assert eng.spec_floor == 500
        deeper = F.FaultFleet((F.FaultSchedule(()), _shrink(F)))
        assert eng.rebind_identity(spec(500, (2, 3)), faults=deeper) is True
        assert eng.rebind_identity(spec(500), faults=None) is False
        with pytest.raises(ValueError) as ei:
            eng.rebind_identity(spec(100), faults=deeper)
        msgs.append(str(ei.value))
    assert "window=500" in msgs[1] and "min_delay_us=100" in msgs[1]
    # the same refusal up to its advice (the reference's names its sweep
    # buckets, which the port does not carry yet)
    assert msgs[0].split(" — ")[0] == msgs[1].split(" — ")[0]

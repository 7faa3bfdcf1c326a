"""Speculation on the port, solo (``timewarp_tpu_torch/speculate/``,
``TorchEngine(speculate=...)``), against ``JaxEngine(insert="xla",
speculate=...)`` — the laws of tests/test_zzzzzzspec.py at its shape (96
nodes, budget 3000, chunk 16):

- the **equivalence law**: the port's committed speculative run equals its
  conservative run on the canonical surface (speculate/equiv.py), on the
  long-tail Pareto link and on an integer link with the same floor gap;
- **equal to the reference** (on the integer link, whose draws are exact
  across backends): the canonical rows, the traces row for row,
  ``last_run_speculation``, every decision and the violation line apart
  from the class name in it (the eager and lazy routing regimes are in
  tests/test_torch_speculate_fleet.py);
- the **detection law**: a forced misspeculation is detected, the pinned
  line is one array-free line, recovery is bit-identical; ``run_quiet``
  never misspeculates silently; a link that lies about its floor is named;
- the **replay law**, rollbacks included (states, traces, checkpoint
  bytes);
- the auto ladder never re-proposes a violated width;
- the README's long-tail example at 128 nodes;
- **off is free**: with ``speculate="off"`` and no controller, no
  speculation code runs and the superstep's window stays a Python int;
- the guards, with the reference's messages.

Tolerance: exact.
"""

import dataclasses

import numpy as np
import pytest
import torch
from jax import numpy as jnp

import timewarp_tpu.speculate as jspec
from timewarp_tpu.interp.jax_engine.engine import JaxEngine
from timewarp_tpu.models import gossip as jg
from timewarp_tpu.net import delays as jd
from timewarp_tpu.trace.events import assert_traces_equal
import timewarp_tpu_torch.speculate as tspec
from timewarp_tpu_torch.dispatch import DecisionTrace
from timewarp_tpu_torch.dispatch.trace import Decision, DispatchTraceError
from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
from timewarp_tpu_torch.interp.torch_engine.fused_sparse import \
    FusedSparseEngine
from timewarp_tpu_torch.interp.torch_engine.state_io import state_to_numpy
from timewarp_tpu_torch.models import gossip as tg
from timewarp_tpu_torch.net import delays as td
from timewarp_tpu_torch.speculate import (SpeculationPolicy,
                                          SpeculationViolation,
                                          assert_spec_equiv, canonical_rows)
from timewarp_tpu_torch.utils.checkpoint import save_state

# one intra-op thread per test process: the test session's workers
# share the host's cores (a process of the default width each
# oversubscribes them several times over)
torch.set_num_threads(1)

N = 96
BUDGET = 3000
CHUNK = 16


@dataclasses.dataclass(frozen=True)
class JGap(jd.LinkModel):
    """Integer delays in ``[lo_us, lo_us + span_us)`` from the message
    key's first word: drop-free, declaring no floor of its own."""
    lo_us: int = 4_000
    span_us: int = 36_001

    def sample(self, src, dst, t, key):
        return (self.lo_us + (key[0] % self.span_us).astype(jnp.int64),
                jnp.zeros(jnp.shape(dst), bool))

    @property
    def can_drop(self):
        return False


@dataclasses.dataclass(frozen=True)
class TGap(td.LinkModel):
    """:class:`JGap` in torch (the key's words are int64 carriers)."""
    lo_us: int = 4_000
    span_us: int = 36_001

    def sample(self, src, dst, t, key):
        return (self.lo_us + key[0] % self.span_us,
                torch.zeros(dst.shape, dtype=torch.bool, device=dst.device))

    @property
    def can_drop(self):
        return False


def _sc(G):
    return G.gossip(N, fanout=4, burst=True, end_us=300_000, mailbox_cap=16,
                    think_us=700)


def _gap(D):
    """The integer link with the long-tail gap: declared floor 500 µs (the
    quantize grid), no sample below 4 ms."""
    return D.Quantize((JGap if D is jd else TGap)(), 500)


def _tail(D):
    return D.Quantize(D.ParetoDelay(4_000, 1.2), 500)


def _port(link=_gap, **kw):
    return TorchEngine(_sc(tg), link(td), window="auto", device="cpu", **kw)


def _ref(link=_gap, **kw):
    return JaxEngine(_sc(jg), link(jd), window="auto", lint="off",
                     insert="xla", **kw)


def _json(decs):
    return [d.to_json() for d in decs]


def _run_ref(eng):
    fin, tr = eng.run_speculative(BUDGET, chunk=CHUNK)
    return (jspec.canonical_rows(fin, tr), tr, eng.last_run_speculation,
            _json(eng.last_run_decisions))


@pytest.fixture(scope="module")
def ref():
    """The reference's speculative runs on the integer link (auto and the
    forced fixed:16000), with the violation lines of its plain and quiet
    drivers."""
    out = {"auto": _run_ref(_ref(speculate="auto")),
           "fixed": _run_ref(_ref(speculate="fixed:16000"))}
    for what, drive in (("line", "run"), ("quiet", "run_quiet")):
        with pytest.raises(jspec.SpeculationViolation) as ei:
            getattr(_ref(speculate="fixed:16000"), drive)(BUDGET)
        out[what] = (str(ei.value), ei.value.hit)
    return out


@pytest.fixture(scope="module")
def conservative():
    """The law's right-hand side on each link: the port's conservative
    (widest provable static window) run."""
    out = {}
    for name, link in (("gap", _gap), ("tail", _tail)):
        eng = _port(link)
        assert eng.window == 500 and eng.spec_floor is None
        fin, tr = eng.run(BUDGET)
        assert int(fin.overflow) == 0
        out[name] = (canonical_rows(fin, tr), len(tr))
    return out


def _same_as_ref(eng, fin, tr, want):
    rows, jtr, jinfo, jdecs = want
    assert canonical_rows(fin, tr) == rows
    assert_traces_equal(jtr, tr, "jax", "torch")
    assert eng.last_run_speculation == jinfo
    assert _json(eng.last_run_decisions) == jdecs


# ---------------------------------------------------------------------------
# the equivalence law, and the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("link", ["gap", "tail"])
def test_equivalence_law_solo(link, conservative, ref):
    eng = _port(_gap if link == "gap" else _tail, speculate="auto")
    assert eng.spec_floor == 500 and eng.window == 2**31 - 2
    assert eng._dyn_ok and eng.adaptive
    fin, tr = eng.run_speculative(BUDGET, chunk=CHUNK)
    rows, steps = conservative[link]
    assert_spec_equiv(rows, canonical_rows(fin, tr), link)
    # the win is structural: committed wide windows coalesce instants
    # the 500 µs floor serializes
    assert len(tr) < steps
    si = eng.last_run_speculation
    assert si["chunks"] > 0 and si["floor_us"] == 500
    assert max(si["windows"]) > 500
    if link == "gap":
        _same_as_ref(eng, fin, tr, ref["auto"])
        assert si["rollbacks"] >= 1      # the ladder met the 4 ms support


def test_forced_misspeculation_detected_and_recovered(conservative, ref):
    eng = _port(speculate="fixed:16000")
    fin, tr = eng.run_speculative(BUDGET, chunk=CHUNK)
    si = eng.last_run_speculation
    assert si["rollbacks"] >= 1, "forced misspeculation never fired"
    assert si["violations"][0]["window_us"] == 16000
    assert si["windows"] == [500]
    roll = [d for d in eng.last_run_decisions if d.obs.get("rolled_back")]
    assert roll and roll[0].obs["tried_us"] == 16000
    assert_spec_equiv(conservative["gap"][0], canonical_rows(fin, tr),
                      "recovery")
    _same_as_ref(eng, fin, tr, ref["fixed"])


def test_pinned_violation_diagnostic(ref):
    with pytest.raises(SpeculationViolation) as ei:
        _port(speculate="fixed:16000").run(BUDGET)
    msg = str(ei.value)
    assert "\n" not in msg and "[" not in msg, msg
    for needle in ("superstep", "committed horizon",
                   "flew shorter than the effective window",
                   "offending delivery", "docs/speculation.md"):
        assert needle in msg, f"{needle!r} missing from: {msg}"
    jmsg, jhit = ref["line"]
    assert msg == jmsg.replace("JaxEngine", "TorchEngine")
    assert ei.value.hit == jhit
    assert set(tspec.hit_scalars(ei.value.hit)) >= {
        "superstep", "horizon", "straggler", "count"}


def test_run_quiet_never_silently_misspeculates(ref):
    with pytest.raises(SpeculationViolation) as ei:
        _port(speculate="fixed:16000").run_quiet(BUDGET)
    assert "short_delay" in str(ei.value)
    assert str(ei.value) == ref["quiet"][0].replace("JaxEngine",
                                                    "TorchEngine")


def test_floor_violation_names_the_lying_link():
    class Liar(td.FnDelay):
        @property
        def min_delay_us(self):
            return 2_000        # samples are 100 µs: a false promise

        @property
        def can_drop(self):
            return False

    liar = Liar(lambda s, d, t, k: (torch.full(d.shape, 100,
                                               dtype=torch.int64),
                                    torch.zeros(d.shape, dtype=torch.bool)))
    eng = TorchEngine(_sc(tg), liar, window="auto", device="cpu",
                      speculate="auto")
    with pytest.raises(SpeculationViolation) as ei:
        eng.run_speculative(BUDGET, chunk=CHUNK)
    assert "conservative floor" in str(ei.value) \
        and "min_delay_us" in str(ei.value)


# ---------------------------------------------------------------------------
# the replay law
# ---------------------------------------------------------------------------

def test_replay_law_bit_identical_including_rollbacks(tmp_path):
    a = _port(speculate="fixed:16000")
    afin, atr = a.run_speculative(BUDGET, chunk=CHUNK)
    assert a.last_run_speculation["rollbacks"] >= 1
    path = str(tmp_path / "decisions.jsonl")
    DecisionTrace.of(a.last_run_decisions).save(path)
    b = _port(speculate="fixed:16000")
    bfin, btr = b.run_speculative(BUDGET, chunk=CHUNK,
                                  replay=DecisionTrace.load(path))
    # literal identity — granularity included — and zero rollbacks
    assert b.last_run_speculation["rollbacks"] == 0
    assert len(atr) == len(btr)
    assert all(atr.row(i) == btr.row(i) for i in range(len(atr)))
    sa, sb = state_to_numpy(afin), state_to_numpy(bfin)
    for k in sa:
        if k == "states":
            assert all(np.array_equal(sa[k][q], sb[k][q]) for q in sa[k])
        else:
            assert np.array_equal(sa[k], sb[k]), k
    pa, pb = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    save_state(pa, afin)
    save_state(pb, bfin)
    assert open(pa, "rb").read() == open(pb, "rb").read()


def test_auto_ladder_never_reproposes_a_violated_width():
    """The port's policy proposes the reference's widths, move for move."""
    from timewarp_tpu.speculate.policy import SpeculationPolicy as JPolicy

    class Eng:
        spec_floor, window = 500, 1 << 20

    def script(P):
        p = P(mode="auto", chunk=16)
        p.begin(Eng())
        seen = [p.decide(0, None, 0)[0].window_us,
                p.decide(1, None, 0)[0].window_us]
        p.rollback(1, {"count": 1})
        seen.append(p.made[1].window_us)
        seen += [p.decide(ci, None, 0)[0].window_us for ci in range(2, 8)]
        p2 = P(mode="auto", chunk=16)
        p2.begin(Eng())
        for ci in range(3):
            p2.decide(ci, None, 0)
        p2.rollback(2, {})
        p2.decide(3, None, 0)
        p2.rollback(3, {})
        seen += [p2.decide(ci, None, 0)[0].window_us for ci in range(4, 8)]
        return seen, _json(p.decisions) + _json(p2.decisions)
    seen, decs = script(SpeculationPolicy)
    assert seen[:3] == [1000, 2000, 500]
    assert all(w < 2000 for w in seen[3:]), seen
    assert (seen, decs) == script(JPolicy)


# ---------------------------------------------------------------------------
# the README's example
# ---------------------------------------------------------------------------

def test_readme_long_tail_example():
    """README's worked example (gossip at 128 nodes as the CLI builds it,
    the Pareto long-tail link, chunk 64): the reference's supersteps,
    windows and rollbacks, and the same canonical surface."""
    def sc(G):      # the CLI's gossip: --think-us is not its argument
        return G.gossip(128, fanout=4, burst=True, end_us=400_000,
                        mailbox_cap=16)
    ports = [TorchEngine(sc(tg), _tail(td), window="auto", device="cpu",
                         **kw) for kw in ({"speculate": "auto"}, {})]
    refs = [JaxEngine(sc(jg), _tail(jd), window="auto", lint="off",
                      insert="xla", **kw)
            for kw in ({"speculate": "auto"}, {})]
    sfin, strc = ports[0].run_speculative(4000, chunk=64)
    cfin, ctrc = ports[1].run(4000)
    jfin, jtrc = refs[0].run_speculative(4000, chunk=64)
    jcfin, jctrc = refs[1].run(4000)
    si = ports[0].last_run_speculation
    assert (len(strc), len(ctrc)) == (len(jtrc), len(jctrc)) == (92, 159)
    assert si == refs[0].last_run_speculation
    assert si["windows"] == [1000, 2000] and si["rollbacks"] == 0
    assert int(sfin.delivered) == int(cfin.delivered) == 488
    assert_spec_equiv(canonical_rows(cfin, ctrc),
                      canonical_rows(sfin, strc), "readme")
    assert canonical_rows(sfin, strc) == jspec.canonical_rows(jfin, jtrc)


# ---------------------------------------------------------------------------
# off is free; the guards
# ---------------------------------------------------------------------------

def test_speculate_off_enters_no_speculation_code(monkeypatch):
    import timewarp_tpu_torch.speculate.equiv as equiv
    import timewarp_tpu_torch.speculate.plane as plane
    import timewarp_tpu_torch.speculate.policy as policy
    import timewarp_tpu_torch.speculate.runner as runner

    def boom(*a, **k):
        raise AssertionError("speculation code ran with speculate='off'")
    for mod, names in (
            (plane, ("parse_speculate", "first_spec_violation",
                     "world_spec_violations", "spec_violation_error",
                     "SpecRow")),
            (runner.SpeculativeRunMixin, ("_capture_spec",
                                          "_quiet_spec_guard",
                                          "run_speculative")),
            (policy, ("SpeculationPolicy",)),
            (equiv, ("canonical_rows",))):
        for name in names:
            monkeypatch.setattr(mod, name, boom)
    seen = []
    flights = TorchEngine._flights

    def spy(self, *a):
        seen.append(self._w_now)
        return flights(self, *a)
    monkeypatch.setattr(TorchEngine, "_flights", spy)
    def droppy(D):      # the eager path
        return D.Quantize(D.WithDrop(TGap(), 0.1), 500)
    for link in (_gap, droppy):
        for kw in ({}, {"speculate": "off"}, {"speculate": None}):
            eng = _port(link, telemetry="counters", **kw)
            assert eng.speculate == "off" and eng.spec_floor is None
            eng.run(40)
            eng.run_quiet(40)
            assert eng._dyn is None
    assert seen and all(type(w) is int and w == 500 for w in seen)


def test_speculate_guards():
    from timewarp_tpu_torch.dispatch import DispatchController
    with pytest.raises(ValueError, match="decision source"):
        _port(speculate="auto", telemetry="counters",
              controller=DispatchController())
    with pytest.raises(ValueError, match="does not exceed"):
        _port(speculate="fixed:500")          # == the floor
    with pytest.raises(ValueError, match="grammar"):
        _port(speculate="fixed:wide")
    with pytest.raises(ValueError, match="kernel"):
        FusedSparseEngine(_sc(tg), _gap(td), window="auto", device="cpu",
                          speculate="auto")
    with pytest.raises(ValueError, match="speculating engine"):
        _port().run_speculative(100)
    with pytest.raises(ValueError, match="_dyn carries"):
        _port().run(10, _dyn=object())
    # a window above the floor names the speculation advice, as the
    # reference's does
    for kw in ({}, {"speculate": "auto"}):
        with pytest.raises(ValueError) as te:
            TorchEngine(_sc(tg), _gap(td), window=1_000, device="cpu", **kw)
        with pytest.raises(ValueError) as je:
            JaxEngine(_sc(jg), _gap(jd), window=1_000, lint="off",
                      insert="xla", **kw)
        assert str(te.value) == str(je.value)
    # a replayed trace recorded for a different configuration refuses
    alien = [Decision(chunk=0, window_us=400, rung_pin=-1, chunk_len=16)]
    with pytest.raises(DispatchTraceError, match="different configuration"):
        _port(speculate="fixed:8000").run_speculative(100, replay=alien)

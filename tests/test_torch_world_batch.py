"""The world axis of the port (``TorchEngine(batch=BatchSpec)``, batched.py)
against the JAX package, mirroring tests/test_world_batch.py.

The batch exactness law, both ways: world b of a port fleet equals world b
of the JAX fleet (``JaxEngine(insert="xla", batch=...)``) — every
``EngineState`` leaf and the per-world trace — and equals the port's solo
run with world b's seed and link. Cases, at the reference tests' sizes:

- ``_ring(48)`` on the eager path (a droppy ``FnDelay`` link), seeds
  (0, 1, 5);
- the ``_burst_gossip(64)`` link sweep under window 3 000 on the adaptive
  path (K2 and K1 across the world axis);
- a lazy ``route_cap`` fleet;
- ``run_quiet`` budgets 70 and 1000, and per-world budgets;
- resume across worlds, ``window="auto"`` over the fleet floor;
- ``BatchSpec`` / ``rebind_link`` errors, ``run_stream`` ≡ ``run``,
  ``rebind_identity`` ≡ a fresh engine, the engines' guards.

Tolerance: exact.
"""

import numpy as np
import pytest

from timewarp_tpu.interp.jax_engine.batched import BatchSpec as JSpec
from timewarp_tpu.interp.jax_engine.batched import world_slice as jslice
from timewarp_tpu.interp.jax_engine.engine import EngineState as JState
from timewarp_tpu.interp.jax_engine.engine import JaxEngine
from timewarp_tpu.models import gossip as jg
from timewarp_tpu.models import token_ring as jr
from timewarp_tpu.net import delays as jd
from timewarp_tpu.trace.events import (assert_states_equal,
                                       assert_traces_equal)
from timewarp_tpu_torch.interp.torch_engine.batched import (BatchSpec,
                                                            rebind_link,
                                                            world_slice)
from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
from timewarp_tpu_torch.interp.torch_engine.state_io import state_to_numpy
from timewarp_tpu_torch.models import gossip as tg
from timewarp_tpu_torch.models import token_ring as tr
from timewarp_tpu_torch.net import delays as td
import torch

# one intra-op thread per test process: the test session's workers
# share the host's cores (a process of the default width each
# oversubscribes them several times over)
torch.set_num_threads(1)


def _ring(mod, n=48):
    sc = mod.token_ring(n, n_tokens=8, think_us=2_000, bootstrap_us=1000,
                        end_us=200_000, with_observer=True, mailbox_cap=16)
    return sc, mod.token_ring_links(n)


def _burst_gossip(gmod, dmod, n=64):
    sc = gmod.gossip(n, fanout=4, think_us=700, burst=True,
                     end_us=400_000, mailbox_cap=16)
    return sc, dmod.Quantize(dmod.UniformDelay(3_000, 9_000), 1_000)


def _np(st):
    return JState(**state_to_numpy(st))


def _law(jfin, jtr, pfin, ptr, spec, solo):
    """World b of the port fleet ≡ world b of the JAX fleet ≡ the port's
    solo run ``solo(b)``."""
    for b in range(spec.B):
        pw = world_slice(pfin, b)
        assert_traces_equal(jtr[b], ptr[b], f"jax world{b}", "port")
        assert_states_equal(jslice(jfin, b), _np(pw), f"world {b}")
        if solo is not None:
            sf, st = solo(b)
            assert_traces_equal(st, ptr[b], "port solo", f"world{b}")
            assert_states_equal(_np(sf), _np(pw), f"solo world {b}")


def test_fleet_ring_eager_equals_jax_and_solo():
    seeds = (0, 1, 5)
    jsc, jl = _ring(jr)
    tsc, tl = _ring(tr)
    jfin, jtr = JaxEngine(jsc, jl, insert="xla",
                          batch=JSpec(seeds=seeds)).run(120)
    eng = TorchEngine(tsc, tl, batch=BatchSpec(seeds=seeds), device="cpu")
    assert not eng.adaptive
    pfin, ptr = eng.run(120)
    assert isinstance(ptr, list) and len(ptr) == 3
    _law(jfin, jtr, pfin, ptr, eng.batch, lambda b: TorchEngine(
        tsc, tl, seed=seeds[b], device="cpu").run(120))
    # per-world digests are per-world: a fleet of clones would pass the
    # law while testing nothing
    assert not np.array_equal(ptr[0].recv_hash, ptr[1].recv_hash)


def test_fleet_link_sweep_windowed_adaptive():
    """Seed and link sweep under a 3 ms window: the adaptive path, K2 and
    K1 across the world axis, each world's link parameters a [B, 1]
    tensor; the solo twin runs ``BatchSpec.world_link``."""
    lp = {"inner.lo": [3000, 4000, 3000, 5000],
          "inner.hi": [9000, 9000, 12000, 8000]}
    seeds = (3, 4, 9, 11)
    jsc, jl = _burst_gossip(jg, jd)
    tsc, tl = _burst_gossip(tg, td)
    jfin, jtr = JaxEngine(jsc, jl, insert="xla", window=3_000,
                          batch=JSpec(seeds=seeds, link_params=lp)).run(200)
    spec = BatchSpec(seeds=seeds, link_params=lp)
    eng = TorchEngine(tsc, tl, window=3_000, batch=spec, device="cpu")
    assert eng.adaptive
    pfin, ptr = eng.run(200)
    _law(jfin, jtr, pfin, ptr, spec, lambda b: TorchEngine(
        tsc, spec.world_link(tl, b), seed=seeds[b], window=3_000,
        device="cpu").run(200))


def test_fleet_lazy_route_cap():
    """The lazy path (``route_cap`` with a drop-free link) over a fleet,
    the cap below the active count in some supersteps."""
    seeds = (2, 8)
    jsc, jl = _burst_gossip(jg, jd)
    tsc, tl = _burst_gossip(tg, td)
    jfin, jtr = JaxEngine(jsc, jl, insert="xla", window=3_000, route_cap=24,
                          batch=JSpec(seeds=seeds)).run(150)
    eng = TorchEngine(tsc, tl, window=3_000, route_cap=24,
                      batch=BatchSpec(seeds=seeds), device="cpu")
    assert eng.lazy
    pfin, ptr = eng.run(150)
    _law(jfin, jtr, pfin, ptr, eng.batch, None)
    assert int(pfin.route_drop.sum()) > 0


def test_fleet_run_quiet_budget_and_quiescence():
    """``run_quiet`` budgets 70 (mid-run freeze) and 1000 (quiescence): a
    world stops at its own budget or quiescence while the others keep
    stepping; frozen worlds equal the JAX fleet's and the solo runs with
    that budget (the solo run to quiescence, ~900 supersteps on the CPU,
    on one world, resumed from its budget-70 state)."""
    seeds = (0, 2, 7)
    jsc, jl = _ring(jr)
    tsc, tl = _ring(tr)
    je = JaxEngine(jsc, jl, insert="xla", batch=JSpec(seeds=seeds))
    te = TorchEngine(tsc, tl, batch=BatchSpec(seeds=seeds), device="cpu")
    solo70, pfin = {}, None
    for budget in (70, 1000):
        # the fleet's run to 1000 resumes from its budget-70 state: the
        # same state as one run_quiet(1000) by the run loop's resume law
        jfin = je.run_quiet(budget)
        pfin = te.run_quiet(70) if pfin is None else \
            te.run_quiet(930, pfin)
        for b, s in enumerate(seeds):
            pw = world_slice(pfin, b)
            assert_states_equal(jslice(jfin, b), _np(pw),
                                f"budget={budget} world {b}")
            solo = TorchEngine(tsc, tl, seed=s, device="cpu")
            if budget == 70:
                solo70[b] = solo.run_quiet(70)
                got = solo70[b]
            elif b == 1:
                got = solo.run_quiet(930, solo70[b])
            else:
                continue
            assert_states_equal(_np(got), _np(pw),
                                f"solo budget={budget} world {b}")
        steps = pfin.steps.tolist()
        assert steps == [70] * 3 if budget == 70 else max(steps) < budget
        assert not te.world_active(pfin).any() or budget == 70


def test_fleet_per_world_budgets():
    """One budget per world (``run`` and ``run_quiet``): world b freezes
    after its own budget, equal to the solo run with it."""
    seeds, budgets = (0, 2, 7), [30, 90, 0]
    tsc, tl = _ring(tr)
    eng = TorchEngine(tsc, tl, batch=BatchSpec(seeds=seeds), device="cpu")
    fin, traces = eng.run(budgets)
    quiet = eng.run_quiet(np.asarray(budgets))
    assert_states_equal(_np(fin), _np(quiet), "run vs run_quiet")
    for b, (s, k) in enumerate(zip(seeds, budgets)):
        sf, st = TorchEngine(tsc, tl, seed=s, device="cpu").run(k)
        assert len(traces[b]) == len(st) == k
        assert_traces_equal(st, traces[b], "solo", f"world{b}")
        assert_states_equal(_np(sf), _np(world_slice(fin, b)), f"w{b}")
    with pytest.raises(ValueError, match="one int per world"):
        eng.run([1, 2])
    solo = TorchEngine(tsc, tl, device="cpu")
    with pytest.raises(ValueError, match="need batch=BatchSpec"):
        solo.run([1, 2, 3])


def test_fleet_resume_across_worlds():
    """run(80) then run(120, state=...) equals run(200), per world."""
    tsc, tl = _ring(tr)
    eng = TorchEngine(tsc, tl, batch=BatchSpec(seeds=(1, 6)), device="cpu")
    full_st, full = eng.run(200)
    mid, first = eng.run(80)
    rest_st, rest = eng.run(120, state=mid)
    for b in range(2):
        assert np.array_equal(
            np.concatenate([first[b].times, rest[b].times]), full[b].times)
        assert np.array_equal(
            np.concatenate([first[b].recv_hash, rest[b].recv_hash]),
            full[b].recv_hash)
    assert_states_equal(_np(full_st), _np(rest_st), "resumed fleet")


def test_fleet_window_auto_resolves_fleet_floor():
    sc, link = _burst_gossip(tg, td)
    spec = BatchSpec(seeds=(0, 1), link_params={"inner.lo": [3000, 5000],
                                                "inner.hi": [9000, 9000]})
    assert TorchEngine(sc, link, window="auto", batch=spec,
                       device="cpu").window == 3000


def test_batchspec_validation_errors():
    with pytest.raises(ValueError, match="at least one world"):
        BatchSpec(seeds=())
    with pytest.raises(ValueError, match="one value per world"):
        BatchSpec(seeds=(0, 1), link_params={"lo": [1, 2, 3]})
    with pytest.raises(ValueError, match="needs batch= or seeds="):
        BatchSpec.of()
    with pytest.raises(ValueError, match="disagrees"):
        BatchSpec.of(3, [0, 1])
    assert BatchSpec.of(3, base_seed=5).seeds == (5, 6, 7)
    assert BatchSpec.of(None, range(2, 5)).seeds == (2, 3, 4)


def test_rebind_link_unknown_path_names_fields():
    link = td.Quantize(td.UniformDelay(1_000, 2_000), 500)
    with pytest.raises(ValueError, match="sweepable fields"):
        rebind_link(link, {"nope": 1})
    with pytest.raises(ValueError, match="sweepable fields"):
        rebind_link(link, {"inner.nope": 1})
    swept = rebind_link(link, {"inner.lo": 1500, "quantum_us": 250})
    assert swept == td.Quantize(td.UniformDelay(1_500, 2_000), 250)


def test_run_stream_equals_run():
    """The chunked driver with per-world budgets equals one run, and
    ``on_quiesce`` fires once per world."""
    tsc, tl = _ring(tr)
    spec = BatchSpec(seeds=(0, 3, 4))
    eng = TorchEngine(tsc, tl, batch=spec, device="cpu")
    budgets = [40, 160, 75]
    fin, traces = eng.run(budgets)
    seen = []
    sfin, straces = eng.run_stream(budgets, chunk=16,
                                   on_quiesce=lambda b, st: seen.append(b))
    assert sorted(seen) == [0, 1, 2]
    assert_states_equal(_np(fin), _np(sfin), "run_stream vs run")
    for b in range(3):
        assert_traces_equal(traces[b], straces[b], "run", "run_stream")
    done, remaining, active = eng.fleet_progress(sfin, budgets)
    assert list(done) == [len(t) for t in traces]
    assert not active.any() and not remaining.any()
    assert eng.world_active(eng.init_state()).tolist() == [True] * 3
    with pytest.raises(ValueError, match="drives a fleet"):
        TorchEngine(tsc, tl, device="cpu").run_stream(10)


def test_rebind_identity_equals_fresh_engine():
    sc, link = _burst_gossip(tg, td)
    lp = {"inner.lo": [3000, 4000], "inner.hi": [9000, 9000]}
    eng = TorchEngine(sc, link, window=3_000, device="cpu",
                      batch=BatchSpec(seeds=(0, 1), link_params=lp))
    eng.run(40)
    new = BatchSpec(seeds=(7, 9), link_params={"inner.lo": [5000, 3000],
                                               "inner.hi": [8000, 12000]})
    assert eng.rebind_identity(new)
    fin, traces = eng.run(120)
    ffin, ftr = TorchEngine(sc, link, window=3_000, batch=new,
                            device="cpu").run(120)
    assert_states_equal(_np(ffin), _np(fin), "rebound vs fresh")
    for b in range(2):
        assert_traces_equal(ftr[b], traces[b], "fresh", "rebound")
    # a different world count or parameter set needs a new engine; a
    # window past the new floor is refused
    assert not eng.rebind_identity(BatchSpec(seeds=(1, 2, 3),
                                             link_params=None))
    assert not eng.rebind_identity(BatchSpec(seeds=(1, 2)))
    with pytest.raises(ValueError, match="exceeds the new fleet"):
        eng.rebind_identity(BatchSpec(seeds=(1, 2), link_params={
            "inner.lo": [1000, 3000], "inner.hi": [9000, 9000]}))
    with pytest.raises(ValueError, match="a solo engine has none"):
        TorchEngine(sc, link, window=3_000,
                    device="cpu").rebind_identity(new)


def test_fleet_engine_guards():
    sc, link = _ring(tr, 16)
    with pytest.raises(ValueError, match="BatchSpec"):
        TorchEngine(sc, link, batch=3, device="cpu")
    with pytest.raises(ValueError, match="solo-run debug ring"):
        TorchEngine(sc, link, batch=BatchSpec(seeds=(0, 1)),
                    record_events=64, device="cpu")
    gsc, glink = _burst_gossip(tg, td, 16)
    with pytest.raises(ValueError, match="min over the batch worlds"):
        TorchEngine(gsc, glink, window=3_000, device="cpu",
                    batch=BatchSpec(seeds=(0, 1), link_params={
                        "inner.lo": [3000, 1000],
                        "inner.hi": [9000, 9000]}))


def test_fused_engines_take_no_batch_or_faults():
    """As in the reference, ``FusedSparseEngine`` and ``FusedRingEngine``
    take neither a fleet nor a fault schedule."""
    from timewarp_tpu_torch.faults import FaultSchedule, NodeCrash
    from timewarp_tpu_torch.interp.torch_engine.fused_ring import \
        FusedRingEngine
    from timewarp_tpu_torch.interp.torch_engine.fused_sparse import \
        FusedSparseEngine
    gsc, glink = _burst_gossip(tg, td)
    ring = tr.token_ring(64, n_tokens=64, think_us=0, with_observer=False)
    sched = FaultSchedule((NodeCrash(1, 10, 20),))
    for kw in (dict(batch=BatchSpec(seeds=(0, 1))), dict(faults=sched)):
        with pytest.raises((TypeError, ValueError), match=next(iter(kw))):
            FusedSparseEngine(gsc, glink, window="auto", device="cpu", **kw)
        with pytest.raises((TypeError, ValueError), match=next(iter(kw))):
            FusedRingEngine(ring, td.FixedDelay(500), device="cpu", **kw)

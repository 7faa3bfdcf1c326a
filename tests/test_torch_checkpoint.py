"""Checkpoint interchange (``timewarp_tpu_torch/utils/checkpoint.py``)
against the JAX package's ``timewarp_tpu/utils/checkpoint.py``, mirroring
tests/test_checkpoint.py: the ``.npz`` layout is the reference's, so a
state saved by either package resumes bit-identically under the other.

- the observer token ring (``EngineState``, ordered inbox): the port
  saves mid-run, the reference loads and resumes under ``JaxEngine``, and
  the reverse; both continuations equal the uninterrupted JAX run;
- the edge engine's ``EdgeState``, both ways;
- Praos's uint32 ``thr`` leaf (``u32_states``), both ways;
- a batched fleet, both ways, and ``load_world_state`` of world b into a
  solo port engine (with fault-row growth) equal to world b continued;
- the int32 → int64 widening, a corrupted leaf and a mismatched tree
  refused, and the ``__treedef__`` string equal to the reference's
  ``str(treedef)`` for every state type.

Tolerance: exact.
"""

import jax
import numpy as np
import pytest
import torch

import timewarp_tpu.utils.checkpoint as jck
from timewarp_tpu.interp.jax_engine.batched import BatchSpec as JSpec
from timewarp_tpu.interp.jax_engine.batched import world_slice as jslice
from timewarp_tpu.interp.jax_engine.edge_engine import EdgeEngine as JEdge
from timewarp_tpu.interp.jax_engine.edge_engine import EdgeState as JEState
from timewarp_tpu.interp.jax_engine.engine import EngineState as JState
from timewarp_tpu.interp.jax_engine.engine import JaxEngine
from timewarp_tpu.models import praos as jp
from timewarp_tpu.models import token_ring as jr
from timewarp_tpu.net import delays as jd
from timewarp_tpu.trace.events import assert_states_equal
import timewarp_tpu_torch.utils.checkpoint as tck
from timewarp_tpu_torch.faults import FaultFleet, FaultSchedule, NodeCrash
from timewarp_tpu_torch.interp.torch_engine.batched import (BatchSpec,
                                                            world_slice)
from timewarp_tpu_torch.interp.torch_engine.edge_engine import EdgeEngine
from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
from timewarp_tpu_torch.interp.torch_engine.state_io import (
    edge_state_to_numpy, state_to_numpy)
from timewarp_tpu_torch.models import praos as tp
from timewarp_tpu_torch.models import token_ring as tr
from timewarp_tpu_torch.net import delays as td

# one intra-op thread per test process: the test session's workers
# share the host's cores (a process of the default width each
# oversubscribes them several times over)
torch.set_num_threads(1)


def _ring(mod, n=48):
    return (mod.token_ring(n, n_tokens=8, think_us=2_000, bootstrap_us=1000,
                           end_us=200_000, with_observer=True,
                           mailbox_cap=16), mod.token_ring_links(n))


def _np(st, sc=None):
    return JState(**state_to_numpy(st, sc))


def _same_tail(full, first, rest):
    k = len(first)
    assert np.array_equal(full.times[k:k + len(rest)], rest.times)
    assert np.array_equal(full.recv_hash[k:k + len(rest)], rest.recv_hash)
    assert np.array_equal(full.sent_hash[k:k + len(rest)], rest.sent_hash)


def test_engine_state_both_ways(tmp_path):
    """Port save → reference load → ``JaxEngine`` resume, and reference
    save → port load → ``TorchEngine`` resume: both equal the
    uninterrupted JAX run, state and trace."""
    jsc, jl = _ring(jr)
    tsc, tl = _ring(tr)
    je = JaxEngine(jsc, jl, insert="xla")
    te = TorchEngine(tsc, tl, device="cpu")
    jfull_st, jfull = je.run(240)
    # port -> reference
    tmid, tfirst = te.run(120)
    path = str(tmp_path / "port.npz")
    tck.save_state(path, tmid, meta={"scenario": tsc.name, "seed": 0})
    loaded, meta = jck.load_state(path, je.init_state(),
                                  expect_meta={"scenario": jsc.name})
    assert meta["seed"] == 0
    jend, jrest = je.run(120, state=loaded)
    _same_tail(jfull, tfirst, jrest)
    assert_states_equal(jfull_st, jend, "port ckpt resumed by JAX")
    # reference -> port
    jmid, jfirst = je.run(120)
    path = str(tmp_path / "jax.npz")
    jck.save_state(path, jmid, meta={"scenario": jsc.name})
    tloaded, _ = tck.load_state(path, te.init_state(),
                                expect_meta={"scenario": tsc.name})
    tend, trest = te.run(120, state=tloaded)
    _same_tail(jfull, jfirst, trest)
    assert_states_equal(jfull_st, _np(tend), "JAX ckpt resumed by port")
    with pytest.raises(ValueError, match="meta mismatch"):
        tck.load_state(path, te.init_state(), expect_meta={"seed": 3})


def test_edge_state_both_ways(tmp_path):
    def ring(mod, dmod):
        return (mod.token_ring(32, n_tokens=8, think_us=1_000,
                               bootstrap_us=1000, end_us=150_000,
                               with_observer=False, mailbox_cap=4),
                dmod.UniformDelay(200, 900))
    je, te = JEdge(*ring(jr, jd)), EdgeEngine(*ring(tr, td), device="cpu")
    jfull_st, jfull = je.run(240)
    tmid, tfirst = te.run(120)
    path = str(tmp_path / "edge_port.npz")
    tck.save_state(path, tmid)
    jend, jrest = je.run(120, state=jck.load_state(path,
                                                   je.init_state())[0])
    _same_tail(jfull, tfirst, jrest)
    assert_states_equal(jfull_st, jend, "edge port -> JAX")
    jmid, jfirst = je.run(120)
    jck.save_state(path, jmid)
    tend, trest = te.run(120, state=tck.load_state(path,
                                                   te.init_state())[0])
    _same_tail(jfull, jfirst, trest)
    assert_states_equal(jfull_st, JEState(**edge_state_to_numpy(tend)),
                        "edge JAX -> port")


def test_praos_uint32_leaf_both_ways(tmp_path):
    """Praos's ``thr`` is uint32 on disk and int64 words in the port; the
    mapping runs in both directions (``scenario=``)."""
    def pair(mod, dmod):
        return (mod.praos(256, slot_us=100_000, n_slots=6,
                          leader_prob=4 / 256, fanout=8, burst=True,
                          mailbox_cap=16),
                dmod.Quantize(dmod.UniformDelay(8_000, 30_000), 1_000))
    (jsc, jl), (tsc, tl) = pair(jp, jd), pair(tp, td)
    je = JaxEngine(jsc, jl, window="auto", insert="xla")
    te = TorchEngine(tsc, tl, window="auto", device="cpu")
    jfull = je.run_quiet(40)
    tmid = te.run_quiet(20)
    path = str(tmp_path / "praos.npz")
    tck.save_state(path, tmid, scenario=tsc)
    with np.load(path) as z:
        names = [k for k in z.files if k.startswith("leaf_")]
        assert any(z[k].dtype == np.uint32 for k in names)
    jend = je.run_quiet(20, jck.load_state(path, je.init_state())[0])
    assert_states_equal(jfull, jend, "praos port -> JAX")
    jck.save_state(path, je.run_quiet(20))
    tend = te.run_quiet(20, tck.load_state(path, te.init_state(),
                                           scenario=tsc)[0])
    assert_states_equal(jfull, _np(tend, tsc), "praos JAX -> port")
    with pytest.raises(ValueError, match="does not match template"):
        tck.load_state(path, te.init_state())   # uint32 without mapping


def test_fleet_both_ways_and_world_fork(tmp_path):
    """A batched fleet through both packages' checkpoints, and
    ``load_world_state`` of one world into a solo port engine whose
    schedule grew a crash row: it continues exactly as the world did."""
    seeds = (0, 3)
    jsc, jl = _ring(jr, 16)
    tsc, tl = _ring(tr, 16)
    je = JaxEngine(jsc, jl, insert="xla", batch=JSpec(seeds=seeds))
    te = TorchEngine(tsc, tl, batch=BatchSpec(seeds=seeds), device="cpu")
    jfull = je.run_quiet(160)
    path = str(tmp_path / "fleet.npz")
    tck.save_state(path, te.run_quiet(80))
    jend = je.run_quiet(80, jck.load_state(path, je.init_state())[0])
    assert_states_equal(jfull, jend, "fleet port -> JAX")
    jck.save_state(path, je.run_quiet(80))
    tend = te.run_quiet(80, tck.load_state(path, te.init_state())[0])
    assert_states_equal(jfull, _np(tend), "fleet JAX -> port")
    # the fork: world 1 of a faulted fleet, continued solo under its
    # schedule plus a crash row that has not yet opened
    crash = NodeCrash(4, 10_000, 30_000, reset_state=True)
    fleet = FaultFleet((FaultSchedule((crash,)),) * 2)
    fe = TorchEngine(tsc, tl, batch=BatchSpec(seeds=seeds), faults=fleet,
                     device="cpu")
    fmid = fe.run_quiet(60)
    tck.save_state(path, fmid)
    fork = TorchEngine(tsc, tl, seed=seeds[1], device="cpu",
                       faults=FaultSchedule((crash, NodeCrash(
                           9, 10**9, 10**9 + 5, reset_state=True))))
    w1, _ = tck.load_world_state(path, fork.init_state(), 1)
    assert w1.restart_done.tolist() == \
        fmid.restart_done[1].tolist() + [False]
    jw1, _ = jck.load_world_state(path, jslice(je.init_state(), 0)._replace(
        restart_done=jax.numpy.zeros((1,), bool)), 1)
    assert_states_equal(jw1, _np(world_slice(fmid, 1)), "JAX world fork")
    fend = fe.run_quiet(60, fmid)
    solo_end = fork.run_quiet(60, w1)
    want = _np(world_slice(fend, 1))
    assert_states_equal(want._replace(restart_done=None),
                        _np(solo_end)._replace(restart_done=None), "fork")
    tck.save_state(path, fork.init_state())
    with pytest.raises(ValueError, match="world-stacked"):
        tck.load_world_state(path, fork.init_state(), 0)
    tck.save_state(path, fmid)
    with pytest.raises(ValueError, match="out of range"):
        tck.load_world_state(path, fork.init_state(), 2)


def test_widening_corruption_and_tree(tmp_path):
    tsc, tl = _ring(tr, 16)
    te = TorchEngine(tsc, tl, device="cpu")
    full_st, full = te.run(100)
    mid, first = te.run(40)
    old = mid._replace(ev_count=mid.ev_count.to(torch.int32))
    path = str(tmp_path / "w.npz")
    tck.save_state(path, old)
    loaded, _ = tck.load_state(path, te.init_state())
    assert loaded.ev_count.dtype == torch.int64
    end, rest = te.run(60, state=loaded)
    _same_tail(full, first, rest)
    assert_states_equal(_np(full_st), _np(end), "widened resume")
    # the reference honors the port's widened file too
    je = JaxEngine(*_ring(jr, 16), insert="xla")
    assert np.asarray(jck.load_state(path, je.init_state())[0]
                      .ev_count).dtype == np.int64
    # narrowing is not sanctioned
    tck.save_state(path, mid)
    with pytest.raises(ValueError, match="does not match template"):
        tck.load_state(path, old)
    # a corrupted leaf fails its digest, naming the leaf
    i = [name for name, _ in tck._leaves(mid)].index("mb_rel")
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    arrays[f"leaf_{i}"] = arrays[f"leaf_{i}"].copy()
    arrays[f"leaf_{i}"].flat[0] ^= 1
    np.savez(path, **arrays)
    for load, eng in ((tck.load_state, te), (jck.load_state, je)):
        with pytest.raises(ValueError, match=f"leaf {i} failed its "):
            load(path, eng.init_state())
    # another tree under the same leaf count is refused, and so is
    # another leaf count (an edge state's)
    tck.save_state(path, mid)
    renamed = mid._replace(states={"x" + k: v for k, v in
                                   mid.states.items()})
    with pytest.raises(ValueError, match="tree structure does not match"):
        tck.load_state(path, renamed)
    # another tree (an edge state's) is refused
    ring = tr.token_ring(16, n_tokens=8, with_observer=False, mailbox_cap=4)
    tck.save_state(path, EdgeEngine(ring, td.FixedDelay(500),
                                    device="cpu").init_state())
    with pytest.raises(ValueError, match="leaves, template has"):
        tck.load_state(path, te.init_state())
    with open(path, "wb") as f:
        f.write(b"not a zip")
    with pytest.raises(ValueError, match="truncated or corrupt"):
        tck.load_state(path, te.init_state())


def test_treedef_string_equals_reference():
    """The port writes the reference's ``str(treedef)`` without JAX:
    gossip, Praos and a fleet's ``EngineState``, and ``EdgeState``."""
    from timewarp_tpu.models import gossip as jg
    from timewarp_tpu_torch.models import gossip as tg
    cases = [
        (JaxEngine(jg.gossip(64, burst=True), jd.FixedDelay(5000),
                   window="auto"),
         TorchEngine(tg.gossip(64, burst=True), td.FixedDelay(5000),
                     window="auto", device="cpu")),
        (JaxEngine(jp.praos(64, slot_us=100_000, n_slots=4,
                            leader_prob=4 / 64, fanout=4, burst=True),
                   jd.FixedDelay(5000), window="auto"),
         TorchEngine(tp.praos(64, slot_us=100_000, n_slots=4,
                              leader_prob=4 / 64, fanout=4, burst=True),
                     td.FixedDelay(5000), window="auto", device="cpu")),
        (JaxEngine(jg.gossip(64, burst=True), jd.FixedDelay(5000),
                   window="auto", batch=JSpec(seeds=(0, 1))),
         TorchEngine(tg.gossip(64, burst=True), td.FixedDelay(5000),
                     window="auto", batch=BatchSpec(seeds=(0, 1)),
                     device="cpu")),
        (JEdge(jr.token_ring(32, with_observer=False, mailbox_cap=4),
               jd.UniformDelay(200, 900)),
         EdgeEngine(tr.token_ring(32, with_observer=False, mailbox_cap=4),
                    td.UniformDelay(200, 900), device="cpu")),
    ]
    for je, te in cases:
        want = str(jax.tree.flatten(je.init_state())[1])
        assert tck.treedef_string(te.init_state()) == want

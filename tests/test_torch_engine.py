"""The slice as a whole: ``TorchEngine(device="cpu")`` (the kernels'
plain versions) against ``JaxEngine(insert="xla")`` — bit-identical to
``insert="interpret"`` by the reference's own law
(tests/test_pallas_insert.py) and much faster on the CPU. Same scenario,
link, seed, window and budget through both packages; equal final states
(every ``EngineState`` leaf) and equal traces (digests included) on:

- burst gossip, N=1024, ``Quantize(UniformDelay(8_000, 30_000), 1_000)``,
  ``window="auto"``;
- the overflow config (``mailbox_cap=2``);
- the observer token ring, N=1024 (ordered inbox, append mode);
- gossip at N=1000 (not a multiple of 1024) and paced gossip;
- Praos, burst and paced (its uint32 ``thr`` leaf mapped by state_io.py);
- a state carried across from a mid-run JAX state (state_io.py), gossip
  and Praos (the latter run on under the fused engine);
- a small ``insert_cap`` whose drops must match the Pallas stage's.

Tolerance: exact. The float lognormal link has its own file
(tests/test_torch_lognormal.py).
"""

import numpy as np
import pytest
import torch

from timewarp_tpu.interp.jax_engine.engine import EngineState as JState
from timewarp_tpu.interp.jax_engine.engine import JaxEngine
from timewarp_tpu.models import gossip as jg
from timewarp_tpu.models import praos as jp
from timewarp_tpu.models.token_ring import token_ring as jring
from timewarp_tpu.net import delays as jd
from timewarp_tpu.trace.events import (assert_states_equal,
                                       assert_traces_equal)
from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
from timewarp_tpu_torch.interp.torch_engine.state_io import (
    state_from_numpy, state_to_numpy)
from timewarp_tpu_torch.interp.torch_engine.fused_sparse import \
    FusedSparseEngine
from timewarp_tpu_torch.models import gossip as tg
from timewarp_tpu_torch.models import praos as tp
from timewarp_tpu_torch.models.token_ring import token_ring as tring
from timewarp_tpu_torch.net import delays as td

# one intra-op thread per test process: the test session's workers
# share the host's cores (a process of the default width each
# oversubscribes them several times over)
torch.set_num_threads(1)


def _quantized_uniform(mod):
    return mod.Quantize(mod.UniformDelay(8_000, 30_000), 1_000)


def _gossip_pair(n, link, **kw):
    args = dict(fanout=8, think_us=2_000, burst=True, end_us=1_000_000,
                mailbox_cap=8)
    args.update(kw)
    return (jg.gossip(n, **args), link(jd)), (tg.gossip(n, **args), link(td))


def _port_as_jax(ts, sc=None):
    """The port's final state as a reference ``EngineState`` of numpy
    leaves (the scenario's ``u32_states`` back to uint32), for the
    reference's own ``assert_states_equal``."""
    return JState(**state_to_numpy(ts, sc))


def _praos_pair(n, link, **kw):
    args = dict(slot_us=100_000, n_slots=40, leader_prob=4.0 / n, fanout=8,
                burst=True, mailbox_cap=16)
    args.update(kw)
    return (jp.praos(n, **args), link(jd)), (tp.praos(n, **args), link(td))


def _run_both(pair, steps, **kw):
    (jsc, jl), (tsc, tl) = pair
    je = JaxEngine(jsc, jl, insert="xla", **kw)
    te = TorchEngine(tsc, tl, device="cpu", **kw)
    js, jt = je.run(steps)
    ts, tt = te.run(steps)
    assert te.window == je.window
    assert_traces_equal(jt, tt, "jax", "torch")
    assert_states_equal(js, _port_as_jax(ts, tsc), "jax vs torch")
    return ts, tt


@pytest.mark.parametrize("case", [
    dict(n=1024, link=_quantized_uniform),
    dict(n=1024, link=_quantized_uniform, mailbox_cap=2),
    dict(n=1000, link=_quantized_uniform),
    dict(n=700, link=_quantized_uniform, burst=False, fanout=3,
         end_us=400_000),
], ids=["burst-1024", "overflow-cap2", "n1000", "paced-700"])
def test_gossip_equals_reference(case):
    case = dict(case)
    n, link = case.pop("n"), case.pop("link")
    ts, tt = _run_both(_gossip_pair(n, link, **case), 80, window="auto",
                       seed=5)
    assert int(ts.delivered) > n // 2     # the wave actually spread
    if case.get("mailbox_cap") == 2:
        assert int(ts.overflow) > 0       # the regime actually overflowed


def test_observer_token_ring_equals_reference():
    kw = dict(n_tokens=16, think_us=1_000, with_observer=True,
              mailbox_cap=8)
    pair = ((jring(1023, **kw), jd.UniformDelay(1_000, 5_000)),
            (tring(1023, **kw), td.UniformDelay(1_000, 5_000)))
    ts, tt = _run_both(pair, 300)
    assert int(ts.delivered) > 100
    assert int(ts.states["prev"][-1]) > 0    # the observer got notes


def test_state_carried_across_from_jax():
    (jsc, jl), (tsc, tl) = _gossip_pair(1024, _quantized_uniform)
    je = JaxEngine(jsc, jl, window="auto", seed=9)
    mid = je.run_quiet(10)
    leaves = {f: ({k: np.asarray(v) for k, v in mid.states.items()}
                  if f == "states" else np.asarray(getattr(mid, f)))
              for f in mid._fields}
    te = TorchEngine(tsc, tl, window="auto", seed=9, device="cpu")
    carried = state_from_numpy(leaves, "cpu")
    assert_states_equal(mid, _port_as_jax(carried), "carried")
    js, jt = je.run(40, mid)
    ts, tt = te.run(40, carried)
    assert_traces_equal(jt, tt, "jax", "torch")
    assert_states_equal(js, _port_as_jax(ts), "after carry")
    bad = dict(leaves, mb_rel=leaves["mb_rel"].astype(np.int64))
    with pytest.raises(ValueError, match="dtype"):
        state_from_numpy(bad, "cpu")


@pytest.mark.parametrize("burst", [True, False], ids=["burst", "paced"])
def test_praos_equals_reference(burst):
    """Praos through the general engine (K2 + K1): burst on an 8 ms
    window, and the paced model (max_out 1) on a 1 ms one."""
    pair = _praos_pair(1024, _quantized_uniform, burst=burst)
    ts, _ = _run_both(pair, 80, window="auto" if burst else 1_000, seed=4)
    assert int(ts.delivered) > 1024
    assert int(ts.states["slot"].min()) >= 1


def _leaves(st):
    return {f: ({k: np.asarray(v) for k, v in st.states.items()}
                if f == "states" else np.asarray(getattr(st, f)))
            for f in st._fields}


def test_praos_state_carried_across_from_jax():
    """A mid-run JAX Praos state (its ``thr`` leaf uint32) carried into
    the port (int64 words), run on under the fused engine, and carried
    back bit for bit."""
    (jsc, jl), (tsc, tl) = _praos_pair(1024, _quantized_uniform)
    je = JaxEngine(jsc, jl, window="auto", seed=9)
    mid, _ = je.run(32)     # the same driver as the run on: one compile
    leaves = _leaves(mid)
    assert leaves["states"]["thr"].dtype == np.uint32
    carried = state_from_numpy(leaves, "cpu", tsc)
    assert carried.states["thr"].dtype == torch.int64
    back = state_to_numpy(carried, tsc)
    assert back["states"]["thr"].dtype == np.uint32
    assert_states_equal(mid, JState(**back), "carried")
    fe = FusedSparseEngine(tsc, tl, window="auto", seed=9, device="cpu",
                           max_batch=1 << 20)
    js, jt = je.run(32, mid)
    ts, tt = fe.run(32, carried)
    assert_traces_equal(jt, tt, "jax", "torch")
    assert_states_equal(js, _port_as_jax(ts, tsc), "after carry")
    with pytest.raises(ValueError, match="u32_states"):
        state_from_numpy(leaves, "cpu")
    wrong = dict(leaves, states=dict(leaves["states"],
                                     thr=leaves["states"]["thr"].astype(
                                         np.int64)))
    with pytest.raises(ValueError, match="dtype"):
        state_from_numpy(wrong, "cpu", tsc)


def test_insert_cap_drops_match_pallas_stage():
    (jsc, jl), (tsc, tl) = _gossip_pair(1024, _quantized_uniform)
    je = JaxEngine(jsc, jl, window="auto", insert="interpret",
                   insert_cap=1024)
    te = TorchEngine(tsc, tl, window="auto", insert_cap=1024, device="cpu")
    js, ts = je.run_quiet(30), te.run_quiet(30)
    assert_states_equal(js, _port_as_jax(ts), "insert_cap")
    assert int(ts.route_drop) > 0


def test_refuses_what_is_not_ported():
    """A keyword the reference takes and the port does not (``insert``)
    is refused as unexpected; the knobs of the other regimes are refused
    where the reference refuses them: ``insert_cap`` outside the adaptive
    regime, ``route_cap < 1``, a negative ``record_events``, and a
    ``fixed:W`` speculation at or below the conservative floor.
    ``batch`` and ``faults`` refuse what is not a ``BatchSpec`` /
    ``FaultSchedule``, as the reference does."""
    tsc, tl = _gossip_pair(256, _quantized_uniform)[1]
    with pytest.raises(ValueError, match="does not exceed"):
        TorchEngine(tsc, tl, window="auto", device="cpu",
                    speculate="fixed:8000")
    with pytest.raises(ValueError, match="telemetry must be"):
        TorchEngine(tsc, tl, window="auto", device="cpu", telemetry="on")
    with pytest.raises(ValueError, match="must be a BatchSpec"):
        TorchEngine(tsc, tl, window="auto", device="cpu", batch=object())
    with pytest.raises(ValueError, match="must be a FaultSchedule"):
        TorchEngine(tsc, tl, window="auto", device="cpu", faults=object())
    with pytest.raises(TypeError):
        TorchEngine(tsc, tl, device="cpu", insert="pallas")
    with pytest.raises(ValueError, match="exceeds"):
        TorchEngine(tsc, tl, window=9_000, device="cpu")
    droppy = td.FnDelay(lambda s, d, t, k: (d.long(), d < 0))
    paced = tg.gossip(256, burst=False)
    for sc, link, kw in ((tsc, droppy, {}),                      # eager
                         (paced, td.FixedDelay(5), {}),          # window 1
                         (tsc, tl, dict(window="auto", route_cap=64))):
        with pytest.raises(ValueError, match="never compacts"):
            TorchEngine(sc, link, insert_cap=2048, device="cpu", **kw)
        assert not TorchEngine(sc, link, device="cpu", **kw).adaptive
    with pytest.raises(ValueError, match="route_cap must be >= 1"):
        TorchEngine(tsc, tl, window="auto", route_cap=0, device="cpu")
    with pytest.raises(ValueError, match="record_events must be >= 0"):
        TorchEngine(tsc, tl, window="auto", record_events=-1, device="cpu")

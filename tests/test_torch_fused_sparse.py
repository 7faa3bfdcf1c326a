"""The fused-sparse engine: ``FusedSparseEngine(device="cpu")`` (K3's
plain version) against the reference, on the configurations of
tests/test_fused_sparse.py. Same scenario, link, seed, window and batch
bound through both packages; every ``EngineState`` leaf equal at several
horizons, and equal traces (digests included):

- against ``JaxEngine(insert="xla")`` — equal to the reference's fused
  engine whenever ``route_drop`` is 0 (the reference's own law), and much
  faster on the CPU: the gossip wave and Praos on their bench links
  (quantized lognormal), 8192 nodes on ``SeededHashUniform``, window 1
  with a wide outbox, and overflow at ``mailbox_cap=2``;
- against the reference's ``FusedSparseEngine`` under the Pallas
  interpreter where only it can judge: ``max_batch=128``, whose whole-
  sender drops (``route_drop``) must be the same;
- beyond the reference kernel's TPU limits (n not a multiple of 1024,
  ``mailbox_cap > 128``, a batch past the 12 MB VMEM budget), which the
  port lifts: against ``JaxEngine(insert="xla")``;
- the scope guards.

Tolerance: exact. None of these runs meets a lognormal draw on which the
two packages' float32 rounding differs (tests/test_torch_lognormal.py).
"""

import pytest

from timewarp_tpu.interp.jax_engine.engine import EngineState as JState
from timewarp_tpu.interp.jax_engine.engine import JaxEngine
from timewarp_tpu.interp.jax_engine.fused_sparse import \
    FusedSparseEngine as JFused
from timewarp_tpu.models import gossip as jg
from timewarp_tpu.models import praos as jp
from timewarp_tpu.net import delays as jd
from timewarp_tpu.trace.events import (assert_states_equal,
                                       assert_traces_equal)
from timewarp_tpu_torch.interp.torch_engine.fused_sparse import \
    FusedSparseEngine
from timewarp_tpu_torch.interp.torch_engine.state_io import state_to_numpy
from timewarp_tpu_torch.models import gossip as tg
from timewarp_tpu_torch.models import praos as tp
from timewarp_tpu_torch.models.token_ring import token_ring
from timewarp_tpu_torch.net import delays as td

N = 1024


def gossip_wave(m, n=N, **kw):
    args = dict(fanout=8, think_us=2_000, burst=True, end_us=2_000_000,
                mailbox_cap=16)
    args.update(kw)
    return m.gossip(n, **args)


def praos_slots(m, n=N, **kw):
    args = dict(slot_us=100_000, n_slots=40, leader_prob=4.0 / n, fanout=8,
                burst=True, mailbox_cap=16)
    args.update(kw)
    return m.praos(n, **args)


def qlognormal(m):
    return m.Quantize(m.LogNormalDelay(20_000, 0.6, cap_us=150_000,
                                       floor_us=8_000), 1_000)


def quniform(m):
    return m.Quantize(m.UniformDelay(8_000, 30_000), 1_000)


def port_as_jax(ts, sc):
    return JState(**state_to_numpy(ts, sc))


def check(scenario, link, legs, steps=30, ref="xla", max_batch=1 << 16,
          **kw):
    """Run ``scenario(m)``/``link(m)`` through the reference and the port
    (``m`` the models/delays modules of each package) for ``legs`` chained
    legs of ``steps`` supersteps (``run``): equal traces and states after
    each leg; and the port's ``run_quiet`` to the first leg's state. Every
    reference leg has the same length, so the reference compiles one
    driver. Returns the port's final state."""
    jsc, tsc = scenario(jg, jp), scenario(tg, tp)
    jl, tl = link(jd), link(td)
    je = JaxEngine(jsc, jl, insert="xla", **kw) if ref == "xla" \
        else JFused(jsc, jl, max_batch=max_batch, **kw)
    fe = FusedSparseEngine(tsc, tl, device="cpu", max_batch=max_batch, **kw)
    js, fs = je.init_state(), fe.init_state()
    for leg in range(1, legs + 1):
        js, jt = je.run(steps, js)
        fs, ft = fe.run(steps, fs)
        assert_traces_equal(jt, ft, "reference", f"port-fused leg {leg}")
        assert_states_equal(js, port_as_jax(fs, tsc), f"+{steps * leg}")
        if leg == 1:
            assert_states_equal(js, port_as_jax(fe.run_quiet(steps), tsc),
                                "run_quiet")
    return fs


def test_gossip_wave():
    """Burst gossip on the quantized lognormal link, through ramp-up,
    peak and quiescence: the kernel's float path."""
    fs = check(lambda g, p: gossip_wave(g), qlognormal, 2, window="auto")
    assert int(fs.delivered) > N


def test_praos():
    """Praos: needs_key leadership draws, payload width 2, slot timers and
    diffusion bursts under an 8 ms window."""
    fs = check(lambda g, p: praos_slots(p), qlognormal, 2, window="auto")
    assert int(fs.delivered) > N
    assert int(fs.states["slot"].min()) >= 2


def test_seeded_hash_8192():
    check(lambda g, p: gossip_wave(g, 8192, fanout=4, think_us=700,
                                   end_us=400_000, mailbox_cap=8),
          lambda m: m.SeededHashUniform(3_000, 9_000, 7), 2, window=3_000)


def test_window_1_wide_outbox():
    check(lambda g, p: gossip_wave(g, fanout=4, think_us=700,
                                   end_us=300_000, mailbox_cap=8),
          lambda m: m.UniformDelay(2_000, 9_000), 2, window=1)


def test_overflow_cap_2():
    fs = check(lambda g, p: gossip_wave(g, end_us=1_000_000, mailbox_cap=2),
               quniform, 2, window="auto")
    assert int(fs.overflow) > 0


def test_max_batch_drops_equal_reference_fused():
    """``max_batch=128``: 16 senders a superstep; the rest are dropped
    whole, by id, exactly as the reference's fused engine drops them."""
    fs = check(lambda g, p: gossip_wave(g, end_us=1_000_000), quniform,
               2, ref="fused", window="auto", max_batch=128)
    assert int(fs.route_drop) > 0


@pytest.mark.parametrize("case", [
    dict(scenario=lambda g, p: gossip_wave(g, 1000, mailbox_cap=130,
                                           end_us=1_000_000),
         refused="128"),
    dict(scenario=lambda g, p: praos_slots(p, 8192, n_slots=2,
                                           mailbox_cap=32),
         refused="budget"),
], ids=["n1000-K130", "vmem-budget"])
def test_beyond_the_tpu_limits(case):
    sc = case["scenario"]
    with pytest.raises(ValueError, match=case["refused"]):
        JFused(sc(jg, jp), quniform(jd), window="auto", max_batch=1 << 20)
    check(sc, quniform, 1, steps=16, window="auto", max_batch=1 << 20)


def test_scope_guards():
    sc = gossip_wave(tg)
    kw = dict(window="auto", device="cpu")
    with pytest.raises(ValueError, match="drop-free"):
        FusedSparseEngine(sc, td.WithDrop(td.UniformDelay(8_000, 9_000), .1),
                          **kw)
    ring = token_ring(N - 1, n_tokens=8, think_us=1_000, with_observer=True)
    with pytest.raises(ValueError, match="commutative"):
        FusedSparseEngine(ring, td.UniformDelay(2_000, 9_000), window=2_000,
                          device="cpu")
    for link in (td.ParetoDelay(8_000, 1.5, floor_us=8_000),
                 td.FnDelay(lambda s, d, t, k: (d.long(), d < 0))):
        with pytest.raises(ValueError, match="drop-free|cannot lower"):
            FusedSparseEngine(sc, link, **kw)
    paced = tg.gossip(N, fanout=1, end_us=100_000)
    with pytest.raises(ValueError, match="windowed"):
        FusedSparseEngine(paced, td.UniformDelay(2_000, 9_000), window=1,
                          device="cpu")
    with pytest.raises(ValueError, match="uint32"):
        FusedSparseEngine(sc, td.Quantize(td.UniformDelay(1, 2**31 - 1),
                                          2**31 - 2), window=4, device="cpu")
    with pytest.raises(ValueError, match="not yet ported"):
        FusedSparseEngine(sc, quniform(td), speculate="auto", **kw)
    with pytest.raises(TypeError):       # the reference's takes none either
        FusedSparseEngine(sc, quniform(td), route_cap=64, **kw)
    with pytest.raises(TypeError):
        FusedSparseEngine(sc, quniform(td), insert_cap=64, **kw)

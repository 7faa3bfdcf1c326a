"""The fused dense-ring engine of the port, ``FusedRingEngine(device=
"cpu")`` (K4's plain version, cuda_ring.py ``fused_ring_plain``), against
the reference:

- one superstep of ``fused_ring_plain`` against one JAX
  ``FusedRingEngine._superstep`` (its Pallas kernel interpreted, as
  tests/test_fused_ring.py runs it on the CPU) on seeded random planes:
  alive and past ``end_us``, a token carried across the ring's wrap
  (node N-1 to node 0) into a node whose two slots are full (overflow),
  and random stale payloads in every slot;
- the JAX ``FusedRingEngine`` over a few supersteps at N=8192, plane for
  plane;
- through ``to_edge_state``, the JAX ``EdgeEngine`` at the horizons of
  tests/test_fused_ring.py (dense: 1, 2, 7, 40, 130 supersteps, the last
  past ``end_us`` to quiescence; sparse: 5 tokens, think 1700 µs);
- beyond the reference's lifted ``n % 8192`` guard, at n = 1000 and 3;
- the ``from_edge_state``/``to_edge_state`` round trip, a JAX edge state
  carried in, the horizon refusal and the scope guards.

The CUDA kernel runs only on the card: the ``cuda``-marked test holds it
against the plain version there and skips elsewhere. Tolerance: exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from timewarp_tpu.interp.jax_engine.edge_engine import EdgeEngine as JEdge
from timewarp_tpu.interp.jax_engine.fused_ring import \
    FusedRingEngine as JFused
from timewarp_tpu.interp.jax_engine.fused_ring import \
    FusedRingState as JFusedState
from timewarp_tpu.models.token_ring import token_ring as jring
from timewarp_tpu.net import delays as jd
from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
from timewarp_tpu_torch.interp.torch_engine import cuda_ring as cr
from timewarp_tpu_torch.interp.torch_engine.edge_engine import EdgeEngine
from timewarp_tpu_torch.interp.torch_engine.fused_ring import \
    FusedRingEngine
from timewarp_tpu_torch.interp.torch_engine.state_io import (
    edge_state_from_numpy, edge_state_to_numpy)
from timewarp_tpu_torch.models.token_ring import token_ring as tring
from timewarp_tpu_torch.net import delays as td
from test_torch_edge_engine import assert_leaves_equal, jax_leaves

I32MAX = 2**31 - 1
N = 8192           # the reference kernel's minimum width


def _pair(n, delay, **kw):
    kw = dict(kw, with_observer=False, mailbox_cap=4)
    return ((jring(n, **kw), jd.FixedDelay(delay)),
            (tring(n, **kw), td.FixedDelay(delay)))


DENSE = dict(n_tokens=None, think_us=0, bootstrap_us=1_000, end_us=60_000)
SPARSE = dict(n_tokens=5, think_us=1_700, bootstrap_us=900, end_us=80_000)


def _ring(n, cfg, delay):
    cfg = dict(cfg)
    if cfg["n_tokens"] is None:
        cfg["n_tokens"] = n
    return _pair(n, delay, **cfg)


# -- K4's plain version against one reference superstep -----------------------

def random_planes(rng, n, t0=3):
    """Seeded planes whose minimum is ``t0``: many nodes fire, random
    kinds and stale values in every slot, node N-1 due with a token and
    node 0's two slots full and kept (so the wrap overflows)."""
    def maybe(p, lo, hi):
        return np.where(rng.random(n) < p, I32MAX, rng.integers(lo, hi, n))
    planes = np.stack([
        maybe(0.35, t0, t0 + 4), maybe(0.5, t0, t0 + 4),
        rng.integers(-100, 100, n), rng.integers(-100, 100, n),
        rng.integers(0, 2, n), rng.integers(0, 2, n),
        maybe(0.3, t0, t0 + 4), rng.integers(0, 3, n),
        rng.integers(-50, 50, n), maybe(0.5, t0 - 2, t0 + 6),
    ]).astype(np.int32)
    planes[[cr.WAKE, cr.CNT, cr.SEND], -1] = (t0, 1, t0)
    planes[[cr.QR0, cr.QR1], -1] = I32MAX
    planes[[cr.QR0, cr.QR1], 0] = t0 + 2
    return planes


@pytest.mark.parametrize("alive", [True, False], ids=["alive", "past-end"])
def test_plain_equals_reference_superstep(alive):
    think, delay, end_us = 3, 5, 1_000_000
    base = 0 if alive else end_us
    jsc = jring(N, n_tokens=N, think_us=think, bootstrap_us=1, end_us=end_us,
                with_observer=False, mailbox_cap=4)
    jeng = JFused(jsc, jd.FixedDelay(delay))
    planes = random_planes(np.random.default_rng(5 + alive), N)
    fs = JFusedState(planes=jnp.asarray(planes.reshape(10, -1, 1024)),
                     base=jnp.int64(base), delivered=jnp.int64(0),
                     overflow=jnp.int32(0), steps=jnp.int64(0))
    want = jeng._superstep(fs)
    t = int(planes[[cr.QR0, cr.QR1, cr.WAKE]].min())
    assert t == 3
    got, counts = cr.fused_ring_plain(torch.from_numpy(planes), t,
                                      base + t < end_us, think, delay)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want.planes).reshape(10, N))
    assert int(counts[0]) == int(want.delivered) > 0
    assert int(counts[1]) == int(want.overflow)
    assert int(want.base) == base + t
    if alive:
        # node N-1's token crossed the wrap into node 0's full slots
        assert int(counts[1]) > 0
    # the wrapper on CPU tensors is the plain version, with buffers
    out = torch.empty((10, N), dtype=torch.int32)
    acc = torch.tensor([7, 1], dtype=torch.int64)
    res, acc2 = cr.fused_ring(torch.from_numpy(planes), t, base + t < end_us,
                              think, delay, out=out, acc=acc)
    assert res is out and acc2 is acc and torch.equal(out, got)
    assert acc.tolist() == [7 + int(counts[0]), 1 + int(counts[1])]


def test_equals_reference_fused_engine():
    """The JAX fused engine (Pallas interpreter) and the port's, plane for
    plane, at the reference's minimum width."""
    (jsc, jl), (tsc, tl) = _ring(N, DENSE, 500)
    jeng, teng = JFused(jsc, jl), FusedRingEngine(tsc, tl, device="cpu")
    js, ts = jeng.init_state(), teng.init_state()
    for k in (1, 2, 7):
        js, ts = jeng.run_quiet(k, js), teng.run_quiet(k, ts)
        np.testing.assert_array_equal(ts.planes.numpy(),
                                      np.asarray(js.planes).reshape(10, N))
        for f in ("base", "delivered", "overflow", "steps"):
            assert int(getattr(ts, f)) == int(getattr(js, f)), (k, f)
    assert int(ts.delivered) == 9 * N


# -- through to_edge_state, against the reference's edge engine ---------------

CASES = {
    "dense-8192": (N, DENSE, 500, (1, 2, 7, 40, 130)),
    "sparse-8192": (N, SPARSE, 700, (3, 10, 60)),
    "dense-1000": (1000, DENSE, 500, (1, 7, 130)),
    "sparse-1000": (1000, SPARSE, 700, (3, 60)),
    "dense-3": (3, DENSE, 500, (1, 7, 130)),
    "sparse-3": (3, dict(SPARSE, n_tokens=2), 700, (3, 60, 200)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_equals_reference_edge_engine(case):
    n, cfg, delay, horizons = CASES[case]
    (jsc, jl), (tsc, tl) = _ring(n, cfg, delay)
    jeng, teng = JEdge(jsc, jl, cap=2), FusedRingEngine(tsc, tl,
                                                        device="cpu")
    js, ts = jeng.init_state(), teng.init_state()
    for k in horizons:
        js, ts = jeng.run_quiet(k, js), teng.run_quiet(k, ts)
        assert_leaves_equal(jax_leaves(js),
                           edge_state_to_numpy(teng.to_edge_state(ts)),
                           f"{case} +{k}")
    assert int(ts.delivered) > 0 and int(ts.overflow) == 0
    if cfg is DENSE:
        # past end_us: quiesced, nothing left to run
        assert int(teng._next_event(ts)) >= 2**62 - 1
        assert teng._superstep(ts) is None


def test_round_trip_and_carried_jax_state():
    (jsc, jl), (tsc, tl) = _ring(1000, SPARSE, 700)
    jeng = JEdge(jsc, jl, cap=2)
    mid = jeng.run_quiet(17)
    carried = edge_state_from_numpy(jax_leaves(mid), "cpu")
    teng = FusedRingEngine(tsc, tl, device="cpu")
    fs = teng.from_edge_state(carried)
    assert_leaves_equal(jax_leaves(mid),
                       edge_state_to_numpy(teng.to_edge_state(fs)), "round")
    fin = teng.run_quiet(40, fs)
    assert_leaves_equal(jax_leaves(jeng.run_quiet(40, mid)),
                       edge_state_to_numpy(teng.to_edge_state(fin)), "on")
    # the run left its input state as it was
    assert_leaves_equal(jax_leaves(mid),
                       edge_state_to_numpy(teng.to_edge_state(fs)), "input")
    # the port's own edge engine agrees through the same round trip
    tedge = EdgeEngine(tsc, tl, device="cpu").run_quiet(40, carried)
    assert_leaves_equal(edge_state_to_numpy(tedge),
                       edge_state_to_numpy(teng.to_edge_state(fin)), "port")


def test_horizon_refusal():
    (_, _), (tsc, tl) = _ring(64, SPARSE, 700)
    teng = FusedRingEngine(tsc, tl, device="cpu")
    st = EdgeEngine(tsc, tl, device="cpu").init_state()
    far = st.wake.clone()
    far[3] = int(st.time) + I32MAX          # one past base + 2^31 - 2
    with pytest.raises(ValueError, match="horizon"):
        teng.from_edge_state(st._replace(wake=far))
    ok = st.wake.clone()
    ok[3] = int(st.time) + I32MAX - 1
    assert int(teng.from_edge_state(st._replace(wake=ok)).planes[
        cr.WAKE, 3]) == I32MAX - 1


def test_scope_guards():
    (_, _), (tsc, tl) = _ring(64, DENSE, 500)
    FusedRingEngine(tsc, tl, device="cpu")   # n % 8192 != 0: accepted
    with pytest.raises(ValueError, match="FixedDelay"):
        FusedRingEngine(tsc, td.UniformDelay(1, 5), device="cpu")
    with pytest.raises(ValueError, match="cap=2"):
        FusedRingEngine(tsc, tl, cap=3, device="cpu")
    with pytest.raises(ValueError, match="telemetry"):
        FusedRingEngine(tsc, tl, telemetry="counters", device="cpu")
    with pytest.raises(ValueError, match="verify"):
        FusedRingEngine(tsc, tl, verify="guard", device="cpu")
    obs = tring(64, n_tokens=64, with_observer=True)
    with pytest.raises(ValueError, match="lean dense"):
        FusedRingEngine(obs, tl, device="cpu")
    slow = tring(64, think_us=2**30, with_observer=False)
    with pytest.raises(ValueError, match="fit int32"):
        FusedRingEngine(slow, tl, device="cpu")
    with pytest.raises(ValueError, match="meta"):
        FusedRingEngine(dataclasses.replace(tsc, meta={}), tl, device="cpu")


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1 << 16, 1003, 257, 3])
@pytest.mark.parametrize("alive", [True, False])
def test_fused_ring_kernel_equals_plain(cuda_device, n, alive):
    planes = torch.from_numpy(
        random_planes(np.random.default_rng(n), n)).to(cuda_device)
    before = ci.LAUNCHES["fused_ring"]
    got, acc = cr.fused_ring(planes, 3, alive, 3, 5)
    want, counts = cr.fused_ring_plain(planes, 3, alive, 3, 5)
    torch.cuda.synchronize()
    assert ci.LAUNCHES["fused_ring"] == before + 1
    assert torch.equal(got, want) and torch.equal(acc, counts)
    with pytest.raises(ValueError, match="out of place"):
        cr.fused_ring(planes, 3, alive, 3, 5, out=planes)

"""The port's insertion stage (timewarp_tpu_torch/interp/torch_engine/
cuda_insert.py) against the reference's Pallas kernels run under the
Pallas interpreter, built through ``PallasInsertStage`` with
``insert="interpret"`` as tests/test_pallas_insert.py runs them.

- fire-compaction (K2): the plain version equals ``stage.compact`` on
  N=1024 for window > 1 and window = 1, at a cap small enough that
  messages drop (which pins the reference's write order), and on an
  8192-node outbox where blocks hold 8 rows;
- mailbox insertion (K1): the plain version equals ``stage.insert`` in
  the commutative (hole-ranked) and ordered (counts plane, with src)
  modes, on batches that overflow.

Tolerance: exact — every output column and counter, bit for bit. The
CUDA kernels themselves run only on the card: the ``cuda``-marked tests
below hold them against the plain versions there and skip elsewhere.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from timewarp_tpu.core.scenario import Scenario as JScenario
from timewarp_tpu.interp.jax_engine.pallas_insert import PallasInsertStage
from timewarp_tpu_torch.core.scenario import Scenario
from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci

I32MAX = 2**31 - 1


def _scenarios(n, K, M, P, ordered, src):
    kw = dict(n_nodes=n, payload_width=P, max_out=M, mailbox_cap=K,
              commutative_inbox=not ordered, inbox_src=src)
    return (JScenario("stage", step=None, init=None, **kw),
            Scenario("stage", step=None, init_batched=None, **kw))


def _jax_stage(jsc, n, W, cap):
    return PallasInsertStage(jsc, n, window=W, interpret=True,
                             adaptive=True, insert_cap=cap, route_cap=None)


def _outbox(rng, n, M, P, frac, W):
    pdst = np.where(rng.random((M, n)) < frac, rng.integers(0, n, (M, n)),
                    -1).astype(np.int32)
    woff = rng.integers(0, max(W, 1), n).astype(np.int32)
    pay = rng.integers(-2**31, I32MAX, (M, P, n)).astype(np.int32)
    return pdst, woff, pay


@pytest.mark.parametrize("n,M,P,W,cap,frac", [
    (1024, 8, 1, 8_000, None, 0.3),     # default cap: nothing drops
    (1024, 8, 1, 8_000, 1024, 0.3),     # drops: the write order decides
    (1024, 4, 2, 1, 2048, 0.8),         # window 1 (no woff column), drops
    (8192, 2, 1, 5_000, 4096, 0.4),     # 8-row blocks, drops
], ids=["w8000-nodrop", "w8000-drop", "w1-drop", "rw8-drop"])
def test_fire_compact_plain_equals_pallas(n, M, P, W, cap, frac):
    jsc, tsc = _scenarios(n, 8, M, P, False, False)
    jstage = _jax_stage(jsc, n, W, cap)
    tstage = ci.InsertStage(tsc, n, window=W, insert_cap=cap)
    assert tstage.S == jstage.S
    rng = np.random.default_rng(n + M + W)
    pdst, woff, pay = _outbox(rng, n, M, P, frac, W)
    jd, jw, js, jp, jdrop = jstage.compact(
        jnp.asarray(pdst), jnp.asarray(woff), jnp.asarray(pay))
    td, tw, ts, tp, tdrop = tstage.compact(
        torch.from_numpy(pdst), torch.from_numpy(woff), torch.from_numpy(pay))
    for name, a, b in (("dst", td, jd), ("woff", tw, jw),
                       ("smrank", ts, js)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    np.testing.assert_array_equal(tp.numpy(),
                                  np.stack([np.asarray(c) for c in jp]))
    assert int(tdrop) == int(jdrop)
    fired = int((pdst >= 0).sum())
    assert int(tdrop) == max(fired - tstage.S, 0)
    if cap is not None:
        assert int(tdrop) > 0


def _batch(rng, n, K, P, S, src, hot_fill):
    """A destination-sorted batch (sentinel n past the valid entries) in
    which 16 hot destinations receive ``hot_fill`` messages each."""
    n_msgs = S // 2
    dst = np.concatenate([rng.integers(0, n, n_msgs - 16 * hot_fill),
                          np.repeat(rng.integers(0, n, 16), hot_fill)])
    sd = np.full(S, n, np.int32)
    sd[:n_msgs] = np.sort(dst)
    return dict(
        sd=sd, drel=rng.integers(0, 1 << 20, S).astype(np.int32),
        src=rng.integers(0, n, S).astype(np.int32),
        pay=rng.integers(-2**31, I32MAX, (P, S)).astype(np.int32))


@pytest.mark.parametrize("ordered", [False, True],
                         ids=["commutative", "ordered-src"])
def test_mailbox_insert_plain_equals_pallas(ordered):
    n, M = 1024, 4
    K, P, src = (8, 2, True) if ordered else (16, 1, False)
    jsc, tsc = _scenarios(n, K, M, P, ordered, src)
    jstage = _jax_stage(jsc, n, 8_000, 2048)
    tstage = ci.InsertStage(tsc, n, window=8_000, insert_cap=2048)
    S = tstage.S
    rng = np.random.default_rng(21 + ordered)
    if ordered:
        counts = rng.integers(0, K + 1, n).astype(np.int32)
        live = np.arange(K)[:, None] < counts[None, :]
    else:
        counts = None
        live = rng.random((K, n)) < 0.5
    mb_rel = np.where(live, rng.integers(0, 1 << 20, (K, n)),
                      I32MAX).astype(np.int32)
    mb_src = rng.integers(0, n, (K, n)).astype(np.int32)
    mb_pay = rng.integers(-2**31, I32MAX, (K, P, n)).astype(np.int32)
    b = _batch(rng, n, K, P, S, src, hot_fill=K + 6)
    jr, js, jp, jovf = jstage.insert(
        jnp.asarray(b["sd"]), jnp.asarray(b["drel"]), jnp.asarray(b["src"]),
        tuple(jnp.asarray(p) for p in b["pay"]), jnp.asarray(mb_rel),
        jnp.asarray(mb_src), jnp.asarray(mb_pay),
        None if counts is None else jnp.asarray(counts))
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    mb = [torch.from_numpy(a) for a in (mb_rel, mb_src, mb_pay)]
    before = [m.clone() for m in mb]
    tr, ts, tp, tovf = tstage.insert(
        t["sd"], t["drel"], t["src"], t["pay"], *mb,
        None if counts is None else torch.from_numpy(counts))
    for name, a, r in (("mb_rel", tr, jr), ("mb_src", ts, js),
                       ("mb_payload", tp, jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r),
                                      err_msg=name)
    assert int(tovf) == int(jovf) > 0
    for m, m0 in zip(mb, before):        # inputs are never written
        assert torch.equal(m, m0)


def test_bucket_bounds_many_ties():
    rng = np.random.default_rng(3)
    n = 50
    sd = np.full(400, n, np.int32)
    sd[:300] = np.sort(rng.integers(0, n, 300))
    start, cnt = ci.bucket_bounds(torch.from_numpy(sd), n)
    for d in range(n):
        idx = np.nonzero(sd == d)[0]
        assert int(cnt[d]) == idx.size
        if idx.size:
            assert int(start[d]) == idx[0]


def test_wrappers_refuse_other_devices():
    meta = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ci.fire_compact(meta, None, torch.zeros((2, 1, 8), dtype=torch.int32,
                                                device="meta"), 1024)


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,M,P,frac,S,window1", [
    (1 << 15, 8, 1, 0.3, 1 << 14, False),   # S below the fired count
    (5000, 8, 1, 0.3, 1 << 14, True),       # blocks of one row, window 1
    (1000, 8, 3, 0.3, 4096, False),         # under one segment, P 3
    (1 << 20, 8, 1, 0.2, 1 << 21, False),   # more units than one batch
    (1 << 17, 8, 0, 0.02, 1 << 18, False),  # a long sentinel tail, P 0
    (1 << 14, 8, 7, 0.3, 1 << 16, False),   # staging above 48 KB, P 7
], ids=["32768-False", "5000-True", "n1000-P3", "n2^20", "long-tail-P0",
        "P7-shared-above-48KB"])
def test_fire_compact_kernel_equals_plain(cuda_device, n, M, P, frac, S,
                                          window1):
    rng = np.random.default_rng(n)
    pdst, woff, pay = (torch.from_numpy(a).to(cuda_device)
                       for a in _outbox(rng, n, M, P, frac, 8_000))
    w = None if window1 else woff
    got = ci.fire_compact(pdst, w, pay, S)
    want = ci.fire_compact_plain(pdst, w, pay, S)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    assert (int(got[4]) > 0) == (n == 1 << 15)


@pytest.mark.cuda
def test_fire_compact_kernel_two_calls(cuda_device):
    """Two calls in a row on different inputs: each call has its own
    scratch, so the second does not disturb the first's result."""
    rng = np.random.default_rng(9)
    a, b = ([torch.from_numpy(x).to(cuda_device)
             for x in _outbox(rng, 1 << 16, 8, 1, f, 8_000)]
            for f in (0.3, 0.1))
    first = ci.fire_compact(*a, 1 << 17)
    second = ci.fire_compact(*b, 1 << 17)
    for got, x in ((first, a), (second, b)):
        for g, w in zip(got, ci.fire_compact_plain(*x, 1 << 17)):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_fire_compact_kernel_refuses_too_wide_payload(cuda_device):
    """K2 stages every payload word in shared memory: a payload wider
    than a CTA's shared memory holds is refused at launch, loudly."""
    rng = np.random.default_rng(10)
    pdst, woff, pay = (torch.from_numpy(a).to(cuda_device)
                       for a in _outbox(rng, 4096, 2, 40, 0.3, 8_000))
    with pytest.raises(RuntimeError, match="fire_compact kernel launch"):
        ci.fire_compact(pdst, woff, pay, 1 << 13)


def test_compact_scratch_words():
    """K2's scratch: 8 warp counts and one CTA total per 256-lane unit
    (4 units a 1024-lane segment, segments = node rows x max_out)."""
    assert ci.compact_scratch_words(1 << 17, 8) == 128 * 8 * 4 * 9
    assert ci.compact_scratch_words(1000, 8) == 1 * 8 * 4 * 9
    assert ci.compact_scratch_words(5000, 3) == 5 * 3 * 4 * 9


@pytest.mark.cuda
@pytest.mark.parametrize("ordered", [False, True])
def test_mailbox_insert_kernel_equals_plain(cuda_device, ordered):
    n, K, P = 5000, 8, 2
    rng = np.random.default_rng(5 + ordered)
    b = _batch(rng, n, K, P, 4096, True, hot_fill=K + 3)
    counts = torch.from_numpy(rng.integers(0, K + 1, n).astype(np.int32)) \
        if ordered else None
    mb_rel = np.where(rng.random((K, n)) < 0.5, 7, I32MAX).astype(np.int32)
    dev = cuda_device
    t = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    start, cnt = ci.bucket_bounds(t["sd"], n)
    args = (start, cnt, None if counts is None else counts.to(dev),
            t["drel"], t["src"], t["pay"], torch.from_numpy(mb_rel).to(dev),
            torch.zeros((K, n), dtype=torch.int32, device=dev),
            torch.zeros((K, P, n), dtype=torch.int32, device=dev))
    got = ci.mailbox_insert(*args)
    want = ci.mailbox_insert_plain(*args)
    for g, x in zip(got, want):
        assert torch.equal(g, x)

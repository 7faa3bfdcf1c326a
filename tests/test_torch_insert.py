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
  modes, on batches that overflow: mailboxes nine tenths full under hot
  nodes, K 40, ordered inboxes whose kept rows are all 0, all K, or 0 or
  K at random, and ordered inboxes whose holes lie apart from their kept
  rows (only ``counts`` tells the rows to fill).

Tolerance: exact — every output column and counter, bit for bit. The
CUDA kernels themselves run only on the card: the ``cuda``-marked tests
below hold them against the plain versions there (K1 on the edges of its
tile walk, in both modes, the ordered one also with holes apart from its
kept rows, and at the eager routing path's width, a batch of
``n * max_out`` lanes that ends in a long sentinel tail) and skip
elsewhere.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from timewarp_tpu.core.scenario import Scenario as JScenario
from timewarp_tpu.interp.jax_engine.pallas_insert import PallasInsertStage
from timewarp_tpu_torch.core.scenario import Scenario
from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci

# one intra-op thread per test process: the test session's workers
# share the host's cores (a process of the default width each
# oversubscribes them several times over)
torch.set_num_threads(1)

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


# (ordered, K, P, src, kept rows of an ordered inbox, share of a
# mailbox's rows live (ordered: drawn apart from the kept rows; None: the
# kept rows are the live ones), messages to each of 16 hot nodes, seed)
_INSERT_CASES = {
    "commutative": (False, 16, 1, False, None, 0.5, 22, 21),
    "ordered-src": (True, 8, 2, True, "random", None, 14, 22),
    # a mailbox nine tenths full: the hot nodes get 3K messages, far past
    # their few holes
    "commutative-hot-past-holes": (False, 16, 1, True, None, 0.9, 48, 23),
    "commutative-K40": (False, 40, 1, False, None, 0.5, 46, 24),
    "ordered-counts-0-or-K": (True, 8, 2, True, "0-or-K", None, 14, 25),
    "ordered-counts-all-0": (True, 16, 1, False, "0", None, 22, 26),
    "ordered-counts-all-K": (True, 8, 1, True, "K", None, 14, 27),
    "ordered-K40-counts-0-to-K": (True, 40, 1, False, "random", None, 46,
                                  28),
    "ordered-src-holes-apart": (True, 8, 2, True, "random", 0.5, 14, 29),
    "ordered-K40-holes-apart": (True, 40, 1, False, "random", 0.5, 46, 30),
}


def _kept_rows(rng, kind, K, n):
    """An ordered inbox's kept rows per node: uniform in [0, K], 0 or K
    each at random, or all 0 or all K."""
    if kind == "random":
        return rng.integers(0, K + 1, n).astype(np.int32)
    if kind == "0-or-K":
        return rng.choice(np.array([0, K], np.int32), n)
    return np.full(n, 0 if kind == "0" else K, np.int32)


@pytest.mark.parametrize("case", list(_INSERT_CASES))
def test_mailbox_insert_plain_equals_pallas(case):
    ordered, K, P, src, kept, live_share, hot_fill, seed = _INSERT_CASES[case]
    n, M = 1024, 4
    jsc, tsc = _scenarios(n, K, M, P, ordered, src)
    jstage = _jax_stage(jsc, n, 8_000, 2048)
    tstage = ci.InsertStage(tsc, n, window=8_000, insert_cap=2048)
    S = tstage.S
    rng = np.random.default_rng(seed)
    if ordered:
        counts = _kept_rows(rng, kept, K, n)
        live = np.arange(K)[:, None] < counts[None, :] if live_share is None \
            else rng.random((K, n)) < live_share
    else:
        counts = None
        live = rng.random((K, n)) < live_share
    mb_rel = np.where(live, rng.integers(0, 1 << 20, (K, n)),
                      I32MAX).astype(np.int32)
    mb_src = rng.integers(0, n, (K, n)).astype(np.int32)
    mb_pay = rng.integers(-2**31, I32MAX, (K, P, n)).astype(np.int32)
    b = _batch(rng, n, K, P, S, src, hot_fill=hot_fill)
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
    if kept == "K":                      # no room: every message overflows
        assert int(tovf) == int((b["sd"] < n).sum())
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


# K1's tile edges, chip_smoke phase 3's cases at a smaller size: (modes, n,
# K, P, src, S, share of S valid, messages to each of 16 hot nodes,
# (node, count) messages replacing that node's own, ordered kept rows).
# The tile walk has tiles of 256 nodes, stages 16 rows of a column and
# buffers 8 kept entries a node before a tile chunks. The mode
# "ordered-apart" is the ordered one on a mailbox whose holes are drawn
# apart from its kept rows.
_K1_MODES = ("commutative", "ordered", "ordered-apart")
_BOTH, _ORDERED = _K1_MODES, _K1_MODES[1:]
_K1_EDGES = {
    "n5000-K8-P2-src": (_BOTH, 5000, 8, 2, True, 4096, 0.5, 11, (), None),
    "n-not-a-tile-multiple": (_BOTH, 4099, 16, 1, False, 8192, 0.7, 24, (),
                              None),
    "chunked-hot-node-after-empty": (_BOTH, 4096, 40, 1, True, 1 << 17, 0.9,
                                     24, ((256, 0), (257, 8192)), None),
    "empty-batch": (_BOTH, 4096, 16, 1, False, 4096, 0.0, 0, (), None),
    "K1-P3-src": (_BOTH, 4096, 1, 3, True, 1 << 14, 0.7, 24, (), None),
    "K40-P0-chunked": (_BOTH, 4096, 40, 0, False, 1 << 17, 0.9, 24, (),
                       None),
    "K130-P3-src-chunked": (_BOTH, 4096, 130, 3, True, 1 << 17, 0.9, 24,
                            ((300, 200),), None),
    "K16-P7-src-buffer-above-48KB": (_BOTH, 4096, 16, 7, True, 1 << 15, 0.7,
                                     24, (), None),
    "counts-all-0": (_ORDERED, 4096, 16, 1, True, 8192, 0.7, 24, (), 0),
    "counts-all-K": (_ORDERED, 4096, 16, 1, True, 8192, 0.7, 24, (),
                     16),
    "K40-counts-all-0": (_ORDERED, 4096, 40, 1, False, 1 << 17, 0.9, 24,
                         (), 0),
    "K130-counts-all-K": (_ORDERED, 4096, 130, 1, False, 1 << 15, 0.7,
                          24, (), 130),
    # the eager routing path's batch: S = n * max_out, most of it the
    # sentinel tail (invalid, dropped and bad-destination lanes)
    "eager-width-long-sentinel-tail": (_BOTH, 1 << 16, 8, 1, False,
                                       1 << 16, 0.25, 24, (), None),
    "eager-width-M2-P2-src-long-sentinel-tail": (_BOTH, 1 << 16, 4, 2, True,
                                                 1 << 17, 0.1, 16, (),
                                                 None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case,mode", [
    (case, mode) for case, spec in _K1_EDGES.items() for mode in spec[0]])
def test_mailbox_insert_kernel_equals_plain(cuda_device, case, mode):
    _, n, K, P, src, S, frac, hot_fill, extra, kept = _K1_EDGES[case]
    ordered = mode != "commutative"
    rng = np.random.default_rng(sum(map(ord, case)) + _K1_MODES.index(mode))
    n_msgs = int(S * frac)
    dst = np.concatenate([rng.integers(0, n, n_msgs - 16 * hot_fill),
                          np.repeat(rng.integers(0, n, 16), hot_fill)])
    for node, count in extra:
        dst = np.concatenate([dst[dst != node], np.full(count, node)])
    sd = np.full(S, n, np.int32)
    sd[:dst.size] = np.sort(dst)
    if ordered:
        counts = rng.integers(0, K + 1, n).astype(np.int32) if kept is None \
            else np.full(n, kept, np.int32)
        live = rng.random((K, n)) < 0.5 if mode == "ordered-apart" \
            else np.arange(K)[:, None] < counts[None, :]
    else:
        counts = None
        live = rng.random((K, n)) < 0.5
    mb_rel = np.where(live, 7, I32MAX).astype(np.int32)
    dev = cuda_device

    def on(a):
        return None if a is None else torch.from_numpy(a).to(dev)
    sd_t = on(sd)
    start, cnt = ci.bucket_bounds(sd_t, n)
    args = (start, cnt, on(counts),
            on(rng.integers(0, 1 << 20, S).astype(np.int32)),
            on(rng.integers(0, n, S).astype(np.int32)) if src else None,
            on(rng.integers(-2**31, I32MAX, (P, S)).astype(np.int32)),
            on(mb_rel), on(rng.integers(0, n, (K, n)).astype(np.int32)),
            on(rng.integers(-2**31, I32MAX, (K, P, n)).astype(np.int32)))
    got = ci.mailbox_insert(*args)
    want = ci.mailbox_insert_plain(*args)
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    valid = int(cnt.sum())
    assert (valid == 0) == (case == "empty-batch")
    assert (int(got[3]) > 0) == (valid > 0)
    if kept == K:                        # no room: every message overflows
        assert int(got[3]) == valid


# -- the world axis (a fleet of B worlds in one call) -------------------------

def _fleet_outbox(rng, B, n, M, P, fracs, W):
    """B worlds' outboxes, world b a share ``fracs[b]`` of valid lanes."""
    outs = [_outbox(rng, n, M, P, f, W) for f in fracs[:B]]
    return tuple(np.stack(x) for x in zip(*outs))


def test_fire_compact_plain_world_axis_equals_pallas_vmap():
    """K2's plain version over a world axis: each world compacted into
    its own batch row, its prefix and drops restarting — equal to the
    reference's Pallas stage ``vmap``-ed over the worlds (its kernels map
    the world axis so) and to the solo call per world. World 1 has an
    empty outbox, world 2 drops while the others do not."""
    import jax
    n, M, P, W, cap = 1024, 4, 2, 8_000, 2048
    jsc, tsc = _scenarios(n, 8, M, P, False, False)
    jstage = _jax_stage(jsc, n, W, cap)
    tstage = ci.InsertStage(tsc, n, window=W, insert_cap=cap)
    rng = np.random.default_rng(41)
    pdst, woff, pay = _fleet_outbox(rng, 3, n, M, P, (0.3, 0.0, 0.9), W)
    want = jax.vmap(jstage.compact)(jnp.asarray(pdst), jnp.asarray(woff),
                                    jnp.asarray(pay))
    got = tstage.compact(*(torch.from_numpy(a) for a in (pdst, woff, pay)))
    for name, a, b in (("dst", got[0], want[0]), ("woff", got[1], want[1]),
                       ("smrank", got[2], want[2]), ("drops", got[4],
                                                     want[4])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    np.testing.assert_array_equal(
        got[3].numpy(), np.stack([np.asarray(c) for c in want[3]], axis=1))
    assert got[4].tolist()[:2] == [0, 0] and int(got[4][2]) > 0
    assert (got[0][1] == n).all()
    for b in range(3):
        solo = ci.fire_compact_plain(*(torch.from_numpy(a[b]) for a in (
            pdst, woff, pay)), tstage.S)
        for s, g in zip(solo, got):
            assert torch.equal(s, g[b])


@pytest.mark.parametrize("ordered", [False, True], ids=["commutative",
                                                        "ordered"])
def test_mailbox_insert_plain_world_axis(ordered):
    """K1's plain version over a world axis equals the reference's Pallas
    stage ``vmap``-ed over the worlds and the solo call per world: world
    0 a normal batch, world 1 an empty one, world 2 overflowing."""
    import jax
    n, K, M, P, B = 1024, 8, 4, 2, 3
    jsc, tsc = _scenarios(n, K, M, P, ordered, True)
    jstage = _jax_stage(jsc, n, 8_000, 2048)
    tstage = ci.InsertStage(tsc, n, window=8_000, insert_cap=2048)
    S = tstage.S
    rng = np.random.default_rng(43 + ordered)
    cols = {k: [] for k in ("sd", "drel", "src", "pay", "rel", "msrc",
                            "mpay", "counts")}
    for b, (share, hot) in enumerate(((0.5, 8), (0.0, 0), (0.95, 40))):
        counts = rng.integers(0, K + 1, n).astype(np.int32)
        live = np.arange(K)[:, None] < counts[None, :] if ordered \
            else rng.random((K, n)) < share
        cols["counts"].append(counts)
        cols["rel"].append(np.where(live, rng.integers(0, 1 << 20, (K, n)),
                                    I32MAX).astype(np.int32))
        cols["msrc"].append(rng.integers(0, n, (K, n)).astype(np.int32))
        cols["mpay"].append(rng.integers(-2**31, I32MAX, (K, P, n))
                            .astype(np.int32))
        bt = _batch(rng, n, K, P, S, True, hot_fill=hot)
        if b == 1:
            bt["sd"][:] = n
        for k in ("sd", "drel", "src", "pay"):
            cols[k].append(bt[k])
    a = {k: np.stack(v) for k, v in cols.items()}
    counts = a["counts"] if ordered else None
    want = jax.vmap(
        lambda sd, dr, sr, py, r, s, p, c: jstage.insert(
            sd, dr, sr, tuple(py[i] for i in range(P)), r, s, p, c),
        in_axes=(0,) * 7 + ((0,) if ordered else (None,)))(
        *(jnp.asarray(a[k]) for k in ("sd", "drel", "src", "pay", "rel",
                                      "msrc", "mpay")),
        None if counts is None else jnp.asarray(counts))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    got = tstage.insert(t["sd"], t["drel"], t["src"], t["pay"], t["rel"],
                        t["msrc"], t["mpay"],
                        t["counts"] if ordered else None)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[3][1]) == 0 and int(got[3][2]) > 0
    for b in range(B):
        start, cnt = ci.bucket_bounds(t["sd"][b], n)
        solo = ci.mailbox_insert_plain(
            start, cnt, t["counts"][b] if ordered else None, t["drel"][b],
            t["src"][b], t["pay"][b], t["rel"][b], t["msrc"][b],
            t["mpay"][b])
        for s, g in zip(solo, got):
            assert torch.equal(s, g[b])


def test_compact_scratch_words_world_axis():
    """K2's scratch grows by B: one world's words per world."""
    assert ci.compact_scratch_words(100_000, 1, 8) == \
        8 * ci.compact_scratch_words(100_000, 1)


# K2 and K1 across the world axis on the card, chip_smoke phase 26's
# cases at a smaller size: (B, n, M, P, valid share per world, S).
_K2_FLEETS = {
    "B1-equals-solo": (1, 1 << 15, 8, 1, (0.3,), 1 << 14),
    "B8-fleet-shape-M1": (8, 100_000, 1, 1, (0.3, 0.0, 0.5, 1.0, 0.1, 0.7,
                                             0.02, 0.4), 100_352),
    "B3-one-world-drops-ragged": (3, 5000, 4, 2, (0.1, 0.9, 0.0), 8192),
    "B5-P0-window1": (5, 4099, 2, 0, (0.5, 0.5, 0.2, 0.0, 0.8), 4096),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_K2_FLEETS))
def test_fire_compact_kernel_world_axis(cuda_device, case):
    B, n, M, P, fracs, S = _K2_FLEETS[case]
    rng = np.random.default_rng(len(case))
    pdst, woff, pay = (torch.from_numpy(a).to(cuda_device) for a in
                       _fleet_outbox(rng, B, n, M, P, fracs, 1_000))
    w = None if case == "B5-P0-window1" else woff
    got = ci.fire_compact(pdst, w, pay, S)
    want = ci.fire_compact_plain(pdst, w, pay, S)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    for b in range(B):
        solo = ci.fire_compact(pdst[b], None if w is None else w[b],
                               pay[b], S)
        for s, g in zip(solo, got):
            assert torch.equal(s, g[b])


_K1_FLEETS = {
    "B1-commutative": (1, 1 << 15, 8, 1, False, 1 << 15),
    "B8-fleet-shape": (8, 100_000, 8, 1, False, 100_352),
    "B3-ragged-ordered-src": (3, 4099, 16, 2, True, 8192),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_K1_FLEETS))
def test_mailbox_insert_kernel_world_axis(cuda_device, case):
    """World 1's batch is empty, the last world's mailboxes overflow."""
    B, n, K, P, ordered, S = _K1_FLEETS[case]
    rng = np.random.default_rng(len(case))
    dev = cuda_device
    sds, counts, rels = [], [], []
    for b in range(B):
        share = 0.0 if b == 1 else (0.95 if b == B - 1 else 0.5)
        sd = np.full(S, n, np.int32)
        m = int(S * share)
        sd[:m] = np.sort(rng.integers(0, n if b < B - 1 else 64, m))
        sds.append(sd)
        c = rng.integers(0, K + 1, n).astype(np.int32)
        counts.append(c)
        rels.append(np.where(np.arange(K)[:, None] < c[None, :], 7, I32MAX)
                    .astype(np.int32))

    def on(x):
        return torch.from_numpy(np.stack(x) if isinstance(x, list) else x) \
            .to(dev)
    sd = on(sds)
    start, cnt = ci.bucket_bounds(sd, n)
    args = (start, cnt, on(counts) if ordered else None,
            on(rng.integers(0, 1 << 20, (B, S)).astype(np.int32)),
            on(rng.integers(0, n, (B, S)).astype(np.int32)) if ordered
            else None,
            on(rng.integers(-2**31, I32MAX, (B, P, S)).astype(np.int32)),
            on(rels), on(rng.integers(0, n, (B, K, n)).astype(np.int32)),
            on(rng.integers(-2**31, I32MAX, (B, K, P, n)).astype(np.int32)))
    got = ci.mailbox_insert(*args)
    want = ci.mailbox_insert_plain(*args)
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    if B > 1:
        assert int(got[3][1]) == 0 and int(got[3][-1]) > 0
    for b in range(B):
        solo = ci.mailbox_insert(*(None if x is None else x[b]
                                   for x in args))
        for s, g in zip(solo, got):
            assert torch.equal(s, g[b])

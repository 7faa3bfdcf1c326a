"""The sample-and-insert kernel K3 (timewarp_tpu_torch/interp/
torch_engine/cuda_insert.py ``sample_insert``) against the reference's
Pallas kernel, ``_build_kernel(mode="sample")`` run through
``_fused_insert_call(..., interpret=True)`` as tests/test_fused_sparse.py
runs it on the CPU.

Each case is one destination-sorted batch with hot destinations that
overfill their mailboxes, so ``overflow > 0`` throughout:

- every lowered link kind — Fixed, Uniform, SeededHashUniform,
  Quantize(Uniform) — at n=1024, with and without the inbox src plane;
- a FixedDelay shorter than the window (``short_delay > 0``), one long
  enough to saturate the deliver time (``bad_delay > 0``), and an epoch
  just below 2^32 µs, so that ``t + woff`` carries into the high word;
- n=8192, a multi-block pipeline in the reference.

Tolerance: exact for the integer models (every mailbox plane and every
counter, bit for bit). Quantize(LogNormal) is float32 inside: its deliver
times follow the per-draw rule of tests/test_torch_lognormal.py (at most
5e-5 of the draws, at least one allowed, each off by at most one
quantum); the payload planes and counters stay exact. The CUDA kernel
itself runs only on the card: the ``cuda``-marked test holds it against
the plain version there and skips elsewhere.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from timewarp_tpu.core.rng import seed_words
from timewarp_tpu.core.scenario import Scenario as JScenario
from timewarp_tpu.interp.jax_engine.common import thi, tlo
from timewarp_tpu.interp.jax_engine.fused_sparse import _lower_link
from timewarp_tpu.interp.jax_engine.pallas_insert import (
    _build_kernel, _fused_insert_call, _insertion_plan)
from timewarp_tpu.net import delays as jd
from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
from timewarp_tpu_torch.interp.torch_engine.fused_sparse import lower_link
from timewarp_tpu_torch.net import delays as td

I32MAX = 2**31 - 1
M, P, W = 8, 2, 8_000


def _qlognormal(m):
    return m.Quantize(m.LogNormalDelay(20_000, 0.6, cap_us=150_000,
                                       floor_us=8_000), 1_000)


LINKS = {
    "fixed": lambda m: m.FixedDelay(9_000),
    "uniform": lambda m: m.UniformDelay(8_000, 30_000),
    "seeded-hash": lambda m: m.SeededHashUniform(8_000, 30_000, 7),
    "quantized-uniform": lambda m: m.Quantize(m.UniformDelay(8_000, 30_000),
                                              1_000),
    "short-fixed": lambda m: m.FixedDelay(3_000),
    "bad-fixed": lambda m: m.FixedDelay(I32MAX - 100),
    "quantized-lognormal": _qlognormal,
}


def make_batch(rng, n, K, S, t, src=False, P=P, frac=0.6, extra=()):
    """A mailbox half full and a batch sorted by ``(dst, woff, smrank)``
    (sentinel ``n`` past the valid entries), a ``frac`` share valid, in
    which 16 hot destinations receive K + 6 messages each (when the batch
    has room for them), as numpy arrays. ``extra`` replaces the messages
    of each ``(node, count)`` by ``count`` new ones."""
    n_msgs = int(S * frac)
    n_hot = 16 if n_msgs >= 16 * (K + 6) else 0
    dst = np.concatenate([rng.integers(0, n, n_msgs - n_hot * (K + 6)),
                          np.repeat(rng.integers(0, n, n_hot), K + 6)])
    for node, count in extra:
        dst = np.concatenate([dst[dst != node], np.full(count, node)])
    n_msgs = dst.size
    woff = rng.integers(0, W, n_msgs)
    smrank = rng.choice(n * M, n_msgs, replace=False) if n_msgs <= n * M \
        else rng.integers(0, n * M, n_msgs)
    order = np.lexsort((smrank, woff, dst))
    sd = np.full(S, n, np.int32)
    sd[:n_msgs] = dst[order]
    col = np.zeros(S, np.int32)
    woff_s, smrank_s = col.copy(), col.copy()
    woff_s[:n_msgs], smrank_s[:n_msgs] = woff[order], smrank[order]
    return dict(
        sd=sd, woff=woff_s, smrank=smrank_s,
        pay=rng.integers(-2**31, I32MAX, (P, S)).astype(np.int32),
        mb_rel=np.where(rng.random((K, n)) < 0.5,
                        rng.integers(0, 1 << 20, (K, n)),
                        I32MAX).astype(np.int32),
        mb_src=rng.integers(0, n, (K, n)).astype(np.int32),
        mb_payload=rng.integers(-2**31, I32MAX, (K, P, n)).astype(np.int32),
        t=np.int64(t), src=src)


def plain(b, link, s0, s1, device="cpu"):
    """The port's K3 on batch ``b`` (``sample_insert`` on ``device``)."""
    t = {k: torch.from_numpy(v).to(device) for k, v in b.items()
         if isinstance(v, np.ndarray)}
    n = b["mb_rel"].shape[1]
    start, cnt = ci.bucket_bounds(t["sd"], n)
    tt = torch.tensor(int(b["t"]), dtype=torch.int64, device=device)
    return ci.sample_insert(start, cnt, t["sd"], t["woff"], t["smrank"],
                            t["pay"], tt, t["mb_rel"], t["mb_src"],
                            t["mb_payload"], link=lower_link(link), s0=s0,
                            s1=s1, M=M, W=W, inbox_src=b["src"])


def reference(b, link, s0, s1):
    """The reference kernel on batch ``b`` under the Pallas interpreter:
    ``(mb_rel, mb_src, mb_payload, overflow, bad_delay, short_delay)``."""
    K, n = b["mb_rel"].shape
    jsc = JScenario("k3", step=None, init=None, n_nodes=n, payload_width=P,
                    max_out=M, mailbox_cap=K, commutative_inbox=True,
                    inbox_src=b["src"])
    S, R, G = _insertion_plan(jsc, n, b["sd"].size, who="test")
    nk, _, fn = _lower_link(link)
    kern = _build_kernel(K=K, P=P, R=R, G=G, SR=S // 128, n=n, M=M, W=W,
                         inbox_src=b["src"], mode="sample", needs_key=nk,
                         s0=s0, s1=s1, delay_fn=fn)
    t = jnp.int64(b["t"])
    scal = jnp.stack([tlo(t).astype(jnp.int32), thi(t).astype(jnp.int32),
                      jnp.int32(0), jnp.int32(0)])
    mrel, msrc, mpay, cnts = _fused_insert_call(
        kern, S, n, K, P, b["src"], scal, jnp.asarray(b["sd"]),
        jnp.asarray(b["woff"]), jnp.asarray(b["smrank"]),
        tuple(jnp.asarray(p) for p in b["pay"]), jnp.asarray(b["mb_rel"]),
        jnp.asarray(b["mb_src"]), jnp.asarray(b["mb_payload"]),
        interpret=True)
    c = np.asarray(cnts).reshape(3, -1).sum(axis=1)
    return (np.asarray(mrel), np.asarray(msrc), np.asarray(mpay),
            int(c[0]), int(c[1]), int(c[2]))


@pytest.mark.parametrize("case", [
    dict(link="fixed"),
    dict(link="uniform", src=True),
    dict(link="seeded-hash"),
    dict(link="quantized-uniform"),
    dict(link="short-fixed"),
    dict(link="bad-fixed"),
    dict(link="quantized-uniform", t=2**32 - 3_000, src=True),
    dict(link="seeded-hash", n=8192, S=8192, t=2**33 - 5_000),
    dict(link="quantized-lognormal"),
], ids=["fixed", "uniform-src", "seeded-hash", "quantized-uniform",
        "short", "bad-delay", "carry-2^32", "seeded-hash-8192",
        "quantized-lognormal"])
def test_sample_insert_plain_equals_pallas(case):
    n, K, S = case.get("n", 1024), case.get("K", 4), case.get("S", 2048)
    rng = np.random.default_rng(n + K + len(case["link"]))
    t = case.get("t", int(rng.integers(1 << 20, 1 << 40)))
    b = make_batch(rng, n, K, S, t, case.get("src", False))
    s0, s1 = seed_words(3)
    link = LINKS[case["link"]]
    want = reference(b, link(jd), s0, s1)
    got = plain(b, link(td), s0, s1)
    rel = got[0].numpy()
    if case["link"] == "quantized-lognormal":
        diff = np.abs(rel.astype(np.int64) - want[0])
        draws = int((b["sd"] < n).sum())
        assert np.count_nonzero(diff) <= max(1, 5e-5 * draws)
        assert diff.max() <= 1_000
    else:
        np.testing.assert_array_equal(rel, want[0], err_msg="mb_rel")
    np.testing.assert_array_equal(got[1].numpy(), want[1], err_msg="mb_src")
    np.testing.assert_array_equal(got[2].numpy(), want[2],
                                  err_msg="mb_payload")
    counters = tuple(int(x) for x in got[3:])
    assert counters == want[3:]
    assert counters[0] > 0                                   # overflow
    assert (counters[1] > 0) == (case["link"] == "bad-fixed")
    assert (counters[2] > 0) == (case["link"] == "short-fixed")


def test_lower_link_scope():
    ll = lower_link(LINKS["quantized-lognormal"](td))
    assert (ll.kind, ll.quantum, ll.max_delay_us) == ("lognormal", 1_000,
                                                      150_000)
    assert lower_link(td.SeededHashUniform(3, 9, 7)).ints[1] == 7
    for bad in (td.Quantize(td.Quantize(td.FixedDelay(5), 2), 3),
                td.ParetoDelay(5_000, 1.5),
                td.WithDrop(td.FixedDelay(5), 0.1)):
        with pytest.raises(ValueError, match="cannot lower"):
            lower_link(bad)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        lower_link(td.UniformDelay(0, 2**31))


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


#: the kernel's cases on the card: every link kind at n = 50 000, then the
#: edges of its tiles (256 nodes, 16 rows of a column staged in shared
#: memory, an entry buffer of 8 entries a node before a tile chunks)
CARD_CASES = {name: dict(link=name) for name in sorted(LINKS)}
CARD_CASES.update({
    "n-not-tile-multiple": dict(n=5 * 256 + 3, S=1 << 13),
    "hot-node-past-tile": dict(S=1 << 15, frac=0.3,
                               extra=((256, 0), (257, 256 * 16 + 100))),
    "empty-batch": dict(S=1 << 12, frac=0.0),
    "K1-P3-src": dict(n=5000, K=1, P=3, S=1 << 14, src=True),
    "K40-P0": dict(n=5000, K=40, P=0, S=1 << 17),
    "K130-P3-src": dict(n=5000, K=130, P=3, S=1 << 17, src=True),
    "K16-P0-src": dict(n=5000, P=0, S=1 << 15, src=True),
})


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_sample_insert_kernel_equals_plain(cuda_device, name):
    case = CARD_CASES[name]
    n, K = case.get("n", 50_000), case.get("K", 16)
    link_name = case.get("link", "quantized-lognormal")
    rng = np.random.default_rng(len(name))
    b = make_batch(rng, n, K, case.get("S", 1 << 17), 2**32 - 3_000,
                   src=case.get("src", name == "uniform"),
                   P=case.get("P", P), frac=case.get("frac", 0.6),
                   extra=case.get("extra", ()))
    s0, s1 = seed_words(5)
    link = LINKS[link_name](td)
    got = plain(b, link, s0, s1, cuda_device)
    t = {k: torch.from_numpy(v).to(cuda_device) for k, v in b.items()
         if isinstance(v, np.ndarray)}
    start, cnt = ci.bucket_bounds(t["sd"], n)
    want = ci.sample_insert_plain(
        start, cnt, t["sd"], t["woff"], t["smrank"], t["pay"],
        torch.tensor(int(b["t"]), device=cuda_device), t["mb_rel"],
        t["mb_src"], t["mb_payload"], link=lower_link(link), s0=s0, s1=s1,
        M=M, W=W, inbox_src=b["src"])
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    assert (int(cnt.sum()) == 0) == (name == "empty-batch")

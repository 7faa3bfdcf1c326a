"""The port's integer foundations against the reference, word for word:
``threefry2x32``, ``seed_words``, ``fire_bits``, ``msg_bits``,
``uniform_int``, ``bernoulli`` (timewarp_tpu_torch/core/rng.py), ``mix32``
(trace/hashing.py) and ``group_rank``/``u32sum``/``tlo``/``thi``
(ops/numeric.py), on random grids and on extreme key/counter grids
(0, 2^31-1, 2^31, 2^32-1, negative int32 node ids).

Tolerance: exact for every integer function. ``normal_f32`` is float32
Box-Muller, and torch's and XLA's float32 ``log``/``cos`` round
differently on some inputs: each draw must lie within 4 float32 ulps of
the reference's, and at most a quarter of the draws may differ at all
(about 11% do on an x86 CPU). What that does to sampled link delays is
held in tests/test_torch_engine.py (the lognormal leg).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from timewarp_tpu.core import rng as jrng
from timewarp_tpu.ops import numeric as jnum
from timewarp_tpu.trace.hashing import mix32_jnp
from timewarp_tpu_torch.core import rng as trng
from timewarp_tpu_torch.ops import numeric as tnum
from timewarp_tpu_torch.trace.hashing import mix32

EXTREME_U32 = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1],
                       np.uint32)
EXTREME_I32 = np.array([0, 1, -1, 2**31 - 1, -2**31, -2**31 + 1], np.int32)
EXTREME_T = np.array([0, 1, 2**32 - 1, 2**32, 2**62 - 1, -1], np.int64)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _words(x) -> np.ndarray:
    """A reference uint32 array or a port int64 carrier as int64 words."""
    if isinstance(x, torch.Tensor):
        return x.numpy().astype(np.int64)
    return np.asarray(x).astype(np.uint32).astype(np.int64)


def _grids(seed):
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, 2**32, (4, 4096), dtype=np.uint64).astype(
        np.uint32)
    ext = np.stack(np.meshgrid(EXTREME_U32, EXTREME_U32, EXTREME_U32,
                               EXTREME_U32, indexing="ij")).reshape(4, -1)
    return [rand, ext]


@pytest.mark.parametrize("grid", [0, 1], ids=["random", "extreme"])
def test_threefry_word_for_word(grid):
    k0, k1, c0, c1 = _grids(7)[grid]
    j0, j1 = jrng.threefry2x32(k0, k1, c0, c1)
    t0, t1 = trng.threefry2x32(*(_t(a.astype(np.int64))
                                 for a in (k0, k1, c0, c1)))
    np.testing.assert_array_equal(_words(t0), _words(j0))
    np.testing.assert_array_equal(_words(t1), _words(j1))


def test_threefry_signed_int32_counters():
    """int32 counters (node ids) enter as their two's-complement word."""
    c = np.tile(EXTREME_I32, 6)
    j0, j1 = jrng.threefry2x32(np.uint32(5), np.uint32(2**32 - 1), c, c)
    t0, t1 = trng.threefry2x32(5, 2**32 - 1, _t(c), _t(c))
    np.testing.assert_array_equal(_words(t0), _words(j0))
    np.testing.assert_array_equal(_words(t1), _words(j1))


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1, 2**32 - 1, 2**40 + 5,
                                  12345678901234])
def test_seed_words(seed):
    assert trng.seed_words(seed) == jrng.seed_words(seed)


def test_fire_and_msg_bits_word_for_word():
    rng = np.random.default_rng(3)
    nodes = np.concatenate([EXTREME_I32,
                            rng.integers(-2**31, 2**31, 2000)]).astype(
        np.int32)
    t = np.concatenate([np.repeat(EXTREME_T, 1), rng.integers(
        0, 2**62, nodes.size - EXTREME_T.size)]).astype(np.int64)
    slot = rng.integers(0, 16, nodes.size).astype(np.int32)
    dst = rng.permutation(nodes)
    for s0, s1 in ((0, 0), (2**32 - 1, 2**31 - 1), jrng.seed_words(9)):
        jf = jrng.fire_bits(s0, s1, nodes, t)
        tf = trng.fire_bits(s0, s1, _t(nodes), _t(t))
        jm = jrng.msg_bits(s0, s1, nodes, dst, t, slot)
        tm = trng.msg_bits(s0, s1, _t(nodes), _t(dst), _t(t), _t(slot))
        for a, b in zip(tf + tm, jf + jm):
            np.testing.assert_array_equal(_words(a), _words(b))


def test_uniform_int_and_bernoulli_exact():
    rng = np.random.default_rng(4)
    bits = np.concatenate([EXTREME_U32, rng.integers(
        0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)])
    tb = _t(bits.astype(np.int64))
    for lo, hi in ((1_000, 5_000), (0, 2**31 - 1), (8_000, 30_000)):
        np.testing.assert_array_equal(
            trng.uniform_int(tb, lo, hi).numpy(),
            np.asarray(jrng.uniform_int(jnp.asarray(bits), lo, hi)))
    for p in (0.0, 0.1, 0.5, 1.0):
        np.testing.assert_array_equal(
            trng.bernoulli(tb, p).numpy(),
            np.asarray(jrng.bernoulli(jnp.asarray(bits), p)))


def test_normal_f32_within_ulps():
    rng = np.random.default_rng(5)
    b = rng.integers(0, 2**32, (2, 1 << 16), dtype=np.uint64).astype(
        np.uint32)
    ref = np.asarray(jrng.normal_f32(jnp.asarray(b[0]), jnp.asarray(b[1])))
    got = trng.normal_f32(_t(b[0].astype(np.int64)),
                          _t(b[1].astype(np.int64))).numpy()
    assert got.dtype == np.float32
    ulp = np.spacing(np.abs(ref).astype(np.float32))
    assert np.all(np.abs(got - ref) <= 4 * ulp)
    assert np.mean(got != ref) < 0.25


def test_mix32_word_for_word():
    rng = np.random.default_rng(6)
    i32 = np.concatenate([EXTREME_I32, rng.integers(
        -2**31, 2**31, 1000)]).astype(np.int32)
    t64 = np.concatenate([EXTREME_T, rng.integers(
        -2**62, 2**62, i32.size - EXTREME_T.size)]).astype(np.int64)
    u32 = rng.integers(0, 2**32, i32.size, dtype=np.uint64).astype(
        np.uint32)
    ref = mix32_jnp(3, i32, t64, u32, i32[::-1].copy())
    got = mix32(3, _t(i32), _t(t64), _t(u32.astype(np.int64)),
                _t(i32[::-1].copy()))
    np.testing.assert_array_equal(_words(got), _words(ref))


def test_numeric_primitives_exact():
    rng = np.random.default_rng(8)
    keys = np.sort(rng.integers(0, 50, 3000)).astype(np.int32)
    np.testing.assert_array_equal(
        tnum.group_rank(_t(keys)).numpy(),
        np.asarray(jnum.group_rank(jnp.asarray(keys))))
    words = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    assert int(tnum.u32sum(_t(words.astype(np.int64)))) == \
        int(jnum.u32sum(jnp.asarray(words)))
    t = np.concatenate([EXTREME_T, rng.integers(-2**62, 2**62, 100)])
    for tf, jf in ((tnum.tlo, jnum.tlo), (tnum.thi, jnum.thi)):
        np.testing.assert_array_equal(_words(tf(_t(t))),
                                      _words(jf(jnp.asarray(t))))

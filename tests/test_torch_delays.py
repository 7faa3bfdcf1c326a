"""The port's link models of this slice against the reference's, draw for
draw on the same ``(src, dst, t, entropy)`` made with numpy from a seed:
``SeededHashUniform`` (keyed by ``(dst, t)``, no entropy), ``WithDrop``
(its drop decision and its inner draw from the ``split_bits`` substream),
``split_bits`` itself, and ``ParetoDelay``; plus each model's declared
``min_delay_us``, ``can_drop`` and ``needs_key``.

Tolerance: exact for the integer models and for every drop decision.
``ParetoDelay`` is float32 inside (``exp(log(u) / -alpha)``): torch's
and XLA's float32 ``log`` differ by an ulp on some inputs (as for
``LogNormalDelay``), and the exponent multiplies that by up to
``|ln u| / alpha`` (about 16 for the 24-bit ``u`` and ``alpha >= 1``). So
at most 1e-3 of the draws may differ, each by at most 2^-18 of the
reference's delay (32 float32 ulps) or 1 µs, whichever is larger
(10 to 26 of 2^16 draws differ on an x86 CPU, the worst by 32 µs of
31.4 s).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from timewarp_tpu.core import rng as jrng
from timewarp_tpu.net import delays as jd
from timewarp_tpu_torch.core import rng as trng
from timewarp_tpu_torch.net import delays as td

# one intra-op thread per test process: the test session's workers
# share the host's cores (a process of the default width each
# oversubscribes them several times over)
torch.set_num_threads(1)

N_DRAWS = 1 << 16


def _inputs(seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 1 << 20, N_DRAWS).astype(np.int32)
    dst = rng.integers(0, 1 << 20, N_DRAWS).astype(np.int32)
    dst[:4] = (0, 1, 2**31 - 1, -1)
    t = rng.integers(0, 2**40, N_DRAWS).astype(np.int64)
    t[:4] = (0, 2**32 - 1, 2**32, 2**62)
    key = rng.integers(0, 2**32, (2, N_DRAWS), dtype=np.uint64).astype(
        np.uint32)
    key[:, :3] = [[0, 2**32 - 1, 2**31], [2**32 - 1, 0, 5]]
    return src, dst, t, key


def _draw(model_j, model_t, seed):
    src, dst, t, key = _inputs(seed)
    jk = tuple(jnp.asarray(k) for k in key) if model_j.needs_key else None
    tk = tuple(torch.from_numpy(k.astype(np.int64)) for k in key) \
        if model_t.needs_key else None
    jdel, jdrop = model_j.sample(jnp.asarray(src), jnp.asarray(dst),
                                 jnp.asarray(t), jk)
    tdel, tdrop = model_t.sample(torch.from_numpy(src), torch.from_numpy(dst),
                                 torch.from_numpy(t), tk)
    for a in ("min_delay_us", "can_drop", "needs_key"):
        assert getattr(model_t, a) == getattr(model_j, a), a
    return (np.asarray(jdel), np.asarray(jdrop), tdel.numpy(), tdrop.numpy())


@pytest.mark.parametrize("models", [
    lambda m: m.SeededHashUniform(1_000, 5_000, 0),
    lambda m: m.SeededHashUniform(8_000, 30_000, 2**40 + 7),
    lambda m: m.Quantize(m.SeededHashUniform(0, 9_999, 3), 1_000),
    lambda m: m.WithDrop(m.UniformDelay(1_000, 5_000), 0.1),
    lambda m: m.WithDrop(m.SeededHashUniform(1_000, 5_000, 4), 0.5),
    lambda m: m.WithDrop(m.FixedDelay(700), m.NEVER_CONNECTED),
    lambda m: m.WithDrop(m.WithDrop(m.UniformDelay(0, 9), 0.2), 0.3),
], ids=["hash", "hash-wide-salt", "quantized-hash", "drop-uniform",
        "drop-hash", "never-connected", "drop-drop"])
def test_integer_models_draw_for_draw(models):
    jdel, jdrop, tdel, tdrop = _draw(models(jd), models(td), 1)
    np.testing.assert_array_equal(tdel, jdel)
    np.testing.assert_array_equal(tdrop, jdrop)
    assert tdel.dtype == np.int64 and tdrop.dtype == np.bool_


def test_split_bits_word_for_word():
    _, _, _, key = _inputs(2)
    for tag in (0, 1, 0x1A7E5EED, 2**32 - 1):
        j0, j1 = jrng.split_bits(jnp.asarray(key[0]), jnp.asarray(key[1]),
                                 tag)
        t0, t1 = trng.split_bits(torch.from_numpy(key[0].astype(np.int64)),
                                 torch.from_numpy(key[1].astype(np.int64)),
                                 tag)
        np.testing.assert_array_equal(t0.numpy(), np.asarray(j0).astype(
            np.int64))
        np.testing.assert_array_equal(t1.numpy(), np.asarray(j1).astype(
            np.int64))


@pytest.mark.parametrize("models", [
    lambda m: m.ParetoDelay(5_000, 1.5),
    lambda m: m.ParetoDelay(20_000, 2.5, cap_us=150_000, floor_us=8_000),
    lambda m: m.WithDrop(m.ParetoDelay(1_000, 1.1), 0.25),
], ids=["pareto", "pareto-clamped", "drop-pareto"])
def test_pareto_per_draw_rule(models):
    jdel, jdrop, tdel, tdrop = _draw(models(jd), models(td), 3)
    np.testing.assert_array_equal(tdrop, jdrop)
    diff = np.abs(tdel - jdel)
    assert np.all(diff <= np.maximum(jdel * 2.0**-18, 1))
    assert np.count_nonzero(diff) <= 1e-3 * diff.size
    if np.count_nonzero(diff):    # the record for the port's fault log
        i = int(np.flatnonzero(diff)[0])
        print(f"{models(td)}: {np.count_nonzero(diff)} of {diff.size} "
              f"draws differ; first: reference {jdel[i]} us, port {tdel[i]} us")

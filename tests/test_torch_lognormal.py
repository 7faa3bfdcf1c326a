"""The lognormal gossip leg: the bench's link,
``Quantize(LogNormalDelay(20_000, 0.6, floor_us=8_000), 1_000)``, is
float32 inside, and torch's and XLA's float32 ``log``/``exp``/``cos``
round differently on some inputs (tests/test_torch_rng.py). So this leg
is held by a per-draw rule, the integer tests staying exact:

- over 2^20 draws, the quantized delays may differ from the reference's
  on at most 5e-5 of the draws, each by at most one quantum (9 differ on
  an x86 CPU: a raw draw within an ulp of a quantum boundary);
- the raw µs-rounded lognormal may differ on at most 1e-3 of the draws,
  each by at most 1 µs (260 differ on an x86 CPU).

``pytest -s`` prints the count and the first diverging draw of each.
The gossip wave on this link (about 8,000 draws) is then held exactly
against ``JaxEngine`` (states and traces): none of its draws diverges.
"""

import numpy as np
import torch

import jax.numpy as jnp

from timewarp_tpu.net import delays as jd
from timewarp_tpu_torch.net import delays as td

from test_torch_engine import _gossip_pair, _run_both


def _quantized_lognormal(mod):
    return mod.Quantize(mod.LogNormalDelay(20_000, 0.6, floor_us=8_000),
                        1_000)


def test_lognormal_per_draw_rule():
    rng = np.random.default_rng(17)
    b = rng.integers(0, 2**32, (2, 1 << 20), dtype=np.uint64).astype(
        np.uint32)
    tb = tuple(torch.from_numpy(x.astype(np.int64)) for x in b)
    jb = tuple(jnp.asarray(x) for x in b)
    z = np.zeros(b.shape[1], np.int32)
    for link, frac, tol in ((_quantized_lognormal, 5e-5, 1_000),
                            (lambda m: m.LogNormalDelay(
                                20_000, 0.6, floor_us=8_000), 1e-3, 1)):
        ref = np.asarray(link(jd).sample(z, z, z, jb)[0])
        got = link(td).sample(torch.from_numpy(z), torch.from_numpy(z),
                              None, tb)[0].numpy()
        diff = np.abs(got - ref)
        bad = np.nonzero(diff)[0]
        if bad.size:      # the record for the port's fault log (-s shows it)
            i = int(bad[0])
            print(f"{link(td)}: {bad.size} of {diff.size} draws differ; "
                  f"first at words ({int(b[0, i])}, {int(b[1, i])}): "
                  f"reference {int(ref[i])} us, port {int(got[i])} us")
        assert bad.size <= frac * diff.size
        assert diff.max() <= tol


def test_lognormal_gossip_equals_reference():
    ts, _ = _run_both(_gossip_pair(1024, _quantized_lognormal), 80,
                      window="auto", seed=2)
    assert int(ts.delivered) > 512

"""The port's ``--link`` grammar (timewarp_tpu_torch/net/links.py)
against the reference's (timewarp_tpu/net/links.py): every spec of
tests/test_zgrammar.py's ``GOOD_LINKS`` parses to the same model (same
class tree and fields, same ``min_delay_us``, ``can_drop`` and
``needs_key``) whose seeded draws equal the reference's; every spec of
its ``BAD_LINKS`` dies with a ``SystemExit`` naming ``LINK_GRAMMAR``.

Tolerance: exact for the integer models and for every drop decision.
The float models follow the per-draw rules of the port's fault log
(ROADMAP.md queue 3; tests/test_torch_lognormal.py,
tests/test_torch_delays.py): over 2^16 draws, a raw lognormal draw may
differ by 1 µs and a raw Pareto draw by 2^-18 of the reference's delay
(or 1 µs), each on at most 1e-3 of the draws; a quantized one by one
quantum, on at most 5e-5 (lognormal) or 1e-3 (Pareto) of the draws.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from timewarp_tpu.net.links import LINK_GRAMMAR as J_GRAMMAR
from timewarp_tpu.net.links import parse_link as jparse
from timewarp_tpu_torch.net.links import LINK_GRAMMAR, parse_link

from test_zgrammar import BAD_LINKS, GOOD_LINKS

# one intra-op thread per test process: the test session's workers
# share the host's cores (a process of the default width each
# oversubscribes them several times over)
torch.set_num_threads(1)

N_DRAWS = 1 << 16

# the float specs: (share of draws that may differ, their largest
# difference as a function of the reference's delays)
_FLOAT_RULES = {
    "lognormal:5000:0.5": (1e-3, lambda d: 1),
    "pareto:4000:1.5": (1e-3, lambda d: np.maximum(d * 2.0**-18, 1)),
    "quantize:1000:lognormal:5000:0.5": (5e-5, lambda d: 1_000),
    "quantize:500:pareto:4000:1.2": (1e-3, lambda d: 500),
}


def test_grammar_text_is_the_reference_s():
    assert LINK_GRAMMAR == J_GRAMMAR


@pytest.mark.parametrize("spec", GOOD_LINKS)
def test_good_links_draw_for_draw(spec):
    jm, tm = jparse(spec), parse_link(spec)
    assert repr(tm) == repr(jm)           # same classes, same fields
    for a in ("min_delay_us", "can_drop", "needs_key"):
        assert getattr(tm, a) == getattr(jm, a), a
    rng = np.random.default_rng(sum(map(ord, spec)))
    src = rng.integers(0, 1 << 20, N_DRAWS).astype(np.int32)
    dst = rng.integers(0, 1 << 20, N_DRAWS).astype(np.int32)
    dst[:2] = (-1, 2**31 - 1)
    t = rng.integers(0, 2**40, N_DRAWS).astype(np.int64)
    key = rng.integers(0, 2**32, (2, N_DRAWS), dtype=np.uint64).astype(
        np.uint32)
    jdel, jdrop = jm.sample(jnp.asarray(src), jnp.asarray(dst),
                            jnp.asarray(t),
                            tuple(jnp.asarray(k) for k in key))
    tdel, tdrop = tm.sample(torch.from_numpy(src), torch.from_numpy(dst),
                            torch.from_numpy(t),
                            tuple(torch.from_numpy(k.astype(np.int64))
                                  for k in key))
    jdel, jdrop = np.asarray(jdel), np.asarray(jdrop)
    np.testing.assert_array_equal(tdrop.numpy(), jdrop)
    diff = np.abs(tdel.numpy() - jdel)
    if spec not in _FLOAT_RULES:
        np.testing.assert_array_equal(tdel.numpy(), jdel)
        return
    share, tol = _FLOAT_RULES[spec]
    assert np.count_nonzero(diff) <= share * diff.size
    assert np.all(diff <= tol(jdel))


@pytest.mark.parametrize("spec", BAD_LINKS)
def test_bad_links_name_the_grammar(spec):
    with pytest.raises(SystemExit) as e:
        parse_link(spec)
    assert LINK_GRAMMAR in str(e.value)

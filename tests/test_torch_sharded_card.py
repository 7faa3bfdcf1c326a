"""K1′ on the card: K1 at a sharded rank's post-exchange shape (its
``n_local`` nodes, a batch of ``D · bucket_cap``, the commutative and the
ordered inbox mode), in two gloo ranks sharing the card
(``parallel.launch.spawn(..., backend="gloo", device="cuda")``), equals
its plain version bit for bit, one launch a call. Marked ``cuda``: it
skips without a card. The file imports no JAX (the plain version is the
reference). Tolerance: exact.
"""

import pytest
import torch

from timewarp_tpu_torch.parallel.launch import spawn


@pytest.mark.cuda
def test_k1_per_shard_equals_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    res = spawn("torch_sharded_cases:run_all", 2, backend="gloo",
                device="cuda", args=(["k1_per_shard"],))
    for r in res:
        got = r["k1_per_shard"]
        assert not (isinstance(got, tuple) and got[0] == "error"), got
        assert got == {"commutative": (True, 1), "ordered": (True, 1)}
